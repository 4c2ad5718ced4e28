"""The work of a step, one module per model family, counted from the
configuration and the traffic alone: the model's dot-product FLOPs
(forward and backward under the configuration's trainable set, no
recompute), and the shapes and number of the attention and RMSNorm calls
a step makes."""
