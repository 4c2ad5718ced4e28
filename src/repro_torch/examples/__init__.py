"""The reference's five examples (``examples/*.py``) on the port, each run
as ``python -m repro_torch.examples.<name>`` with ``main(argv=None)``:

* ``quickstart``      — one cell's prediction, the training-behaviour
  factorization, the OoM guard (host arithmetic);
* ``capacity_plan``   — three memoized sweeps (the torch engine on the
  card, ``--device cpu`` on the host);
* ``predict_memory``  — the paper's workflow as a CLI; ``--validate`` runs
  one real step of the cell on the card and scores the prediction against
  the allocator's peak;
* ``serve_batched``   — serving-memory admission control, then batched
  greedy generation on the reduced smollm-360m;
* ``train_llava_e2e`` — a ~100M LLaVA trained with the fault-tolerant
  runtime (pipeline, trainer, async checkpoints).

The predictor's printed lines are the reference scripts'; whatever runs a
model runs on the card unless ``--device cpu`` asks for the host.
"""
