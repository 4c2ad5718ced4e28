"""The benchmark's plain reference: one module per model family, each the
family's forward pass and loss in plain float32 PyTorch, and ``common``,
their layers and training loop.  Nothing here imports the program."""
