"""The benchmark of the PyTorch/CUDA port: run one cell with run.py."""
