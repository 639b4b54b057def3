"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`ref.py`) and the op that dispatches between them (`ops.py`)."""
