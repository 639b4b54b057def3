"""The learned-index probe: Hopper kernel (`kernel.py`, `csrc/`), plain
version (`ref.py`) and the ops that dispatch between them (`ops.py`)."""
