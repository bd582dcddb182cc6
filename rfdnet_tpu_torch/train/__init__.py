"""Training: the optimizer and steps (`trainer.py`), checkpoints
(`checkpoint.py`) and the epoch loop (`loop.py`)."""
