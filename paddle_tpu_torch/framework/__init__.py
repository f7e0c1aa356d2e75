"""The training step of the PyTorch/CUDA port and its checkpoints."""
from .auto_checkpoint import AutoCheckpoint
from .trainer import TrainState, Trainer

__all__ = ["AutoCheckpoint", "TrainState", "Trainer"]
