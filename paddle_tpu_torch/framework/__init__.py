"""The training step of the PyTorch/CUDA port."""
from .trainer import TrainState, Trainer

__all__ = ["TrainState", "Trainer"]
