"""The high-level API of the PyTorch/CUDA port: `Model` over the port's
`Trainer`, and the callbacks `fit` builds."""
from . import callbacks
from .model import Model

__all__ = ["callbacks", "Model"]
