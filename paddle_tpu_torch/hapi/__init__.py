"""The high-level API of the PyTorch/CUDA port: `Model` over the port's
`Trainer`, the callbacks `fit` builds, and `summary`."""
from . import callbacks
from .model import InputSpec, Model
from .model_summary import summary

__all__ = ["callbacks", "Model", "InputSpec", "summary"]
