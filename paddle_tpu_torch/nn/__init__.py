"""Layers and functional ops of the PyTorch/CUDA port (the subset GPT
training uses)."""
from . import functional
from .layers import GELU, Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "Linear", "Embedding", "LayerNorm", "GELU",
           "Dropout"]
