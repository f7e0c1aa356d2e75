"""Layers and functional ops of the PyTorch/CUDA port (the subset GPT
training uses)."""
from . import clip, functional, rng
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import GELU, Dropout, Embedding, LayerNorm, Linear

__all__ = ["clip", "functional", "rng", "Linear", "Embedding", "LayerNorm",
           "GELU", "Dropout", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
