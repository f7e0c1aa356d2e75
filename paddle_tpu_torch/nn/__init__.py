"""Layers and functional ops of the PyTorch/CUDA port (the subsets GPT
and the ResNet family train with)."""
from . import clip, functional, initializer, rng
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import GELU, Dropout, Embedding, LayerNorm, Linear
from .layers_common import Flatten, ReLU, Sequential
from .layers_conv import Conv1D, Conv2D, Conv3D
from .layers_loss import CrossEntropyLoss
from .layers_norm import BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D
from .layers_pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["clip", "functional", "initializer", "rng", "Linear",
           "Embedding", "LayerNorm", "GELU", "Dropout", "ReLU", "Flatten",
           "Sequential", "Conv1D", "Conv2D", "Conv3D", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "MaxPool2D",
           "AvgPool2D", "AdaptiveAvgPool2D", "CrossEntropyLoss",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
