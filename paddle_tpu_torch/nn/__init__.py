"""Layers and functional ops of the PyTorch/CUDA port (the subsets GPT,
the ResNet family and BERT / ERNIE train with, the activations,
containers, transformer layers and losses); `ranks` is the runtime of a
mesh's logical ranks that `parallel/` drives."""
from . import clip, functional, initializer, ranks, rng
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import GELU, Dropout, Embedding, LayerNorm, Linear
from .layers_common import (CELU, ELU, GLU, SELU, AlphaDropout, Dropout2D,
                            Dropout3D, Flatten, Hardshrink, Hardsigmoid,
                            Hardswish, Hardtanh, Identity, LayerDict,
                            LayerList, LeakyReLU, LogSigmoid, LogSoftmax,
                            Maxout, Mish, ParameterList, PReLU, ReLU, ReLU6,
                            RReLU, Sequential, Sigmoid, Silu, Softmax,
                            Softplus, Softshrink, Softsign, Swish, Tanh,
                            Tanhshrink, ThresholdedReLU)
from .layers_conv import Conv1D, Conv2D, Conv3D
from .layers_loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                          CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                          HingeEmbeddingLoss, HuberLoss, KLDivLoss, L1Loss,
                          MarginRankingLoss, MSELoss,
                          MultiLabelSoftMarginLoss, NLLLoss, PoissonNLLLoss,
                          SmoothL1Loss, SoftMarginLoss, TripletMarginLoss)
from .layers_norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          SyncBatchNorm)
from .layers_pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .layers_transformer import (FusedFeedForward, FusedMultiHeadAttention,
                                 FusedTransformerEncoderLayer,
                                 MultiHeadAttention, Transformer,
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "ranks", "rng", "Linear",
           "Embedding", "LayerNorm", "GELU", "Dropout", "Identity",
           "Flatten", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Sequential", "LayerList", "LayerDict", "ParameterList", "ReLU",
           "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "Silu", "Swish",
           "Mish", "Sigmoid", "LogSigmoid", "Hardsigmoid", "Hardswish",
           "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink", "Softplus",
           "Softsign", "Tanh", "PReLU", "RReLU", "GLU", "Maxout", "Softmax",
           "LogSoftmax", "ThresholdedReLU", "Conv1D", "Conv2D", "Conv3D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "CrossEntropyLoss",
           "MSELoss", "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss",
           "KLDivLoss", "SmoothL1Loss", "HuberLoss", "MarginRankingLoss",
           "HingeEmbeddingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
           "PoissonNLLLoss", "GaussianNLLLoss", "SoftMarginLoss",
           "MultiLabelSoftMarginLoss", "CTCLoss",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
