"""`vision` of the PyTorch/CUDA port: the datasets and transforms of
`paddle_tpu/vision/` that CIFAR / MNIST training reads (the models are
`paddle_tpu_torch.models`)."""
from . import datasets, transforms

__all__ = ["datasets", "transforms"]
