"""Models of the PyTorch/CUDA port."""
from .gpt import (GPT, GPTConfig, generate_greedy, gpt_1p3b, gpt_medium,
                  gpt_small, gpt_tiny)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, wide_resnet50_2,
                     wide_resnet101_2)
from .weights import (from_jax_params, from_jax_train_state,
                      load_jax_int8_params, load_jax_params, load_jax_state)

__all__ = ["GPT", "GPTConfig", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b", "generate_greedy", "ResNet", "BasicBlock",
           "BottleneckBlock", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "from_jax_params",
           "from_jax_train_state", "load_jax_params", "load_jax_int8_params",
           "load_jax_state"]
