from . import functional
from .functional import (center_crop, crop, hflip, normalize, pad, resize,
                         to_tensor, vflip)
from .transforms import (BaseTransform, CenterCrop, Compose, Normalize, Pad,
                         RandomCrop, RandomHorizontalFlip, Resize,
                         SeededRandom, ToTensor, Transpose)

__all__ = ["functional", "Compose", "BaseTransform", "ToTensor", "Normalize",
           "Transpose", "RandomHorizontalFlip", "RandomCrop", "Pad",
           "CenterCrop", "Resize", "SeededRandom", "to_tensor", "resize",
           "crop", "center_crop", "hflip", "vflip", "pad", "normalize"]
