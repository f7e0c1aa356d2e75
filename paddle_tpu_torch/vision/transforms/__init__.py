from . import functional
from .functional import (adjust_brightness, adjust_contrast, adjust_hue,
                         adjust_saturation, center_crop, crop, erase, hflip,
                         normalize, pad, resize, rotate, to_grayscale,
                         to_tensor, vflip)
from .transforms import (BaseTransform, BrightnessTransform, CenterCrop,
                         ColorJitter, Compose, ContrastTransform, Grayscale,
                         HueTransform, Normalize, Pad, RandomCrop,
                         RandomErasing, RandomHorizontalFlip,
                         RandomResizedCrop, RandomRotation,
                         RandomVerticalFlip, Resize, SaturationTransform,
                         SeededRandom, ToTensor, Transpose)

__all__ = ["functional", "Compose", "BaseTransform", "ToTensor", "Resize",
           "RandomResizedCrop", "CenterCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "Normalize", "Transpose",
           "BrightnessTransform", "ContrastTransform", "SaturationTransform",
           "HueTransform", "ColorJitter", "RandomCrop", "Pad",
           "RandomRotation", "Grayscale", "RandomErasing", "SeededRandom",
           "to_tensor", "resize", "crop", "center_crop", "hflip", "vflip",
           "pad", "rotate", "to_grayscale", "normalize", "adjust_brightness",
           "adjust_contrast", "adjust_saturation", "adjust_hue", "erase"]
