"""`vision` of the PyTorch/CUDA port: the datasets and transforms of
`paddle_tpu/vision/`, and the model zoo (`paddle_tpu_torch.models`)
re-exported lazily, as the JAX package's `vision` does: `vision.models`
is the zoo, and `vision.<name>` resolves to `models.<name>`."""
from . import datasets, transforms

__all__ = ["datasets", "transforms", "set_image_backend",
           "get_image_backend"]


def __getattr__(name):
    from .. import models as _models
    if name == "models":
        return _models
    if hasattr(_models, name):
        return getattr(_models, name)
    raise AttributeError(
        f"paddle_tpu_torch.vision has no attribute {name!r}")


_BACKEND = "cv2"


def set_image_backend(backend: str):
    global _BACKEND
    _BACKEND = backend


def get_image_backend() -> str:
    return _BACKEND
