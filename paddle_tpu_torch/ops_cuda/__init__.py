"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Sources live in `csrc/`; `_build.py` compiles them on
first use."""
from .decode_attention import (ragged_decode_attention,
                               ragged_decode_reference)

__all__ = ["ragged_decode_attention", "ragged_decode_reference"]
