"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Sources live in `csrc/`; `_build.py` compiles them on
first use."""
from .decode_attention import (paged_decode_reference,
                               paged_ragged_decode_attention,
                               ragged_decode_attention,
                               ragged_decode_reference)
from .flash_attention import (attention_reference, dot_product_attention,
                              flash_backward_plain, flash_forward_plain)
from .int8_linear import int8_linear_fused, int8_linear_plain

__all__ = ["ragged_decode_attention", "ragged_decode_reference",
           "paged_ragged_decode_attention", "paged_decode_reference",
           "dot_product_attention", "attention_reference",
           "flash_forward_plain", "flash_backward_plain",
           "int8_linear_fused", "int8_linear_plain"]
