"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

The JAX package `paddle_tpu` is the reference this package is held
against; this package imports neither it nor JAX. Entry points take an
explicit `device` (default "cuda", which raises without a card); every
TPU kernel on a ported path is a hand-written Hopper kernel under
`ops_cuda/`, with a plain PyTorch version beside it for CPU tensors.
Ported paths: GPT served by `LLMEngine` from a slotted or paged, fp or
int8 KV cache (kernels K1, K4, K5, K6), with int8-PTQ weights and
speculative decoding (kernel K7, the fused int8 GEMV), and GPT trained
by `Trainer` with `AdamW` (kernels K2 and K3).
"""
from . import (framework, models, nn, ops_cuda, optimizer, quantization,
               serving)
from .core import default_device, resolve_device, resolve_dtype
from .framework import Trainer
from .models import GPT, GPTConfig, gpt_small, gpt_tiny
from .serving import LLMEngine, SamplingParams

__all__ = ["framework", "models", "nn", "ops_cuda", "optimizer",
           "quantization", "serving",
           "default_device", "resolve_device", "resolve_dtype", "GPT",
           "GPTConfig", "gpt_small", "gpt_tiny", "LLMEngine",
           "SamplingParams", "Trainer"]
