"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

The JAX package `paddle_tpu` is the reference this package is held
against; this package imports neither it nor JAX. Entry points take an
explicit `device` (default "cuda", which raises without a card); every
TPU kernel on a ported path is a hand-written Hopper kernel under
`ops_cuda/`, with a plain PyTorch version beside it for CPU tensors.
Ported paths: GPT served by `LLMEngine` from a slotted or paged, fp or
int8 KV cache (kernels K1, K4, K5, K6), with int8-PTQ weights and
speculative decoding (kernel K7, the fused int8 GEMV), GPT served by a
replica fleet (`serving.EngineFleet`, its KV tier over `ps/` and its
autoscaler; the same kernels in every replica), and GPT trained
by `Trainer` (kernels K2 and K3, in bf16, fp16 and fp32) with every
optimizer rule, LR scheduler and gradient clip of the JAX package, AMP
O1 and O2, a GradScaler, dropout, remat and the `check_nan_inf` flag,
and the ResNet family trained by `Trainer` or `hapi.Model.fit` over
`io.DataLoader` and `vision.datasets` (convolution, batch norm and
pooling as PyTorch ops, since the JAX package computes them with plain
XLA: no TPU kernel lies on that path), with BatchNorm's running
statistics threaded through the Trainer's steps as in JAX, and BERT /
ERNIE fine-tuning (`models/bert.py` over the transformer, activation
and container layers; `text/`'s datasets) by `Trainer` or `hapi.Model`,
whose attention takes K2/K3 (non-causal, packed qkv) without a mask or
attention dropout and the dense path with either; and program capture
and export (`jit.to_static`, `jit.save` / `jit.load` over
`torch.export`, with Python control flow rewritten onto `torch.cond` /
`while_loop` by `jit.dy2static`; `static`'s shims) served by
`inference.Predictor`, one CUDA graph per input signature, with K2/K3
as `paddle_tpu_torch::` operators inside the exported programs; and
data-parallel and ZeRO 1-3 training over a mesh of logical ranks on one
card (`parallel`, also `distributed`; `Trainer(mesh=)`, synced batch
norm, `fleet`).

The flat tensor surface is the reference's root namespace: the dtype,
device, seed and grad-mode helpers of `core`, the ops of `ops` (`from
.ops import *`; `tensor` is `ops`), `Parameter` / `functional_call`,
and functional autograd (`autograd`, `grad`, `value_and_grad`). Run it
on the CPU with `set_device("cpu")`; the default device is the card.
"""
from . import (amp, framework, hapi, inference, io, jit, metric, models,
               nn, ops_cuda, optimizer, parallel, quantization, serving,
               static, text, vision)
from . import core
from .core import (bfloat16, bool_, complex64, complex128,  # noqa: F401
                   convert_dtype, default_device, device_count, float16,
                   float32, float64, get_default_dtype, get_device,
                   get_flags, int8, int16, int32, int64, is_compiled_with_tpu,
                   no_grad, resolve_device, resolve_dtype, seed,
                   set_default_dtype, set_device, set_flags, uint8)

# flat tensor-op namespace (paddle.* parity)
from .ops import *  # noqa: F401,F403
from .ops import creation, linalg, manipulation, math  # noqa: F401
from . import ops
from . import ops as tensor  # noqa: F401

from .nn.layer import Parameter, functional_call  # noqa: F401

from . import autograd  # noqa: F401
from .autograd import grad, value_and_grad  # noqa: F401
from .framework import Trainer
from .hapi import Model, summary
from .parallel import DataParallel
from .models import (GPT, Bert, BertConfig, BertForMaskedLM,
                     BertForSequenceClassification, GPTConfig, ernie_base,
                     gpt_small, gpt_tiny, resnet18, resnet50)
from .serving import LLMEngine, SamplingParams

distributed = parallel


# the reference's root names still to port, by ROADMAP item
_PENDING = {"distribution": "13.5",
            "sparse": "13.5", "incubate": "13.5", "onnx": "13.5",
            "utils": "13.5", "analysis": "13.6"}


def __getattr__(name):
    if name in ("save", "load"):
        from .framework import io as _io
        globals()["save"], globals()["load"] = _io.save, _io.load
        return globals()[name]
    if name == "Tensor":
        import torch
        return torch.Tensor
    if name in _PENDING:
        raise AttributeError(
            f"paddle_tpu_torch.{name} is not ported yet (ROADMAP Queue 1, "
            f"item {_PENDING[name]})")
    if name == "ops_pallas":
        raise AttributeError(
            "paddle_tpu_torch has no ops_pallas: the TPU kernels' "
            "counterparts are the Hopper kernels of paddle_tpu_torch.ops_cuda")
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")

__all__ = ["amp", "framework", "hapi", "inference", "io", "jit", "metric",
           "models", "nn", "ops_cuda", "optimizer", "parallel",
           "distributed", "quantization", "serving", "static", "text",
           "vision", "DataParallel",
           "default_device", "resolve_device", "resolve_dtype",
           "set_flags", "get_flags", "GPT",
           "GPTConfig", "gpt_small", "gpt_tiny", "resnet18", "resnet50",
           "Bert", "BertConfig", "BertForSequenceClassification",
           "BertForMaskedLM", "ernie_base",
           "LLMEngine", "SamplingParams", "Trainer", "Model", "summary",
           "core",
           "ops", "tensor", "autograd", "grad", "value_and_grad",
           "Parameter", "functional_call", "seed", "set_device",
           "get_device", "device_count", "is_compiled_with_tpu",
           "convert_dtype", "set_default_dtype", "get_default_dtype",
           "no_grad"]
