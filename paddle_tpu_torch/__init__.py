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
"""
from . import (amp, framework, hapi, inference, io, jit, metric, models,
               nn, ops_cuda, optimizer, parallel, quantization, serving,
               static, text, vision)
from .core import (default_device, get_flags, resolve_device,
                   resolve_dtype, set_flags)
from .framework import Trainer
from .hapi import Model
from .parallel import DataParallel
from .models import (GPT, Bert, BertConfig, BertForMaskedLM,
                     BertForSequenceClassification, GPTConfig, ernie_base,
                     gpt_small, gpt_tiny, resnet18, resnet50)
from .serving import LLMEngine, SamplingParams

distributed = parallel

__all__ = ["amp", "framework", "hapi", "inference", "io", "jit", "metric",
           "models", "nn", "ops_cuda", "optimizer", "parallel",
           "distributed", "quantization", "serving", "static", "text",
           "vision", "DataParallel",
           "default_device", "resolve_device", "resolve_dtype",
           "set_flags", "get_flags", "GPT",
           "GPTConfig", "gpt_small", "gpt_tiny", "resnet18", "resnet50",
           "Bert", "BertConfig", "BertForSequenceClassification",
           "BertForMaskedLM", "ernie_base",
           "LLMEngine", "SamplingParams", "Trainer", "Model"]
