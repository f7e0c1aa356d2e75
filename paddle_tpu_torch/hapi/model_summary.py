"""`summary`: the counterpart of `paddle_tpu/hapi/model_summary.py`,
each leaf module's output shape and parameter count, and the totals.

JAX reads the shapes from forward hooks under `jax.eval_shape`; the
port runs the eval forward on the `meta` device (`functional_call` over
meta copies of the parameters and buffers: shapes only, no arithmetic,
no device memory). The rows, the printed table and the returned dict
are JAX's.
"""
from __future__ import annotations

import torch

from .. import core

__all__ = ["summary"]


def summary(net: torch.nn.Module, input_size=None, dtypes=None,
            input=None):
    """Print the table and return {"total_params", "trainable_params"}.
    `input_size` is one shape or a list of shapes (None dims are 1) of
    `dtypes` (the default dtype when None), or `input` the tensors."""
    rows, hooks = [], []

    def mk_hook(name):
        def hook(mod, args, out):
            n_params = sum(p.numel() for p in mod.parameters(recurse=False))
            shape = getattr(out, "shape", None)
            rows.append((f"{name} ({type(mod).__name__})",
                         tuple(shape) if shape is not None else "-",
                         n_params))
        return hook

    for name, sub in net.named_modules():
        if name and next(sub.children(), None) is None:      # leaves only
            hooks.append(sub.register_forward_hook(mk_hook(name)))

    if input is not None:
        inputs = list(input) if isinstance(input, (list, tuple)) \
            else [input]
        inputs = [torch.as_tensor(i) for i in inputs]
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size[0], (list, tuple)) \
            else [input_size]
        dt = core.convert_dtype(dtypes) or core.get_default_dtype()
        inputs = [torch.zeros(tuple(1 if s is None else s for s in sz),
                              dtype=dt) for sz in sizes]

    was_training = net.training
    net.eval()
    try:
        state = {k: torch.empty_like(v, device="meta")
                 for k, v in list(net.named_parameters())
                 + list(net.named_buffers())}
        with torch.no_grad():
            torch.func.functional_call(
                net, state, tuple(i.to("meta") for i in inputs))
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)

    width = max([len(r[0]) for r in rows] + [20])
    lines = ["-" * (width + 40),
             f"{'Layer (type)':<{width}} {'Output Shape':<22} {'Params':>10}",
             "=" * (width + 40)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}} {str(shape):<22} {n:>10,}")
    lines += ["=" * (width + 40),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * (width + 40)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
