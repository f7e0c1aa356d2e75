"""Helpers of the port's ResNet tests: a JAX ResNet built from a seed
with its parameters and buffers as numpy, the port's twin carrying
them, seeded image batches, and per-tensor comparisons."""
import numpy as np
import torch

import paddle_tpu as pt
from paddle_tpu_torch.models import load_jax_state


def jax_model(ctor, seed=0, **kw):
    """(JAX model, {name: array} params, {name: array} buffers); the
    arrays are copies (a JAX Trainer donates the model's own buffers,
    and a zero-copy numpy view would follow them)."""
    pt.seed(seed)
    m = ctor(**kw)
    return (m, numpy_tree(m.raw_parameters()), numpy_tree(m.raw_buffers()))


def numpy_tree(t):
    """Copies of every array of a nest of dicts."""
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    return np.array(t)


def port_twin(ctor, params, buffers, **kw):
    return load_jax_state(ctor(device="cpu", seed=123, **kw), params,
                          buffers)


def images(n, size, fmt="NHWC", classes=10, seed=0):
    rs = np.random.RandomState(seed)
    shape = (n, size, size, 3) if fmt == "NHWC" else (n, 3, size, size)
    return rs.randn(*shape).astype(np.float32), \
        rs.randint(0, classes, (n,)).astype(np.int64)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def rel_err(got, want):
    """max |got - want| / max |want| (1 for an all-zero want)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def worst(got: dict, want: dict):
    """(largest rel_err, its name) over the names of `want`, which must
    equal `got`'s."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    return max((rel_err(got[k], v), k) for k, v in want.items())


def worst_move(got: dict, want: dict, start: dict):
    """(largest max |got - want| / max |want - start|, its name): the
    difference of two runs as a share of how far the run moved each
    tensor from `start`."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    out = []
    for k, v in want.items():
        move = np.abs(f32(v) - f32(start[k])).max()
        out.append((float(np.abs(f32(got[k]) - f32(v)).max()
                          / max(move, 1e-30)), k))
    return max(out)
