#!/usr/bin/env python3
"""Probes behind chip_smoke.py's ResNet phases (6g, 6i).

    python3 scripts/resnet_probe.py [--device cuda|cpu] [--out FILE]

1. trajectory: ResNet-18 (10 classes, NHWC, stem_s2d) at 8 x 32 x 32,
   Momentum(1e-3, 0.9), 3 Trainer steps in fp32 and in fp64 from one
   seed (TF32 off): after each step, the largest |fp32 - fp64| / max
   |fp64| of the parameters, BatchNorm buffers and velocity slots, for
   the free-running fp32 run and for one fp32 step started from the
   fp64 run's state.
2. perturbation (CPU): the same 3 steps from initial weights scaled by
   (1 + eps N(0, 1)), fp32 against fp64 of the same start, for eps 0,
   1e-7 and 3e-7.
3. flips: at the fp64 run's state before each step, the stem's
   max-pool windows (positive maxima) whose argmax, and the ReLU inputs
   whose sign, differ between the fp32 and the fp64 forward on
   `--device`.
4. cudnn.benchmark (the card only): ResNet-50 at bench.py's
   configuration (O2 bf16, 128 x 224 x 224, Momentum(0.1, 0.9)), 3
   warm-up and 10 timed steps with cudnn.benchmark off and on: warm-up
   s and step ms.
Every line names the device (and on the card its name and power
limit).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import cast_floating  # noqa: E402
from paddle_tpu_torch.framework import Trainer, TrainState  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.optimizer import Momentum  # noqa: E402

KW = dict(num_classes=10, data_format="NHWC", stem_s2d=True, seed=0)


def device_line(dev: str) -> str:
    if dev == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def batch():
    rs = np.random.RandomState(0)
    return rs.randn(8, 32, 32, 3), rs.randint(0, 10, (8,))


def trainer(dev, dtype, eps=0.0):
    model = P.models.resnet18(device=dev, **KW).to(dtype)
    if eps:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen,
                                             dtype=torch.float64)
                       .to(dev, dtype))
    return Trainer(model, Momentum(1e-3, 0.9),
                   lambda o, t: F.cross_entropy(o, t))


def parts(st):
    return {"params": st.params, "buffers": st.buffers,
            "velocity": {k: s["velocity"]
                         for k, s in st.opt_state["slots"].items()}}


def worst(a, b):
    """{part: (largest |a - b| / max |b| over the part's tensors, name)}."""
    out = {}
    for part, ref in parts(b).items():
        got = parts(a)[part]
        out[part] = max((float((got[k].detach().double().cpu()
                                - v.detach().double().cpu()).abs().max()
                               / v.detach().double().abs().max().cpu()
                               .clamp_min(1e-30)), k)
                        for k, v in ref.items())
    return out


def trajectory(dev):
    x, y = batch()
    ref, free = trainer(dev, torch.float64), trainer(dev, torch.float32)
    one = trainer(dev, torch.float32)
    ref.init_state()
    rows = []
    for step in range(1, 4):
        st = ref.state                      # one fp32 step from fp64's
        one.load_state(TrainState(
            cast_floating(st.params, torch.float32),
            cast_floating(st.buffers, torch.float32),
            cast_floating(st.opt_state, torch.float32), {}, st.rng_key,
            st.step))
        ref.train_steps(torch.from_numpy(x), y, steps=1)
        free.train_steps(torch.from_numpy(x).float(), y, steps=1)
        one.train_steps(torch.from_numpy(x).float(), y, steps=1)
        rows.append({"step": step, "free": worst(free.state, ref.state),
                     "one_step": worst(one.state, ref.state)})
        print(f"  step {step} [{device_line(dev)}]: free-running "
              f"{rows[-1]['free']}; one step from fp64's state "
              f"{rows[-1]['one_step']}", flush=True)
    return rows


def perturbation():
    x, y = batch()
    rows = []
    for eps in (0.0, 1e-7, 3e-7):
        runs = {}
        for dtype in (torch.float32, torch.float64):
            tr = trainer("cpu", dtype, eps)
            tr.train_steps(torch.from_numpy(x).to(dtype), y, steps=3)
            runs[dtype] = tr.state
        w = worst(runs[torch.float32], runs[torch.float64])
        rows.append({"eps": eps, "worst": w})
        print(f"  eps {eps:g} [cpu]: fp32 vs fp64 after 3 steps {w}",
              flush=True)
    return rows


def flips(dev):
    """At the fp64 run's state before each step, what the fp32 forward
    decides otherwise than the fp64 one: stem max-pool windows (with a
    positive maximum) whose argmax differs, and ReLU inputs whose sign
    differs (each re-routes a gradient)."""
    x, y = batch()
    ref = trainer(dev, torch.float64)
    models = {torch.float64: P.models.resnet18(device=dev, **KW).double(),
              torch.float32: P.models.resnet18(device=dev, **KW)}
    ref.init_state()
    out = []
    for step in range(1, 4):
        seen = {}
        for dtype, model in models.items():
            model.load_state_dict({**ref.state.params, **ref.state.buffers})
            model.train()
            acts = []
            hooks = [m.register_forward_hook(
                lambda mod, inp, o: acts.append(inp[0].detach().cpu()))
                for m in model.modules() if isinstance(m, P.nn.ReLU)]
            pools = []
            hooks.append(model.maxpool.register_forward_hook(
                lambda mod, inp, o: pools.append(
                    torch.nn.functional.max_pool2d(
                        inp[0].detach().permute(0, 3, 1, 2), 3, 2, 1,
                        return_indices=True))))
            with torch.no_grad():
                model(torch.from_numpy(x).to(dev, dtype))
            for h in hooks:
                h.remove()
            seen[dtype] = (acts, [t.cpu() for t in pools[0]])
        (a64, (v64, i64)), (a32, (_, i32)) = seen[torch.float64], \
            seen[torch.float32]
        argmax = int(((i64 != i32) & (v64 > 0)).sum())
        signs = sum(int(((p > 0) != (q > 0)).sum())
                    for p, q in zip(a64, a32))
        out.append({"step": step, "maxpool_argmax": argmax,
                    "relu_signs": signs,
                    "relu_inputs": sum(p.numel() for p in a64)})
        print(f"  step {step} [{device_line(dev)}]: {argmax} of "
              f"{i64.numel()} stem max-pool windows change their argmax, "
              f"{signs} of {out[-1]['relu_inputs']} ReLU inputs their "
              f"sign, in fp32", flush=True)
        ref.train_steps(torch.from_numpy(x), y, steps=1)
    return out


def cudnn_benchmark(dev):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(128, 224, 224, 3).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (128,))).to(dev)
    out = {}
    prev = torch.backends.cudnn.benchmark
    try:
        for on in (False, True):
            torch.backends.cudnn.benchmark = on
            model = P.models.resnet50(num_classes=1000, data_format="NHWC",
                                      stem_s2d=True, seed=0, device=dev)
            tr = Trainer(model, Momentum(0.1, 0.9),
                         lambda o, t: F.cross_entropy(o, t),
                         amp_level="O2", amp_dtype="bfloat16")
            t0 = time.perf_counter()
            tr.train_steps(x, y, steps=3)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            tr.train_steps(x, y, steps=10)
            torch.cuda.synchronize()
            out[on] = {"warmup_s": warm,
                       "step_ms": (time.perf_counter() - t0) * 100}
            print(f"  ResNet-50 O2 bf16 128 x 224^2, cudnn.benchmark {on} "
                  f"[{device_line(dev)}]: warm-up {warm:.2f} s, "
                  f"{out[on]['step_ms']:.2f} ms a step", flush=True)
            del tr, model
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = prev
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = str(P.resolve_device(args.device))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("1. trajectory", flush=True)
    res = {"device": device_line(dev), "trajectory": trajectory(dev)}
    print("2. perturbation", flush=True)
    res["perturbation"] = perturbation()
    print("3. flips", flush=True)
    res["flips"] = flips(dev)
    if dev.startswith("cuda"):
        print("4. cudnn.benchmark", flush=True)
        res["cudnn_benchmark"] = cudnn_benchmark(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
