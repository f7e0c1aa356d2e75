"""Where the time of a data-parallel ResNet-50 step goes on the card.

Runs bench.py's ResNet-50 configuration (128 x 224^2, NHWC, stem_s2d,
O2 bf16, Momentum(0.1, 0.9)) through `Trainer(mesh=)` over 1, 2 and 4
data ranks (synced batch norm) and through a plain `Trainer`, and
splits each mesh step into the ranks' forwards (the SPMD run), the
joint backward, the gradients' collectives and the update, each timed
on the host with the device synchronised at its edges; prints the
device-busy share of one step from torch.profiler.

    python3 scripts/dp_probe.py [--steps 4] [--out dp.json]
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch
    import paddle_tpu_torch as P
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer, trainer as trmod
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.optimizer import Momentum
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card {card}", flush=True)
    torch.backends.cudnn.benchmark = False
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(128, 224, 224, 3).astype(np.float32)
                         ).to("cuda", torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (128,))).cuda()
    parts = {}

    def timed(name, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrap

    out = {"card": card}
    for k in [None] + args.ranks:
        mesh = parallel.init_mesh(dp=k, device="cuda") if k else None
        model = P.models.resnet50(num_classes=1000, data_format="NHWC",
                                  stem_s2d=True, seed=0, device="cuda")
        tr = Trainer(model, Momentum(0.1, 0.9),
                     lambda o, t: F.cross_entropy(o, t), mesh=mesh,
                     amp_level="O2", amp_dtype="bfloat16")
        tr.train_steps(x, y, steps=2)
        saved = (ranks.spmd, trmod.Trainer._mesh_reduce,
                 trmod.Trainer._mesh_update, torch.autograd.grad)
        ranks.spmd = timed("rank runs (forwards; uncoupled: +backwards)",
                           ranks.spmd)
        trmod.Trainer._mesh_reduce = timed("gradient collectives",
                                           trmod.Trainer._mesh_reduce)
        trmod.Trainer._mesh_update = timed("update",
                                           trmod.Trainer._mesh_update)
        parts.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_steps(x, y, steps=args.steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) / args.steps * 1e3
        (ranks.spmd, trmod.Trainer._mesh_reduce, trmod.Trainer._mesh_update,
         torch.autograd.grad) = saved
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.train_steps(x, y, steps=1)
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        rec = {"step_ms": step_ms, "kernels_per_step": len(kern),
               "kernel_ms_sum": busy,
               "parts_ms": {n: v / args.steps * 1e3
                            for n, v in parts.items()}}
        name = f"dp {k}" if k else "plain Trainer"
        print(f"{name} [{card}]: {json.dumps(rec)}", flush=True)
        out[name] = rec
        del tr, model
        parallel.set_mesh(None)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
