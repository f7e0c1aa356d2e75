#!/usr/bin/env python3
"""Where a fresh process's first GPT-small training step spends its
time on the card: the process start, CUDA's init, the model build, and
the first and second forward / backward (fp32, TF32 off, the tf32x3
route of K2/K3), each ended by a synchronise, with the first step's
host-side op totals from torch.profiler; then the first and second
`Trainer` step over a dp 2 mesh of logical ranks (Momentum), the first
under cProfile (its top functions by cumulative time).

    python3 scripts/first_step_probe.py [--trainer-first] \
        [--out first_step.json]

`--trainer-first` skips the bare forward / backward, so the first
Trainer step is the process's first use of the model.

Prints the card's name and power limit beside the numbers.
"""
import argparse
import json
import subprocess
import sys
import time

T_START = time.time()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--trainer-first", action="store_true")
    args = ap.parse_args()
    import torch
    t_import = time.time()
    torch.cuda.init()
    t_cuda = time.time()
    sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
    import numpy as np
    import paddle_tpu_torch as P
    t_port = time.time()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = P.models.gpt_small(seed=0, device="cuda")
    torch.cuda.synchronize()
    t_model = time.time()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (4, 256))).cuda()
    out = {"card": card, "import_torch_s": t_import - T_START,
           "cuda_init_s": t_cuda - t_import, "import_port_s": t_port - t_cuda,
           "model_s": t_model - t_port, "steps": []}
    from torch.profiler import ProfilerActivity, profile
    for i in range(0 if args.trainer_first else 3):
        prof = profile(activities=[ProfilerActivity.CPU]) if i == 0 else None
        if prof:
            prof.__enter__()
        t0 = time.time()
        loss = model.loss(model(ids), ids)
        torch.cuda.synchronize()
        t1 = time.time()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.time()
        if prof:
            prof.__exit__(None, None, None)
            out["first_step_ops"] = [
                (e.key, round(e.cpu_time_total / 1e3, 1))
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:12]]
        out["steps"].append({"forward_s": t1 - t0, "backward_s": t2 - t1})
        model.zero_grad(set_to_none=True)
    import cProfile
    import io
    import pstats
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import Momentum
    tr = Trainer(model, Momentum(1e-2, 0.9), lambda lg, y: model.loss(lg, y),
                 mesh=parallel.init_mesh(dp=2, world_size=2, device="cuda"))
    ids8 = torch.cat([ids, ids])
    prof = cProfile.Profile()
    out["trainer_steps_s"] = []
    for i in range(2):
        t0 = time.time()
        if i == 0:
            prof.enable()
        float(tr.train_step(ids8, ids8)[0])
        if i == 0:
            prof.disable()
        out["trainer_steps_s"].append(time.time() - t0)
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(30)
    out["first_trainer_step_profile"] = buf.getvalue().splitlines()[:60]
    print(card)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
