#!/usr/bin/env python3
"""Times the select_k (#1) and fused_knn (#2) kernels of one tree of the
PyTorch port on one CUDA card, at the shapes PERF.md holds them to, beside
the PyTorch library call that computes the same function.

    python3 kernel_ab.py [--tree DIR]

``--tree`` names the directory that holds the ``raft_tpu_torch`` package to
time (default: this script's checkout), so that a change and its parent are
timed by the same code on the same card, in turns (parent, change, change,
parent).  The kernels build from that tree's sources into
its own build directory.  Inputs: the main path's dataset (synthetic
sift-128-euclidean rows, seed 0) for fused_knn, seeded normal rows for
select_k.  Prints the card's name and power limit, then one JSON line per
shape: the kernel's and the library call's mean ms over CUDA events (for
select_k also their device time per call, and for fused_knn each of its
kernels' device time, from the profiler).
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import datasets, kernels
    from raft_tpu_torch.kernels import fused_knn as fk
    from raft_tpu_torch.kernels import select_k as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t = time.perf_counter()
    kernels.library()
    print(f"tree {tree}: kernels built+loaded in {time.perf_counter() - t:.1f} s", flush=True)
    dev = torch.device("cuda")

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps=50):
        """Device time per call of ``fn``, all its kernels (``torch.profiler``):
        CUDA events around launches this short time the host."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.events()
                   if e.device_type.name == "CUDA") / 1e3 / reps

    def by_kernel(fn):
        """Device ms of each kernel one call of ``fn`` launches (profiler)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                out[e.name[:60]] = out.get(e.name[:60], 0.0) + e.device_time_total / 1e3
        return out

    def emit(kernel, shape, ms, library, library_ms, **extra):
        print(json.dumps({"tree": str(tree), "kernel": kernel, "shape": shape, "ms": ms,
                          "library": library, "library_ms": library_ms, **extra}), flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    for rows, n, k, with_ids, note in ((10000, 258, 129, True, "refine (CAGRA build)"),
                                       (10000, 1099, 20, False, "IVF coarse selection"),
                                       (512, 64, 1, False, "CAGRA pick_parents"),
                                       (64, 128, 64, False, "filtered CAGRA buffer"),
                                       (64, 74, 10, False, "filtered CAGRA result"),
                                       (40, 4000, 2048, True, "deep k")):
        s = torch.randn(rows, n, generator=g, device=dev)
        ids = (torch.randint(0, 1 << 20, (rows, n), generator=g, device=dev, dtype=torch.int32)
               if with_ids else None)
        reps = 50 if rows * n < 1 << 20 else 20
        kern = lambda: sk.select_k_kernel(s, k, input_indices=ids)
        lib = lambda: torch.topk(s, k, dim=1, largest=False)
        emit("select_k", f"[{rows}, {n}] k={k}" + (" with ids" if with_ids else ""),
             cuda_ms(kern, reps), "torch.topk", cuda_ms(lib, reps), use=note,
             device_ms=device_ms(kern), library_device_ms=device_ms(lib))

    ds = datasets.synthetic("sift-128-euclidean", seed=0)
    x = torch.from_numpy(ds.base).to(dev)
    q = torch.from_numpy(ds.queries).to(dev)
    xx = (x * x).sum(dim=1)
    del ds
    for n_q, k, reps in ((256, 10, 5), (256, 129, 5), (1000, 2048, 3)):
        qs = q[:n_q]
        emit("fused_knn", f"q [{n_q}, 128] x [{x.shape[0]}, 128] k={k}",
             cuda_ms(lambda: fk.fused_l2_topk(qs, x, xx, k), reps),
             "torch.topk(torch.cdist)",
             cuda_ms(lambda: torch.topk(torch.cdist(qs, x), k, dim=1, largest=False), reps),
             by_kernel=by_kernel(lambda: fk.fused_l2_topk(qs, x, xx, k)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
