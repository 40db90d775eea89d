#!/usr/bin/env python3
"""Per-call device times of the sparse products at config 6's shape
(bench_configs.py:461-570: n = d = 2^20, 64 nnz a row, column 0 the
intercept), on one CUDA card:

    python3 tools/sparse_lowerings.py

Times, with CUDA events over 20 calls after 3 warm-ups: the gather matvec,
the ``index_add_`` scatter rmatvec and the sorted ``segment_reduce``
rmatvec of the transpose plan, in f32 and with bf16 values; checks that
each can be captured into a CUDA graph and that the segment sum, unlike the
scatter, repeats bit for bit. The ops are written out here as
``photon_tpu_torch/data/batch.py::SparseFeatures`` runs them. Prints the
card's name and power limit first."""

import subprocess
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("sparse_lowerings: needs a CUDA device", file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    n, d, k = 1 << 20, 1 << 20, 64
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, d, (n, k), device=dev, generator=g, dtype=torch.int32)
    idx[:, 0] = 0
    vals = torch.randn(n, k, device=dev, generator=g)
    vals[:, 0] = 1.0
    r = torch.randn(n, device=dev, generator=g)
    w = torch.randn(d, device=dev, generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segs, order = torch.sort(idx.reshape(-1), stable=True)
    order, segs = order.to(torch.int32), segs.to(torch.int32)
    offs = torch.searchsorted(segs, torch.arange(d + 1, device=dev, dtype=torch.int32))
    torch.cuda.synchronize()
    print(f"plan (stable sort of {n * k} indices): {time.perf_counter() - t0:.4f} s", flush=True)

    def ms(fn, it=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(it):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / it

    for tag, v in (("f32", vals), ("bf16", vals.to(torch.bfloat16))):
        ops = {"matvec": lambda v=v: torch.sum(v * w[idx], dim=-1),
               "scatter": lambda v=v: torch.zeros(d, device=dev).index_add_(0, idx.reshape(-1),
                                                                            (v * r[:, None]).reshape(-1)),
               "segsum": lambda v=v: torch.segment_reduce((v * r[:, None]).reshape(-1)[order], "sum", offsets=offs,
                                                          unsafe=True)}
        for name, fn in ops.items():
            repeat = torch.equal(fn(), fn())
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
            graph.replay()
            torch.cuda.synchronize()
            print(f"{name} {tag}: {ms(fn):.4f} ms a call; bitwise the same twice: {repeat}; captured, max |captured "
                  f"- eager| {float((out.double() - fn().double()).abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
