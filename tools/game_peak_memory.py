#!/usr/bin/env python3
"""Peak device memory of chip_smoke.py's phase 7 (the GAME core at full
width) or phase 8 (the GAME drivers on files) for the checkout at CHECKOUT,
on one CUDA card.

    python3 tools/game_peak_memory.py CHECKOUT [7|8]

Imports ``chip_smoke`` and ``photon_tpu_torch`` from CHECKOUT (so two
commits can be compared in one run on one card, one process each) and runs
the smoke's ``game_phase`` (7a, 7b, 7c; on phase 4's data, made as the smoke
makes it) or ``game_drivers_phase`` between
``torch.cuda.reset_peak_memory_stats()`` and
``torch.cuda.max_memory_allocated()``; the phase's own resets of the peak
are disabled. The captured-against-eager solves (``captured_solves``), where
the checkout has them, are left out: they build caches of their own that the
fit does not. Prints one JSON line, with the device memory still allocated
when the phase has returned.
"""

import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    phase = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("game_peak_memory: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls

    assert Path(cs.__file__).resolve().parent == root, cs.__file__
    full_precision_matmuls()
    kernels.build_all()
    if hasattr(cs, "captured_solves"):
        cs.captured_solves = lambda *a, **k: None
    dev = torch.device("cuda")
    if phase == 7:
        Xf, Xr, users, _y = make_data(cs.N, cs.D_FIX, cs.D_RE, cs.E, seed=0, device=dev)
        Xb = Xf.to(torch.bfloat16)
        del Xf
        torch.cuda.empty_cache()
    reset_peak = torch.cuda.reset_peak_memory_stats
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None  # the phases reset it per pass
    failures = []

    def check(ok, what):
        cs.log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            failures.append(what)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    reset_peak()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if phase == 7:
        cs.game_phase(dev, smi, check, Xb, Xr, users, cs.E)
    else:
        out = cs.game_drivers_phase(dev, smi, check)
        if isinstance(out, tuple):  # a checkout whose phase 8 leaves its files for phase 11b
            import shutil

            shutil.rmtree(out[1]["work"], ignore_errors=True)
    torch.cuda.synchronize()
    print(json.dumps({"checkout": str(root), "card": smi, "phase": phase,
                      "peak_bytes": torch.cuda.max_memory_allocated(), "allocated_before_bytes": base,
                      "allocated_after_bytes": torch.cuda.memory_allocated(), "seconds": time.perf_counter() - t0,
                      "failed_checks": failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
