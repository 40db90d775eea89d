#!/usr/bin/env python3
"""Walls, host reads and idle shares of chip_smoke.py's phases 4 (GLMix
step), 6 (train_glm) and 7 (GAME core) for the checkout at CHECKOUT, on one
CUDA card, so that two commits can be compared in one run on one card (one
process each, run as parent, change, change, parent):

    python3 tools/solver_walls.py CHECKOUT

Imports ``chip_smoke`` and ``photon_tpu_torch`` from CHECKOUT and builds its
kernels; then runs phase 4's two GLMix passes at the headline width and its
profiled pass (made as the smoke makes them), and the checkout's own
``train_glm_phase`` (6a, 6b, 6c) and ``game_phase`` (7a, 7b, 7c). The
captured-against-eager solves of 7b (``captured_solves``) are left out.
Prints the phases' lines, then one JSON line with the checkout and the
checks that failed; exits 1 if one did.
"""

import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("solver_walls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from photon_tpu_torch.algorithm.solve_cache import default_cache
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls, glmix_train_step

    assert Path(cs.__file__).resolve().parent == root, cs.__file__
    full_precision_matmuls()
    kernels.build_all()
    cs.captured_solves = lambda *a, **k: None
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(f"# solver_walls {root} on {smi}")
    failures = []

    def check(ok, what):
        cs.log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            failures.append(what)

    # Phase 4b and 4c, as the smoke runs them.
    Xf, Xr, users, y = make_data(cs.N, cs.D_FIX, cs.D_RE, cs.E, seed=0, device=dev)
    (block,) = build_random_effect_dataset(
        users.cpu().numpy(), Xr.cpu().numpy(), y.cpu().numpy(), np.ones(cs.N, np.float32), cs.E,
        RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=1), device=dev).blocks
    Xb = Xf.to(torch.bfloat16)
    del Xf
    obj = dict(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    step = glmix_train_step(GLMObjective(use_fused=True, **obj), GLMObjective(**obj),
                            OptimizerConfig(max_iter=cs.FE_ITERS, track_history=False),
                            OptimizerConfig(max_iter=cs.RE_ITERS, tol=1e-6, track_history=False), re_kernel="auto")
    fe_batch = LabeledBatch(y, Xb)
    w_fixed = torch.full((cs.D_FIX,), 1e-4, device=dev)
    re_coefs = torch.full((cs.E, cs.D_RE), 1e-4, device=dev)
    cs.log("## phase 4: GLMix training step")
    for p in range(1, cs.CD_PASSES + 1):
        torch.cuda.synchronize()
        counts0 = default_cache().stats.counts()
        r0, t0 = HOST_READS.count, time.perf_counter()
        w_fixed, re_coefs, scores, fe_evals, re_visits = step(w_fixed, re_coefs, fe_batch, block, Xr, users)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        visits = cs.N * int(fe_evals) + int(re_visits)
        cs.log(f"  pass {p}: {dt:.4f} s wall, {HOST_READS.count - r0} host reads, fe X passes {int(fe_evals)}, "
               f"{visits / dt:.4e} samples/s; {cs.cache_text(default_cache().stats.since(counts0))}")
        check(bool(torch.isfinite(scores).all()), f"pass {p}: scores finite")
    cs.profiled("profiled pass", lambda: step(w_fixed, re_coefs, fe_batch, block, Xr, users))
    del fe_batch, block, step
    default_cache().release()
    torch.cuda.empty_cache()

    cs.train_glm_phase(dev, smi, check)
    torch.cuda.empty_cache()
    cs.game_phase(dev, smi, check, Xb, Xr, users, cs.E)
    print(json.dumps({"checkout": str(root), "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
