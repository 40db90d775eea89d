#!/usr/bin/env python3
"""Where two f32 solves of the same problem part, on one CUDA card.

    python3 tools/f32_ties.py [--repeats N] [--parts cut,tron]

Run from the root of a checkout (it imports ``chip_smoke`` for the data).
Two parts, each printing what it found:

- cut: ``chip_smoke.py`` phase 10a's cut copy (config 6 at n = d = 2^14),
  solved on the card with the scatter lowering (``index_add_``, float
  atomics) N times captured and N times eagerly, each against the CPU
  float64 path's margins (the check's 2e-3 bar): per solve the margins'
  relative error, iterations, stop reason and objective; for one solve
  over the bar and one under it, the first step where their traces part;
  and for the captured solves, how many pass 10a's check
  (``chip_smoke.cut_scatter_verdict``: margins against the float64 path run
  for the same iterations, the stop reason, the objective) and how many the
  check it replaced would have failed.
- tron: phase 14a's fixed-effect TRON solve (7b's batch, max_iter 5) on the
  batch cut into 8 row shards and on the whole batch, with the plain and
  the fused (K1/K2) objective, captured and stepped by hand: the solves'
  objectives, their coefficients' max |Δw| / max |w|, and the first step
  where a decision of the traces differs.
"""

import argparse
import sys
import time

import torch

sys.path.insert(0, ".")


def traced(prog, fields):
    """Step ``prog`` by hand, reading ``fields(state)`` after every step."""
    prog.init()
    trace = []
    for _ in range(prog.max_steps):
        if not bool(prog.running()):
            break
        prog.step()
        trace.append(fields(prog.s))
    prog.finish()
    return prog.result(), trace


def parting(a, b, n_decisions):
    for k, (x, y) in enumerate(zip(a, b)):
        if x[:n_decisions] != y[:n_decisions]:
            return k
    return None if len(a) == len(b) else min(len(a), len(b))


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-30))


def show(label, a, b, k):
    print(f"{label}: first parting step {k} of {len(a)} and {len(b)}")
    lo = max(0, (k or 0) - 2)
    for j in range(lo, min(len(a), len(b), (k or 0) + 3)):
        print(f"   step {j}: {a[j]} | {b[j]}")


def cut_part(cs, dev, repeats):
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec, fe_program, make_optimizer
    from photon_tpu_torch.optim.linesearch import _A_CUR, _EVALS, _PHASE

    obj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0)
    spec = OptimizerSpec(max_iter=cs.SP_ITERS, track_history=False)
    n = cs.SP_CUT
    ci, cv, cy = cs._sparse_wide_data(n=n, d=n)
    cut64 = LabeledBatch(torch.as_tensor(cy, dtype=torch.float64),
                         SparseFeatures(torch.as_tensor(ci), torch.as_tensor(cv, dtype=torch.float64), n))
    ref = make_optimizer(obj, spec)(torch.zeros(n, dtype=torch.float64), cut64)
    want = cut64.margins(ref.w)
    print(f"cut: float64 path {int(ref.iterations)} iterations, reason {int(ref.reason_code)}, "
          f"objective {float(ref.value)!r}")
    lb = LabeledBatch(torch.as_tensor(cy, device=dev),
                      SparseFeatures(torch.as_tensor(ci, device=dev), torch.as_tensor(cv, device=dev), n))

    def fields(S):
        ls = S["ls"]
        # (iteration, search phase, trials, reason, f, trial step)
        return (int(S["it"]), int(ls[_PHASE]), int(ls[_EVALS]), int(S["reason"]), float(S["f"]), float(ls[_A_CUR]))

    runs = {"captured": [], "eager": []}
    verdicts = []
    for _ in range(repeats):
        got = SolveCache().fe_solver(obj, spec)(torch.zeros(n, device=dev), lb)
        runs["captured"].append((rel(lb.margins(got.w).cpu(), want), int(got.iterations), int(got.reason_code),
                                 float(got.value), None))
        ok, text = cs.cut_scatter_verdict(obj, spec, cut64, ref, lb, got)
        verdicts.append(ok)
        print(f"cut: captured solve {len(verdicts)}: {'pass' if ok else 'FAIL'}: {text}")
        res, tr = traced(fe_program(obj, spec, torch.zeros(n, device=dev), lb), fields)
        runs["eager"].append((rel(lb.margins(res.w).cpu(), want), int(res.iterations), int(res.reason_code),
                              float(res.value), tr))
    for mode, rs in runs.items():
        over = sum(r[0] > 2e-3 for r in rs)
        print(f"cut: {mode} scatter, {over} of {len(rs)} solves over 2e-3 (margins rel, iterations, reason, "
              f"objective): {[r[:4] for r in rs]}")
    print(f"cut: 10a's check passed {sum(verdicts)} of {len(verdicts)} captured solves; the replaced check "
          f"would have failed {sum(r[0] > 2e-3 for r in runs['captured'])} of them")
    good = [r for r in runs["eager"] if r[0] <= 2e-3]
    bad = [r for r in runs["eager"] if r[0] > 2e-3]
    if good and bad:
        a, b = good[0][4], bad[0][4]
        show("cut: eager under | over the bar (iteration, search phase, trials, reason, f, trial step)", a, b,
             parting(a, b, 4))


def tron_part(cs, dev):
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec, fe_program
    from photon_tpu_torch.parallel.distributed import shard_batch
    from photon_tpu_torch.types import OptimizerType

    Xf, Xr, users, _y = make_data(cs.N, cs.D_FIX, cs.D_RE, cs.E, seed=0, device=dev)
    train, _valid = cs._glmix_batches(dev, "tools/f32_ties.py", Xf.to(torch.bfloat16), Xr, users, cs.E, seed=7)
    del Xf, Xr, users, _y, _valid
    whole = train.labeled_batch("global")
    batches = {"sharded": shard_batch(whole, None), "whole": whole}
    spec = OptimizerSpec(OptimizerType.TRON, max_iter=5, track_history=False)
    w0 = torch.zeros(cs.D_FIX, device=dev)

    def fields(S):
        # (iteration, phase, CG steps, reason, f, radius, trial f)
        return (int(S["it"]), int(S["phase"]), int(S["cg_it"]), int(S["reason"]), float(S["f"]),
                float(S["delta"]), float(S["f_t"]))

    for fused in (False, True):
        obj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0, use_fused=fused)
        out = {}
        for name, b in batches.items():
            got = SolveCache().fe_solver(obj, spec)(w0, b)
            res, tr = traced(fe_program(obj, spec, w0, b), fields)
            out[name] = (got, res, tr)
            print(f"tron ({'fused' if fused else 'plain'}) {name}: captured {int(got.iterations)} iterations, reason "
                  f"{int(got.reason_code)}, objective {float(got.value)!r}; stepped by hand {int(res.iterations)} "
                  f"iterations, objective {float(res.value)!r}; captured == stepped: {bool(torch.equal(got.w, res.w))}")
        s, w = out["sharded"], out["whole"]
        print(f"tron ({'fused' if fused else 'plain'}): sharded vs whole, max |Δw| / max |w| {rel(s[0].w, w[0].w):.3e}")
        show(f"tron ({'fused' if fused else 'plain'}): sharded | whole (iteration, phase, CG steps, reason, f, radius, "
             f"trial f)", s[2], w[2], parting(s[2], w[2], 4))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=14, help="cut copy solves of each mode")
    p.add_argument("--parts", default="cut,tron", help="which parts to run, comma-separated")
    args = p.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        print("tools/f32_ties.py: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls

    full_precision_matmuls()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if "cut" in parts:
        cut_part(cs, dev, args.repeats)
    if "tron" in parts:
        tron_part(cs, dev)
    print(f"wall {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
