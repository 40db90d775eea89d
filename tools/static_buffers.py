#!/usr/bin/env python3
"""The solve cache's static buffers and the out-of-core budget, for one
checkout, on one CUDA card.

    python3 tools/static_buffers.py CHECKOUT [--skip-7b]

Imports ``CHECKOUT``'s package and ``chip_smoke.py`` and runs, at their
constants: ``chip_smoke.py`` phase 13a's data (7b's widths, 16 sample-count
buckets), its fully resident run and its run with a quarter of each random
effect's footprint as budget, and (unless ``--skip-7b``) phase 7b's fit.
Prints one JSON line: the static-buffer bytes the cache held, each budgeted
coordinate's store peak, held static bytes and effective budget (where the
checkout reports them), the card's peak memory a run, the pass walls, and
7b's pass walls. Run the parent and the change in one chip call (parent,
change, change, parent), each in a process of its own.
"""

import argparse
import json
import re
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkout")
    p.add_argument("--skip-7b", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, args.checkout)
    import torch

    if not torch.cuda.is_available():
        print("tools/static_buffers.py: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls
    from photon_tpu_torch.algorithm.re_store import block_device_cost

    full_precision_matmuls()
    kernels.build_all()
    dev = torch.device("cuda")
    lines = []
    cs.log = lambda msg: lines.append(msg)  # noqa: E731 (the phases' log lines, parsed below)
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)

    smi = "static_buffers"
    out = dict(checkout=args.checkout, card=torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    Xf, Xr, users, _ = make_data(cs.N, cs.D_FIX, cs.D_RE, cs.E, seed=13, device=dev)
    Xb = Xf.to(torch.bfloat16)
    del Xf
    train, valid = cs._glmix_batches(dev, smi, Xb, Xr, users, cs.E, seed=13)
    del Xb, Xr, users
    host_ds = cs._ooc_datasets(train)
    footprint = {c: sum(block_device_cost(b) for b in ds.blocks) for c, ds in host_ds.items()}
    budgets = {c: footprint[c] // cs.OOC_BUDGET_DIVISOR for c in host_ds}
    for label, b in (("resident", None), ("budgeted", budgets)):
        cache = SolveCache()
        torch.cuda.empty_cache()
        r = cs._ooc_run(f"13a {label}", dev, smi, train, valid, host_ds, b, cache)
        out[label] = dict(walls=r["walls"], peak_gib=r["peak"] / 2 ** 30, static_mib=cache.static_bytes() / 2 ** 20,
                          stores={c: {k: st.get(k) for k in ("budget_bytes", "effective_budget_bytes", "peak_bytes",
                                                             "static_bytes", "peak_total_bytes", "evictions",
                                                             "uploads")}
                                  for c, st in r["stats"].items() if st is not None})
        cache.release()
        del r
    out["footprint_mb"] = {c: v / 1e6 for c, v in footprint.items()}
    del train, valid, host_ds
    torch.cuda.empty_cache()
    if not args.skip_7b:
        Xf, Xr, users, _ = make_data(cs.N, cs.D_FIX, cs.D_RE, cs.E, seed=0, device=dev)
        Xb = Xf.to(torch.bfloat16)
        del Xf
        train, valid = cs._glmix_batches(dev, smi, Xb, Xr, users, cs.E, seed=7)
        est, reg = cs._game_estimator(cs.E, cs.G_ITEMS, cs.G_ITEM_CAP, cs.G_PASSES)
        torch.cuda.reset_peak_memory_stats()
        cs._fit_passes("7b", est, reg, train, valid, check, smi, read_bound=60)
        out["7b"] = dict(walls=[float(m.group(1)) for m in (re.search(r"7b pass \d+: ([0-9.]+) s wall", x)
                                                              for x in lines) if m],
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["seconds"] = time.perf_counter() - t0
    out["failed_checks"] = fails
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
