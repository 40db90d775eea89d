#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (photon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build    — compile the three CUDA kernels from photon_tpu_torch/csrc/
                (one nvcc per source, in parallel) and print ptxas's
                register / shared-memory lines;
  2. parity   — hold each kernel against its plain PyTorch version on the
                card at the main path's shapes and at small ragged shapes,
                K1 and K2 on both of their routes ("row" and "tile"), K3 on
                both of its routes ("bulk" and "direct") up to d = 64, and
                check that two launches of K1 and of K2 at the headline are
                bitwise equal;
  3. timing   — kernel, plain version and a library yardstick, with CUDA
                events, beside the kernel's bound (bytes or operations over
                the H100's published peaks); the launch plans of K1 and K2
                (route, tile, slots, ring stages, resident CTAs per SM, grid)
                and of K3 (route, blocks, team warps, row groups, entities
                per CTA, chunk rows, stages, grid);
  4. GLMix    — a small-input check of the GLMix step on the card against
                the port's plain path in float64 on the CPU, then two
                coordinate-descent passes of ``glmix_train_step`` at the
                headline width (N = 2^21, d_fix = 256 in bf16, d_re = 16,
                E = 4096, logistic), which must lower the training logloss
                and launch kernels 1 and 3;
  5. TRON     — a fixed-effect TRON solve on the same batch, which must lower
                the objective and launch kernels 1 and 2;
  6. train_glm — the legacy GLM driver: ``train_glm.main`` on a LIBSVM file
                (2^14 rows) and an Avro file (2^12 rows) of 255 features with
                validation files and λ = 10, 1, 0.1, whose model files must
                be written and load back, with validation AUC > 0.7 and K1
                launched; the driver's λ loop at N = 2^21, d = 256 (f32) with
                L-BFGS (K1) and TRON (K1 and K2), per λ iterations, X passes,
                wall time, host syncs, samples/s and AUC; and the λ loop on
                the card against the port's float64 plain path on the CPU.
It prints the card's name and power limit, a JSON line of per-kernel numbers,
and last {"ok": true, "device": {...}}. It exits non-zero, printing no
result, when there is no CUDA device or any phase fails. Float32 matrix
products run in full f32 (TF32 off).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Headline shape (bench.py:65-71).
N, D_FIX, D_RE, E = 1 << 21, 256, 16, 4096
FE_ITERS, RE_ITERS, CD_PASSES = 30, 8, 2
# Phase 6 (train_glm): file sizes of 6a, the validation rows of 6b (whose
# training batch is N rows); every file and batch has 255 features, which
# the driver's intercept takes to d = 256.
A_LIBSVM_ROWS, A_AVRO_ROWS, A_VALID_ROWS, A_FEATURES = 1 << 14, 1 << 12, 1 << 12, 255
B_VALID_ROWS, B_FEATURES = 1 << 18, 255
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version: both sum in f32, in different orders, over up to
# 2^21 terms; max |kernel - plain| / max(1, max |plain|) must stay below.
PARITY_TOL = 1e-5
# GLMix on the card (f32, kernels) vs the port's plain path in float64 on
# the CPU, small input: scores, relative to max |score|.
REFERENCE_TOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor):
    a, b = a.double(), b.double()
    err = float((a - b).abs().max())
    return err, err / max(1.0, float(b.abs().max()))


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profiled(label: str, fn, indent: str = "  ") -> None:
    """Run fn once under torch.profiler and print its wall time, the device's
    busy and idle share, the top device time by kernel and the port's own
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only: an aten:: op row repeats its kernels' time.
    rows_dev = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows_dev)
    if busy_us <= 0:
        log(f"{indent}{label}: the profiler recorded no device time (device busy share not measured)")
        return
    log(f"{indent}{label}: {wall * 1e3:.2f} ms wall (profiler on), device busy {busy_us / 1e3:.2f} ms "
        f"= {busy_us / 1e6 / wall:.1%}, idle {1 - busy_us / 1e6 / wall:.1%}; top device time:")
    for us, key, count in sorted(rows_dev, reverse=True)[:8]:
        log(f"{indent}  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    log(f"{indent}the port's kernels in that run:")
    for us, key, count in sorted(rows_dev, reverse=True):
        if key.startswith("void pt::") and "reduce_parts" not in key:
            log(f"{indent}  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def _planted_logistic(n: int, d: int, seed: int):
    """(X (n, d) with no intercept column, labels 0/1) of a planted logistic
    model, from numpy; the driver adds the intercept."""
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(1234).normal(size=d) * 2.0 / np.sqrt(d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float32)
    return X, y


def _write_libsvm(path, X, y) -> None:
    with open(path, "w") as f:
        for row, label in zip(X, y):
            f.write(("+1 " if label > 0 else "-1 ") + " ".join(f"{j + 1}:{v:.4f}" for j, v in enumerate(row)) + "\n")


def _write_avro(path, X, y) -> None:
    from photon_tpu_torch.io.avro import write_avro_records
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    write_avro_records(str(path), TRAINING_EXAMPLE_SCHEMA, [
        {"uid": str(i), "label": float(label), "metadataMap": None, "weight": None, "offset": None,
         "features": [{"name": str(j + 1), "term": "", "value": float(v)} for j, v in enumerate(row)]}
        for i, (row, label) in enumerate(zip(X, y))])


def _text_coefficients(path, imap, device) -> torch.Tensor:
    w = torch.zeros(len(imap), dtype=torch.float64)
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                key, value = line.rstrip("\n").split("\t")
                w[imap.get_index(key)] = float(value)
    return w.to(device)


def train_glm_phase(dev, smi: str, check) -> dict:
    """Phase 6: the legacy GLM driver. (a) ``train_glm.main`` on a LIBSVM and
    an Avro file on the card; (b) the driver's λ loop at full width with
    L-BFGS and TRON; (c) the λ loop on the card against the CPU float64 plain
    path on a small file. Returns the kernel launches of (a) and (b)."""
    from photon_tpu_torch.cli import train_glm
    from photon_tpu_torch.evaluation.metrics_map import AREA_UNDER_ROC, metrics_map
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    launches = {k: 0 for k in kernels.LAUNCHES}

    def count(used: dict) -> None:
        for k, v in used.items():
            launches[k] += v

    log("## phase 6: train_glm")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_train_glm"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lambdas = "10,1,0.1"

    # 6a. End to end on files, through the entry point a user calls.
    t0 = time.perf_counter()
    files = {}
    for fmt, n_train, n_valid, write, ext in (("libsvm", A_LIBSVM_ROWS, A_VALID_ROWS, _write_libsvm, "txt"),
                                             ("avro", A_AVRO_ROWS, A_VALID_ROWS // 4, _write_avro, "avro")):
        paths = []
        for part, n, seed in (("train", n_train, 11), ("valid", n_valid, 12)):
            paths.append(str(work / f"{fmt}-{part}.{ext}"))
            write(paths[-1], *_planted_logistic(n, A_FEATURES, seed))
        files[fmt] = paths
    log(f"  wrote the LIBSVM ({A_LIBSVM_ROWS} rows) and Avro ({A_AVRO_ROWS} rows) files, {A_FEATURES} features, "
        f"in {time.perf_counter() - t0:.1f} s")
    for fmt, (train_path, valid_path) in files.items():
        out = work / f"out-{fmt}"
        argv = ["--training-data", train_path, "--validation-data", valid_path, "--format", fmt,
                "--output-dir", str(out), "--regularization-weights", lambdas, "--device", "cuda"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = train_glm.main(argv)
        wall = time.perf_counter() - t0
        used = dict(kernels.LAUNCHES)
        count(used)
        written = [out / f"model-lambda-{lam:g}.txt" for lam in (10.0, 1.0, 0.1)] + [
            out / "LATEST", out / "training-summary.json", out / "best" / "model-metadata.json"]
        check(all(p.exists() for p in written), f"6a {fmt}: model files, LATEST and training-summary.json written")
        best = next(m for m in summary["models"] if m["lambda"] == summary["best_lambda"])
        auc = best["validation"][AREA_UNDER_ROC]
        log(f"  6a {fmt}: {wall:.2f} s, best λ {summary['best_lambda']:g}, validation AUC {auc:.4f}; per λ "
            + ", ".join(f"{m['lambda']:g}: {m['iterations']} it {m['reason']}" for m in summary["models"])
            + f"; launches {used}")
        check(auc > 0.7, f"6a {fmt}: validation AUC {auc:.4f} > 0.7")
        check(used["fused_value_grad"] > 0, f"6a {fmt}: the driver launched K1")
        args = train_glm.build_parser().parse_args(argv)
        valid, imap = train_glm.load_data(args, valid_path, dev)
        model = load_game_model(str(out / "best"), {"features": imap}, device=dev)
        n = valid.label.shape[0]
        scores = model.score(GameBatch(valid.label, valid.offset, valid.weight, {"features": valid.features}, {}))
        w_text = _text_coefficients(out / f"model-lambda-{summary['best_lambda']:g}.txt", imap, dev)
        _, r = rel_err(scores, valid.features.double() @ w_text)
        check(len(imap) == A_FEATURES + 1 and scores.shape == (n,) and r <= 1e-5,
              f"6a {fmt}: best/ loads back and scores the text model's margins (rel {r:.3e}, tolerance 1e-5)")

    # 6b. Full width through the driver's λ loop: N = 2^21, d = 256, f32.
    log(f"  6b: N=2^21 d={B_FEATURES + 1} f32 (intercept last), validation {B_VALID_ROWS} rows, λ = {lambdas}, "
        f"SIMPLE variances; card {smi}")
    g = torch.Generator(device=dev).manual_seed(6)
    w_true = torch.randn(B_FEATURES, device=dev, generator=g) * 2.0 / B_FEATURES ** 0.5

    def planted(n):
        X = torch.ones(n, B_FEATURES + 1, device=dev)
        X[:, :B_FEATURES] = torch.randn(n, B_FEATURES, device=dev, generator=g)
        y = (torch.rand(n, device=dev, generator=g) < torch.sigmoid(X[:, :B_FEATURES] @ w_true)).float()
        return X, y

    from photon_tpu_torch.data.batch import LabeledBatch

    Xt, yt = planted(N)
    Xv, yv = planted(B_VALID_ROWS)
    train, valid = LabeledBatch(yt, Xt), LabeledBatch(yv, Xv)
    weights = [float(x) for x in lambdas.split(",")]
    for opt, needs in ((OptimizerType.LBFGS, ("fused_value_grad",)),
                       (OptimizerType.TRON, ("fused_value_grad", "fused_hvp"))):
        kernels.reset_launches()
        sweep = train_glm.train_lambda_sweep(train, weights, TaskType.LOGISTIC_REGRESSION, OptimizerSpec(opt),
                                             intercept_index=B_FEATURES,
                                             variance=VarianceComputationType.SIMPLE)
        used = dict(kernels.LAUNCHES)
        count(used)
        for r in sweep:
            passes = int(r.result.x_passes)
            auc = metrics_map(TaskType.LOGISTIC_REGRESSION, valid.margins(r.w_model), yv)[AREA_UNDER_ROC]
            value = float(r.result.value)
            log(f"    {opt.name} λ={r.lam:g}: {int(r.result.iterations)} iterations, "
                f"{r.result.convergence_reason.value}, {passes} X passes, {r.wall_s:.4f} s wall, "
                f"{r.host_syncs} host syncs, {N * passes / r.wall_s:.4e} samples/s, objective {value:.6e}, "
                f"validation AUC {auc:.4f}")
            check(np.isfinite(value) and bool(torch.isfinite(r.variances).all()),
                  f"6b {opt.name} λ={r.lam:g}: objective and variances finite")
            check(auc > 0.6, f"6b {opt.name} λ={r.lam:g}: validation AUC {auc:.4f} > 0.6")
        log(f"    {opt.name} sweep launches {used}")
        check(all(used[k] > 0 for k in needs), f"6b {opt.name}: launched {', '.join(needs)}")
        # The first λ once more, under the profiler (its launches are not counted).
        profiled(f"{opt.name} λ={weights[0]:g} from zero, profiled", lambda: train_glm.train_lambda_sweep(
            train, weights[:1], TaskType.LOGISTIC_REGRESSION, OptimizerSpec(opt), intercept_index=B_FEATURES),
            indent="    ")
    del Xt, Xv, train, valid
    torch.cuda.empty_cache()

    # 6c. The λ loop on the card (f32, kernels) against the CPU plain path in
    # float64, on the 6a LIBSVM training file.
    args = train_glm.build_parser().parse_args(
        ["--training-data", files["libsvm"][0], "--format", "libsvm", "--output-dir", str(work)])
    small, imap = train_glm.load_data(args, files["libsvm"][0], "cpu")
    icpt = imap.get_index(imap.INTERCEPT)
    spec = OptimizerSpec(OptimizerType.LBFGS)
    card = train_glm.train_lambda_sweep(LabeledBatch(small.label.to(dev), small.features.to(dev)), weights,
                                        TaskType.LOGISTIC_REGRESSION, spec, intercept_index=icpt)
    plain = train_glm.train_lambda_sweep(LabeledBatch(small.label.double(), small.features.double()), weights,
                                         TaskType.LOGISTIC_REGRESSION, spec, intercept_index=icpt)
    for rc, rp in zip(card, plain):
        _, r = rel_err(rc.w_model.cpu(), rp.w_model)
        check(r <= REFERENCE_TOL, f"6c λ={rc.lam:g}: coefficients on the card (f32) vs float64 plain path on the CPU: "
                                  f"rel {r:.3e} (tolerance {REFERENCE_TOL:g})")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a GPU", file=sys.stderr)
        return 1

    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.ops.fused_glm import (
        fused_hvp, fused_hvp_plain, fused_value_grad, fused_value_grad_plain, hvp_plan,
        value_grad_plan, value_grad_route)
    from photon_tpu_torch.ops.fused_newton import newton_system, newton_system_plain, system_plan
    from photon_tpu_torch.ops.losses import (
        LogisticLoss, PoissonLoss, SmoothedHingeLoss, SquaredLoss)
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
    from photon_tpu_torch.optim.tron import minimize_tron
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls, glmix_train_step

    full_precision_matmuls()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"# device: {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    failures = []

    def check(ok: bool, what: str) -> None:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            failures.append(what)

    # ---------------- 1. build ----------------
    log("## phase 1: build")
    t0 = time.perf_counter()
    report = kernels.build_all()
    log(f"  built {len(report)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.2f} s{' (cached)' if r['cached'] else ''}")
        for line in r["ptxas"]:
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    # ---------------- data at the headline shape ----------------
    log("## data: make_data + random-effect blocks")
    t0 = time.perf_counter()
    Xf, Xr, users, y = make_data(N, D_FIX, D_RE, E, seed=0, device=dev)
    ds = build_random_effect_dataset(
        users.cpu().numpy(), Xr.cpu().numpy(), y.cpu().numpy(), np.ones(N, np.float32), E,
        RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=1), device=dev,
    )
    (block,) = ds.blocks
    Xb = Xf.to(torch.bfloat16)
    log(f"  {time.perf_counter() - t0:.1f} s; X {tuple(Xf.shape)}, block {tuple(block.features.shape)}")

    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(D_FIX, device=dev, generator=g) / D_FIX ** 0.5
    off = torch.randn(N, device=dev, generator=g) * 0.1
    wt = torch.ones(N, device=dev)
    d2 = torch.rand(N, device=dev, generator=g) * 0.25

    # ---------------- 2. parity ----------------
    log(f"## phase 2: kernel parity (tolerance {PARITY_TOL:g} of max(1, max |plain|))")
    headline_err = {}

    def parity(label, got, ref, key=None):
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
        check(worst_rel <= PARITY_TOL, f"{label}: max abs {worst_abs:.3e}, rel {worst_rel:.3e}")
        if key is not None:
            headline_err[key] = worst_abs

    for Xk, tag in ((Xb, "bf16"), (Xf, "f32")):
        for margins in (True, False):
            got = fused_value_grad(LogisticLoss, w, Xk, y, off, wt, return_margins=margins)
            ref = fused_value_grad_plain(LogisticLoss, w, Xk, y, off, wt, return_margins=margins)
            parity(f"K1 fused_value_grad logistic N=2^21 d=256 {tag} margins={margins}", got, ref,
                   "fused_value_grad" if (tag == "bf16" and margins) else None)
        parity(f"K2 fused_hvp N=2^21 d=256 {tag}", [fused_hvp(w, Xk, d2)], [fused_hvp_plain(w, Xk, d2)],
               "fused_hvp" if tag == "bf16" else None)
    n_s, d_s = 1000, 40
    Xs = torch.randn(n_s, d_s, device=dev, generator=g)
    ws = torch.randn(d_s, device=dev, generator=g) / d_s ** 0.5
    ys = (torch.rand(n_s, device=dev, generator=g) < 0.5).float()
    offs, wts = off[:n_s].clone(), torch.rand(n_s, device=dev, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        Xsd = Xs.to(dt)
        for loss in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss):
            parity(f"K1 {loss.name} n={n_s} d={d_s} {dt}",
                   fused_value_grad(loss, ws, Xsd, ys, offs, wts, return_margins=True),
                   fused_value_grad_plain(loss, ws, Xsd, ys, offs, wts, return_margins=True))
        parity(f"K2 n={n_s} d={d_s} {dt}", [fused_hvp(ws, Xsd, wts)], [fused_hvp_plain(ws, Xsd, wts)])
    # K1 off the row route: rows that are not whole 16-byte chunks (d = 37)
    # and d above ROW_MAX_DIM (d = 2048) take the tile route.
    n_t = 4099
    wt_t = torch.rand(n_t, device=dev, generator=g)
    for d_t in (37, 2048):
        Xt = torch.randn(n_t, d_t, device=dev, generator=g)
        wv = torch.randn(d_t, device=dev, generator=g) / d_t ** 0.5
        for dt in (torch.float32, torch.bfloat16):
            Xtd = Xt.to(dt)
            route = value_grad_route(d_t, Xtd.element_size(), Xtd.data_ptr())
            args = (LogisticLoss, wv, Xtd, y[:n_t], off[:n_t], wt_t)
            parity(f"K1 logistic n={n_t} d={d_t} {dt} ({route} route)",
                   fused_value_grad(*args, return_margins=True),
                   fused_value_grad_plain(*args, return_margins=True))
            parity(f"K2 n={n_t} d={d_t} {dt} ({hvp_plan(Xtd)['route']} route)",
                   [fused_hvp(wv, Xtd, wt_t)], [fused_hvp_plain(wv, Xtd, wt_t)])
    del Xt, Xtd
    first = fused_value_grad(LogisticLoss, w, Xb, y, off, wt, return_margins=True)
    again = fused_value_grad(LogisticLoss, w, Xb, y, off, wt, return_margins=True)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "K1 N=2^21 d=256 bf16 margins: two launches give bitwise equal value, gradient and margins")
    check(torch.equal(fused_hvp(w, Xb, d2), fused_hvp(w, Xb, d2)),
          "K2 N=2^21 d=256 bf16: two launches give bitwise equal products")
    del first, again
    Eb, nb, db = block.features.shape
    rd2 = torch.rand(Eb, nb, device=dev, generator=g) * 0.25 * block.weight
    rdz = torch.randn(Eb, nb, device=dev, generator=g) * block.weight
    Xre_b = block.features.to(torch.bfloat16)
    parity(f"K3 newton_system E={Eb} n_max={nb} d={db} f32", newton_system(block.features, rd2, rdz),
           newton_system_plain(block.features, rd2, rdz), "newton_system")
    parity(f"K3 newton_system E={Eb} n_max={nb} d={db} bf16", newton_system(Xre_b, rd2, rdz),
           newton_system_plain(Xre_b, rd2, rdz))
    # K3 off the headline: n_max = 101 takes the direct route, n_max = 100
    # the bulk route with a ragged last chunk; d = 64 is the widest.
    for En, nn, dn in ((37, 101, 13), (37, 100, 64), (37, 101, 64)):
        Xn = torch.randn(En, nn, dn, device=dev, generator=g)
        n2, nz = torch.rand(En, nn, device=dev, generator=g), torch.randn(En, nn, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            Xnd = Xn.to(dt)
            Hn, gn = newton_system(Xnd, n2, nz)
            parity(f"K3 newton_system E={En} n_max={nn} d={dn} {dt} ({system_plan(Xnd, n2, nz)['route']} route)",
                   (Hn, gn), newton_system_plain(Xnd, n2, nz))
            check(torch.equal(Hn, Hn.transpose(1, 2)), f"K3 E={En} n_max={nn} d={dn} {dt}: H exactly symmetric")
    for Xk in (block.features, Xre_b):
        H, _ = newton_system(Xk, rd2, rdz)
        check(torch.equal(H, H.transpose(1, 2)), f"K3 E={Eb} n_max={nb} d={db} {Xk.dtype}: H exactly symmetric")
    del Xn, Xnd, Hn, gn, H
    torch.cuda.synchronize()

    # ---------------- 3. timing ----------------
    log(f"## phase 3: kernel timing (CUDA events; bound vs H100 SXM peaks: "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, bf16 {PEAK_OPS[torch.bfloat16] / 1e12:.0f} / "
        f"f32 {PEAK_OPS[torch.float32] / 1e12:.0f} TFLOP/s; card: {smi})")
    timings = {}

    def timed(name, label, dtype, nbytes, ops, kernel_fn, plain_fn, library_fn):
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, iters=3)
        lib_ms = cuda_ms(library_fn)
        b_ms, b_by = bound_ms(nbytes, ops, dtype)
        log(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) "
            f"-> {b_ms / ms:.1%} of bound, {nbytes / ms / 1e6:.1f} GB/s")
        if name is not None:
            timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    dz = torch.randn(N, device=dev, generator=g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for Xk, tag in ((Xb, "bf16"), (Xf, "f32")):
        log(f"  K1 N=2^21 d=256 {tag} launch plan on {sms} SMs: {value_grad_plan(Xk, LogisticLoss)}")
        log(f"  K2 N=2^21 d=256 {tag} launch plan on {sms} SMs: {hvp_plan(Xk)}")
        es = Xk.element_size()
        vb = w.to(Xk.dtype)
        dzk = dz.to(Xk.dtype)
        timed(f"fused_value_grad_{tag}", f"K1 N=2^21 d=256 {tag} margins", Xk.dtype,
              N * D_FIX * es + 3 * N * 4 + D_FIX * 4 + N * 4 + (D_FIX + 1) * 4, 4.0 * N * D_FIX,
              lambda: fused_value_grad(LogisticLoss, w, Xk, y, off, wt, return_margins=True),
              lambda: fused_value_grad_plain(LogisticLoss, w, Xk, y, off, wt, return_margins=True),
              lambda: (torch.mv(Xk, vb), torch.mv(Xk.t(), dzk)))
        timed(f"fused_hvp_{tag}", f"K2 N=2^21 d=256 {tag}", Xk.dtype,
              N * D_FIX * es + N * 4 + 2 * D_FIX * 4, 4.0 * N * D_FIX,
              lambda: fused_hvp(w, Xk, d2), lambda: fused_hvp_plain(w, Xk, d2),
              lambda: (torch.mv(Xk, vb), torch.mv(Xk.t(), dzk)))
    for Xk, tag in ((block.features, "f32"), (Xre_b, "bf16")):
        log(f"  K3 E={Eb} n_max={nb} d={db} {tag} launch plan on {sms} SMs: {system_plan(Xk, rd2, rdz)}")
        rd2k = rd2.to(Xk.dtype)[..., None]
        rdzk = rdz.to(Xk.dtype)[..., None]
        timed(f"newton_system_{tag}", f"K3 E={Eb} n_max={nb} d={db} {tag}", Xk.dtype,
              Eb * nb * db * Xk.element_size() + 2 * Eb * nb * 4 + Eb * (db * db + db) * 4,
              float(Eb) * nb * (2 * db * db + 3 * db),
              lambda: newton_system(Xk, rd2, rdz), lambda: newton_system_plain(Xk, rd2, rdz),
              lambda: (torch.bmm(Xk.mT, Xk * rd2k), torch.bmm(Xk.mT, rdzk)))
    # Does K1's loss math cost time? The same launch with the squared loss,
    # which has no exp, log or division.
    sq_ms = cuda_ms(lambda: fused_value_grad(SquaredLoss, w, Xb, y, off, wt, return_margins=True))
    log(f"  K1 N=2^21 d=256 bf16 margins, squared loss: kernel {sq_ms:.4f} ms "
        f"(logistic {timings['fused_value_grad_bf16']['ms']:.4f} ms)")
    del Xf, Xre_b
    torch.cuda.empty_cache()

    # ---------------- 4. GLMix step ----------------
    log("## phase 4: GLMix training step")
    obj = dict(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    fe_cfg = OptimizerConfig(max_iter=FE_ITERS, track_history=False)
    re_cfg = OptimizerConfig(max_iter=RE_ITERS, tol=1e-6, track_history=False)

    # 4a. small input: kernels on the card (f32) vs the plain path in float64 on the CPU.
    sn, sd, sdr, sE = 1 << 14, 32, 8, 64
    small = make_data(sn, sd, sdr, sE, seed=1, device="cpu")

    def run_small(device, dtype, fused, re_kernel):
        Xs_, Xr_, u_, y_ = (t.to(device) for t in small)
        Xs_, Xr_, y_ = Xs_.to(dtype), Xr_.to(dtype), y_.to(dtype)
        (blk,) = build_random_effect_dataset(
            u_.cpu().numpy(), Xr_.cpu().numpy(), y_.cpu().numpy(), np.ones(sn, y_.cpu().numpy().dtype),
            sE, RandomEffectDataConfig("userId", "re", n_buckets=1), device=device).blocks
        step = glmix_train_step(GLMObjective(use_fused=fused, **obj), GLMObjective(**obj),
                                fe_cfg, re_cfg, re_kernel=re_kernel)
        wv = torch.zeros(sd, dtype=dtype, device=device)
        cv = torch.zeros(sE, sdr, dtype=dtype, device=device)
        for _ in range(CD_PASSES):
            wv, cv, sc, _, _ = step(wv, cv, LabeledBatch(y_, Xs_), blk, Xr_, u_)
        return sc

    kernels.reset_launches()
    s_card = run_small(dev, torch.float32, True, "auto")
    used = dict(kernels.LAUNCHES)
    s_ref = run_small("cpu", torch.float64, False, "torch")
    _, r = rel_err(s_card.cpu(), s_ref)
    check(r <= REFERENCE_TOL and used["fused_value_grad"] > 0 and used["newton_system"] > 0,
          f"small GLMix (n={sn}) on the card vs float64 plain path on the CPU: scores rel {r:.3e} "
          f"(tolerance {REFERENCE_TOL:g}); launches {used}")

    # 4b. headline width.
    step = glmix_train_step(GLMObjective(use_fused=True, **obj), GLMObjective(**obj),
                            fe_cfg, re_cfg, re_kernel="auto")
    fe_batch = LabeledBatch(y, Xb)
    w_fixed = torch.full((D_FIX,), 1e-4, device=dev)
    re_coefs = torch.full((E, D_RE), 1e-4, device=dev)

    def logloss(scores):
        return float(torch.mean(LogisticLoss.value(scores, y)))

    s0 = fe_batch.margins(w_fixed) + torch.sum(Xr * re_coefs[users.long()], dim=-1)
    losses = [logloss(s0)]
    log(f"  pass 0 (initial point): training logloss {losses[0]:.6f}")
    kernels.reset_launches()
    reads0, total_visits, total_s = HOST_READS.count, 0, 0.0
    for p in range(1, CD_PASSES + 1):
        torch.cuda.synchronize()
        r0, t0 = HOST_READS.count, time.perf_counter()
        w_fixed, re_coefs, scores, fe_evals, re_visits = step(w_fixed, re_coefs, fe_batch, block, Xr, users)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        visits = N * int(fe_evals) + int(re_visits)
        total_visits, total_s = total_visits + visits, total_s + dt
        losses.append(logloss(scores))
        fe_obj = GLMObjective(**obj).value(w_fixed, fe_batch.add_scores_to_offsets(scores - fe_batch.margins(w_fixed)))
        log(f"  pass {p}: {dt:.3f} s wall, {HOST_READS.count - r0} host syncs, fe X passes {int(fe_evals)}, "
            f"re visits {int(re_visits)}, {visits / dt:.4e} samples/s, training logloss {losses[-1]:.6f}, "
            f"FE objective {float(fe_obj):.6e}")
        check(bool(torch.isfinite(scores).all()) and np.isfinite(float(fe_obj)), f"pass {p}: scores and objective finite")
        check(losses[-1] < losses[-2], f"pass {p}: training logloss fell ({losses[-2]:.6f} -> {losses[-1]:.6f})")
    glmix_launches = dict(kernels.LAUNCHES)
    log(f"  GLMix {CD_PASSES} passes: {total_s:.3f} s, {HOST_READS.count - reads0} host syncs, "
        f"{total_visits / total_s:.4e} samples/s (bench.py visit accounting) on {smi}; launches {glmix_launches}")
    check(glmix_launches["fused_value_grad"] > 0 and glmix_launches["newton_system"] > 0,
          "GLMix path launched K1 and K3")

    # 4c. one more pass under torch.profiler: device busy share, time by kernel.
    profiled("profiled pass", lambda: step(w_fixed, re_coefs, fe_batch, block, Xr, users))

    # ---------------- 5. TRON ----------------
    log("## phase 5: fixed-effect TRON (hvp_factory = linearized_hvp)")
    tron_obj = GLMObjective(use_fused=True, **obj)
    w0 = torch.zeros(D_FIX, device=dev)
    f0 = float(tron_obj.value_and_grad(w0, fe_batch)[0])
    kernels.reset_launches()
    torch.cuda.synchronize()
    r0, t0 = HOST_READS.count, time.perf_counter()
    res = minimize_tron(lambda v: tron_obj.value_and_grad(v, fe_batch), None, w0,
                        OptimizerConfig(max_iter=5, tol=1e-5),
                        hvp_factory=lambda v: tron_obj.linearized_hvp(v, fe_batch))
    torch.cuda.synchronize()
    tron_launches = dict(kernels.LAUNCHES)
    log(f"  {time.perf_counter() - t0:.3f} s, {int(res.iterations)} iterations, {HOST_READS.count - r0} host syncs, "
        f"objective {f0:.6e} -> {float(res.value):.6e}; launches {tron_launches}")
    check(float(res.value) < f0 and np.isfinite(float(res.value)), "TRON lowered the objective")
    check(tron_launches["fused_value_grad"] > 0 and tron_launches["fused_hvp"] > 0, "TRON path launched K1 and K2")

    # ---------------- 6. train_glm ----------------
    del fe_batch, Xb, Xr, block, ds
    torch.cuda.empty_cache()
    glm_launches = train_glm_phase(dev, smi, check)

    # ---------------- report ----------------
    sources = {
        "fused_value_grad": ("photon_tpu_torch/csrc/fused_value_grad.cu", "photon_tpu/ops/pallas_glm.py:345"),
        "fused_hvp": ("photon_tpu_torch/csrc/fused_hvp.cu", "photon_tpu/ops/pallas_glm.py:227"),
        "newton_system": ("photon_tpu_torch/csrc/newton_system.cu", "photon_tpu/ops/pallas_newton.py:150"),
    }
    # K1's and K2's rows are their bf16 timings, K3's its f32 timing (the
    # types of the main path); the other type's time and bound ride beside.
    for name, main, other in (("fused_value_grad", "bf16", "f32"), ("fused_hvp", "bf16", "f32"),
                              ("newton_system", "f32", "bf16")):
        o = timings.pop(f"{name}_{other}")
        timings[name] = dict(timings.pop(f"{name}_{main}"),
                             **{f"{other}_ms": o["ms"], f"{other}_bound_ms": o["bound_ms"]})
    rows = []
    for name, (src, repl) in sources.items():
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=glmix_launches[name] + tron_launches[name] + glm_launches[name],
                         max_abs_err=headline_err[name], **timings[name]))
    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed: {failures}")
        return 1
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
