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
                both of its routes ("bulk" and "direct") up to d = 64 and at
                d = 96, 128 and 192 (where it works H in panels), and
                check that two launches of K1 and of K2 at the headline are
                bitwise equal;
  3. timing   — kernel, plain version and a library yardstick, with CUDA
                events, beside the kernel's bound (bytes or operations over
                the H100's published peaks), K3 also at d = 96 and 128
                (E = 1024, n_max = 768); the launch plans of K1 and K2
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
  7. GAME     — ``GameEstimator.fit`` then ``GameTransformer.transform`` with
                three coordinates over phase 4's N = 2^21 rows: the fixed
                effect (d = 256, bf16 X, L-BFGS, K1), per user (E = 4096,
                d = 16, Newton, K3) and per item (E = 1024 Zipf-like items,
                d = 128, at most 4096 samples an item, 4 sample-count blocks,
                Newton, K3 at d = 128); two passes with the active set and a
                2^18-row validation batch. First a small input on the card
                against the float64 plain path on the CPU; then per pass the
                wall time, host syncs, samples/s, each coordinate's wall, K1
                and K3 launches by width, entities skipped, training logloss
                (must fall) and validation AUC (GLMix must reach fixed-only);
                then one pass under the profiler.
  8. GAME drivers — ``feature_indexing.main``, ``game_training.main`` and
                ``game_scoring.main`` on Avro files written here (2^13
                training and 2^12 validation rows; bags of 255, 15 and 127
                values, which the intercepts take to d = 256, 16 and 128; 256
                users and 256 Zipf-like items in metadataMap): fixed + per
                user + per item, λ = 1|10 on the fixed effect, 2 passes with
                the active set, SIMPLE variances, AUC. The files, LATEST and
                the summary must be written, K1 and K3 at d = 16 and 128
                launched, the best AUC above 0.7, every score of scores.avro
                the in-process score of best/ loaded back (1e-5 relative), the
                scoring AUC the training one (1e-5); and on a 2^10-row file
                of 16 users and 16 items the driver on the card must give
                the CPU run's coefficients (2e-3 relative). Each driver's wall time by stage, host syncs
                and launches by width are logged.
It prints the card's name and power limit, a JSON line of per-kernel numbers,
and last {"ok": true, "device": {...}}. It exits non-zero, printing no
result, when there is no CUDA device or any phase fails. Float32 matrix
products run in full f32 (TF32 off).
"""

from __future__ import annotations

import dataclasses
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
# Phase 7 (GAME): items, their width and sample cap, validation rows, passes;
# K3's shapes at the per-item widths (E = 1024 items, n_max = 768).
G_ITEMS, G_D_ITEM, G_ITEM_CAP, G_VALID_ROWS, G_PASSES = 1024, 128, 4096, 1 << 18, 2
K3_WIDE = ((1024, 768, 96), (1024, 768, 128), (256, 768, 192))
# Phase 8 (GAME drivers): rows of the training, validation and card-vs-CPU
# files, users and items. Phase 7's 2^21 rows, 4096 users and 1024 items are
# cut because the port parses Avro in pure Python (the native columnar
# decoder is not ported); the widths are phase 7's, not cut.
H_TRAIN_ROWS, H_VALID_ROWS, H_USERS, H_ITEMS = 1 << 13, 1 << 12, 256, 256
# The card-vs-CPU file: 2^10 rows over 16 users and 16 items. Spread over
# 256 of each, a user or item has ~4 rows, many with one label only; their
# unregularized intercepts then diverge until the solver stops, so their
# coefficients are not determined and no two runs need agree.
H_SMALL_ROWS, H_SMALL_ENTITIES = 1 << 10, 16
H_BAGS = (("features", "globalShard", D_FIX - 1), ("userFeatures", "userShard", D_RE - 1),
          ("itemFeatures", "itemShard", G_D_ITEM - 1))
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


def _game_batch(dev, Xf, Xu, users, Xi, items, w_fe, W_u, W_i, g):
    """A GameBatch of the planted GLMix model: fixed effect over Xf (f32 or
    bf16), per-user effects over Xu, per-item effects over Xi."""
    from photon_tpu_torch.data.batch import matvec
    from photon_tpu_torch.data.game_data import GameBatch

    logits = (matvec(Xf, w_fe) + torch.sum(Xu * W_u[users.long()], dim=-1)
              + torch.sum(Xi * W_i[items.long()], dim=-1))
    y = (torch.rand(Xf.shape[0], device=dev, generator=g, dtype=logits.dtype) < torch.sigmoid(logits))
    n = Xf.shape[0]
    return GameBatch(label=y.to(w_fe.dtype), offset=torch.zeros(n, dtype=w_fe.dtype, device=dev),
                     weight=torch.ones(n, dtype=w_fe.dtype, device=dev),
                     features={"global": Xf, "user": Xu, "item": Xi},
                     entity_ids={"userId": users, "itemId": items})


def _zipf_items(n, n_items, dev, g):
    p = 1.0 / torch.arange(1, n_items + 1, device=dev, dtype=torch.float64) ** 1.1
    return torch.multinomial(p, n, replacement=True, generator=g).to(torch.int32)


def _game_estimator(n_users, n_items, item_cap, passes, fixed_only=False):
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    cfgs = [config.FixedEffectCoordinateConfig("global", "global"),
            config.RandomEffectCoordinateConfig("per_user", "userId", "user"),
            config.RandomEffectCoordinateConfig("per_item", "itemId", "item", active_upper_bound=item_cap)]
    if fixed_only:
        cfgs = cfgs[:1]
    reg = config.GameOptimizationConfig({c.coordinate_id: config.RegularizationConfig(1.0) for c in cfgs})
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=passes,
                        intercept_indices={"global": 0, "user": 0, "item": 0},
                        num_entities={"userId": n_users, "itemId": n_items}, re_active_set=True)
    return est, reg


def game_phase(dev, smi: str, check, Xb, Xr, users, n_users: int) -> dict:
    """Phase 7: the GAME core. (a) A small input on the card (f32, kernels)
    against the float64 plain path on the CPU; (b) ``GameEstimator.fit`` and
    ``GameTransformer.transform`` at full width over phase 4's X (bf16), per
    user features and ids, with per-item features and planted labels made
    here; (c) one more pass under the profiler. Returns the kernel launches
    of (b), with K3's by width under "newton_system_d<d>"."""
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.optim.common import HOST_READS

    log("## phase 7: GAME core (GameEstimator.fit, GameTransformer.transform)")
    g = torch.Generator(device=dev).manual_seed(7)

    # 7a. Small input: f32 on the card (K1, K3 at d = 16 and 128) against the
    # float64 plain path on the CPU, same numpy data.
    rng = np.random.default_rng(70)
    sn, sd, sdu, sdi, sE, sI = 1 << 14, 32, 8, G_D_ITEM, 64, 32
    cols = lambda k: np.concatenate([np.ones((sn, 1)), rng.normal(size=(sn, k - 1))], axis=1)  # noqa: E731
    small = dict(Xf=cols(sd), Xu=cols(sdu), Xi=cols(sdi), users=rng.integers(0, sE, size=sn),
                 w_fe=rng.normal(size=sd) / sd ** 0.5, W_u=rng.normal(size=(sE, sdu)) * 0.5,
                 W_i=rng.normal(size=(sI, sdi)) * 0.1)
    p = 1.0 / np.arange(1, sI + 1) ** 1.1
    small["items"] = rng.choice(sI, size=sn, p=p / p.sum())

    def small_scores(device, dtype, labels=None):
        t = {k: torch.as_tensor(v, device=device, dtype=torch.int32 if k in ("users", "items") else dtype)
             for k, v in small.items()}
        gs = torch.Generator(device=device).manual_seed(71)
        batch = _game_batch(device, t["Xf"], t["Xu"], t["users"], t["Xi"], t["items"], t["w_fe"], t["W_u"],
                            t["W_i"], gs)
        if labels is not None:  # the same labels on both sides
            batch = dataclasses.replace(batch, label=labels.to(device=device, dtype=dtype))
        est, reg = _game_estimator(sE, sI, 256, G_PASSES)
        (res,) = est.fit(batch, optimization_configs=[reg])
        return GameTransformer(res.model).transform(batch), batch.label

    ref, small_labels = small_scores("cpu", torch.float64)
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    card, _ = small_scores(dev, torch.float32, small_labels)
    torch.cuda.synchronize()
    used = dict(kernels.LAUNCHES, by_width=dict(fused_newton.LAUNCHES_BY_WIDTH))
    _, r = rel_err(card.cpu(), ref)
    check(r <= REFERENCE_TOL and used["fused_value_grad"] > 0 and used["by_width"].get(G_D_ITEM, 0) > 0,
          f"7a small GAME fit (n={sn}, 3 coordinates, d_item={sdi}) on the card vs float64 plain path on the "
          f"CPU: scores rel {r:.3e} (tolerance {REFERENCE_TOL:g}); launches {used}")

    # 7b. Full width.
    t0 = time.perf_counter()
    N = Xb.shape[0]
    d_fix, d_user = Xb.shape[1], Xr.shape[1]
    w_fe = torch.randn(d_fix, device=dev, generator=g) / d_fix ** 0.5
    W_u = torch.randn(n_users, d_user, device=dev, generator=g) * 0.5
    W_i = torch.randn(G_ITEMS, G_D_ITEM, device=dev, generator=g) * 0.1

    def item_features(n):
        X = torch.randn(n, G_D_ITEM, device=dev, generator=g)
        X[:, 0] = 1.0
        return X

    train = _game_batch(dev, Xb, Xr, users, item_features(N), _zipf_items(N, G_ITEMS, dev, g), w_fe, W_u, W_i, g)
    nv = G_VALID_ROWS
    Xv = torch.randn(nv, d_fix, device=dev, generator=g)
    Xv[:, 0] = 1.0
    Xuv = torch.randn(nv, d_user, device=dev, generator=g)
    Xuv[:, 0] = 1.0
    valid = _game_batch(dev, Xv.to(torch.bfloat16), Xuv,
                        torch.randint(0, n_users, (nv,), device=dev, generator=g, dtype=torch.int32),
                        item_features(nv), _zipf_items(nv, G_ITEMS, dev, g), w_fe, W_u, W_i, g)
    del Xv
    counts = torch.bincount(train.entity_ids["itemId"].long(), minlength=G_ITEMS)
    log(f"  data {time.perf_counter() - t0:.1f} s: N=2^21, global d={d_fix} bf16, per_user E={n_users} "
        f"d={d_user}, per_item E={G_ITEMS} d={G_D_ITEM} (samples an item: max {int(counts.max())}, median "
        f"{int(counts.median())}, min {int(counts.min())}; cap {G_ITEM_CAP}); validation {nv} rows; card {smi}")

    def logloss(model, batch):
        return float(torch.mean(LogisticLoss.value(model.score_with_offset(batch), batch.label)))

    history = []

    class Suite(EvaluationSuite):
        """Validation AUC (the primary metric), and the training logloss, of
        each pass's model."""

        def evaluate_model(self, model, batch):
            out = dict(super().evaluate_model(model, batch), train_logloss=logloss(model, train))
            history.append(out)
            return out

    est, reg = _game_estimator(n_users, G_ITEMS, G_ITEM_CAP, G_PASSES)
    t0 = time.perf_counter()
    est._prepare_datasets(train)
    torch.cuda.synchronize()
    for cid, ds in est._re_datasets.items():
        log(f"  {cid}: {len(ds.blocks)} blocks {[tuple(b.features.shape) for b in ds.blocks]}, "
            f"{ds.num_active_samples} active samples")
    log(f"  random-effect blocks built in {time.perf_counter() - t0:.1f} s (host grouping, once per batch)")

    marks = []

    def on_coordinate(it, cid, coord, wall):
        stats = getattr(coord, "last_active_set_stats", None)
        marks.append(dict(it=it, cid=cid, wall=wall, reads=HOST_READS.count, launches=dict(kernels.LAUNCHES),
                          by_width=dict(fused_newton.LAUNCHES_BY_WIDTH),
                          skipped=None if stats is None else stats["entities_skipped"]))

    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    torch.cuda.synchronize()
    reads0 = HOST_READS.count
    (res,) = est.fit(train, validation_batch=valid, evaluation_suite=Suite([EvaluatorSpec.parse("AUC")]),
                     optimization_configs=[reg], on_coordinate=on_coordinate)
    transformer = GameTransformer(res.model, EvaluationSuite([EvaluatorSpec.parse("AUC")]))
    scores = transformer.transform(valid)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})

    losses = [float(np.log(2.0))]  # every score is 0 before the first pass
    prev = dict(reads=reads0, launches={k: 0 for k in kernels.LAUNCHES}, by_width={})
    total_visits, total_s = 0, 0.0
    for it in range(G_PASSES):
        pm = [m for m in marks if m["it"] == it]
        fe = res.tracker["global"][it]
        visits = N * int(fe.x_passes) + sum(int(res.tracker[c][it].sample_visits) for c in ("per_user", "per_item"))
        wall = sum(m["wall"] for m in pm)
        total_visits, total_s = total_visits + visits, total_s + wall
        end = pm[-1]
        k1 = end["launches"]["fused_value_grad"] - prev["launches"]["fused_value_grad"]
        k3 = {d: c - prev["by_width"].get(d, 0) for d, c in end["by_width"].items()}
        losses.append(history[it]["train_logloss"])
        auc = history[it]["AUC"]
        log(f"  pass {it + 1}: {wall:.3f} s wall, {end['reads'] - prev['reads']} host syncs, "
            f"{visits / wall:.4e} samples/s ({visits} visits; fixed effect {int(fe.x_passes)} X passes, "
            f"{int(fe.iterations)} iterations), coordinates "
            + ", ".join(f"{m['cid']} {m['wall']:.3f} s" for m in pm)
            + f"; K1 launches {k1}, K3 launches by width {k3}; entities skipped "
            + ", ".join(f"{m['cid']} {m['skipped']}" for m in pm if m["skipped"] is not None)
            + f"; training logloss {losses[-1]:.6f}, validation AUC {auc:.4f}")
        for cid in ("per_user", "per_item"):
            log(f"    {cid}: {res.tracker[cid][it].summary()}")
        check(losses[-1] < losses[-2], f"7b pass {it + 1}: training logloss fell ({losses[-2]:.6f} -> {losses[-1]:.6f})")
        check(np.isfinite(auc), f"7b pass {it + 1}: validation AUC {auc:.4f} finite")
        prev = end
    log(f"  GAME {G_PASSES} passes: {total_s:.3f} s, {marks[-1]['reads'] - reads0} host syncs, "
        f"{total_visits / total_s:.4e} samples/s (bench.py visit accounting) on {smi}; launches {launches}")
    check(launches["fused_value_grad"] > 0 and launches.get(f"newton_system_d{Xr.shape[1]}", 0) > 0
          and launches.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          f"GAME path launched K1, and K3 at d = {Xr.shape[1]} and d = {G_D_ITEM}")
    glmix_auc = max(h["AUC"] for h in history)  # the fit returns the best pass's model
    check(bool(torch.isfinite(scores).all()) and scores.shape == (nv,)
          and abs(transformer.last_metrics["AUC"] - glmix_auc) <= 1e-6,
          f"GameTransformer.transform of the fit's model: {nv} finite scores, validation AUC "
          f"{transformer.last_metrics['AUC']:.4f} (the fit's best pass {glmix_auc:.4f})")

    fe_est, fe_reg = _game_estimator(n_users, G_ITEMS, G_ITEM_CAP, 1, fixed_only=True)
    (fe_res,) = fe_est.fit(train, validation_batch=valid, evaluation_suite=EvaluationSuite(
        [EvaluatorSpec.parse("AUC")]), optimization_configs=[fe_reg])
    check(glmix_auc >= fe_res.metrics["AUC"],
          f"7b GLMix validation AUC {glmix_auc:.4f} >= fixed-only {fe_res.metrics['AUC']:.4f}")

    # 7c. One more pass from the trained model under the profiler (its
    # launches are not counted).
    est.num_iterations = 1
    profiled("GAME pass from the trained model, profiled",
             lambda: est.fit(train, optimization_configs=[reg], initial_model=res.model))
    return launches


def _driver_records(n: int, seed: int, n_users: int = H_USERS, n_items: int = H_ITEMS) -> list:
    """TrainingExampleAvro rows with three bags (H_BAGS) and the ids of
    ``n_users`` users and ``n_items`` Zipf-like items in metadataMap; labels
    planted from a fixed, a per-user and a per-item effect. The planted model
    comes from one seed, the rows from ``seed``."""
    model = np.random.default_rng(80)
    w_fe = model.normal(size=D_FIX - 1) * 3.0 / np.sqrt(D_FIX - 1)
    W_u = model.normal(size=(H_USERS, D_RE)) * 0.4
    W_i = model.normal(size=(H_ITEMS, G_D_ITEM)) * 0.05
    rng = np.random.default_rng(seed)
    X = {bag: rng.normal(size=(n, k)) for bag, _, k in H_BAGS}
    users = rng.integers(0, n_users, size=n)
    p = 1.0 / np.arange(1, n_items + 1) ** 1.1
    items = rng.choice(n_items, size=n, p=p / p.sum())
    logits = (X["features"] @ w_fe + np.sum(X["userFeatures"] * W_u[users, 1:], 1) + W_u[users, 0]
              + np.sum(X["itemFeatures"] * W_i[items, 1:], 1) + W_i[items, 0])
    y = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))
    return [{"uid": str(i), "label": float(y[i]), "weight": None, "offset": None,
             "metadataMap": {"userId": f"user{users[i]}", "itemId": f"item{items[i]}"},
             **{bag: [{"name": f"{bag[0]}{j}", "term": "", "value": float(v)} for j, v in enumerate(X[bag][i])]
                for bag, _, _ in H_BAGS}}
            for i in range(n)]


def game_drivers_phase(dev, smi: str, check) -> dict:
    """Phase 8: the GAME drivers end to end on files: feature_indexing,
    game_training and game_scoring, as a user calls them. Returns the kernel
    launches of that run, K3's by width under "newton_system_d<d>"."""
    import copy

    from photon_tpu_torch.cli import feature_indexing, game_scoring, game_training
    from photon_tpu_torch.cli.common import parse_feature_shard_config
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.io.avro import write_avro_records
    from photon_tpu_torch.io.data_reader import read_merged
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from photon_tpu_torch.io.scores import load_scores
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.optim.common import HOST_READS
    from photon_tpu_torch.utils.timed import Timed

    log("## phase 8: GAME drivers (feature_indexing, game_training, game_scoring)")
    log(f"  cut from phase 7: {H_TRAIN_ROWS} training rows (not 2^21), {H_USERS} users (not {E}), "
        f"{H_ITEMS} items (not {G_ITEMS}), {H_VALID_ROWS} validation rows (not {G_VALID_ROWS}): the port parses "
        f"Avro in pure Python; widths not cut (d = {D_FIX}, {D_RE}, {G_D_ITEM})")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_game_drivers"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = copy.deepcopy(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] += [{"name": bag, "type": {"type": "array", "items": "FeatureAvro"}}
                         for bag, _, _ in H_BAGS[1:]]
    t0 = time.perf_counter()
    train_recs = _driver_records(H_TRAIN_ROWS, 81)
    paths = {"train": work / "train.avro", "valid": work / "valid.avro", "small": work / "small.avro"}
    write_avro_records(str(paths["train"]), schema, train_recs)
    write_avro_records(str(paths["valid"]), schema, _driver_records(H_VALID_ROWS, 82))
    write_avro_records(str(paths["small"]), schema,
                       _driver_records(H_SMALL_ROWS, 83, H_SMALL_ENTITIES, H_SMALL_ENTITIES))
    paths = {k: str(v) for k, v in paths.items()}
    log(f"  wrote the Avro files in {time.perf_counter() - t0:.1f} s")
    shards = ["--feature-shard-configurations"] + [f"name={shard},feature.bags={bag}" for bag, shard, _ in H_BAGS]
    coords = ["--coordinate-configurations",
              "name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=1|10",
              "name=perUser,feature.shard=userShard,random.effect.type=userId,reg.weights=1",
              "name=perItem,feature.shard=itemShard,random.effect.type=itemId,reg.weights=1",
              "--update-sequence", "global,perUser,perItem", "--coordinate-descent-iterations", "2",
              "--re-active-set", "--evaluators", "AUC", "--variance-computation", "SIMPLE"]
    out, idx, scored = work / "out", work / "index", work / "scores"

    def stages(label, wall, reads):
        by_stage = ", ".join(f"{k[len('driver/'):]} {v:.2f} s" for k, v in Timed.records.items()
                             if k.startswith("driver/"))
        log(f"  {label}: {wall:.2f} s wall, {reads} host syncs" + (f"; by stage {by_stage}" if by_stage else ""))

    # The main path, counted: the three drivers, in the order a user runs them.
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    Timed.reset()
    t0 = time.perf_counter()
    sizes = feature_indexing.main(["--input-paths", paths["train"], "--output-dir", str(idx)] + shards)
    stages(f"feature_indexing {sizes}", time.perf_counter() - t0, 0)
    Timed.reset()
    reads0, t0 = HOST_READS.count, time.perf_counter()
    summary = game_training.main(["--input-paths", paths["train"], "--validation-paths", paths["valid"],
                                  "--output-dir", str(out), "--feature-index-dir", str(idx), "--device", "cuda"]
                                 + shards + coords)
    torch.cuda.synchronize()
    stages("game_training", time.perf_counter() - t0, HOST_READS.count - reads0)
    trained = dict(kernels.LAUNCHES, by_width=dict(fused_newton.LAUNCHES_BY_WIDTH))
    Timed.reset()
    reads0, t0 = HOST_READS.count, time.perf_counter()
    result = game_scoring.main(["--input-paths", paths["valid"], "--output-dir", str(scored), "--model-input-dir",
                                str(out / "best"), "--evaluators", "AUC", "--device", "cuda"] + shards)
    torch.cuda.synchronize()
    stages("game_scoring", time.perf_counter() - t0, HOST_READS.count - reads0)
    launches = dict(kernels.LAUNCHES)
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    log(f"  launches: training {trained}; all three drivers {launches}")

    written = [out / "best" / "model-metadata.json", out / "LATEST", out / "training-summary.json",
               out / "entity-index-userId.json", out / "entity-index-itemId.json"] + [
        out / f"index-map-{shard}.json" for _, shard, _ in H_BAGS]
    check(all(p.exists() for p in written) and (out / "LATEST").read_text().strip() == "best"
          and len(summary["configs"]) == 2,
          "8 game_training: best/, index maps, entity indexes, LATEST = best and a 2-config training-summary.json")
    for c in summary["configs"]:
        log(f"    {c['config']}: validation AUC {c['metrics']['AUC']:.4f}")
    check(trained["fused_value_grad"] > 0 and trained["by_width"].get(D_RE, 0) > 0
          and trained["by_width"].get(G_D_ITEM, 0) > 0,
          f"8 game_training launched K1, and K3 at d = {D_RE} and d = {G_D_ITEM}")
    best_auc = summary["best"]["metrics"]["AUC"]
    check(best_auc > 0.7, f"8 best validation AUC {best_auc:.4f} > 0.7 ({summary['best']['config']})")
    check(result["numScored"] == H_VALID_ROWS, f"8 game_scoring scored {result['numScored']} rows")

    # best/ loaded back and scored in process against scores.avro.
    imaps = {shard: IndexMap.load(str(out / f"index-map-{shard}.json")) for _, shard, _ in H_BAGS}
    eidx = {rt: EntityIndex.load(str(out / f"entity-index-{rt}.json")) for rt in ("userId", "itemId")}
    model = load_game_model(str(out / "best"), imaps, eidx, device=dev)
    shard_cfgs = {}
    for bag, shard, _ in H_BAGS:
        shard_cfgs.update(parse_feature_shard_config(f"name={shard},feature.bags={bag}"))
    valid, _, _ = read_merged([paths["valid"]], shard_cfgs, imaps, {"userId": "userId", "itemId": "itemId"},
                              eidx, intern_new_entities=False, device=dev)
    want = model.score_with_offset(valid).double().cpu()
    got = torch.tensor([r["predictionScore"] for r in load_scores(str(scored / "scores.avro"))], dtype=torch.float64)
    _, r = rel_err(got, want)
    check(got.shape == want.shape and r <= 1e-5,
          f"8 scores.avro vs GameModel.score_with_offset of best/ loaded back: rel {r:.3e} (tolerance 1e-5)")
    check(abs(result["metrics"]["AUC"] - best_auc) <= 1e-5,
          f"8 scoring AUC {result['metrics']['AUC']:.6f} = training summary's best {best_auc:.6f} (tolerance 1e-5)")

    # Card against CPU on the small file (not counted).
    small = {}
    for device in ("cuda", "cpu"):
        o = work / f"small-{device}"
        game_training.main(["--input-paths", paths["small"], "--output-dir", str(o), "--device", device]
                           + shards + coords)
        maps = {shard: IndexMap.load(str(o / f"index-map-{shard}.json")) for _, shard, _ in H_BAGS}
        ents = {rt: EntityIndex.load(str(o / f"entity-index-{rt}.json")) for rt in ("userId", "itemId")}
        small[device] = load_game_model(str(o / "best"), maps, ents, device="cpu").models
    worst = 0.0
    for cid, m in small["cpu"].items():
        a = small["cuda"][cid]
        wa, wb = ((x.model.coefficients.means if cid == "global" else x.coefficients) for x in (a, m))
        worst = max(worst, rel_err(wa, wb)[1])
    check(worst <= REFERENCE_TOL, f"8 game_training on {H_SMALL_ROWS} rows of {H_SMALL_ENTITIES} users and items, "
                                  f"--device cuda vs --device cpu: best/ coefficients rel {worst:.3e} "
                                  f"(tolerance {REFERENCE_TOL:g})")
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
    # K3 at the per-item widths, where it works H in panels (bucket_dim takes
    # 65-128 to 96 or 128; an explicit NEWTON spec takes any width, 192 here).
    wide = {}
    for En, nn, dn in K3_WIDE:
        Xn = torch.randn(En, nn, dn, device=dev, generator=g)
        Xn[:, :, 0] = 1.0
        n2, nz = torch.rand(En, nn, device=dev, generator=g) * 0.25, torch.randn(En, nn, device=dev, generator=g)
        wide[dn] = (Xn, n2, nz)
        for dt in (torch.float32, torch.bfloat16):
            Xnd = Xn.to(dt)
            Hn, gn = newton_system(Xnd, n2, nz)
            plan = system_plan(Xnd, n2, nz)
            parity(f"K3 newton_system E={En} n_max={nn} d={dn} {dt} ({plan['route']} route, {plan['panels']} panels)",
                   (Hn, gn), newton_system_plain(Xnd, n2, nz), f"newton_system_d{dn}" if dt == torch.float32 else None)
            check(torch.equal(Hn, Hn.transpose(1, 2)), f"K3 E={En} n_max={nn} d={dn} {dt}: H exactly symmetric")
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
    for dn in (96, 128, 192):
        Xn, n2, nz = wide[dn]
        En, nn, _ = Xn.shape
        for Xk, tag in ((Xn, "f32"), (Xn.to(torch.bfloat16), "bf16")):
            log(f"  K3 E={En} n_max={nn} d={dn} {tag} launch plan on {sms} SMs: {system_plan(Xk, n2, nz)}")
            n2k, nzk = n2.to(Xk.dtype)[..., None], nz.to(Xk.dtype)[..., None]
            # The upper triangle of H and g: d(d+1) + 2d flops a row.
            timed(f"newton_system_d{dn}_{tag}", f"K3 E={En} n_max={nn} d={dn} {tag}", Xk.dtype,
                  En * nn * dn * Xk.element_size() + 2 * En * nn * 4 + En * (dn * dn + dn) * 4,
                  float(En) * nn * (dn * (dn + 1) + 2 * dn),
                  lambda: newton_system(Xk, n2, nz), lambda: newton_system_plain(Xk, n2, nz),
                  lambda: (torch.bmm(Xk.mT, Xk * n2k), torch.bmm(Xk.mT, nzk)))
    del wide, Xn, Xk
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
    del fe_batch, block, ds
    torch.cuda.empty_cache()
    glm_launches = train_glm_phase(dev, smi, check)

    # ---------------- 7. GAME ----------------
    torch.cuda.empty_cache()
    game_launches = game_phase(dev, smi, check, Xb, Xr, users, E)
    del Xb, Xr, users, y

    # ---------------- 8. GAME drivers ----------------
    torch.cuda.empty_cache()
    driver_launches = game_drivers_phase(dev, smi, check)

    # ---------------- report ----------------
    sources = {
        "fused_value_grad": ("photon_tpu_torch/csrc/fused_value_grad.cu", "photon_tpu/ops/pallas_glm.py:345"),
        "fused_hvp": ("photon_tpu_torch/csrc/fused_hvp.cu", "photon_tpu/ops/pallas_glm.py:227"),
        "newton_system": ("photon_tpu_torch/csrc/newton_system.cu", "photon_tpu/ops/pallas_newton.py:150"),
    }
    # K3 at the per-item width (d = 128, which phase 7 runs) is a row of its
    # own, its launches those at that width. No main path runs d = 96, so
    # its numbers ride in the d = 128 row (a row of its own would show no
    # launch); d = 192 is in the log.
    sources["newton_system_d128"] = sources["newton_system"]
    # K1's and K2's rows are their bf16 timings, K3's its f32 timing (the
    # types of the main path); the other type's time and bound ride beside.
    for name, main, other in (("fused_value_grad", "bf16", "f32"), ("fused_hvp", "bf16", "f32"),
                              ("newton_system", "f32", "bf16"), ("newton_system_d128", "f32", "bf16"),
                              ("newton_system_d96", "f32", "bf16")):
        o = timings.pop(f"{name}_{other}")
        timings[name] = dict(timings.pop(f"{name}_{main}"),
                             **{f"{other}_ms": o["ms"], f"{other}_bound_ms": o["bound_ms"]})
    timings["newton_system_d128"].update({f"d96_{k}": v for k, v in timings.pop("newton_system_d96").items()},
                                         d96_max_abs_err=headline_err["newton_system_d96"])
    rows = []
    for name, (src, repl) in sources.items():
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=(glmix_launches.get(name, 0) + tron_launches.get(name, 0)
                                   + glm_launches.get(name, 0) + game_launches.get(name, 0)
                                   + driver_launches.get(name, 0)),
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
