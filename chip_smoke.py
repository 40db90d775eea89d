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
                bitwise equal, and that there, in bf16 and f32, a launch
                with its launch flag on is bitwise the launch without it
                and one with the flag off leaves its zeroed outputs zero
                and is not counted as run;
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
  5. TRON     — a fixed-effect TRON solve on the same batch through the solve
                cache (captured: K1 trials and K2 products, each with its
                launch flag), which must lower the objective, run kernels
                1 and 2 (launches whose flag was on, counted on the card:
                ``kernels.ran``) and equal the same program run eagerly (iterations,
                reason, coefficients within 1e-6); it prints host reads,
                captures, X passes run and the masked cost and graph nodes of
                a step;
  6. train_glm — the legacy GLM driver: ``train_glm.main`` on a LIBSVM file
                (2^14 rows) and an Avro file (2^12 rows) of 255 features with
                validation files and λ = 10, 1, 0.1, whose model files must
                be written and load back, with validation AUC > 0.7 and K1
                launched; the driver's λ loop at N = 2^21, d = 256 (f32) with
                L-BFGS (K1), TRON (K1 and K2) and ELASTIC_NET α = 0.5
                (OWL-QN, K1), per λ iterations, X passes, wall time, host
                reads (at most SWEEP_READS a λ), samples/s and AUC, one
                capture a sweep; and the λ loop on the card against the
                port's float64 plain path on the CPU.
  7. GAME     — ``GameEstimator.fit`` then ``GameTransformer.transform`` with
                three coordinates over phase 4's N = 2^21 rows: the fixed
                effect (d = 256, bf16 X, L-BFGS, K1), per user (E = 4096,
                d = 16, Newton, K3) and per item (E = 1024 Zipf-like items,
                d = 128, at most 4096 samples an item, 4 sample-count blocks,
                Newton, K3 at d = 128); two passes with the active set and a
                2^18-row validation batch. First a small input on the card
                against the float64 plain path on the CPU; then per pass the
                wall time, host reads, samples/s, each coordinate's wall, K1
                and K3 launches by width, entities skipped, training logloss
                (must fall) and validation AUC (GLMix must reach fixed-only);
                then one pass under the profiler.
  8. GAME drivers — ``feature_indexing.main`` (on a 2^13-row file),
                ``game_training.main`` and ``game_scoring.main`` on Avro files
                written here by a spawn pool (2^17 training rows in 8 files,
                2^15 validation rows in 2; bags of 255, 15 and 127 values,
                which the intercepts take to d = 256, 16 and 128; 4096 users
                and 1024 Zipf-like items in metadataMap): fixed + per user +
                per item, λ = 1|10 on the fixed effect, 2 passes with the
                active set, SIMPLE variances, AUC. Every read must take the
                native columnar decoder (``READ_PATHS``); the files, LATEST
                and the summary must be written, K1 and K3 at d = 16 and 128
                launched, the best AUC above 0.7, every score of scores.avro
                the in-process score of best/ loaded back (1e-5 relative), the
                scoring AUC the training one (1e-5); and on a 2^10-row file
                of 16 users and 16 items the driver on the card must give
                the CPU run's coefficients (2e-3 relative). The writer's
                wall, each driver's wall by stage, each read's rows, bytes,
                wall, rows/s and path, the columnar and the row read of the
                2^10-row file side by side, host reads and launches by width
                are logged. The pool also writes phase 17's delta.
  9. GAME solvers — phase 7's data and widths with the other solvers, two
                passes with the active set: 9a TRON on the fixed effect (K1,
                K2), elastic net per user (batched OWL-QN) and TRON per item
                (batched TRON at d = 128); 9b Pearson caps per user under
                standardization (gradient-form L-BFGS) and per item (margin
                L-BFGS at d = 128). Each first a small input on the card
                against the float64 plain path on the CPU; per pass as 7b;
                fails unless the logloss falls, GLMix reaches the fixed-only
                AUC, pass 2 captures nothing, K1 (and for 9a K2) run, and
                captured equals eager per route at each K of PHASE9_CHUNKS.
 10. sparse  — the sparse wide fixed effect: 10a bench_configs.py config 6
                at full width (n = d = 2^20, 64 nnz a row, margin L-BFGS, 30
                iterations) in four variants (scatter or segment-sum
                rmatvec, f32 or bf16 values), each eager and captured: wall,
                X passes, samples/s, GB/s, host reads, captures, bytes bound
                and the run-to-run spread of the objective; fails unless the
                segment sum's captured solve is its eager one bit for bit,
                the variants' objectives at convergence agree (1e-4), a cut
                copy (n = d = 2^14) matches the float64 plain path on the
                CPU and the λ sweep's lanes reach the single solves'
                objectives at convergence (1e-4). 10b GAME with phase
                7b's per-user and per-item effects (K3 at d = 16, 128) and a
                config-6 fixed-effect shard over its 2^21 rows, two passes
                (as 7b, GLMix AUC at least the fixed-only AUC, no K1). 10c
                the drivers on sparse Avro files (2^13 rows of 2^16 columns,
                cut): train_glm with --constraint-string and
                --summarization-output-dir and with ELASTIC_NET,
                game_training with --coordinate-constraints and a sparse
                per-user shard (projected blocks), game_scoring of that
                model (its scores the in-process ones), on 2^17 training
                and 2^15 validation rows of 2^16 columns (every read
                columnar); name_and_term_bags on a 2^13-row file (its
                counts the columnar decode's distinct keys).
 11. tuning  — 11a in process on phase 7's rows (N = 2^21, d_fix = 256
                bf16, per user d = 16 over E = 4096, logistic): q = 4 and 8
                candidates as batched lanes (two rounds) against q
                sequential fits, with wall, host reads, captures, replays,
                X passes and peak memory; fails unless every lane's AUC is
                finite and within 2e-3 of its fit, the second round replays
                with no new capture, and a cut copy on the card matches the
                CPU float64 plain path (2e-3). 11b game_training
                --hyper-parameter-tuning BAYESIAN --hyper-parameter-batch-size
                2 --output-mode TUNED on phase 8's files (global and
                per user): no decline, every candidate in
                hyperparameter-observations.json, the TUNED model scored
                by game_scoring, every read columnar.
 12. durability — on phase 8's files, widths and index: 12a
                ``stream_merged`` + ``concat_game_batches`` and
                ``stream_device_batches`` (overlapped and serial; pinned
                copies on a copy stream) + ``materialize_game_batch`` with
                2^14-row chunks must equal ``read_merged`` bit for bit on
                the card (rows/s of each against the whole-file read, the
                pipeline's stages, the materialize peak memory); 12b phase
                8's game_training with --stream-ingest-chunk-rows and
                --checkpoint-dir, SIGKILLed by a fault plan right after
                cfg_0/step_0 is durable (exit -9), then --resume'd in
                process: its model within 1e-6 of phase 8's (bitwise is
                printed), the same best, the same entities solved by the
                active set (phase 8's events), K1 and K3 at d = 16 and 128
                launched; 12c train_glm on the training files streamed
                through a 64 MiB replay cache (which must spill), λ = 10,
                1, 0.1, killed after λ = 10's checkpoint, resumed: losses
                and coefficients within 1e-6 of an unbroken whole-file
                sweep, the same best λ, K1 launched; 12d game_scoring of the
                12b model streamed in 2^12-row chunks, overlapped and
                --serial-ingest: every score phase 8's exactly, by uid; 12e a
                checkpoint of the CUDA model with a bf16 leaf restored onto
                the card with equal bits, a real torch.cuda.OutOfMemoryError
                classified by ``resources.is_device_oom``, and a SolveCache
                capture after a streamed ingest has joined its threads.
 13. out of core — 13a 7b's model resident and with each random effect
                budgeted at a quarter of its footprint, bitwise; 13b-d the
                drivers with a budget and a spill, the partitioned index, an
                injected OOM.
 14. multiple devices — torch.distributed ranks on this one card, sharing
                7b's batch with the parent through CUDA IPC:
                ``GameEstimator(mesh=...).fit`` of 7b's model (the fixed
                effect on each rank's rows, K1 a row shard and one
                all-reduce; the random effects entity-sharded, K3 on each
                rank's shards) and a rows-sharded fixed-effect TRON solve
                (K2) on 14a one NCCL rank (solves captured with their
                all-reduce), 14b 2 and 4 gloo ranks (eager), 14c 2 gloo ranks
                with every shard out of core at a quarter of its footprint;
                14d config 6 with w over 1 and 2 gloo ranks. Per rank: K1/K2/K3
                launches, each fixed-effect solve's route, peak memory, each
                shard's store and static-buffer bytes. Fails unless K1, K2
                and K3 ran on every rank, the random effects, fixed effect
                and TRON solve of 14a-c are bitwise equal, the fixed effect
                is within MR_FE_TOL of 7b's, 14a's random effects are within
                MR_RE_TOL of the unsharded coordinates', 14a's TRON follows
                the whole batch's step for step, and 14d (against one rank)
                agrees at a seeded point and step for step. No check runs
                on more than one GPU.
 15. online serving — phase 8's model behind the serving engine (hot/cold
                store, micro-batcher, admission, HTTP front end): scores
                equal game_scoring's bit for bit, nothing captured after
                warm-up, load at 1, 8 and 64 clients, and a second
                generation shadowed, promoted and rolled back under load.
 16. telemetry — 16a phase 8's game_training with --telemetry-out and
                --otlp-endpoint (an in-process MockCollector on localhost):
                every report line validates, each coordinate has its pass
                spans with solve and score, the collector received spans
                and metrics, the model files (Avro records, other bytes)
                are phase 8's, and the host reads up to the report's
                finalize and the K1 and K3 launches by width are phase 8's;
                16b phase 15's engine on phase 8's model with an exporter,
                a report flusher and the SLO-gated watcher (on) against
                none of them (off): /metrics parses and carries the serve_*
                families, a request with a traceparent comes back from
                /v1/traces with its spans, stats() has the slo block, the
                scores are game_scoring's bit for bit, nothing is captured
                or allocated after warm-up, and submit requests/s and
                p50/p99 at 1 and 64 clients, on beside off; 16c
                ``python -m photon_tpu_torch.cli.obs_tool`` summarizes 16a's
                report and scrapes 16b's /metrics.
 17. streaming — on phase 8's files and model: 17a phase 8's best/
                published as gen-1 under a publish root, then a delta of
                2^14 rows (a subset of the users and items, and new ones)
                through game_incremental in process (K1, K3 at d = 16 and
                128; unchanged rows the parent's bit for bit; the gate
                passes and LATEST moves), the same run spawned on a copy of
                the root (the same sha256s) and incremental_update with
                emit_delta (the layer resolves to the full publish bit for
                bit); 17b game_serving --feedback-spool spawned on the card,
                2048 scored requests with uids and their labels through
                /v1/feedback, then game_streaming --max-cycles 1 spawned: a
                delta micro-generation with its consume cursor that the
                server's watcher installs under live traffic, after which
                the served scores are game_scoring's of the resolved chain
                bit for bit, nothing is captured after the delta's warm-up
                and no request failed (label-to-serve freshness, the cycle's
                wall, requests/s across the flip); 17c game_streaming killed
                at stream.consume and restarted in process: 17b's model files
                and the cursor applied once; 17d an engine with a pinned
                quality baseline counts every joined label under both
                versions.
Phases 4, 6b, 7b, 8 and 9 print, per pass, λ or driver, the host reads (every
device-to-host read of the path, through ``HOST_READS``; validation apart),
the solve cache's captures (programs; the keys, which count each λ, apart),
hits, replays, X passes run (masked steps included) and bytes copied into
its static buffers, and the peak memory; once, the guard (mask) and K; per
capture, its seconds and the chunk graph's node count. 7b also runs the
fixed-effect solve and a block of each random effect eagerly and captured
at K = 1, 2, 4 and 8, and fails at any K unless iterations and reasons are
equal and coefficients within 1e-6; it fails if pass 2 captures anything or
the two passes' coordinate updates make more than 60 host reads; 6b fails
above SWEEP_READS reads for a λ solve. The order of the run is 1-7, 9, 11a,
10, 8, 16, 11b, 12, 13, 15, 17, 14; the whole run's wall is printed at its
end.
It prints the card's name and power limit, a JSON line of per-kernel numbers
("launches" and "ran": the launches of the main paths, and those of them
that did their work; a K1 or K2 launch whose flag was off does not), and last {"ok": true, "device": {...}}. It exits non-zero, printing no
result, when there is no CUDA device or any phase fails. Float32 matrix
products run in full f32 (TF32 off).
"""

from __future__ import annotations

import contextlib
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
# Phase 6b: host reads a λ solve may take, by sweep. On an NVIDIA H100 80GB
# HBM3 at 700 W the captured programs read 6, 4, 4 a λ for TRON at K = 8
# (11, 7, 7 at its K = 4) and 3 a λ for ELASTIC_NET (OWL-QN, K = 4).
SWEEP_READS = {"LBFGS": 6, "TRON": 16, "ELASTIC_NET": 8}
# Phase 7 (GAME): items, their width and sample cap, validation rows, passes;
# K3's shapes at the per-item widths (E = 1024 items, n_max = 768).
G_ITEMS, G_D_ITEM, G_ITEM_CAP, G_VALID_ROWS, G_PASSES = 1024, 128, 4096, 1 << 18, 2
K3_WIDE = ((1024, 768, 96), (1024, 768, 128), (256, 768, 192))
# Phase 9 (GAME with the other solvers, on phase 7's data): each route's
# coordinate options (estimators/config.py fields; reg_alpha: the elastic-net
# alpha of λ = 1) and the shards standardized. A Pearson cap keeps
# ceil(ratio × samples) of an entity's columns: per user ~512 samples of
# d = 16, per item a median of ~395 of d = 128.
# K swept by phase 9's captured-vs-eager solves (all of solve_cache's K set
# to each; None: the defaults).
PHASE9_CHUNKS = (None, 2, 4, 8, 16)
SOLVER_ROUTES = {
    "9a": {"global": dict(optimizer="TRON"), "per_user": dict(reg_alpha=0.5), "per_item": dict(optimizer="TRON")},
    "9b": {"per_user": dict(features_to_samples_ratio=0.02), "per_item": dict(features_to_samples_ratio=0.1),
           "standardize": ("user",)},
}
# Phase 8 (GAME drivers): rows of the training and validation sets, users
# and items (phase 7's), and the files each set is written as (by a spawn
# pool, one process a file: the Avro writer is pure Python). The drivers read
# them through the native columnar decoder; only the 2^21 rows of phase 7
# are cut, to bound the writer's time. feature_indexing (which parses rows
# in pure Python in both packages) reads a file of H_INDEX_ROWS rows of the
# same bags: every dense feature occurs in every row, so its index covers the
# large files.
H_TRAIN_ROWS, H_VALID_ROWS, H_USERS, H_ITEMS = 1 << 17, 1 << 15, E, G_ITEMS
H_TRAIN_FILES, H_VALID_FILES, H_INDEX_ROWS = 8, 2, 1 << 13
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
# 10a's scatter cut copy: its f32 objective where it stopped against the
# float64 path's after as many iterations (~12 ulps of an f32 objective).
CUT_OBJECTIVE_TOL = 1e-6
# Phase 10 (the sparse wide fixed effect). 10a: bench_configs.py config 6
# (:461-570), not cut: n = d = 2^20, 64 nnz a row in the padded-sparse
# layout (column 0 the intercept), logistic, l2 = 1, margin L-BFGS for 30
# iterations; its card-vs-CPU copy n = d = 2^14; the λ sweep's weights.
SP_N, SP_D, SP_K, SP_ITERS, SP_SEED = 1 << 20, 1 << 20, 64, 30, 3
SP_CUT, SP_LAMBDAS = 1 << 14, (0.1, 1.0, 10.0, 100.0)
# 10a's solves run to convergence (its agreement checks): the iteration cap
# and the relative-improvement tolerance. The default 1e-7 is about one f32
# ulp of the objective (~2e5), so an f32 solve would stop on the first
# iteration that gains less, as much as 1e-4 above the optimum and at a point
# that follows the scatter's summation order; 1e-9 lies below that ulp, so a
# solve ends only where an iteration leaves the f32 objective unchanged.
SP_CONVERGED, SP_CONVERGED_TOL = 400, 1e-9
# 10c (the drivers on Avro files), cut as phase 8 is: training and
# validation rows, global columns (drawn ∝ 1 / rank: ~40,000 of them occur
# in the training rows) and nnz a row; users, each with a window of its own
# user features (4 a row). The user shard is 256 × 20 = 5,120
# columns wide (sparse: above the reader's dense limit of 4096); each of the
# 4 projected blocks holds ~64 users (96 rows allocated), ~64 × 20 + 1 =
# 1,281 columns (margin L-BFGS: Newton takes 128 at most), at most 96 × 64 ×
# 1,281 f32 = 31 MB a block.
S_TRAIN_ROWS, S_VALID_ROWS, S_COLUMNS, S_NNZ = 1 << 17, 1 << 15, 1 << 16, 32
S_USERS, S_USER_WINDOW, S_USER_NNZ = 256, 20, 4
# 10c writes its sets as phase 8 does; name_and_term_bags (pure Python in
# both packages) reads a cut file of S_CUT_ROWS rows.
S_TRAIN_FILES, S_VALID_FILES, S_CUT_ROWS = 4, 1, 1 << 13
# Phase 11 (hyperparameter tuning). 11a: q candidates a round (log10 λ of
# the fixed effect and the per-user effect drawn in [-2, 2]) as batched
# lanes against q sequential fits, on the GLMix headline rows; its cut copy
# on the card against the CPU float64 plain path. Lanes and fits must agree
# within TUNING_TOL (the reference's bar for batched against sequential).
TUNING_Q, TUNING_TOL = (4, 8), 2e-3
# Phase 12 (durability and streaming ingest, on phase 8's files and
# widths): the chunk rows of the streamed reads and drivers (12a-c) and of
# streamed scoring (12d); 12c's replay-cache budget, below the ~0.6 GB the
# decoded training set takes, so the cache spills to disk; the fault plan
# that SIGKILLs a driver right after its first checkpoint is durable; the
# resumed models' tolerance against the unbroken ones.
P_CHUNK_ROWS, P_SCORE_CHUNK_ROWS, P_REPLAY_MB = 1 << 14, 1 << 12, 64
KILL_AFTER_FIRST_SAVE = {"rules": [{"site": "checkpoint.after_save", "kind": "kill", "at": [0]}]}
RESUME_TOL = 1e-6
# Phase 13 (out-of-core random effects). 13a: passes, the random effects'
# sample-count buckets, and each budgeted coordinate's budget as a fraction
# (1 / OOC_BUDGET_DIVISOR) of its footprint (bench.py:1165-1183 takes a
# quarter); 13b: the drivers' budget (MiB: it floors at each coordinate's
# largest block) and spill member; 13c: the index store's partitions.
OOC_PASSES, OOC_BUCKETS, OOC_BUDGET_DIVISOR = 3, 16, 4
# Phase 15: the engine's max batch, its client threads, the rows through
# HTTP /v1/score-batch, requests a client in the load runs, the rows of the
# bucket-invariance, promotion and device-shard checks, shadow scores before
# a promotion.
SERVE_MAX_BATCH, SERVE_CLIENTS, SERVE_HTTP_ROWS, SERVE_LOAD_REQUESTS = 64, 8, 4096, 64
SERVE_INVARIANCE_ROWS, SERVE_SHADOW_QUOTA = 4096, 256
# Phase 16: requests a client in the telemetry on/off load runs, and the
# seconds between the run-report flushes and OTLP metric exports while on.
TELEMETRY_LOAD_REQUESTS, TELEMETRY_FLUSH_S = 256, 1.0
OOC_DRIVER_BUDGET_MB, OOC_SPILL_MEMBER, OOC_PARTITIONS = "1", "updater:3", 4
# Phase 17 (the streaming freshness loop, on phase 8's files and model). 17a:
# the delta's rows (drawn by phase 8's generator with its own seed, written
# as STREAM_DELTA_FILES files) over STREAM_USERS users: the first
# STREAM_KNOWN_USERS land on every STREAM_USER_STRIDE-th known user, the
# rest are new; items from STREAM_NEW_ITEMS_FROM on take new ids. 17b: the
# requests scored with uids and labelled, the spool's segment size and age,
# the HTTP clients, the rows scored after the flip against game_scoring.
STREAM_DELTA_ROWS, STREAM_DELTA_FILES, STREAM_DELTA_SEED = 1 << 14, 4, 8700
STREAM_USERS, STREAM_KNOWN_USERS, STREAM_USER_STRIDE, STREAM_NEW_ITEMS_FROM = 640, 576, 7, 1008
STREAM_REQUESTS, STREAM_SEGMENT_RECORDS, STREAM_SEGMENT_AGE_S, STREAM_CLIENTS = 2048, 512, 1.0, 8
STREAM_CHECK_ROWS, STREAM_QUALITY_REQUESTS = 2048, 512
# Phase 14 (multiple devices: torch.distributed ranks on this one card).
# 14b's gloo world sizes; each group's timeout (a dead rank fails its peers
# within it) and each run's deadline; 14c's per-shard budget divisor (a
# quarter of each shard's footprint, as 13a); 14d's L-BFGS iterations. The
# fixed effect after 2 passes against 7b's: max |Δw| / max |w| below
# MR_FE_TOL (3.668e-3 measured on the H100, the same in every run). 14a's
# coordinates against the unsharded ones, one pass from 14a's model on the
# same batch: every random-effect coefficient within MR_RE_TOL·(1 + |c|)
# (the CPU tests' 1e-3 bar). Solves compared step for step (14a's TRON on
# the rows-sharded batch against the whole batch's, 14d's fit on 2 ranks
# against 1): each step's objectives within MR_TRAJECTORY_TOL and its step
# or trust radius within MR_STEP_TOL relative (both interpolate differences
# of f) until the first step where a decision (iteration, phase, search or
# CG steps, reason) differs, if any; and 14a's TRON objectives within
# MR_TRAJECTORY_TOL. Their coefficients are logged, not held: an f32
# objective this size is flat to an ulp along directions where they part
# (a tie on the last ulp of f ends one solve an iteration before the other).
# 14d at a seeded point: value and gradient within MR_FEATURE_TOL relative.
MR_WORLDS, MR_TIMEOUT_S, MR_DEADLINE_S, MR_BUDGET_DIVISOR = (2, 4), 300.0, 600.0, OOC_BUDGET_DIVISOR
MR_FEATURE_ITERS, MR_FE_TOL, MR_FEATURE_TOL = 5, 1e-2, 1e-5
MR_RE_TOL, MR_TRAJECTORY_TOL, MR_STEP_TOL = 1e-3, 1e-5, 1e-3
# The optimization-log events of the drivers' runs (``record_event`` is
# registered by dotted path with --event-listener).
EVENTS: list = []
# 7b's fixed-effect coefficients, which phase 14 is held against.
PHASE7B: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def record_event(event) -> None:
    """An event listener the drivers register by dotted path."""
    EVENTS.append(event)


def _active_counts(events) -> list:
    """(coordinate, pass, entities solved) of the random-effect updates of
    ``events``, in order."""
    return [(e.payload["coordinate"], e.payload["cd_iteration"], e.payload["active_set"]["entities_active"])
            for e in events if e.name == "PhotonOptimizationLogEvent" and e.payload.get("active_set")]


def cache_text(d: dict) -> str:
    """A ``SolveCacheStats.since`` delta of the solve cache, as printed."""
    return (f"solve cache: captures {d['captures']} (keys {d['traces']}), hits {d['hits']}, replays {d['replays']}, "
            f"{d['x_passes_run']} X passes run, {d['copied_bytes'] / 1e6:.1f} MB copied into static buffers")


def peak_text() -> str:
    return f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB"


def cache_setup(label: str, cache=None) -> int:
    """Print how captured solves run; returns the count of programs built
    so far in ``cache`` (default: the shared one), for ``cache_entries``."""
    from photon_tpu_torch.algorithm import solve_cache

    cache = cache if cache is not None else solve_cache.default_cache()
    log(f"  {label}: solve cache guard = mask (torch {torch.__version__} has no capture into CUDA graph "
        f"conditional nodes); steps per host read K = {solve_cache.FE_CHUNK} fixed-effect margin L-BFGS, "
        f"{solve_cache.CHUNK} every other program")
    return len(cache.entry_info())


def cache_entries(since: int, cache=None) -> None:
    """Print the captures made in ``cache`` (default: the shared one) since
    ``cache_setup``: key, K, capture time, node count of the chunk graph."""
    from photon_tpu_torch.algorithm.solve_cache import default_cache

    for info in (cache if cache is not None else default_cache()).entry_info()[since:]:
        log(f"    captured {tuple(info['key'])}: K = {info['chunk']}, {info.get('capture_s', 0.0):.3f} s, "
            f"chunk graph {info.get('chunk_nodes')} nodes")


def launch_counts() -> dict:
    """The launches counted since the last ``kernels.reset_launches``, and
    per kernel "<name>_ran": those that did their work (a K1 or K2 launch
    whose launch flag was off does not; one read of the card's counters)."""
    from photon_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES, **{f"{k}_ran": v for k, v in kernels.ran().items()})


def ran(counts: dict, name: str) -> int:
    """The launches of ``name`` in ``counts`` that ran (K3's by width, which
    has no flag: its launches)."""
    return counts.get(f"{name}_ran", counts.get(name, 0))


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
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.cli import train_glm
    from photon_tpu_torch.evaluation.metrics_map import AREA_UNDER_ROC, metrics_map
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    launches = {}

    def count(used: dict) -> None:
        for k, v in used.items():
            launches[k] = launches.get(k, 0) + v

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
        used = launch_counts()
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
    # (label, optimizer, elastic-net alpha, kernels it must launch, host reads a λ at most: SWEEP_READS)
    for label, opt, alpha, needs in (("LBFGS", OptimizerType.LBFGS, 0.0, ("fused_value_grad",)),
                                     ("TRON", OptimizerType.TRON, 0.0, ("fused_value_grad", "fused_hvp")),
                                     ("ELASTIC_NET", OptimizerType.LBFGS, 0.5, ("fused_value_grad",))):
        # A cache of the sweep's own, so that the profiled λ below hits it.
        sweep_cache = SolveCache()
        built0 = cache_setup("6b λ sweep", sweep_cache)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        sweep = train_glm.train_lambda_sweep(train, weights, TaskType.LOGISTIC_REGRESSION, OptimizerSpec(opt),
                                             elastic_net_alpha=alpha, intercept_index=B_FEATURES,
                                             variance=VarianceComputationType.SIMPLE, solve_cache=sweep_cache)
        used = launch_counts()
        log(f"    {label} sweep: {peak_text()}")
        count(used)
        for r in sweep:
            passes = int(r.result.x_passes)
            auc = metrics_map(TaskType.LOGISTIC_REGRESSION, valid.margins(r.w_model), yv)[AREA_UNDER_ROC]
            value = float(r.result.value)
            log(f"    {label} λ={r.lam:g}: {int(r.result.iterations)} iterations, "
                f"{r.result.convergence_reason.value}, {passes} X passes, {r.wall_s:.4f} s wall, "
                f"{r.host_syncs} host reads, {N * passes / r.wall_s:.4e} samples/s, objective {value:.6e}, "
                f"{int((r.w_model == 0).sum())} zero coefficients, validation AUC {auc:.4f}; {cache_text(r.cache)}")
            check(r.host_syncs <= SWEEP_READS[label],
                  f"6b {label} λ={r.lam:g}: {r.host_syncs} host reads <= {SWEEP_READS[label]}")
            check(np.isfinite(value) and bool(torch.isfinite(r.variances).all()),
                  f"6b {label} λ={r.lam:g}: objective and variances finite")
            check(auc > 0.6, f"6b {label} λ={r.lam:g}: validation AUC {auc:.4f} > 0.6")
        log(f"    {label} sweep launches {used}")
        cache_entries(built0, sweep_cache)
        for info, (ms, nodes) in zip(sweep_cache.entry_info(), masked_steps(sweep_cache)):
            log(f"    masked step of {info['key']}: {ms:.4f} ms, {nodes} graph nodes a step")
        check(all(ran(used, k) > 0 for k in needs), f"6b {label}: ran {', '.join(needs)}")
        check(sweep_cache.stats.captures == 1 and sweep_cache.stats.traces == len(weights),
              f"6b {label}: one capture for the sweep ({sweep_cache.stats.captures}), one key a λ "
              f"({sweep_cache.stats.traces})")
        # The first λ once more, under the profiler (its launches are not counted).
        profiled(f"{label} λ={weights[0]:g} from zero, profiled", lambda: train_glm.train_lambda_sweep(
            train, weights[:1], TaskType.LOGISTIC_REGRESSION, OptimizerSpec(opt), elastic_net_alpha=alpha,
            intercept_index=B_FEATURES, solve_cache=sweep_cache), indent="    ")
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


def _standardization(X: torch.Tensor):
    """STANDARDIZATION of a shard whose column 0 is the intercept (factor 1,
    shift 0 there), from its rows."""
    from photon_tpu_torch.data.normalization import NormalizationContext

    mean, std = X.mean(0), X.std(0)
    mean[0], std[0] = 0.0, 1.0
    std = torch.where(std > 0, std, torch.ones_like(std))
    return NormalizationContext(1.0 / std, mean, 0)


def _game_estimator(n_users, n_items, item_cap, passes, fixed_only=False, route=None, batch=None):
    """The GAME estimator of phases 7 and 9 (fixed + per user + per item,
    λ = 1, active set) and its regularization; ``route`` names phase 9's
    solver options (SOLVER_ROUTES), whose standardized shards take their
    statistics from ``batch``."""
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import OptimizerType, TaskType

    opts = SOLVER_ROUTES.get(route, {})
    kw = {name: dict(opts.get(name, {})) for name in ("global", "per_user", "per_item")}
    for d in kw.values():
        if "optimizer" in d:
            d["optimizer"] = OptimizerType[d["optimizer"]]
    alphas = {cid: d.pop("reg_alpha", 0.0) for cid, d in kw.items()}
    cfgs = [config.FixedEffectCoordinateConfig("global", "global", **kw["global"]),
            config.RandomEffectCoordinateConfig("per_user", "userId", "user", **kw["per_user"]),
            config.RandomEffectCoordinateConfig("per_item", "itemId", "item", active_upper_bound=item_cap,
                                                **kw["per_item"])]
    if fixed_only:
        cfgs = cfgs[:1]
    reg = config.GameOptimizationConfig({c.coordinate_id: config.RegularizationConfig(1.0, alphas[c.coordinate_id])
                                         for c in cfgs})
    norm = {shard: _standardization(batch.features[shard]) for shard in opts.get("standardize", ())}
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=passes,
                        intercept_indices={"global": 0, "user": 0, "item": 0},
                        num_entities={"userId": n_users, "itemId": n_items}, re_active_set=True,
                        normalization=norm or None)
    return est, reg


def _small_game(dev, check, label: str, route=None, needs=()) -> None:
    """A small GAME fit (n = 2^14, 3 coordinates, d_item = 128) on the card
    (f32, kernels) against the float64 plain path on the CPU, same numpy data
    and labels: scores within REFERENCE_TOL, and the card run launched the
    kernels ``needs`` names ("newton_system_d<d>": K3 at width d)."""
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.ops import fused_newton, kernels

    rng = np.random.default_rng(70)
    sn, sd, sdu, sdi, sE, sI = 1 << 14, 32, 8, G_D_ITEM, 64, 32
    cols = lambda k: np.concatenate([np.ones((sn, 1)), rng.normal(size=(sn, k - 1))], axis=1)  # noqa: E731
    small = dict(Xf=cols(sd), Xu=cols(sdu), Xi=cols(sdi), users=rng.integers(0, sE, size=sn),
                 w_fe=rng.normal(size=sd) / sd ** 0.5, W_u=rng.normal(size=(sE, sdu)) * 0.5,
                 W_i=rng.normal(size=(sI, sdi)) * 0.1)
    p = 1.0 / np.arange(1, sI + 1) ** 1.1
    small["items"] = rng.choice(sI, size=sn, p=p / p.sum())

    def scores(device, dtype, labels=None):
        t = {k: torch.as_tensor(v, device=device, dtype=torch.int32 if k in ("users", "items") else dtype)
             for k, v in small.items()}
        gs = torch.Generator(device=device).manual_seed(71)
        batch = _game_batch(device, t["Xf"], t["Xu"], t["users"], t["Xi"], t["items"], t["w_fe"], t["W_u"],
                            t["W_i"], gs)
        if labels is not None:  # the same labels on both sides
            batch = dataclasses.replace(batch, label=labels.to(device=device, dtype=dtype))
        est, reg = _game_estimator(sE, sI, 256, G_PASSES, route=route, batch=batch)
        (res,) = est.fit(batch, optimization_configs=[reg])
        return GameTransformer(res.model).transform(batch), batch.label

    ref, labels = scores("cpu", torch.float64)
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    card, _ = scores(dev, torch.float32, labels)
    torch.cuda.synchronize()
    used = dict(launch_counts(), **{f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    _, r = rel_err(card.cpu(), ref)
    check(r <= REFERENCE_TOL and all(ran(used, k) > 0 for k in needs),
          f"{label} small GAME fit (n={sn}, 3 coordinates, d_item={sdi}) on the card vs float64 plain path on the "
          f"CPU: scores rel {r:.3e} (tolerance {REFERENCE_TOL:g}); launches {used}")


def _fit_passes(label: str, est, reg, train, valid, check, smi: str, read_bound=None) -> dict:
    """``est.fit`` of ``train`` with ``valid`` for validation, through a
    solve cache of its own, and one line a pass: wall, host reads of the
    coordinate updates (validation apart), samples/s (bench.py's visit
    accounting), each coordinate's wall, launches, entities skipped,
    training logloss, validation AUC, the cache's counts and peak memory.
    Fails unless the logloss falls every pass, the AUC is finite, a pass
    after the first captures nothing, and (``read_bound``) the coordinate
    updates of all passes read at most that often. Returns the result, the
    estimator's cache, the launches (K3's by width as "newton_system_d<d>")
    and the best pass's AUC."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.optim.common import HOST_READS

    N = train.label.shape[0]

    def logloss(model, batch):
        return float(HOST_READS.fetch(torch.mean(LogisticLoss.value(model.score_with_offset(batch), batch.label)))[0])

    history = []

    class Suite(EvaluationSuite):
        """Validation AUC (the primary metric), and the training logloss, of
        each pass's model, with the host reads of the validation and the
        pass's peak memory (the peak is reset for the next pass)."""

        def evaluate_model(self, model, batch):
            r0 = HOST_READS.count
            out = dict(super().evaluate_model(model, batch), train_logloss=logloss(model, train))
            history.append(dict(out, validation_reads=HOST_READS.count - r0,
                                peak=torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            return out

    # A cache of the fit's own (the shared one is released when a fit
    # returns), so that later runs can replay its captures.
    cache = est.solve_cache = SolveCache()
    t0 = time.perf_counter()
    est._prepare_datasets(train)
    torch.cuda.synchronize()
    for cid, ds in est._re_datasets.items():
        log(f"  {label} {cid}: {len(ds.blocks)} blocks {[tuple(b.features.shape) for b in ds.blocks]}, "
            f"{ds.num_active_samples} active samples")
    log(f"  {label} random-effect blocks built in {time.perf_counter() - t0:.1f} s (host grouping, once per batch)")
    marks = []

    def on_coordinate(it, cid, coord, wall):
        stats = getattr(coord, "last_active_set_stats", None)
        marks.append(dict(it=it, cid=cid, wall=wall, reads=HOST_READS.count, launches=dict(kernels.LAUNCHES),
                          by_width=dict(fused_newton.LAUNCHES_BY_WIDTH), cache=cache.stats.counts(),
                          skipped=None if stats is None else stats["entities_skipped"]))

    built0 = cache_setup(f"{label} GAME", cache)
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reads0, counts0 = HOST_READS.count, cache.stats.counts()
    (res,) = est.fit(train, validation_batch=valid, evaluation_suite=Suite([EvaluatorSpec.parse("AUC")]),
                     optimization_configs=[reg], on_coordinate=on_coordinate)
    torch.cuda.synchronize()
    launches = launch_counts()
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})

    losses = [float(np.log(2.0))]  # every score is 0 before the first pass
    prev = dict(reads=reads0, launches={k: 0 for k in kernels.LAUNCHES}, by_width={}, cache=counts0)
    total_visits, total_s, coordinate_reads = 0, 0.0, 0
    for it in range(est.num_iterations):
        pm = [m for m in marks if m["it"] == it]
        fe = res.tracker["global"][it]
        visits = N * int(fe.x_passes) + sum(int(res.tracker[c][it].sample_visits) for c in ("per_user", "per_item"))
        wall = sum(m["wall"] for m in pm)
        total_visits, total_s = total_visits + visits, total_s + wall
        end = pm[-1]
        ran = {k: v - prev["launches"][k] for k, v in end["launches"].items()}
        k3 = {d: c - prev["by_width"].get(d, 0) for d, c in end["by_width"].items()}
        losses.append(history[it]["train_logloss"])
        auc = history[it]["AUC"]
        # The pass's coordinate updates: from the end of the last validation
        # (or the fit's start) to the last update; validation comes after.
        reads = end["reads"] - prev["reads"] - (history[it - 1]["validation_reads"] if it else 0)
        coordinate_reads += reads
        delta = {k: end["cache"][k] - prev["cache"][k] for k in end["cache"]}
        assert pm[0]["cid"] == "global"
        fe_run = pm[0]["cache"]["x_passes_run"] - prev["cache"]["x_passes_run"]
        log(f"  {label} pass {it + 1}: {wall:.3f} s wall, {reads} host reads in the coordinate updates (validation "
            f"{history[it]['validation_reads']} more), {visits / wall:.4e} samples/s ({visits} visits; fixed effect "
            f"{int(fe.x_passes)} X passes of its iterations, {fe_run} run on the card with masked steps and "
            f"capture warm-ups, {int(fe.iterations)} iterations), coordinates "
            + ", ".join(f"{m['cid']} {m['wall']:.3f} s" for m in pm)
            + f"; launches {ran}, K3 by width {k3}; entities skipped "
            + ", ".join(f"{m['cid']} {m['skipped']}" for m in pm if m["skipped"] is not None)
            + f"; training logloss {losses[-1]:.6f}, validation AUC {auc:.4f}; {cache_text(delta)}; "
            f"peak memory {history[it]['peak'] / 2 ** 30:.2f} GiB")
        for cid in ("per_user", "per_item"):
            log(f"    {cid}: {res.tracker[cid][it].summary()}")
        check(losses[-1] < losses[-2],
              f"{label} pass {it + 1}: training logloss fell ({losses[-2]:.6f} -> {losses[-1]:.6f})")
        check(np.isfinite(auc), f"{label} pass {it + 1}: validation AUC {auc:.4f} finite")
        if it > 0:
            check(delta["captures"] == 0 and delta["traces"] == 0,
                  f"{label} pass {it + 1}: no new capture ({delta['captures']}) or key ({delta['traces']})")
        prev = end
    cache_entries(built0, cache)
    log(f"  {label} GAME {est.num_iterations} passes: {total_s:.3f} s, {coordinate_reads} host reads in the "
        f"coordinate updates, {total_visits / total_s:.4e} samples/s (bench.py visit accounting) on {smi}; "
        f"launches {launches}")
    if read_bound is not None:
        check(coordinate_reads <= read_bound,
              f"{label}: {coordinate_reads} host reads in the coordinate updates of all passes <= {read_bound}")
    return dict(res=res, cache=cache, launches=launches, auc=max(h["AUC"] for h in history))


def _glmix_batches(dev, smi: str, Xb, Xr, users, n_users: int, seed: int):
    """Phase 7b's training batch over Xb (bf16), Xr and the user ids, with
    per-item features of 1024 Zipf-like items and labels planted here, and
    its 2^18-row validation batch."""
    g = torch.Generator(device=dev).manual_seed(seed)
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
    return train, valid


def game_phase(dev, smi: str, check, Xb, Xr, users, n_users: int):
    """Phase 7: the GAME core. (a) A small input on the card (f32, kernels)
    against the float64 plain path on the CPU; (b) ``GameEstimator.fit`` and
    ``GameTransformer.transform`` at full width over phase 4's X (bf16), per
    user features and ids, with per-item features and planted labels made
    here; (c) one more pass under the profiler. Returns the kernel launches
    of (b), with K3's by width under "newton_system_d<d>", the training and
    validation batches and the fixed-only validation AUC (for phase 9)."""
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec

    log("## phase 7: GAME core (GameEstimator.fit, GameTransformer.transform)")
    _small_game(dev, check, "7a", needs=("fused_value_grad", f"newton_system_d{G_D_ITEM}"))

    # 7b. Full width.
    train, valid = _glmix_batches(dev, smi, Xb, Xr, users, n_users, seed=7)
    d_user = Xr.shape[1]
    nv = G_VALID_ROWS
    est, reg = _game_estimator(n_users, G_ITEMS, G_ITEM_CAP, G_PASSES)
    out = _fit_passes("7b", est, reg, train, valid, check, smi, read_bound=60)
    res, launches = out["res"], out["launches"]
    transformer = GameTransformer(res.model, EvaluationSuite([EvaluatorSpec.parse("AUC")]))
    scores = transformer.transform(valid)
    check(launches["fused_value_grad"] > 0 and launches.get(f"newton_system_d{d_user}", 0) > 0
          and launches.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          f"GAME path launched K1, and K3 at d = {d_user} and d = {G_D_ITEM}")
    check(bool(torch.isfinite(scores).all()) and scores.shape == (nv,)
          and abs(transformer.last_metrics["AUC"] - out["auc"]) <= 1e-6,
          f"GameTransformer.transform of the fit's model: {nv} finite scores, validation AUC "
          f"{transformer.last_metrics['AUC']:.4f} (the fit's best pass {out['auc']:.4f})")

    fe_est, fe_reg = _game_estimator(n_users, G_ITEMS, G_ITEM_CAP, 1, fixed_only=True)
    (fe_res,) = fe_est.fit(train, validation_batch=valid, evaluation_suite=EvaluationSuite(
        [EvaluatorSpec.parse("AUC")]), optimization_configs=[fe_reg])
    fe_auc = fe_res.metrics["AUC"]
    check(out["auc"] >= fe_auc, f"7b GLMix validation AUC {out['auc']:.4f} >= fixed-only {fe_auc:.4f}")

    captured_solves("7b", est, reg, train, check, chunks=(1, 2, 4, 8))

    # 7c. One more pass from the trained model under the profiler (its
    # launches are not counted).
    est.num_iterations = 1
    profiled("GAME pass from the trained model, profiled",
             lambda: est.fit(train, optimization_configs=[reg], initial_model=res.model))
    PHASE7B["global"] = res.model.get("global").model.coefficients.means.float().cpu()
    return launches, train, valid, fe_auc


def game_solvers_phase(dev, smi: str, check, train, valid, fe_auc: float) -> dict:
    """Phase 9: GAME with the other solvers on phase 7's data, at full
    width, each route (SOLVER_ROUTES) first on a small input against the
    float64 plain path on the CPU, then fit for G_PASSES passes with the
    active set: 9a TRON on the fixed effect (K1, K2), elastic net per user
    (batched OWL-QN) and TRON per item (batched TRON at d = 128); 9b Pearson
    caps per user under standardization (gradient-form L-BFGS) and per item
    (margin L-BFGS at d = 128). Fails unless each fit passes _fit_passes'
    checks, its GLMix AUC reaches the fixed-only AUC, captured equals eager
    per route at every K of PHASE9_CHUNKS (the sweep that chose the TRON
    and OWL-QN K), and K1 and K2 were launched; then one pass of each under
    the profiler. Returns the launches of both fits."""
    log("## phase 9: GAME with TRON, OWL-QN and the L-BFGS fallbacks")
    launches = {}
    for route, needs in (("9a", ("fused_value_grad", "fused_hvp")), ("9b", ("fused_value_grad",))):
        log(f"  {route}: " + "; ".join(f"{k} {v}" for k, v in SOLVER_ROUTES[route].items()))
        _small_game(dev, check, route, route, needs)
        est, reg = _game_estimator(train.entity_ids["userId"].max().item() + 1, G_ITEMS, G_ITEM_CAP, G_PASSES,
                                   route=route, batch=train)
        out = _fit_passes(route, est, reg, train, valid, check, smi)
        check(out["auc"] >= fe_auc, f"{route} GLMix validation AUC {out['auc']:.4f} >= fixed-only {fe_auc:.4f}")
        check(all(ran(out["launches"], k) > 0 for k in needs), f"{route} ran {', '.join(needs)}")
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
        captured_solves(route, est, reg, train, check, chunks=PHASE9_CHUNKS)
        # One more pass from the trained model under the profiler (its
        # launches are not counted).
        est.num_iterations = 1
        profiled(f"{route} GAME pass from the trained model, profiled",
                 lambda: est.fit(train, optimization_configs=[reg], initial_model=out["res"].model))
        del est, out
        torch.cuda.empty_cache()
    return launches


def captured_solves(label: str, est, reg, train, check, chunks=(None,)) -> None:
    """After a fit: the fixed-effect solve and the first block of each random
    effect of the fit's configuration (its coordinates' objectives, specs and
    Pearson masks; from zero, no offsets), run eagerly on the card and
    through a solve cache at each K of ``chunks`` (every K of solve_cache set
    to it; None: the defaults). At every K, iterations and reasons must
    equal the eager ones and coefficients agree within 1e-6 relative; per
    K, the wall and host reads of a solve replayed after its capture, each
    capture's seconds and graph nodes, and each program's masked step (its
    chunk graph replayed after its solve ended, over K)."""
    from photon_tpu_torch.algorithm import solve_cache
    from photon_tpu_torch.algorithm.random_effect import _solve_block
    from photon_tpu_torch.optim.common import HOST_READS
    from photon_tpu_torch.optim.factory import make_optimizer

    coords = est._build_coordinates(train, reg)
    fe = coords["global"]
    fe_obj = dataclasses.replace(fe.objective, use_fused=True)
    lb = train.labeled_batch("global")
    fe_w0 = torch.zeros(lb.features.shape[1], device=lb.label.device)
    eager = make_optimizer(fe_obj, fe.optimizer_spec)(fe_w0, lb)
    solves = {"fixed effect": (lambda cache: cache.fe_solver(fe_obj, fe.optimizer_spec), (fe_w0, lb),
                               (eager.w, eager.iterations, eager.reason_code))}
    for cid in ("per_user", "per_item"):
        c = coords[cid]
        b, obj, mask = c.dataset.blocks[0], c._block_objectives[0], c._feature_masks.get(0)
        args = (b, torch.zeros_like(b.label), torch.zeros(b.num_entities, b.dim, device=b.label.device), mask)
        solves[f"{cid} block {tuple(b.features.shape)}"] = (
            lambda cache, c=c, obj=obj, mask=mask: cache.block_solver(obj, c.optimizer_spec, c._config,
                                                                      has_mask=mask is not None,
                                                                      re_kernel=c._re_kernel),
            args, _solve_block(*args[:3], obj, c.optimizer_spec, c._config, mask, re_kernel=c._re_kernel)[:3])
    names = ("FE_CHUNK", "CHUNK")
    defaults = {k: getattr(solve_cache, k) for k in names}
    try:
        for K in chunks:
            for k in names:
                setattr(solve_cache, k, defaults[k] if K is None else K)
            cache = solve_cache.SolveCache()
            parts = []
            for name, (make, args, want) in solves.items():
                solve = make(cache)
                got = solve(*args)  # captures
                torch.cuda.synchronize()
                r0, t0 = HOST_READS.count, time.perf_counter()
                solve(*args)
                torch.cuda.synchronize()
                wall, reads = time.perf_counter() - t0, HOST_READS.count - r0
                w, it, reason = (got.w, got.iterations, got.reason_code) if name == "fixed effect" else got[:3]
                parts.append(f"{name} {wall * 1e3:.2f} ms, {reads} reads, {int(it.max())} iterations")
                _, r = rel_err(w, want[0])
                check(torch.equal(it, want[1]) and torch.equal(reason, want[2]) and r <= 1e-6,
                      f"{label} {name}: captured (K = {'default' if K is None else K}) vs eager on the card: "
                      f"iterations and reasons equal, coefficients rel {r:.3e} (tolerance 1e-6)")
            log(f"  {label} K = {'default' if K is None else K}: " + "; ".join(parts))
            for info, (ms, nodes) in zip(cache.entry_info(), masked_steps(cache)):
                log(f"    {info['key']}: K = {info['chunk']}, capture {info.get('capture_s', 0.0):.3f} s, chunk graph "
                    f"{info.get('chunk_nodes')} nodes ({nodes} a step), masked step {ms:.4f} ms")
            del cache, solve
    finally:
        for k in names:
            setattr(solve_cache, k, defaults[k])


def masked_steps(cache) -> list:
    """Per program of ``cache``, in build order: (ms, nodes) of one step of
    its chunk graph replayed after its solve has ended, every part masked
    and the launch flags of K1 and K2 off (the chunk's outputs included, so
    an upper bound), timed with CUDA events over 20 replays; nodes per step
    likewise."""
    out = []
    for entry in sorted(cache._programs.values(), key=lambda e: cache._built.index(e.info)):
        entry.g_chunk.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            entry.g_chunk.replay()
        end.record()
        end.synchronize()
        nodes = entry.info.get("chunk_nodes")
        out.append((start.elapsed_time(end) / 20 / entry.chunk, None if nodes is None else nodes // entry.chunk))
    return out


def _driver_arrays(n: int, seed: int, n_users=None, n_items=None):
    """The features (by bag), users, Zipf-like items and planted labels of
    ``_driver_records``' rows (default H_USERS users and H_ITEMS items):
    the planted model comes from one seed, the rows from ``seed``."""
    n_users = H_USERS if n_users is None else n_users
    n_items = H_ITEMS if n_items is None else n_items
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
    return X, users, items, y


def _delta_ids(users, items):
    """Phase 17's delta: ``_driver_arrays`` over STREAM_USERS users, whose
    ids land on every STREAM_USER_STRIDE-th known user and past the known
    ones (new users), and over the known items, whose rarest (from
    STREAM_NEW_ITEMS_FROM on) take new ids. Returns the id strings."""
    known = users < STREAM_KNOWN_USERS
    u = np.where(known, users * STREAM_USER_STRIDE, H_USERS + users - STREAM_KNOWN_USERS)
    it = np.where(items < STREAM_NEW_ITEMS_FROM, items, H_ITEMS + items - STREAM_NEW_ITEMS_FROM)
    return [f"user{k}" for k in u], [f"item{k}" for k in it]


def _driver_records(n: int, seed: int, n_users=None, n_items=None, delta: bool = False):
    """TrainingExampleAvro rows with three bags (H_BAGS) and the ids of
    ``n_users`` users and ``n_items`` Zipf-like items in metadataMap; labels
    planted from a fixed, a per-user and a per-item effect. The rows are
    made as they are written. ``delta``: phase 17's ids (``_delta_ids``)."""
    X, users, items, y = _driver_arrays(n, seed, n_users, n_items)
    if delta:
        user_ids, item_ids = _delta_ids(users, items)
    else:
        user_ids, item_ids = [f"user{k}" for k in users], [f"item{k}" for k in items]
    return ({"uid": str(i), "label": float(y[i]), "weight": None, "offset": None,
             "metadataMap": {"userId": user_ids[i], "itemId": item_ids[i]},
             **{bag: [{"name": f"{bag[0]}{j}", "term": "", "value": float(v)} for j, v in enumerate(X[bag][i])]
                for bag, _, _ in H_BAGS}}
            for i in range(n))


def _driver_schema(bags) -> dict:
    """TrainingExampleAvro with the further feature bags ``bags``."""
    import copy

    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    schema = copy.deepcopy(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] += [{"name": bag, "type": {"type": "array", "items": "FeatureAvro"}} for bag in bags]
    return schema


def _write_part(job) -> float:
    """Write one Avro file (a task of ``write_files``' pool): ``job`` is
    (kind, path, rows, seed[, users, items]), kind "game" (phase 8's rows),
    "delta" (phase 17's) or "sparse" (10c's). Returns the seconds it took."""
    from photon_tpu_torch.io.avro import write_avro_records

    kind, path, n, seed, *ents = job
    t0 = time.perf_counter()
    if kind in ("game", "delta"):
        write_avro_records(path, _driver_schema([bag for bag, _, _ in H_BAGS[1:]]),
                           _driver_records(n, seed, *ents, delta=kind == "delta"))
    else:
        write_avro_records(path, _driver_schema(["userFeatures"]), _sparse_driver_records(n, seed))
    return time.perf_counter() - t0


def write_files(jobs) -> str:
    """Write the files of ``jobs`` (``_write_part``'s) from a pool of spawned
    processes, one a file (never forked from a process holding CUDA);
    returns the writer's wall, rows and bytes as printed."""
    import multiprocessing
    import os

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        secs = pool.map(_write_part, jobs)
    wall = time.perf_counter() - t0
    rows, size = sum(j[2] for j in jobs), sum(os.path.getsize(j[1]) for j in jobs)
    return (f"wrote {len(jobs)} Avro files ({rows} rows, {size / 1e6:.1f} MB) in {wall:.1f} s wall from a pool of "
            f"{min(len(jobs), os.cpu_count() or 1)} processes ({sum(secs):.1f} s of writer time, "
            f"{rows / sum(secs):.0f} rows/s a process)")


def _split(folder: Path, rows: int, files: int) -> list:
    """(path, rows) of the files of a set of ``rows`` rows written as
    ``files`` files in ``folder`` (which the drivers take as their input)."""
    folder.mkdir(parents=True, exist_ok=True)
    return [(str(folder / f"part-{i:05d}.avro"), rows // files) for i in range(files)]


def read_report(label: str, files, rows: int, seconds: float, took: dict) -> None:
    """One line for a read: rows, file bytes, wall, rows/s and the path it
    took (``READ_PATHS`` counts added)."""
    import os

    size = sum(os.path.getsize(f) for f in files)
    log(f"  read {label}: {rows} rows, {size / 1e6:.1f} MB of files, {seconds:.3f} s wall, "
        f"{rows / max(seconds, 1e-9):.4e} rows/s, path {dict(took) or 'none'}")


def read_paths_since(snap: dict) -> dict:
    """The reads of ``read_merged`` by path since ``snap`` (a copy of
    ``READ_PATHS.counts``)."""
    from photon_tpu_torch.io.data_reader import READ_PATHS

    return {k: v - snap.get(k, 0) for k, v in READ_PATHS.counts.items() if v != snap.get(k, 0)}


@contextlib.contextmanager
def reads_to_finalize():
    """Yields a dict that gets "reads": the host reads (``HOST_READS``) from
    entry up to the run report's first collection, the driver's finalize."""
    from photon_tpu_torch.obs import report
    from photon_tpu_torch.optim.common import HOST_READS

    real, box, start = report.collect_run_records, {}, HOST_READS.count

    def counting(*args, **kwargs):
        box.setdefault("reads", HOST_READS.count - start)
        return real(*args, **kwargs)

    report.collect_run_records = counting
    try:
        yield box
    finally:
        report.collect_run_records = real


def game_drivers_phase(dev, smi: str, check) -> tuple:
    """Phase 8: the GAME drivers end to end on files: feature_indexing,
    game_training and game_scoring, as a user calls them. Returns the kernel
    launches of that run (K3's by width under "newton_system_d<d>"), and the
    work directory, files and shard flags phase 11b trains on."""
    from photon_tpu_torch.algorithm.solve_cache import default_cache
    from photon_tpu_torch.cli import feature_indexing, game_scoring, game_training
    from photon_tpu_torch.cli.common import parse_feature_shard_config
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.io.data_reader import READ_PATHS, read_merged
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.io.scores import load_scores
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.optim.common import HOST_READS
    from photon_tpu_torch.utils.timed import Timed

    log("## phase 8: GAME drivers (feature_indexing, game_training, game_scoring)")
    log(f"  {H_TRAIN_ROWS} training rows in {H_TRAIN_FILES} files (phase 7: 2^21), {H_VALID_ROWS} validation rows "
        f"in {H_VALID_FILES}, {H_USERS} users, {H_ITEMS} Zipf-like items; widths d = {D_FIX}, {D_RE}, {G_D_ITEM}; "
        f"feature_indexing on a file of {H_INDEX_ROWS} rows of the same bags")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_game_drivers"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    train_files = _split(work / "train", H_TRAIN_ROWS, H_TRAIN_FILES)
    valid_files = _split(work / "valid", H_VALID_ROWS, H_VALID_FILES)
    paths = {"index": str(work / "index.avro"), "small": str(work / "small.avro")}
    jobs = ([("game", f, n, 8100 + i) for i, (f, n) in enumerate(train_files)]
            + [("game", f, n, 8200 + i) for i, (f, n) in enumerate(valid_files)]
            + [("game", paths["index"], H_INDEX_ROWS, 84),
               ("game", paths["small"], H_SMALL_ROWS, 83, H_SMALL_ENTITIES, H_SMALL_ENTITIES)]
            # Phase 17's delta, in the pool's idle second wave.
            + [("delta", f, n, STREAM_DELTA_SEED + i, STREAM_USERS, H_ITEMS)
               for i, (f, n) in enumerate(_split(work / "stream-delta", STREAM_DELTA_ROWS, STREAM_DELTA_FILES))])
    log("  " + write_files(jobs))
    train_paths, valid_paths = [f for f, _ in train_files], [f for f, _ in valid_files]
    train_dir, valid_dir = str(work / "train"), str(work / "valid")
    shards = ["--feature-shard-configurations"] + [f"name={shard},feature.bags={bag}" for bag, shard, _ in H_BAGS]
    coords = ["--coordinate-configurations",
              "name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=1|10",
              "name=perUser,feature.shard=userShard,random.effect.type=userId,reg.weights=1",
              "name=perItem,feature.shard=itemShard,random.effect.type=itemId,reg.weights=1",
              "--update-sequence", "global,perUser,perItem", "--coordinate-descent-iterations", "2",
              "--re-active-set", "--evaluators", "AUC", "--variance-computation", "SIMPLE"]
    out, idx, scored = work / "out", work / "index", work / "scores"

    def stages(label, wall, reads, counts0=None):
        """``counts0`` None: a driver that reset the shared cache's counters
        at its entry (``begin_run``), whose counts are the counters now."""
        by_stage = ", ".join(f"{k[len('driver/'):]} {v:.2f} s" for k, v in Timed.records.items()
                             if k.startswith("driver/"))
        counts = default_cache().stats.counts() if counts0 is None else default_cache().stats.since(counts0)
        log(f"  {label}: {wall:.2f} s wall, {reads} host reads" + (f"; by stage {by_stage}" if by_stage else "")
            + f"; {cache_text(counts)}; {peak_text()}")
        torch.cuda.reset_peak_memory_stats()

    # The main path, counted: the three drivers, in the order a user runs them.
    built0 = cache_setup("8 drivers")
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    Timed.reset()
    torch.cuda.reset_peak_memory_stats()
    counts0, t0 = default_cache().stats.counts(), time.perf_counter()
    sizes = feature_indexing.main(["--input-paths", paths["index"], "--output-dir", str(idx)] + shards)
    stages(f"feature_indexing {sizes}", time.perf_counter() - t0, 0, counts0)
    Timed.reset()
    snap = dict(READ_PATHS.counts)
    reads0, t0 = HOST_READS.count, time.perf_counter()
    EVENTS.clear()
    with reads_to_finalize() as until_finalize:
        summary = game_training.main(["--input-paths", train_dir, "--validation-paths", valid_dir,
                                      "--output-dir", str(out), "--feature-index-dir", str(idx), "--device", "cuda",
                                      "--event-listener", f"{__name__}:record_event"] + shards + coords)
    train_events = list(EVENTS)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    stages("game_training", train_wall, HOST_READS.count - reads0)
    took_train = read_paths_since(snap)
    # (The driver's two reads share one count of paths.)
    read_report("8 game_training training set", train_paths, H_TRAIN_ROWS, Timed.records["driver/read-train"],
                took_train)
    read_report("8 game_training validation set", valid_paths, H_VALID_ROWS,
                Timed.records["driver/read-validation"], took_train)
    cache_entries(built0)
    trained = dict(kernels.LAUNCHES, by_width=dict(fused_newton.LAUNCHES_BY_WIDTH))
    Timed.reset()
    snap = dict(READ_PATHS.counts)
    reads0, t0 = HOST_READS.count, time.perf_counter()
    result = game_scoring.main(["--input-paths", valid_dir, "--output-dir", str(scored), "--model-input-dir",
                                str(out / "best"), "--evaluators", "AUC", "--device", "cuda"] + shards)
    torch.cuda.synchronize()
    stages("game_scoring", time.perf_counter() - t0, HOST_READS.count - reads0)
    took_score = read_paths_since(snap)
    read_report("8 game_scoring", valid_paths, H_VALID_ROWS, Timed.records["driver/read"], took_score)
    launches = launch_counts()
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    log(f"  launches: training {trained}; all three drivers {launches}")
    check(took_train == {"columnar": 2} and took_score == {"columnar": 1},
          f"8 every read of game_training ({took_train}) and game_scoring ({took_score}) took the columnar path")

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
    valid, _, _ = read_merged(valid_paths, shard_cfgs, imaps, {"userId": "userId", "itemId": "itemId"},
                              eidx, intern_new_entities=False, device=dev)
    want = model.score_with_offset(valid).double().cpu()
    got = torch.tensor([r["predictionScore"] for r in load_scores(str(scored / "scores.avro"))], dtype=torch.float64)
    _, r = rel_err(got, want)
    check(got.shape == want.shape and r <= 1e-5,
          f"8 scores.avro vs GameModel.score_with_offset of best/ loaded back: rel {r:.3e} (tolerance 1e-5)")
    check(abs(result["metrics"]["AUC"] - best_auc) <= 1e-5,
          f"8 scoring AUC {result['metrics']['AUC']:.6f} = training summary's best {best_auc:.6f} (tolerance 1e-5)")

    # The columnar read against the row read of one file (not counted): the
    # small file, as the row codec reads ~500 rows/s.
    for use_columnar in (True, False):
        torch.cuda.synchronize()
        snap, t0 = dict(READ_PATHS.counts), time.perf_counter()
        read_merged([paths["small"]], shard_cfgs, imaps, {"userId": "userId", "itemId": "itemId"}, eidx,
                    intern_new_entities=False, use_columnar=use_columnar, device=dev)
        torch.cuda.synchronize()
        read_report(f"8 side by side, use_columnar={use_columnar}", [paths["small"]], H_SMALL_ROWS,
                    time.perf_counter() - t0, read_paths_since(snap))

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
    return launches, dict(work=work, train=train_dir, valid=valid_dir, index=idx, out=out, scores=scored,
                          delta=str(work / "stream-delta"),
                          shards=shards, coords=coords, events=train_events, train_paths=train_paths,
                          training=dict(wall=train_wall, reads=until_finalize["reads"], launches=trained))


def _sparse_wide_data(seed: int = SP_SEED, n: int = 0, d: int = 0):
    """bench_configs.py::_sparse_wide_data (:474-483), its sizes as
    arguments (0: config 6's): (indices (n, k) int32, values (n, k) f32,
    labels 0/1) of a planted logistic model, column 0 the intercept."""
    n, d, k = n or SP_N, d or SP_D, SP_K
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    idx[:, 0] = 0  # intercept slot: feature 0, value 1
    vals[:, 0] = 1.0
    w_true = (rng.normal(size=d) / 8.0).astype(np.float32)
    z = np.sum(vals * w_true[idx], axis=1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return idx, vals, y


def sparse_wide_phase(dev, smi: str, check) -> dict:
    """Phase 10a: config 6 at full width, its four rmatvec variants (scatter
    or segment sum, f32 or bf16 values), each eagerly and through the solve
    cache (captured): per variant the wall (best of 3 after a warm-up, as at
    bench_configs.py:540-551), X passes, samples/s, nnz GB/s, host reads,
    captures, the bytes bound, and the run-to-run spread of the objective
    and iteration count over three solves from zero. Fails unless the
    segment sum's captured solve is its eager one bit for bit, its f32 and
    bf16 solves agree at convergence (1e-4 relative), the scatter's Xᵀ·r
    matches the segment sum's at full size (PARITY_TOL), a cut copy matches
    the float64 plain path on the CPU (REFERENCE_TOL) and the λ sweep's
    lanes match four single solves' objectives at convergence (1e-4); the
    scatter's solves to convergence are measured. Returns the
    measurements."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures, default_transpose_plan
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
    from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
    from photon_tpu_torch.optim.margin_lbfgs import sweep_l2_lbfgs_margin

    log(f"## phase 10a: sparse wide fixed effect (bench_configs.py config 6, not cut: n = 2^{SP_N.bit_length() - 1}, "
        f"d = 2^{SP_D.bit_length() - 1}, {SP_K} nnz a row, logistic, l2 = 1, margin L-BFGS, {SP_ITERS} iterations; "
        f"card {smi})")
    t0 = time.perf_counter()
    idx, vals, y = _sparse_wide_data()
    log(f"  data (numpy, seed {SP_SEED}): {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    idx_d, vals_d, y_d = (torch.as_tensor(a, device=dev) for a in (idx, vals, y))
    plain = SparseFeatures(idx_d, vals_d, SP_D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planned = plain.with_transpose_plan()
    torch.cuda.synchronize()
    log(f"  transpose plan (stable sort of {SP_N * SP_K} indices on the card): {time.perf_counter() - t0:.3f} s")
    vals_b = vals_d.to(torch.bfloat16)
    variants = {"scatter": plain, "segsum": planned, "scatter_bf16": SparseFeatures(idx_d, vals_b, SP_D),
                "segsum_bf16": SparseFeatures(idx_d, vals_b, SP_D, planned.csc_order, planned.csc_segments)}
    obj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0)
    spec = OptimizerSpec(max_iter=SP_ITERS, track_history=False)
    nnz = SP_N * SP_K
    out, finals = {}, {}
    for name, X in variants.items():
        batch = LabeledBatch(y_d, X)
        pass_bytes = nnz * (idx_d.element_size() + X.values.element_size())
        pass_bound_ms = pass_bytes / HBM_BYTES_PER_S * 1e3
        for mode in ("eager", "captured"):
            cache = SolveCache()
            solve = cache.fe_solver(obj, spec) if mode == "captured" else make_optimizer(obj, spec)
            runs = []
            for rep, start in enumerate((0.0, 1e-6, 2e-6, 3e-6, 0.0, 0.0)):
                w0 = torch.full((SP_D,), start, device=dev)
                torch.cuda.synchronize()
                r0, c0, t0 = HOST_READS.count, cache.stats.counts(), time.perf_counter()
                res = solve(w0, batch)
                torch.cuda.synchronize()
                runs.append(dict(wall=time.perf_counter() - t0, reads=HOST_READS.count - r0,
                                 captures=cache.stats.since(c0)["captures"], passes=int(res.x_passes),
                                 value=float(res.value), it=int(res.iterations), res=res if rep == 0 else None))
            timed = runs[1:4]  # the warm-up first, then 3 (bench_configs.py's starts), then 2 more from zero
            best = min(timed, key=lambda r: r["wall"])
            from_zero = [runs[0], runs[4], runs[5]]
            values = [r["value"] for r in from_zero]
            spread = (max(values) - min(values)) / abs(np.mean(values))
            its = sorted({r["it"] for r in from_zero})
            bound_ms = best["passes"] * pass_bound_ms
            m = dict(wall_s=best["wall"], x_passes=best["passes"], reads=best["reads"],
                     captures=sum(r["captures"] for r in runs), samples_per_s=SP_N * best["passes"] / best["wall"],
                     nnz_gbps=best["passes"] * pass_bytes / best["wall"] / 1e9, bound_ms=bound_ms,
                     walls=[r["wall"] for r in timed], objective=values[0], objective_spread=spread, iterations=its)
            out[f"{name}_{mode}"] = m
            finals[(name, mode)] = runs[0]["res"]
            log(f"  {name} {mode}: wall {m['wall_s']:.4f} s (best of {', '.join(f'{w:.4f}' for w in m['walls'])}), "
                f"{m['x_passes']} X passes, {m['samples_per_s']:.4e} samples/s, {m['nnz_gbps']:.1f} GB/s of indices "
                f"and values, {m['reads']} host reads a solve, {m['captures']} captures; bytes bound "
                f"{bound_ms:.3f} ms ({pass_bytes / 2 ** 20:.0f} MiB a pass over {HBM_BYTES_PER_S / 1e12} TB/s) = "
                f"{bound_ms / 1e3 / m['wall_s']:.2%} of the wall; objective {values[0]:.8e}, run-to-run spread "
                f"{spread:.3e} relative over 3 solves from zero, iterations {its}")
            del cache, solve
    log(f"  peak memory of 10a's solves: {peak_text()}")
    fastest = min(("scatter", "segsum"), key=lambda v: out[f"{v}_captured"]["wall_s"])
    log(f"  the faster f32 lowering, captured: {fastest} (default on this device: "
        f"{'segsum' if default_transpose_plan(dev) else 'scatter'})")

    # The segment sum sums in one order: captured is eager bit for bit.
    for name in ("segsum", "segsum_bf16"):
        e, c = finals[(name, "eager")], finals[(name, "captured")]
        check(int(c.iterations) == int(e.iterations) and torch.equal(c.w, e.w),
              f"10a {name}: captured vs eager on the card after {SP_ITERS} iterations: iterations equal "
              f"({int(c.iterations)}), coefficients bitwise equal")
    # Where two scatter solves from zero part: their loss histories.
    hist = [make_optimizer(obj, dataclasses.replace(spec, track_history=True))(
        torch.zeros(SP_D, device=dev), LabeledBatch(y_d, plain)).loss_history.cpu() for _ in range(2)]
    apart = torch.nonzero(hist[0] != hist[1])
    log(f"  two eager scatter solves from zero: loss histories bitwise equal through iteration "
        f"{int(apart[0]) - 1 if apart.numel() else SP_ITERS}; at iteration {SP_ITERS} {float(hist[0][-1]):.8e} and "
        f"{float(hist[1][-1]):.8e}")
    # Agreement on solves run to convergence (SP_CONVERGED_TOL: until a line
    # search no longer changes the f32 objective). After config 6's 30
    # iterations a solve is far from its optimum and its path follows the
    # summation order. The segment sum sums in one order: its f32 and bf16
    # solves are held to one another at 1e-4. The scatter's float atomics
    # change the gradient's last bits from run to run, and where its f32
    # solve stalls moves with them (8.9e-5 off the segment sum's in one of
    # PERF.md §6's runs), so its solves to convergence are measured, not held;
    # the scatter lowering is held by its products on the same inputs below,
    # and by its captured solve of the cut copy against the CPU.
    conv_spec = dataclasses.replace(spec, max_iter=SP_CONVERGED, tol=SP_CONVERGED_TOL)
    conv = {}
    for name, X in variants.items():
        for mode in ("eager", "captured") if "scatter" in name else ("captured",):
            solve = SolveCache().fe_solver(obj, conv_spec) if mode == "captured" else make_optimizer(obj, conv_spec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = conv[(name, mode)] = solve(torch.zeros(SP_D, device=dev), LabeledBatch(y_d, X))
            torch.cuda.synchronize()
            log(f"  {name} {mode} to convergence: {int(res.iterations)} iterations, {res.convergence_reason.value}, "
                f"objective {float(res.value):.8e}, {time.perf_counter() - t0:.3f} s")
    optimum = conv[("segsum", "captured")]
    off = {k: abs(float(r.value) - float(optimum.value)) / abs(float(optimum.value)) for k, r in conv.items()}
    check(off[("segsum_bf16", "captured")] <= 1e-4,
          f"10a the segment sum's solves at convergence, f32 and bf16 values: objectives rel "
          f"{off[('segsum_bf16', 'captured')]:.3e} (tolerance 1e-4)")
    log(f"  the scatter's solves at convergence, off the segment sum's objective (measured, not held): "
        + ", ".join(f"{n} {m} {v:.3e}" for (n, m), v in off.items() if "scatter" in n))
    # The scatter lowering at full size: Xᵀ·r with r the logistic residual at
    # the segment sum's solution, against the segment sum's on the same r,
    # for f32 and bf16 values. Both sum the same terms in f32 in different
    # orders; at a solution the sums cancel (the intercept's 2^20 terms sum
    # to about -w₀), so a column's difference is taken relative to the sum
    # of its terms' magnitudes, |X|ᵀ·|r| (in float64).
    r_star = torch.sigmoid(plain.matvec(optimum.w)) - y_d
    for a, b in (("scatter", "segsum"), ("scatter_bf16", "segsum_bf16")):
        Xb = variants[b]
        scale = SparseFeatures(idx_d, Xb.values.double().abs(), SP_D, Xb.csc_order, Xb.csc_segments).rmatvec(
            r_star.double().abs())
        diff = (variants[a].rmatvec(r_star).double() - Xb.rmatvec(r_star).double()).abs()
        rel = float((diff / scale.clamp(min=1e-30)).max())
        check(rel <= PARITY_TOL, f"10a {a} vs {b}: Xᵀ·r at the segment sum's solution (n = d = "
                                 f"2^{SP_N.bit_length() - 1}): max abs {float(diff.max()):.3e}, max over columns "
                                 f"of |difference| / (|X|ᵀ·|r|) {rel:.3e} (tolerance {PARITY_TOL:g})")
    del variants, plain, vals_b, finals, conv

    # The cut copy, n = d = SP_CUT: the card (f32, both lowerings) against the
    # float64 plain path on the CPU, margins relative to max |margin|.
    ci, cv, cy = _sparse_wide_data(n=SP_CUT, d=SP_CUT)
    cut = {dt: LabeledBatch(torch.as_tensor(cy, device=d_, dtype=dt),
                            SparseFeatures(torch.as_tensor(ci, device=d_), torch.as_tensor(cv, device=d_, dtype=dt),
                                           SP_CUT))
           for dt, d_ in ((torch.float32, dev), (torch.float64, "cpu"))}
    ref = make_optimizer(obj, spec)(torch.zeros(SP_CUT, dtype=torch.float64), cut[torch.float64])
    want = cut[torch.float64].margins(ref.w)
    X = cut[torch.float32].features
    lb = LabeledBatch(cut[torch.float32].label, X.with_transpose_plan())
    got = SolveCache().fe_solver(obj, spec)(torch.zeros(SP_CUT, device=dev), lb)
    _, r = rel_err(lb.margins(got.w).cpu(), want)
    check(r <= REFERENCE_TOL, f"10a cut copy (n = d = {SP_CUT}, segsum) captured on the card (f32) vs float64 plain "
                              f"path on the CPU: margins rel {r:.3e} (tolerance {REFERENCE_TOL:g})")
    lb = LabeledBatch(cut[torch.float32].label, X)
    got = SolveCache().fe_solver(obj, spec)(torch.zeros(SP_CUT, device=dev), lb)
    ok, text = cut_scatter_verdict(obj, spec, cut[torch.float64], ref, lb, got)
    check(ok, text)

    # The λ sweep over the same data, run to convergence: one program, a
    # lane a weight, against four single solves.
    batch = LabeledBatch(y_d, planned if default_transpose_plan(dev) else SparseFeatures(idx_d, vals_d, SP_D))
    cfg = OptimizerConfig(max_iter=SP_CONVERGED, tol=SP_CONVERGED_TOL, track_history=False)
    spec = conv_spec
    torch.cuda.synchronize()
    r0, t0 = HOST_READS.count, time.perf_counter()
    sweep = sweep_l2_lbfgs_margin(obj, batch, torch.zeros(len(SP_LAMBDAS), SP_D, device=dev), SP_LAMBDAS, cfg)
    torch.cuda.synchronize()
    sweep_s, sweep_reads = time.perf_counter() - t0, HOST_READS.count - r0
    t0 = time.perf_counter()
    singles = [make_optimizer(obj.with_l2(lam), spec)(torch.zeros(SP_D, device=dev), batch) for lam in SP_LAMBDAS]
    torch.cuda.synchronize()
    singles_s = time.perf_counter() - t0
    log(f"  sweep over λ = {SP_LAMBDAS}: {sweep_s:.3f} s, {sweep_reads} host reads, iterations "
        f"{sweep.iterations.tolist()}; four single solves {singles_s:.3f} s, iterations "
        f"{[int(s.iterations) for s in singles]}; {peak_text()}")
    # Held on the objective: an f32 solve stops on a plateau where the
    # objective agrees to 1e-4 but w, along flat directions, does not (the
    # margins' difference is logged).
    for i, (lam, one) in enumerate(zip(SP_LAMBDAS, singles)):
        _, r = rel_err(batch.margins(sweep.w[i]), batch.margins(one.w))
        dv = abs(float(sweep.value[i]) - float(one.value)) / abs(float(one.value))
        check(dv <= 1e-4, f"10a sweep lane λ={lam:g} vs its single solve at convergence: objective rel {dv:.3e} "
                          f"(tolerance 1e-4); margins rel {r:.3e}")
    out.update(sweep_s=sweep_s, singles_s=singles_s, fastest=fastest)
    return out


def cut_scatter_verdict(obj, spec, cut64, ref, lb, got) -> tuple:
    """10a's check of the cut copy's captured f32 scatter solve ``got`` (on
    ``lb``) against the CPU float64 plain path (``ref``: ``spec``'s
    iterations on ``cut64``). The scatter's float atomics decide 1-ulp
    line-search ties, so where the f32 solve stops moves run to run: it is
    held step for step, against the float64 path run for exactly its k
    iterations: the margins relative to max |margin| (REFERENCE_TOL), the
    objective within CUT_OBJECTIVE_TOL relative; its stop reason must be a
    convergence or the iteration limit. Returns (passed, text); the text also
    gives the endpoint checks this replaced (margins and objective against
    ``ref``'s after all its iterations)."""
    from photon_tpu_torch.optim.factory import make_optimizer
    from photon_tpu_torch.types import ConvergenceReason

    k, reason = int(got.iterations), got.convergence_reason
    same_k = make_optimizer(obj, dataclasses.replace(spec, max_iter=k))(torch.zeros_like(ref.w), cut64)
    _, r = rel_err(lb.margins(got.w).cpu(), cut64.margins(same_k.w))
    _, r_old = rel_err(lb.margins(got.w).cpu(), cut64.margins(ref.w))
    off = abs(float(got.value) - float(same_k.value)) / abs(float(same_k.value))
    off_old = abs(float(got.value) - float(ref.value)) / abs(float(ref.value))
    stopped = reason in (ConvergenceReason.MAX_ITERATIONS, ConvergenceReason.FUNCTION_VALUES_CONVERGED,
                         ConvergenceReason.GRADIENT_CONVERGED)
    ok = r <= REFERENCE_TOL and stopped and off <= CUT_OBJECTIVE_TOL
    return ok, (f"10a cut copy (n = d = {SP_CUT}, scatter) captured on the card (f32), {k} iterations, "
                f"{reason.value}: margins vs the float64 plain path run {k} iterations rel {r:.3e} (tolerance "
                f"{REFERENCE_TOL:g}), objective rel {off:.3e} (tolerance {CUT_OBJECTIVE_TOL:g}); the replaced "
                f"endpoint checks against the float64 path's after {int(ref.iterations)}: margins {r_old:.3e} "
                f"({'pass' if r_old <= REFERENCE_TOL else 'FAIL'}), objective {off_old:.3e} "
                f"({'pass' if off_old <= CUT_OBJECTIVE_TOL else 'FAIL'})")


def sparse_game_phase(dev, smi: str, check, train, valid) -> dict:
    """Phase 10b: phase 7b's model, data and widths with the fixed-effect
    shard replaced by config 6's layout over its N = 2^21 rows (d = 2^20, 64
    nnz a row, the transpose plan by ``default_transpose_plan``; validation
    likewise), labels planted anew over it; per user (d = 16) and per item
    (d = 128) dense, on K3. Two passes with the active set, then a
    fixed-only fit and one profiled pass. Fails unless _fit_passes' checks
    hold, GLMix reaches the fixed-only AUC, K3 runs at both widths and K1
    never (the reference never fuses sparse). Returns the launches."""
    from photon_tpu_torch.data.batch import SparseFeatures, default_transpose_plan
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec

    log(f"## phase 10b: GAME with a sparse fixed-effect shard (d = 2^{SP_D.bit_length() - 1}, {SP_K} nnz a row over "
        f"phase 7's N = {train.n} rows) beside its per-user (d = {D_RE}) and per-item (d = {G_D_ITEM}) effects; "
        f"card {smi}")
    g = torch.Generator(device=dev).manual_seed(10)
    plan = default_transpose_plan(dev)

    def sparse_rows(n):
        idx = torch.randint(0, SP_D, (n, SP_K), device=dev, generator=g, dtype=torch.int32)
        vals = torch.randn(n, SP_K, device=dev, generator=g)
        idx[:, 0], vals[:, 0] = 0, 1.0
        X = SparseFeatures(idx, vals, SP_D)
        return X.with_transpose_plan() if plan else X

    t0 = time.perf_counter()
    n_users = int(train.entity_ids["userId"].max()) + 1
    w_fe = torch.randn(SP_D, device=dev, generator=g) / 8.0
    W_u = torch.randn(n_users, D_RE, device=dev, generator=g) * 0.5
    W_i = torch.randn(G_ITEMS, G_D_ITEM, device=dev, generator=g) * 0.1
    batches = []
    for b in (train, valid):
        batches.append(_game_batch(dev, sparse_rows(b.n), b.features["user"], b.entity_ids["userId"],
                                   b.features["item"], b.entity_ids["itemId"], w_fe, W_u, W_i, g))
    train_s, valid_s = batches
    torch.cuda.synchronize()
    log(f"  data {time.perf_counter() - t0:.1f} s: fixed-effect shard {SP_K} nnz a row, "
        f"{'segment-sum plan' if plan else 'scatter'}; validation {valid_s.n} rows")
    est, reg = _game_estimator(n_users, G_ITEMS, G_ITEM_CAP, G_PASSES)
    out = _fit_passes("10b", est, reg, train_s, valid_s, check, smi)
    launches = out["launches"]
    check(launches.get("fused_value_grad", 0) == 0 and launches.get(f"newton_system_d{D_RE}", 0) > 0
          and launches.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          f"10b: K3 at d = {D_RE} and d = {G_D_ITEM}, and no K1 (a sparse fixed effect never fuses): {launches}")
    fe_est, fe_reg = _game_estimator(n_users, G_ITEMS, G_ITEM_CAP, 1, fixed_only=True)
    (fe_res,) = fe_est.fit(train_s, validation_batch=valid_s, evaluation_suite=EvaluationSuite(
        [EvaluatorSpec.parse("AUC")]), optimization_configs=[fe_reg])
    fe_auc = fe_res.metrics["AUC"]
    check(out["auc"] >= fe_auc, f"10b GLMix validation AUC {out['auc']:.4f} >= fixed-only {fe_auc:.4f}")
    est.num_iterations = 1
    profiled("10b GAME pass from the trained model, profiled",
             lambda: est.fit(train_s, optimization_configs=[reg], initial_model=out["res"].model))
    return launches


def _sparse_planted():
    """10c's planted global weights and the features boxed by its
    constraints: the 4 strongest of the 100 most frequent."""
    w = np.random.default_rng(100).normal(size=S_COLUMNS) * 0.5
    return w, np.argsort(-np.abs(w[:100]))[:4]


def _sparse_driver_records(n: int, seed: int):
    """TrainingExampleAvro rows of 10c: S_NNZ global features ("f<j>") of
    S_COLUMNS, feature j drawn with frequency ∝ 1 / (j + 1) (a wide shard's
    few common and many rare features), and S_USER_NNZ of the user's own
    S_USER_WINDOW user features ("u<user>_<j>", bag userFeatures), the user
    in metadataMap; labels planted from a fixed and a per-user effect (the
    model from one seed, the rows from ``seed``)."""
    model = np.random.default_rng(100)
    w, _ = _sparse_planted()
    W_u = model.normal(size=(S_USERS, S_USER_WINDOW)) * 0.5
    b_u = model.normal(size=S_USERS) * 0.5
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, S_COLUMNS + 1)
    cols = rng.choice(S_COLUMNS, size=(n, S_NNZ), p=p / p.sum())
    vals = rng.normal(size=(n, S_NNZ))
    users = rng.integers(0, S_USERS, size=n)
    ucols = np.argsort(rng.random((n, S_USER_WINDOW)), axis=1)[:, :S_USER_NNZ]
    uvals = rng.normal(size=(n, S_USER_NNZ))
    logits = (np.sum(vals * w[cols], axis=1) * 2.0 / np.sqrt(S_NNZ)
              + np.sum(uvals * W_u[users[:, None], ucols], axis=1) + b_u[users])
    y = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))
    return ({"uid": str(i), "label": float(y[i]), "weight": None, "offset": None,
             "metadataMap": {"userId": f"user{users[i]}"},
             "features": [{"name": f"f{c}", "term": "", "value": float(v)} for c, v in zip(cols[i], vals[i])],
             "userFeatures": [{"name": f"u{users[i]}_{c}", "term": "", "value": float(v)}
                              for c, v in zip(ucols[i], uvals[i])]}
            for i in range(n))


def sparse_drivers_phase(dev, smi: str, check) -> None:
    """Phase 10c: the drivers on Avro files wider than the reader's dense
    limit: train_glm with --constraint-string and --summarization-output-dir
    (L-BFGS under the box), and ELASTIC_NET; game_training with
    --coordinate-constraints over a sparse global shard and a sparse
    per-user shard (projected blocks); game_scoring of that model; and
    name_and_term_bags on the training file."""
    from photon_tpu_torch.cli import game_scoring, game_training, name_and_term_bags, train_glm
    from photon_tpu_torch.cli.common import parse_feature_shard_config
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.evaluation.metrics_map import AREA_UNDER_ROC
    from photon_tpu_torch.io import columnar
    from photon_tpu_torch.io.avro import read_avro_records
    from photon_tpu_torch.io.data_reader import READ_PATHS, read_merged
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.io.scores import load_scores
    from photon_tpu_torch.optim.common import HOST_READS
    from photon_tpu_torch.utils.timed import Timed

    log(f"## phase 10c: drivers on sparse Avro files: {S_TRAIN_ROWS} training rows in {S_TRAIN_FILES} files and "
        f"{S_VALID_ROWS} validation rows, {S_COLUMNS} global columns, {S_NNZ} a row (config 6: 2^20 rows of 2^20 "
        f"columns, 64 a row); {S_USERS} users of {S_USER_WINDOW} user features each, {S_USER_NNZ} a row; "
        f"name_and_term_bags on a file of {S_CUT_ROWS} rows")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_sparse_drivers"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    train_files = _split(work / "train", S_TRAIN_ROWS, S_TRAIN_FILES)
    valid_files = _split(work / "valid", S_VALID_ROWS, S_VALID_FILES)
    cut = str(work / "cut.avro")
    log("  " + write_files([("sparse", f, n, 1010 + i) for i, (f, n) in enumerate(train_files)]
                           + [("sparse", f, n, 1020 + i) for i, (f, n) in enumerate(valid_files)]
                           + [("sparse", cut, S_CUT_ROWS, 103)]))
    paths = {"train": str(work / "train"), "valid": str(work / "valid")}
    files = {"train": [f for f, _ in train_files], "valid": [f for f, _ in valid_files]}
    device = dev.type
    snap0 = dict(READ_PATHS.counts)
    torch.cuda.reset_peak_memory_stats()
    # Common features of strong planted weights, boxed to ±0.01.
    _, strongest = _sparse_planted()
    box = [{"name": f"f{j}", "term": "", "lowerBound": -0.01, "upperBound": 0.01} for j in strongest]

    def run(label, fn, argv):
        Timed.reset()
        snap, reads0, t0 = dict(READ_PATHS.counts), HOST_READS.count, time.perf_counter()
        result = fn(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        by_stage = ", ".join(f"{k[len('driver/'):]} {v:.2f} s" for k, v in Timed.records.items()
                             if k.startswith("driver/"))
        log(f"  {label}: {time.perf_counter() - t0:.2f} s wall, {HOST_READS.count - reads0} host reads"
            + (f"; by stage {by_stage}" if by_stage else "") + f"; {peak_text()}")
        took = read_paths_since(snap)
        for stage, key, rows in (("driver/read-train", "train", S_TRAIN_ROWS),
                                 ("driver/read-validation", "valid", S_VALID_ROWS),
                                 ("driver/read", "valid", S_VALID_ROWS)):
            if stage in Timed.records:
                read_report(f"10c {label} {stage[len('driver/'):]}", files[key], rows, Timed.records[stage], took)
        torch.cuda.reset_peak_memory_stats()
        return result

    # train_glm: L-BFGS under the constraint box, with the summary; ELASTIC_NET.
    summ = work / "summary"
    nonzero = {}
    for label, extra in (("LBFGS + --constraint-string", ["--constraint-string", json.dumps(box),
                                                          "--summarization-output-dir", str(summ)]),
                         ("ELASTIC_NET α = 0.5", ["--regularization-type", "ELASTIC_NET",
                                                  "--elastic-net-alpha", "0.5"])):
        out = work / f"glm-{len(extra)}"
        summary = run(f"train_glm {label}", train_glm.main,
                      ["--training-data", paths["train"], "--validation-data", paths["valid"], "--output-dir",
                       str(out), "--regularization-weights", "10,1", "--device", device] + extra)
        best = next(m for m in summary["models"] if m["lambda"] == summary["best_lambda"])
        auc = best["validation"][AREA_UNDER_ROC]
        text = {}
        with open(out / f"model-lambda-{summary['best_lambda']:g}.txt") as f:
            for line in f:
                if not line.startswith("#"):
                    key, value = line.rstrip("\n").split("\t")
                    text[key] = float(value)
        log(f"    best λ {summary['best_lambda']:g}, validation AUC {auc:.4f}; per λ "
            + ", ".join(f"{m['lambda']:g}: {m['iterations']} it {m['reason']}" for m in summary["models"])
            + f"; {len(text)} nonzero coefficients written")
        nonzero[label] = len(text)
        check(auc > 0.55 and (out / "best" / "model-metadata.json").exists(),
              f"10c train_glm {label}: best/ written, validation AUC {auc:.4f} > 0.55")
        if "--constraint-string" in extra:
            boxed = [abs(text.get(f"f{j}", 0.0)) for j in strongest]
            check(max(boxed) <= 0.01 + 1e-6 and max(boxed) >= 0.0099,
                  f"10c train_glm: the boxed coefficients {[f'{b:.4f}' for b in boxed]} within ±0.01, binding")
            records = read_avro_records(str(summ / "part-00000.avro"))
            check(len(records) > 4096, f"10c --summarization-output-dir: {len(records)} feature summaries (> 4096)")
        else:
            dense = nonzero["LBFGS + --constraint-string"]
            check(len(text) < dense, f"10c train_glm ELASTIC_NET: {dense - len(text)} more coefficients exactly "
                                     f"zero than under L2")

    # game_training with --coordinate-constraints, then game_scoring.
    shards = ["--feature-shard-configurations", "name=globalShard,feature.bags=features",
              "name=userShard,feature.bags=userFeatures"]
    coords = ["--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1",
              "name=perUser,feature.shard=userShard,random.effect.type=userId,reg.weights=1",
              "--update-sequence", "global,perUser", "--coordinate-descent-iterations", "2", "--evaluators", "AUC",
              "--coordinate-constraints", json.dumps({"global": box})]
    out, scored = work / "game", work / "scores"
    summary = run("game_training", game_training.main,
                  ["--input-paths", paths["train"], "--validation-paths", paths["valid"], "--output-dir", str(out),
                   "--device", device] + shards + coords)
    imaps = {s: IndexMap.load(str(out / f"index-map-{s}.json")) for s in ("globalShard", "userShard")}
    eidx = {"userId": EntityIndex.load(str(out / "entity-index-userId.json"))}
    model = load_game_model(str(out / "best"), imaps, eidx, device=dev)
    w = model.models["global"].model.coefficients.means
    boxed = [abs(float(w[imaps["globalShard"].get_index(f"f{j}")])) for j in strongest]
    auc = summary["best"]["metrics"]["AUC"]
    log(f"    shard widths {[len(m) for m in imaps.values()]}; best {summary['best']['config']}: AUC {auc:.4f}")
    check(min(len(m) for m in imaps.values()) > 4096 and auc > 0.6 and max(boxed) <= 0.01 + 1e-6,
          f"10c game_training: both shards sparse (widths {[len(m) for m in imaps.values()]}), validation AUC "
          f"{auc:.4f} > 0.6, boxed coefficients within ±0.01 ({max(boxed):.4f})")
    result = run("game_scoring", game_scoring.main,
                 ["--input-paths", paths["valid"], "--output-dir", str(scored), "--model-input-dir", str(out / "best"),
                  "--evaluators", "AUC", "--device", device] + shards)
    shard_cfgs = {}
    for spec in shards[1:]:
        shard_cfgs.update(parse_feature_shard_config(spec))
    valid, _, _ = read_merged([paths["valid"]], shard_cfgs, imaps, {"userId": "userId"}, eidx,
                              intern_new_entities=False, device=dev)
    took = read_paths_since(snap0)
    check(took.get("rows", 0) == 0 and took.get("columnar", 0) == 8,
          f"10c every read of train_glm, game_training and game_scoring took the columnar path ({took})")
    check(all(isinstance(valid.features[s], SparseFeatures) for s in imaps),
          "10c the validation file reads back as two sparse shards")
    want = model.score_with_offset(valid).double().cpu()
    got = torch.tensor([r["predictionScore"] for r in load_scores(str(scored / "scores.avro"))], dtype=torch.float64)
    _, r = rel_err(got, want)
    # (The summary's AUC is the last pass's, best/ the best pass's: ROADMAP queue 3.)
    check(got.shape == want.shape and r <= 1e-5,
          f"10c game_scoring: scores.avro vs best/ scored in process rel {r:.3e} (tolerance 1e-5); scoring AUC "
          f"{result['metrics']['AUC']:.4f}")

    # The per-user coordinate in process: projected blocks of the sparse shard.
    from photon_tpu_torch.estimators import config as gconfig
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    train_b, _, _ = read_merged([paths["train"]], shard_cfgs, imaps, {"userId": "userId"}, eidx, device=dev)
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, [gconfig.RandomEffectCoordinateConfig(
        "perUser", "userId", "userShard")], num_entities={"userId": len(eidx["userId"])})
    est._prepare_datasets(train_b)
    ds = est._re_datasets["perUser"]
    log(f"    per-user projected blocks {[tuple(b.features.shape) for b in ds.blocks]}")
    check(ds.projected and all(b.dim < len(imaps["userShard"]) for b in ds.blocks),
          "10c the sparse per-user shard trains in projected blocks")

    counts = run("name_and_term_bags", lambda argv: name_and_term_bags.run(name_and_term_bags.build_parser()
                                                                              .parse_args(argv)),
                 ["--input-data-directories", cut, "--root-output-directory", str(work / "bags"),
                  "--feature-bags-keys", "features", "userFeatures"])
    decoded = columnar.read_avro_columnar([cut])
    distinct = {bag: len(np.unique(decoded.bags[bag].key_ids)) for bag in ("features", "userFeatures")}
    check(counts == distinct, f"10c name_and_term_bags on the {S_CUT_ROWS}-row file: {counts} distinct features, "
                              f"the columnar decode's {distinct}")
    shutil.rmtree(work, ignore_errors=True)


def _tuning_estimator(n_users: int, solve_cache=None):
    """The GLMix tuning setup of phase 11: the fixed effect over "global" and
    per-user effects over "user" (L-BFGS, Newton), λ = 1 each, two passes,
    validation AUC."""
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.types import TaskType

    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, [config.FixedEffectCoordinateConfig("global", "global"),
                                                       config.RandomEffectCoordinateConfig("per_user", "userId", "user")],
                        num_iterations=G_PASSES, intercept_indices={"global": 0, "user": 0},
                        num_entities={"userId": n_users}, solve_cache=solve_cache)
    base = config.GameOptimizationConfig({"global": config.RegularizationConfig(1.0),
                                          "per_user": config.RegularizationConfig(1.0)})
    return est, base, EvaluationSuite([EvaluatorSpec.parse("AUC")])


def tuning_phase(dev, smi: str, check, train, valid) -> dict:
    """Phase 11a: hyperparameter tuning in process on the GLMix headline rows
    (phase 7's batches: N = 2^21, d_fix = 256 bf16, per user d = 16 over
    E = 4096, logistic): for q in TUNING_Q, q candidates as batched lanes
    (two rounds: the first captures, the second replays) against the same q
    sequential fits; then a cut copy on the card against the CPU float64
    plain path. Returns the kernel launches of the lanes and fits."""
    from photon_tpu_torch.algorithm.solve_cache import default_cache
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.estimators.evaluation_function import GameEstimatorEvaluationFunction
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.optim.common import HOST_READS

    log("## phase 11a: hyperparameter tuning, q candidates as batched lanes vs q sequential fits")
    est, base, suite = _tuning_estimator(E)
    fn = GameEstimatorEvaluationFunction(est, base, train, valid, suite, True)
    t0 = time.perf_counter()
    lanes = fn._batched_evaluator()
    torch.cuda.synchronize()
    check(lanes is not None, "11a the GLMix headline setup is batchable (no decline)")
    blocks = [tuple(b.features.shape) for b in lanes.re.dataset.blocks]
    log(f"  lanes built in {time.perf_counter() - t0:.1f} s (random-effect blocks {blocks}); fixed effect X "
        f"{tuple(train.features['global'].shape)} {train.features['global'].dtype}; card {smi}")
    rng = np.random.default_rng(110)
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    for q in TUNING_Q:
        X = rng.uniform(-2.0, 2.0, size=(q, 2))
        rounds = []
        for r in (1, 2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts0, reads0, t0 = lanes.cache.stats.counts(), HOST_READS.count, time.perf_counter()
            rounds.append(fn.evaluate_batch(X))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            since = lanes.cache.stats.since(counts0)
            log(f"  11a q={q} batched round {r}: {wall:.3f} s wall, {HOST_READS.count - reads0} host reads, "
                f"{cache_text(since)}; {peak_text()}")
        check(since["captures"] == 0 and since["traces"] == 0 and since["replays"] > 0 and rounds[1] == rounds[0],
              f"11a q={q}: the second round replays ({since['replays']} replays) with no new capture and repeats "
              f"the first")
        profiled(f"11a q={q} batched round 3, profiled", lambda: fn.evaluate_batch(X))
        torch.cuda.reset_peak_memory_stats()
        counts0, reads0, t0 = default_cache().stats.counts(), HOST_READS.count, time.perf_counter()
        seq = [fn(x) for x in X]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  11a q={q} sequential fits: {wall:.3f} s wall, {HOST_READS.count - reads0} host reads, "
            f"{cache_text(default_cache().stats.since(counts0))}; {peak_text()}")
        diff = float(np.max(np.abs(np.array(rounds[0]) - np.array(seq))))
        log("    log10 λ (global, per_user) → AUC batched / sequential: " + "; ".join(
            f"({x[0]:+.3f}, {x[1]:+.3f}) {-b:.6f} / {-v:.6f}" for x, b, v in zip(X, rounds[0], seq)))
        check(bool(np.all(np.isfinite(rounds[0]))) and diff <= TUNING_TOL,
              f"11a q={q}: every lane's AUC finite and within {TUNING_TOL:g} of its sequential fit ({diff:.3e})")
    launches = launch_counts()
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    log(f"  11a launches {launches}")
    check(launches.get(f"newton_system_d{D_RE}", 0) > 0 and ran(launches, "fused_value_grad") > 0,
          f"11a launched K3 at d = {D_RE} (lanes and fits) and K1 (the sequential fits)")

    # A cut copy on the card against the CPU float64 plain path (not counted).
    cut = np.random.default_rng(111)
    n, e, d_fix = 1 << 14, 64, 32
    Xf, Xu = cut.normal(size=(n, d_fix)), cut.normal(size=(n, D_RE))
    Xf[:, 0] = Xu[:, 0] = 1.0
    users = cut.integers(0, e, size=n)
    logits = Xf @ cut.normal(size=d_fix) / d_fix ** 0.5 + np.sum(Xu * cut.normal(size=(e, D_RE))[users], 1) * 0.5
    y = cut.uniform(size=n) < 1 / (1 + np.exp(-logits))
    X = cut.uniform(-2.0, 2.0, size=(4, 2))
    out = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        def batch(sl):
            t = lambda a: torch.as_tensor(a[sl], device=device, dtype=dtype)  # noqa: E731
            m = y[sl].shape[0]
            return GameBatch(t(y), torch.zeros(m, device=device, dtype=dtype),
                             torch.ones(m, device=device, dtype=dtype), {"global": t(Xf), "user": t(Xu)},
                             {"userId": torch.as_tensor(users[sl], device=device, dtype=torch.int32)})

        est_c, base_c, suite_c = _tuning_estimator(e)
        fn_c = GameEstimatorEvaluationFunction(est_c, base_c, batch(slice(0, n // 2)), batch(slice(n // 2, None)),
                                               suite_c, True)
        out.append(fn_c.evaluate_batch(X))
    diff = float(np.max(np.abs(np.array(out[0]) - np.array(out[1]))))
    check(diff <= REFERENCE_TOL, f"11a cut copy (n={n}, d_fix={d_fix}, E={e}, 4 lanes) on the card vs the float64 "
                                 f"plain path on the CPU: AUC within {diff:.3e} (tolerance {REFERENCE_TOL:g})")
    return launches


def tuning_driver_phase(dev, smi: str, check, files: dict) -> dict:
    """Phase 11b: ``game_training --hyper-parameter-tuning BAYESIAN
    --hyper-parameter-batch-size 2 --output-mode TUNED`` on phase 8's files
    with the batchable two-coordinate configuration (global, perUser), then
    ``game_scoring`` of the TUNED model. Returns the kernel launches of the
    two drivers."""
    import logging

    from photon_tpu_torch.algorithm.solve_cache import default_cache
    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.io.data_reader import READ_PATHS
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.optim.common import HOST_READS
    from photon_tpu_torch.utils.timed import Timed

    log("## phase 11b: game_training --hyper-parameter-tuning BAYESIAN --output-mode TUNED, then game_scoring")
    work = files["work"]
    shards = ["--feature-shard-configurations", "name=globalShard,feature.bags=features",
              "name=userShard,feature.bags=userFeatures"]
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], "--output-dir", str(work / "tuned"),
            "--feature-index-dir", str(files["index"]), "--device", "cuda", *shards, "--coordinate-configurations",
            "name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=1|10",
            "name=perUser,feature.shard=userShard,random.effect.type=userId,reg.weights=1",
            "--update-sequence", "global,perUser", "--coordinate-descent-iterations", "2", "--evaluators", "AUC",
            "--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "4",
            "--hyper-parameter-batch-size", "2", "--output-mode", "TUNED"]
    declined = []

    class Declines(logging.Handler):
        def emit(self, record):
            if "declined" in record.getMessage():
                declined.append(record.getMessage())

    handler = Declines()
    logging.getLogger("photon_tpu_torch.estimators.batched_tuning").addHandler(handler)
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    Timed.reset()
    snap = dict(READ_PATHS.counts)
    reads0, t0 = HOST_READS.count, time.perf_counter()
    try:
        summary = game_training.main(argv)
    finally:
        logging.getLogger("photon_tpu_torch.estimators.batched_tuning").removeHandler(handler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_stage = ", ".join(f"{k[len('driver/'):]} {v:.2f} s" for k, v in Timed.records.items() if k.startswith("driver/"))
    # The driver's begin_run zeroed the shared cache's counters: they are its own.
    log(f"  game_training: {wall:.2f} s wall, {HOST_READS.count - reads0} host reads; by stage {by_stage}; "
        f"{cache_text(default_cache().stats.counts())}; {peak_text()}")
    records = json.loads((work / "tuned" / "hyperparameter-observations.json").read_text())["records"]
    for rec in records:
        log(f"    observed log10 λ global {rec['global.weight']:+.4f}, perUser {rec['perUser.weight']:+.4f}: "
            f"evaluation {rec['evaluationValue']:.6f}")
    check(not declined, f"11b the batched lanes ran (declines logged: {declined})")
    check(len(records) == 2 + 4 and all(np.isfinite(r["evaluationValue"]) for r in records),
          f"11b hyperparameter-observations.json holds the 2 grid points and the 4 candidates ({len(records)})")
    check(len(summary["tuned_configs"]) == 1 and (work / "tuned" / "best" / "model-metadata.json").exists(),
          f"11b TUNED saved the winner's sequential refit: {summary['best']['config']}, AUC "
          f"{summary['best']['metrics']['AUC']:.4f}")
    Timed.reset()
    t0 = time.perf_counter()
    result = game_scoring.main(["--input-paths", files["valid"], "--output-dir", str(work / "tuned-scores"),
                                "--model-input-dir", str(work / "tuned" / "best"), "--evaluators", "AUC",
                                "--device", "cuda", *shards])
    torch.cuda.synchronize()
    log(f"  game_scoring of the TUNED model: {time.perf_counter() - t0:.2f} s wall, AUC {result['metrics']['AUC']:.4f}")
    took = read_paths_since(snap)
    check(took == {"columnar": 3}, f"11b every read took the columnar path ({took})")
    check(result["numScored"] == H_VALID_ROWS and np.isfinite(result["metrics"]["AUC"])
          and result["metrics"]["AUC"] > 0.6, f"11b game_scoring scored the TUNED model: {result['numScored']} rows, "
                                              f"AUC {result['metrics']['AUC']:.4f} > 0.6")
    launches = launch_counts()
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    log(f"  11b launches {launches}")
    return launches


def _run_killed(module: str, argv: list, log_path: Path) -> int:
    """``python -m photon_tpu_torch.cli.<module> argv`` in a process of its
    own under KILL_AFTER_FIRST_SAVE; returns its exit code (its output goes
    to ``log_path``)."""
    import os

    env = dict(os.environ, PHOTON_TPU_FAULT_PLAN=json.dumps(KILL_AFTER_FIRST_SAVE))
    with open(log_path, "w") as f:
        return subprocess.run([sys.executable, "-m", f"photon_tpu_torch.cli.{module}", *argv], env=env,
                              cwd=str(Path(__file__).resolve().parent), stdout=f, stderr=subprocess.STDOUT,
                              timeout=900).returncode


def _tail(path: Path, lines: int = 15) -> str:
    return "\n".join(path.read_text(errors="replace").splitlines()[-lines:]) if path.exists() else "(no output)"


def _model_coefficients(out: Path) -> dict:
    """Coordinate → coefficients (CPU) of ``out``/best, loaded with the index
    maps and entity indexes beside it."""
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.io.model_io import load_game_model

    imaps = {shard: IndexMap.load(str(out / f"index-map-{shard}.json")) for _, shard, _ in H_BAGS}
    eidx = {rt: EntityIndex.load(str(out / f"entity-index-{rt}.json")) for rt in ("userId", "itemId")}
    model = load_game_model(str(out / "best"), imaps, eidx, device="cpu")
    return {cid: (m.model.coefficients.means if cid == "global" else m.coefficients) for cid, m in model.models.items()}


def _batches_equal(a, b) -> bool:
    from photon_tpu_torch.data.batch import SparseFeatures

    pairs = [(getattr(a, k), getattr(b, k)) for k in ("label", "offset", "weight", "uid")]
    pairs += [(a.entity_ids[k], b.entity_ids[k]) for k in b.entity_ids]
    for k, f in b.features.items():
        g = a.features[k]
        pairs += list(zip(g.tensors(), f.tensors())) if isinstance(f, SparseFeatures) else [(g, f)]
    return a.features.keys() == b.features.keys() and all(x.device == y.device and torch.equal(x, y)
                                                          for x, y in pairs)


def _stage_text(summary: dict) -> str:
    return "; ".join(f"{name} busy {st['busy_s']:.3f} s, starved {st['wait_in_s']:.3f} s, backpressured "
                     f"{st['wait_out_s']:.3f} s, {st['items']} chunks" for name, st in summary["stages"].items())


def durability_phase(dev, smi: str, check, files: dict) -> dict:
    """Phase 12: durability and streaming ingest on phase 8's files and
    widths. 12a the streamed reads against the whole-file read in process;
    12b game_training streamed and checkpointed, SIGKILLed after config 0's
    first pass, then resumed, against phase 8's model; 12c train_glm
    streamed through a replay cache that spills, SIGKILLed after the first
    λ, then resumed, against an unbroken whole-file sweep; 12d game_scoring
    streamed, overlapped and serial, against phase 8's scores; 12e a CUDA
    checkpoint round trip, a real device OOM classified, and a capture after
    a streamed ingest. Returns the kernel launches of the resumed drivers."""
    import threading

    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.cli import game_scoring, game_training, train_glm
    from photon_tpu_torch.cli.common import parse_feature_shard_config
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.io.data_reader import concat_game_batches, read_merged, stream_merged
    from photon_tpu_torch.io.pipeline import materialize_game_batch, stream_device_batches
    from photon_tpu_torch.io.scores import load_scores
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.utils import resources
    from photon_tpu_torch.utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
    from photon_tpu_torch.utils.timed import PipelineStats

    t_phase = time.perf_counter()
    log("## phase 12: durability and streaming ingest (phase 8's files and widths)")
    work = files["work"] / "durability"
    work.mkdir(parents=True, exist_ok=True)
    shard_cfgs = {}
    for bag, shard, _ in H_BAGS:
        shard_cfgs.update(parse_feature_shard_config(f"name={shard},feature.bags={bag}"))
    imaps = {shard: IndexMap.load(str(files["index"] / f"index-map-{shard}.json")) for _, shard, _ in H_BAGS}
    ids = {"userId": "userId", "itemId": "itemId"}
    listener = ["--event-listener", f"{__name__}:record_event"]

    # ---- 12a: streamed reads against the whole-file read ----
    def timed_read(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (whole, _, eidx_whole), t_whole = timed_read(lambda: read_merged(files["train_paths"], shard_cfgs, imaps, ids,
                                                                     device=dev))
    eidx_s = {}
    merged, t_merged = timed_read(lambda: concat_game_batches(list(stream_merged(
        files["train_paths"], shard_cfgs, imaps, ids, eidx_s, chunk_rows=P_CHUNK_ROWS, device=dev))))
    check(_batches_equal(merged, whole) and eidx_s["userId"].ids() == eidx_whole["userId"].ids(),
          f"12a stream_merged + concat_game_batches (chunk rows {P_CHUNK_ROWS}) equals read_merged bit for bit "
          f"on the card")
    del merged
    log(f"  12a whole-file columnar read: {H_TRAIN_ROWS} rows in {t_whole:.3f} s = {H_TRAIN_ROWS / t_whole:.4e} rows/s; "
        f"stream_merged + concat: {t_merged:.3f} s = {H_TRAIN_ROWS / t_merged:.4e} rows/s")
    for overlap in (True, False):
        stats = PipelineStats()
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        streamed, t_s = timed_read(lambda: materialize_game_batch(stream_device_batches(
            files["train_paths"], shard_cfgs, imaps, ids, {}, chunk_rows=P_CHUNK_ROWS, overlap=overlap, stats=stats,
            telemetry_label=f"12a-{overlap}", device=dev)))
        peak = torch.cuda.max_memory_allocated() - base_mem
        summ = stats.summary()
        check(_batches_equal(streamed, whole), f"12a stream_device_batches overlap={overlap} + "
                                               f"materialize_game_batch equals read_merged bit for bit on the card")
        log(f"  12a stream_device_batches overlap={overlap}: {t_s:.3f} s = {H_TRAIN_ROWS / t_s:.4e} rows/s "
            f"(whole-file read {H_TRAIN_ROWS / t_whole:.4e}); overlap factor {summ['overlap_factor']}; "
            f"{_stage_text(summ)}; materialize peak device memory {peak / 2 ** 30:.3f} GiB above the "
            f"{base_mem / 2 ** 30:.3f} GiB held before (the batch itself "
            f"{sum(t.numel() * t.element_size() for t in (whole.label, whole.offset, whole.weight, whole.uid, *whole.features.values(), *whole.entity_ids.values())) / 2 ** 30:.3f} GiB)")
        del streamed
    del whole
    torch.cuda.empty_cache()

    # ---- 12b: game_training streamed, killed after config 0's pass 0, resumed ----
    ck, out = work / "game-ck", work / "game-out"
    argv = (["--input-paths", files["train"], "--validation-paths", files["valid"], "--output-dir", str(out),
             "--feature-index-dir", str(files["index"]), "--device", "cuda", "--stream-ingest-chunk-rows",
             str(P_CHUNK_ROWS), "--checkpoint-dir", str(ck)] + files["shards"] + files["coords"])
    t0 = time.perf_counter()
    rc = _run_killed("game_training", argv, work / "game-killed.log")
    t_killed = time.perf_counter() - t0
    check(rc == -9 and (ck / "cfg_0" / "step_0.npz").exists() and (ck / "cfg_0" / "LATEST").exists()
          and latest_step(str(ck / "cfg_0")) == 0 and not (ck / "cfg_1").exists(),
          f"12b game_training killed by the plan right after cfg_0/step_0 became durable: exit {rc} "
          f"(want -9) in {t_killed:.1f} s")
    if rc != -9:
        log(_tail(work / "game-killed.log"))
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    EVENTS.clear()
    t0 = time.perf_counter()
    summary = game_training.main(argv + ["--resume"] + listener)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    launches_b = launch_counts()
    launches_b.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    resumed_events = list(EVENTS)
    want, got = _model_coefficients(files["out"]), _model_coefficients(out)
    worst, bitwise = 0.0, True
    for cid, w in want.items():
        a, r = rel_err(got[cid], w)
        worst, bitwise = max(worst, r), bitwise and torch.equal(got[cid], w)
        log(f"  12b {cid}: max |resumed - phase 8| {a:.3e}, rel {r:.3e}, bitwise {torch.equal(got[cid], w)}")
    log(f"  12b resumed game_training: {t_resume:.2f} s wall (the killed run {t_killed:.1f} s); launches {launches_b}")
    check(worst <= RESUME_TOL, f"12b resumed model (fixed, per user, per item) vs phase 8's unbroken whole-file "
                               f"model: rel {worst:.3e} (tolerance {RESUME_TOL:g}), bitwise {bitwise}")
    base = json.loads((files["out"] / "training-summary.json").read_text())
    check(summary["best"]["config"] == base["best"]["config"]
          and abs(summary["best"]["metrics"]["AUC"] - base["best"]["metrics"]["AUC"]) <= RESUME_TOL,
          f"12b the same best: {summary['best']['config']}, AUC {summary['best']['metrics']['AUC']:.6f} "
          f"(phase 8 {base['best']['metrics']['AUC']:.6f})")
    unbroken = _active_counts(files["events"])
    resumed = _active_counts(resumed_events)
    # Phase 8's run: config 0 passes 0 and 1, then config 1; the resumed run
    # starts at config 0's pass 1.
    check(len(unbroken) == 8 and resumed == unbroken[2:],
          f"12b the resumed pass 1 solves the unbroken run's entities (coordinate, pass, entities solved): "
          f"resumed {resumed}, unbroken {unbroken[2:]}")
    check(launches_b["fused_value_grad"] > 0 and launches_b.get(f"newton_system_d{D_RE}", 0) > 0
          and launches_b.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          f"12b the resumed run launched K1, and K3 at d = {D_RE} and {G_D_ITEM}")

    # ---- 12c: train_glm streamed with a spilling replay cache, killed after λ = 10, resumed ----
    glm = ["--training-data", files["train"], "--validation-data", files["valid"], "--regularization-weights",
           "10,1,0.1", "--device", "cuda"]
    base_sum = train_glm.main(glm + ["--output-dir", str(work / "glm-base")])
    streamed = glm + ["--output-dir", str(work / "glm-out"), "--stream-ingest-chunk-rows", str(P_CHUNK_ROWS),
                      "--replay-cache-mb", str(P_REPLAY_MB), "--checkpoint-dir", str(work / "glm-ck")]
    rc = _run_killed("train_glm", streamed, work / "glm-killed.log")
    check(rc == -9 and latest_step(str(work / "glm-ck")) == 0,
          f"12c train_glm killed by the plan right after λ = 10's checkpoint: exit {rc} (want -9)")
    if rc != -9:
        log(_tail(work / "glm-killed.log"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res_sum = train_glm.main(streamed + ["--resume"])
    torch.cuda.synchronize()
    t_glm = time.perf_counter() - t0
    launches_c = launch_counts()
    ing, ckp = res_sum["ingest"], res_sum["checkpoint"]
    log(f"  12c resumed train_glm: {t_glm:.2f} s wall; streamed read {ing['rows']} rows in {ing['wall_s']:.3f} s "
        f"({ing['rows'] / ing['wall_s']:.4e} rows/s), replay cache spilled {ing['spilled']} "
        f"({ing['cached_bytes'] / 2 ** 20:.1f} MiB held, {ing['spilled_bytes'] / 2 ** 20:.1f} MiB spooled), "
        f"decode passes {ing['decode_passes']}, replay passes {ing['replay_passes']}; checkpoint saves "
        f"{[round(s, 4) for s in ckp['save_wall_s']]} s; resumed λs {ckp['resumed_lambdas']}")
    check(ing["spilled"] and ing["decode_passes"] == 1 and ing["replay_passes"] == 1,
          "12c the replay cache spilled to disk and the decode ran once")
    worst = 0.0
    for mb, mr in zip(base_sum["models"], res_sum["models"]):
        r = abs(mr["loss"] - mb["loss"]) / abs(mb["loss"])
        wb, wr = (dict(line.rstrip("\n").split("\t") for line in open(d / f"model-lambda-{mb['lambda']:g}.txt")
                       if not line.startswith("#")) for d in (work / "glm-base", work / "glm-out"))
        keys = set(wb) | set(wr)
        scale = max([1.0] + [abs(float(v)) for v in wb.values()])
        wdiff = max(abs(float(wb.get(k, 0)) - float(wr.get(k, 0))) for k in keys) / scale
        worst = max(worst, r, wdiff)
        log(f"  12c λ={mb['lambda']:g}: loss {mb['loss']:.9e} unbroken, {mr['loss']:.9e} resumed (rel {r:.3e}); "
            f"coefficients rel {wdiff:.3e}")
    check(worst <= RESUME_TOL and res_sum["best_lambda"] == base_sum["best_lambda"] and ckp["resumed_lambdas"] == 1,
          f"12c resumed streamed sweep vs the unbroken whole-file sweep: losses and coefficients rel {worst:.3e} "
          f"(tolerance {RESUME_TOL:g}), best λ {res_sum['best_lambda']:g} = {base_sum['best_lambda']:g}")
    check(launches_c["fused_value_grad"] > 0, f"12c the resumed sweep launched K1 ({launches_c})")

    # ---- 12d: game_scoring streamed, overlapped and serial ----
    want_scores = {r["uid"]: r for r in load_scores(str(files["scores"] / "scores.avro"))}
    for extra in ([], ["--serial-ingest"]):
        sdir = work / f"scores{'-serial' if extra else ''}"
        t0 = time.perf_counter()
        res = game_scoring.main(["--input-paths", files["valid"], "--output-dir", str(sdir), "--model-input-dir",
                                 str(out / "best"), "--evaluators", "AUC", "--device", "cuda",
                                 "--stream-ingest-chunk-rows", str(P_SCORE_CHUNK_ROWS)] + files["shards"] + extra)
        wall = time.perf_counter() - t0
        got_scores = load_scores(str(sdir / "scores.avro"))
        same = len(got_scores) == len(want_scores) and all(
            (r["predictionScore"], r["label"], r["weight"]) == (want_scores[r["uid"]]["predictionScore"],
                                                               want_scores[r["uid"]]["label"],
                                                               want_scores[r["uid"]]["weight"])
            for r in got_scores)
        pipe = res["ingestPipeline"]
        log(f"  12d game_scoring streamed{' --serial-ingest' if extra else ''}: {wall:.2f} s wall, "
            f"{res['numScored'] / wall:.4e} rows/s; pipeline wall {pipe['wall_s']} s, overlap factor "
            f"{pipe['overlap_factor']}; {_stage_text(pipe)}")
        check(same and res["numScored"] == H_VALID_ROWS,
              f"12d streamed scores{' (serial)' if extra else ''} equal phase 8's whole-file scores exactly, row for "
              f"row by uid ({len(got_scores)} rows), AUC {res['metrics']['AUC']:.6f}")

    # ---- 12e: on the card, in process ----
    model_dev = {cid: w.to(dev) for cid, w in got.items()}
    state = dict(model=model_dev, bf16=model_dev["global"].to(torch.bfloat16), step=np.int64(7))
    save_checkpoint(str(work / "ckpt-e"), state, 0)
    back, _ = load_checkpoint(str(work / "ckpt-e"), device=dev)
    check(all(back["model"][k].device.type == dev.type and torch.equal(back["model"][k], v)
              for k, v in model_dev.items())
          and back["bf16"].dtype == torch.bfloat16 and torch.equal(back["bf16"].view(torch.int16),
                                                                 state["bf16"].view(torch.int16))
          and back["step"] == 7, "12e a checkpoint of the CUDA model with a bf16 leaf restores onto cuda, equal bits")
    free, _total = torch.cuda.mem_get_info()
    oom = None
    try:
        torch.empty(free + (1 << 30), dtype=torch.uint8, device=dev)
    except torch.cuda.OutOfMemoryError as exc:
        oom = exc
    torch.cuda.empty_cache()
    check(oom is not None and resources.is_device_oom(oom),
          f"12e a real torch.cuda.OutOfMemoryError ({str(oom).splitlines()[0][:80] if oom else 'none raised'}) "
          f"is classified by is_device_oom")
    batch = materialize_game_batch(stream_device_batches(
        [files["train_paths"][0]], shard_cfgs, imaps, ids, {}, chunk_rows=P_CHUNK_ROWS, telemetry_label="12e",
        device=dev))
    alive = [t.name for t in threading.enumerate() if t.name.startswith("photon-pipe-") and t.is_alive()]
    cache = SolveCache()
    res_e = cache.fe_solver(GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=D_FIX - 1, use_fused=True),
                            OptimizerSpec(max_iter=10))(torch.zeros(D_FIX, device=dev),
                                                        LabeledBatch(batch.label, batch.features["globalShard"]))
    torch.cuda.synchronize()
    check(not alive and cache.stats.captures == 1 and bool(torch.isfinite(res_e.w).all()),
          f"12e a capture through SolveCache after a streamed ingest joined its threads (threads left {alive}): "
          f"{cache.stats.captures} capture, {int(res_e.iterations)} iterations, objective {float(res_e.value):.6e}")
    cache.release()
    del batch, model_dev, back
    launches = {k: launches_b.get(k, 0) + launches_c.get(k, 0) for k in set(launches_b) | set(launches_c)}
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s wall on {smi}; launches {launches}")
    return launches


def _ooc_datasets(train) -> dict:
    """13a: the per-user and per-item datasets of ``train``, grouped once on
    the host (OOC_BUCKETS sample-count buckets; items capped at G_ITEM_CAP
    samples), as CPU tensors."""
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.optim.common import HOST_READS

    label, weight, users, items, Xu, Xi = HOST_READS.fetch(
        train.label, train.weight, train.entity_ids["userId"], train.entity_ids["itemId"], train.features["user"],
        train.features["item"])
    out = {}
    for cid, re_type, shard, ids, X, n_ent, cap in (("per_user", "userId", "user", users, Xu, E, None),
                                                    ("per_item", "itemId", "item", items, Xi, G_ITEMS, G_ITEM_CAP)):
        out[cid] = build_random_effect_dataset(
            ids, X, label, weight, n_ent,
            RandomEffectDataConfig(re_type=re_type, feature_shard=shard, active_upper_bound=cap, n_buckets=OOC_BUCKETS),
            device="cpu")
    return out


def _on_device(ds, dev):
    """A copy of a dataset with its blocks on ``dev``."""
    fields = ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")
    return dataclasses.replace(ds, blocks=[dataclasses.replace(b, **{f: getattr(b, f).to(dev) for f in fields})
                                           for b in ds.blocks])


def _ooc_coordinates(dev, host_ds: dict, budgets, cache) -> dict:
    """13a's coordinates as ``GameEstimator`` builds them for phase 7b
    (logistic, l2 = 1, intercepts, the active set), each random effect with
    its own budget (None: fully resident), over blocks put on the card here."""
    from photon_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
    from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    obj = lambda: GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)  # noqa: E731
    coords = {"global": FixedEffectCoordinate("global", "global", task, obj(),
                                              config.FixedEffectCoordinateConfig("global", "global").optimizer_spec(),
                                              dim=D_FIX, device=dev, solve_cache=cache)}
    for cid, re_type, shard in (("per_user", "userId", "user"), ("per_item", "itemId", "item")):
        spec = config.RandomEffectCoordinateConfig(cid, re_type, shard).optimizer_spec()
        coords[cid] = RandomEffectCoordinate(cid, _on_device(host_ds[cid], dev), task, obj(), spec, active_set=True,
                                             device_budget_bytes=None if budgets is None else budgets[cid],
                                             solve_cache=cache)
    return coords


def _static_block_bytes(blocks) -> int:
    """Bytes the solve cache's static buffers took for ``blocks`` in their
    former layout, one set a block geometry: one block of each distinct
    geometry, with its offsets and warm start."""
    from photon_tpu_torch.algorithm.re_store import block_data_bytes

    seen = {}
    for b in blocks:
        key = tuple(b.features.shape)
        if key not in seen:
            item = b.label.element_size() if isinstance(b.label, torch.Tensor) else b.label.dtype.itemsize
            seen[key] = block_data_bytes(b) + (b.num_entities * b.n_max + b.num_entities * b.dim) * item
    return sum(seen.values())


def _ooc_run(label: str, dev, smi: str, train, valid, host_ds: dict, budgets, cache) -> dict:
    """13a: OOC_PASSES coordinate-descent passes of 7b's three coordinates
    (budgets None: fully resident), one line a pass: wall, samples/s, host
    reads, peak memory and static-buffer bytes, and per budgeted coordinate
    its uploads, hits, bytes and GB/s, overlapped uploads, evictions and the
    ``re_store`` pipeline's stages. The peak is from after construction."""
    from photon_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.models.game import TABLE_COPIES
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.optim.common import HOST_READS

    n = train.label.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    coords = _ooc_coordinates(dev, host_ds, budgets, cache)
    torch.cuda.synchronize()
    log(f"  {label}: coordinates built in {time.perf_counter() - t0:.1f} s, construction peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (the blocks are made on the card, then moved to the "
        f"host master once), {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB held after it")
    suite = EvaluationSuite([EvaluatorSpec.parse("AUC")])
    history, marks = [], []

    def validation_fn(model, batch):
        out = suite.evaluate_model(model, batch)
        history.append(dict(peak=torch.cuda.max_memory_allocated(), mark=cache.trace_mark(),
                            static=cache.static_bytes(), auc=out["AUC"]))
        torch.cuda.reset_peak_memory_stats()
        return out

    def on_coordinate(it, cid, coord, wall):
        res = getattr(coord, "last_residency_stats", None)
        marks.append(dict(it=it, cid=cid, wall=wall, reads=HOST_READS.count, res=None if res is None else dict(res)))

    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    copies0 = dataclasses.replace(TABLE_COPIES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reads0 = HOST_READS.count
    result = CoordinateDescent(coords, ["global", "per_user", "per_item"], num_iterations=OOC_PASSES).run(
        train, validation_batch=valid, validation_fn=validation_fn, better=suite.primary.better(),
        on_coordinate=on_coordinate)
    torch.cuda.synchronize()
    launches = launch_counts()
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    walls, prev_reads, prev_res = [], reads0, {}
    for it in range(OOC_PASSES):
        pm = [m for m in marks if m["it"] == it]
        wall = sum(m["wall"] for m in pm)
        walls.append(wall)
        visits = n * int(result.tracker["global"][it].x_passes) + sum(
            int(result.tracker[c][it].sample_visits) for c in ("per_user", "per_item"))
        reads = pm[-1]["reads"] - prev_reads
        prev_reads = pm[-1]["reads"]
        h = history[it]
        parts = []
        for m in pm:
            r = m["res"]
            if r is None:
                continue
            keys = ("uploads", "upload_hits", "upload_bytes", "upload_s", "overlapped_uploads", "evictions")
            p = prev_res.get(m["cid"], dict.fromkeys(keys, 0))
            d = {k: r[k] - p[k] for k in keys}
            prev_res[m["cid"]] = r
            rate = d["upload_bytes"] / max(d["upload_s"], 1e-9) / 1e9
            parts.append(f"{m['cid']}: {d['uploads']} uploads, {d['upload_hits']} hits, "
                         f"{d['upload_bytes'] / 1e6:.1f} MB at {rate:.2f} GB/s (host copy into pinned staging and "
                         f"issue), {d['overlapped_uploads']} overlapped, {d['evictions']} evictions, store peak "
                         f"{r['peak_bytes'] / 1e6:.1f} MB; {_stage_text(r['pipeline'])}")
        log(f"  {label} pass {it + 1}: {wall:.3f} s wall, {visits / wall:.4e} samples/s, {reads} host reads (with "
            f"validation), peak memory {h['peak'] / 2 ** 30:.3f} GiB, static buffers {h['static'] / 2 ** 20:.1f} MiB, "
            f"validation AUC {h['auc']:.4f}; coordinates " + ", ".join(f"{m['cid']} {m['wall']:.3f} s" for m in pm))
        for line in parts:
            log(f"    {line}")
    scores = result.model.score(valid)
    torch.cuda.synchronize()
    copies = TABLE_COPIES.copies - copies0.copies, TABLE_COPIES.bytes - copies0.bytes
    log(f"  {label}: {sum(walls):.3f} s for {OOC_PASSES} passes on {smi}; launches {launches}; coefficient tables "
        f"copied to the card for scoring {copies[0]} times ({copies[1] / 1e6:.2f} MB)")
    out = dict(walls=walls, peak=max(h["peak"] for h in history), launches=launches,
               after_pass0=cache.traces_since(history[0]["mark"]), scores=scores.cpu(),
               coefs={c: result.model.models[c].coefficients.cpu() for c in ("per_user", "per_item")},
               stats={c: coords[c].last_residency_stats for c in ("per_user", "per_item")},
               blocks={c: coords[c].dataset.blocks for c in ("per_user", "per_item")})
    del result, coords
    return out


def _serving_rows(files: dict, model_dir: Path, with_labels: bool = False):
    """Phase 8's validation rows as the serving engine takes them: the rows
    game_scoring reads (read_merged on the CPU, the model's index maps and
    entity indexes, no new entities), each shard a dense float32 matrix,
    entity ids interned, in game_scoring's row order (its scores file's).
    ``with_labels``: their labels too, last."""
    from photon_tpu_torch.cli.common import parse_feature_shard_config
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.io.data_reader import read_merged
    from photon_tpu_torch.io.model_io import model_re_types, read_model_metadata

    artifacts = model_dir.parent
    shard_configs: dict = {}
    for spec in files["shards"][1:]:
        shard_configs.update(parse_feature_shard_config(spec))
    imaps = {s: IndexMap.load(str(artifacts / f"index-map-{s}.json")) for s in shard_configs}
    re_types = model_re_types(read_model_metadata(str(model_dir)))
    eidx = {rt: EntityIndex.load(str(artifacts / f"entity-index-{rt}.json")) for rt in re_types}
    batch, _, _ = read_merged([str(files["valid"])], shard_configs,
                              index_maps=imaps, entity_id_columns={rt: rt for rt in re_types}, entity_indexes=eidx,
                              intern_new_entities=False, device="cpu")
    feats = {s: batch.features[s].numpy() for s in shard_configs}
    ids = {rt: batch.entity_ids[rt].numpy() for rt in re_types}
    if with_labels:
        return feats, ids, batch.offset.numpy(), batch.label.numpy()
    return feats, ids, batch.offset.numpy()


def _driver_scores(path: Path) -> np.ndarray:
    """game_scoring's scores, in its row order."""
    from photon_tpu_torch.io.scores import load_scores

    return np.asarray([r["predictionScore"] for r in load_scores(str(path))], np.float32)


def _requests(feats, ids, offsets, rows):
    from photon_tpu_torch.serve import ScoreRequest

    return [ScoreRequest({s: m[i] for s, m in feats.items()}, {rt: int(v[i]) for rt, v in ids.items()},
                         float(offsets[i])) for i in rows]


def _submit_all(eng, reqs, clients: int) -> tuple:
    """Every request (a copy: the engine stamps the version that scored it)
    through ``eng.submit`` from ``clients`` threads, each its share in turn,
    waiting for each answer; (scores, failures, latencies s, wall s)."""
    import threading

    scores = np.full(len(reqs), np.nan, np.float32)
    lat = np.zeros(len(reqs))
    failed = []

    def client(k):
        for i in range(k, len(reqs), clients):
            t0 = time.perf_counter()
            try:
                scores[i] = eng.submit(dataclasses.replace(reqs[i])).result(timeout=120)
            except Exception as exc:  # noqa: BLE001 — counted and reported
                failed.append(repr(exc))
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return scores, failed, lat, time.perf_counter() - t0


def _http_all(port: int, lines, clients: int) -> tuple:
    """``lines`` (JSON request bodies) through POST /v1/score from
    ``clients`` threads on keep-alive connections; (scores, failures,
    latencies s, wall s)."""
    import http.client
    import threading

    scores = np.full(len(lines), np.nan, np.float32)
    lat = np.zeros(len(lines))
    failed = []

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for i in range(k, len(lines), clients):
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/v1/score", body=lines[i], headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status != 200:
                        raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
                    scores[i] = json.loads(body)["score"]
                except Exception as exc:  # noqa: BLE001 — counted and reported
                    failed.append(repr(exc))
                lat[i] = time.perf_counter() - t0
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return scores, failed, lat, time.perf_counter() - t0


def _http_server(eng):
    import threading

    from photon_tpu_torch.cli.game_serving import make_handler
    from photon_tpu_torch.serve.frontend import ServingHTTPServer

    server = ServingHTTPServer(("127.0.0.1", 0), make_handler(eng))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def _stop_http(server, t) -> None:
    server.shutdown()
    server.server_close()
    t.join(timeout=30)


def _load_text(label: str, n: int, lat: np.ndarray, wall: float) -> str:
    return (f"{label}: {n / wall:.1f} requests/s, p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.3f} ms")


def _replay_ms(eng) -> dict:
    """The primary version's graph replay ms per row bucket (CUDA events,
    50 replays a reading)."""
    out = {}
    for rows, b in sorted(eng._state.scorer.buckets.items()):
        out[rows] = cuda_ms(b.graph.replay, iters=50, warmup=3)
    return out


def serving_phase(dev, smi: str, check, files: dict) -> dict:
    """Phase 15: online serving on the card, on phase 8's files. The
    engine (``load_engine`` of phase 8's best/ model, its index maps and
    entity indexes) at two hot budgets, one that pins every table and one
    that holds a quarter of the per-item table: phase 8's validation rows
    through ``submit`` from 8 client threads and a share of them through
    HTTP /v1/score-batch, each score equal to game_scoring's bit for bit;
    max_batch_size 1 against 64; nothing captured or allocated after
    warm-up; requests/s and p50/p99 at 1, 8 and 64 clients through
    ``submit`` and HTTP; uploads under the quarter budget; replay ms per row
    bucket. Then a second generation trained here by game_training (another
    λ, 1 pass: K1 and K3), published through gate_and_publish and LATEST,
    shadowed, promoted by the reload watcher under load and rolled back,
    with no failed request and, after the promotion, game_scoring's scores
    of that generation. Then device_shards=8 against the plain engine.
    Returns the launches of its main path (the second generation's
    training)."""
    import threading

    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.cli.game_serving import RolloutOptions, _reload_watcher
    from photon_tpu_torch.io.model_io import gate_and_publish, write_generation_manifest
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.serve import ServeConfig
    from photon_tpu_torch.serve.engine import load_engine

    log("## phase 15: online serving (store, batcher, engine, HTTP front end, reload watcher)")
    t_phase = time.perf_counter()
    out, work = Path(files["out"]), Path(files["work"])
    model_dir = out / "best"
    t0 = time.perf_counter()
    feats, ids, offsets = _serving_rows(files, model_dir)
    n = offsets.shape[0]
    want = _driver_scores(Path(files["scores"]) / "scores.avro")
    check(want.shape == (n,), f"15 game_scoring scored the {n} rows read for serving")
    log(f"  {n} validation rows of phase 8 read for serving in {time.perf_counter() - t0:.1f} s; shards "
        f"{ {s: m.shape[1] for s, m in feats.items()} }, entity types {list(ids)}")
    reqs = _requests(feats, ids, offsets, range(n))
    n_http = min(n, SERVE_HTTP_ROWS)
    lines_http = [json.dumps({"features": {s: m[i].tolist() for s, m in feats.items()},
                              "entityIds": {rt: int(v[i]) for rt, v in ids.items()},
                              "offset": float(offsets[i])}) for i in range(n_http)]
    item_table = None
    torch.cuda.reset_peak_memory_stats()
    for budget_label in ("pinned", "quarter item table"):
        if budget_label == "pinned":
            hot = 1 << 40
        else:
            from photon_tpu_torch.io.model_io import read_model_metadata

            meta = read_model_metadata(str(model_dir))["coordinates"]
            item = next(c for c in meta.values() if c.get("reType") == "itemId")
            item_table = 4 * item["dim"] * item["numEntities"]
            user = [c for c in meta.values() if c.get("reType") == "userId"]
            # The budget splits across types by table size: the item share
            # is a quarter of its table.
            hot = (item_table + sum(4 * c["dim"] * c["numEntities"] for c in user)) // 4
        t0 = time.perf_counter()
        eng = load_engine(str(model_dir), artifacts_dir=str(out),
                          config=ServeConfig(max_batch_size=SERVE_MAX_BATCH, max_delay_ms=1.0, hot_bytes=hot,
                                             queue_cap=1 << 16))
        try:
            info = eng.stats()["warm_up"][eng.model_version]
            store = eng.stats()["store"]
            log(f"  15 {budget_label} (hot budget {hot / 2 ** 20:.1f} MiB): engine built and warmed in "
                f"{time.perf_counter() - t0:.2f} s (warm-up {info['warm_up_s']:.3f} s, {info['graphs']} graphs for "
                f"row buckets {info['buckets']}); store " + "; ".join(
                    f"{rt}: {st['entities']} entities, {st['hot_capacity']} hot rows, pinned {st['pinned']}"
                    for rt, st in store.items()))
            up0 = eng._state.store.upload_stats()
            got, failed, lat, wall = _submit_all(eng, reqs, SERVE_CLIENTS)
            up = eng._state.store.upload_stats()
            check(not failed and np.array_equal(got, want),
                  f"15 {budget_label}: {n} rows through submit from {SERVE_CLIENTS} client threads equal "
                  f"game_scoring's scores bit for bit ({len(failed)} failed, max |diff| "
                  f"{float(np.nanmax(np.abs(got - want))):.3e}); " + _load_text("load", n, lat, wall))
            if budget_label != "pinned":
                rows_up = up["rows"] - up0["rows"]
                secs = up["seconds"] - up0["seconds"]
                log(f"  15 {budget_label}: hot-store uploads {rows_up} rows, {(up['bytes'] - up0['bytes']) / 1e6:.1f} "
                    f"MB in {secs:.3f} s: {rows_up / max(secs, 1e-9):.0f} rows/s, "
                    f"{(up['bytes'] - up0['bytes']) / max(secs, 1e-9) / 1e9:.3f} GB/s (host gather, pinned copy, "
                    f"index_copy_, synchronized); store {eng.stats()['store']}")
                check(rows_up > 0 and not eng.stats()["store"]["itemId"]["pinned"],
                      f"15 {budget_label}: the per-item table is not pinned and the miss path uploaded rows")
            server, t = _http_server(eng)
            try:
                import urllib.request

                body = "".join(line + "\n" for line in lines_http).encode()
                req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/v1/score-batch",
                                             data=body, method="POST")
                with urllib.request.urlopen(req, timeout=600) as resp:
                    raw = resp.read().decode()
                got_http = np.asarray([json.loads(x).get("score", np.nan) for x in raw.splitlines()], np.float32)
                check(got_http.shape == (n_http,) and np.array_equal(got_http, want[:n_http]),
                      f"15 {budget_label}: {n_http} rows through HTTP /v1/score-batch equal game_scoring's scores bit "
                      f"for bit")
                for clients in (1, 8, 64):
                    k = min(n, SERVE_LOAD_REQUESTS * clients)
                    s, failed, lat, wall = _submit_all(eng, reqs[:k], clients)
                    log(f"  15 {budget_label} load, " + _load_text(f"submit, {clients} clients, {k} requests", k,
                                                                   lat, wall) + f" ({len(failed)} failed)")
                    kh = min(n_http, SERVE_LOAD_REQUESTS * clients)
                    s, failed_h, lat, wall = _http_all(server.server_address[1], lines_http[:kh], clients)
                    log(f"  15 {budget_label} load, " + _load_text(f"HTTP /v1/score, {clients} clients, {kh} "
                                                                   f"requests", kh, lat, wall)
                        + f" ({len(failed_h)} failed{': ' + failed_h[0] if failed_h else ''})")
                    check(not failed and not failed_h and np.array_equal(s, want[:kh]),
                          f"15 {budget_label}: {clients} clients, no failed request, HTTP scores equal game_scoring's")
            finally:
                _stop_http(server, t)
            replay = _replay_ms(eng)
            log(f"  15 {budget_label}: graph replay ms per row bucket {{" + ", ".join(
                f"{k}: {v:.4f}" for k, v in replay.items()) + f"}} on {smi}")
            retr = eng.retraces_since_warmup
            check(retr == 0, f"15 {budget_label}: retraces_since_warmup {retr} after all traffic (graph captures "
                             f"after warm-up plus new allocator segments)")
        finally:
            eng.close()
        torch.cuda.empty_cache()

    # Bucket invariance: the same rows at max_batch_size 1 and 64.
    sub = reqs[:SERVE_INVARIANCE_ROWS]
    outs = {}
    for mb in (1, 64):
        eng = load_engine(str(model_dir), artifacts_dir=str(out),
                          config=ServeConfig(max_batch_size=mb, max_delay_ms=1.0, hot_bytes=1 << 40))
        try:
            outs[mb], failed, _, _ = _submit_all(eng, _requests(feats, ids, offsets, range(len(sub))), 8)
            check(eng.retraces_since_warmup == 0 and not failed, f"15 max_batch_size {mb}: nothing captured after "
                                                                 f"warm-up, no failed request")
        finally:
            eng.close()
    check(np.array_equal(outs[1], outs[64]) and np.array_equal(outs[1], want[:len(sub)]),
          f"15 scores of {len(sub)} rows at max_batch_size 1 and 64 are equal bit for bit (and game_scoring's)")

    # ---- reload under load: a second generation, shadowed, promoted, rolled back ----
    coords = list(files["coords"])
    i = coords.index("--coordinate-descent-iterations")
    coords[i + 1] = "1"
    coords = [c.replace("reg.weights=1|10", "reg.weights=3") for c in coords]
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    t0 = time.perf_counter()
    gen_train = work / "gen-2-train"
    summary = game_training.main(["--input-paths", files["train"], "--validation-paths", files["valid"],
                                  "--output-dir", str(gen_train), "--feature-index-dir", str(files["index"]),
                                  "--device", "cuda"] + list(files["shards"]) + coords)
    torch.cuda.synchronize()
    launches = launch_counts()
    launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    log(f"  15 second generation: game_training (global λ = 3, 1 pass) in {time.perf_counter() - t0:.2f} s; "
        f"launches {launches}")
    check(launches.get("fused_value_grad", 0) > 0 and launches.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          "15 the second generation's training launched K1 and K3")
    shutil.copytree(gen_train / "best", out / "gen-2")
    auc = summary["configs"][0]["metrics"]["AUC"]
    write_generation_manifest(str(out / "gen-2"), parent="best", holdout_metrics={"AUC": auc})
    gen2_scored = work / "gen-2-scores"
    game_scoring.main(["--input-paths", files["valid"], "--output-dir", str(gen2_scored), "--model-input-dir",
                       str(out / "gen-2"), "--device", "cuda"] + list(files["shards"]))
    want2 = _driver_scores(gen2_scored / "scores.avro")
    eng = load_engine(str(model_dir), artifacts_dir=str(out),
                      config=ServeConfig(max_batch_size=SERVE_MAX_BATCH, max_delay_ms=1.0, hot_bytes=1 << 40,
                                         queue_cap=1 << 16, max_versions=2, promotion_settle_s=0))
    stop = threading.Event()
    watcher = threading.Thread(target=_reload_watcher, args=(eng, str(out), 0.05, stop, RolloutOptions(
        shadow_fraction=0.25, shadow_quota=SERVE_SHADOW_QUOTA, divergence_bound=1e9)), daemon=True)
    watcher.start()
    load_stop = threading.Event()
    load_failed, load_count = [], [0]

    def load():
        k = 0
        while not load_stop.is_set():
            try:
                eng.submit(dataclasses.replace(reqs[k % n])).result(timeout=120)
                load_count[0] += 1
            except Exception as exc:  # noqa: BLE001 — counted and reported
                load_failed.append(repr(exc))
            k += 7

    loaders = [threading.Thread(target=load) for _ in range(SERVE_CLIENTS)]
    for t in loaders:
        t.start()
    try:
        time.sleep(0.5)
        t_pub = time.perf_counter()
        gate = gate_and_publish(str(out), "gen-2")
        check(gate.ok, f"15 gate_and_publish of gen-2: {gate.reason or 'passed'}; LATEST -> gen-2")
        deadline = time.monotonic() + 120
        while eng.shadow_version is None and not eng.model_version.endswith("gen-2") and time.monotonic() < deadline:
            time.sleep(0.01)
        t_shadow = time.perf_counter()
        while not eng.model_version.endswith("gen-2") and time.monotonic() < deadline:
            time.sleep(0.01)
        t_promoted = time.perf_counter()
        st = eng.stats()
        promoted = eng.model_version.endswith("gen-2")
        log(f"  15 reload: shadow resident {t_shadow - t_pub:.2f} s after the publish (build and warm-up of the "
            f"version {st['warm_up'].get(str(out / 'gen-2'), {})}), promoted {t_promoted - t_pub:.2f} s after it, "
            f"{load_count[0]} requests served meanwhile")
        check(promoted, f"15 the watcher shadowed gen-2 ({SERVE_SHADOW_QUOTA} shadow scores) and promoted it")
        got2, failed, _, _ = _submit_all(eng, reqs[:SERVE_INVARIANCE_ROWS], 8)
        check(not failed and np.array_equal(got2, want2[:SERVE_INVARIANCE_ROWS]),
              f"15 after the promotion: {SERVE_INVARIANCE_ROWS} rows equal game_scoring's scores of gen-2 bit for bit")
        t0 = time.perf_counter()
        demoted = eng.rollback("chip_smoke phase 15")
        swap = time.perf_counter() - t0
        got1, failed, _, _ = _submit_all(eng, reqs[:SERVE_INVARIANCE_ROWS], 8)
        check(demoted is not None and demoted.endswith("gen-2") and not failed
              and np.array_equal(got1, want[:SERVE_INVARIANCE_ROWS]),
              f"15 rollback to best in {swap * 1e3:.3f} ms: scores equal game_scoring's of best again")
    finally:
        load_stop.set()
        for t in loaders:
            t.join(timeout=120)
        stop.set()
        watcher.join(timeout=30)
        retr = eng.retraces_since_warmup
        eng.close()
    check(not load_failed and load_count[0] > 0 and retr == 0,
          f"15 reload under load: {load_count[0]} requests from {SERVE_CLIENTS} threads across the publish, shadow, "
          f"promotion and rollback, {len(load_failed)} failed {load_failed[:2]}; retraces_since_warmup {retr}")

    # ---- device shards ----
    sub = reqs[:SERVE_INVARIANCE_ROWS]
    eng = load_engine(str(model_dir), artifacts_dir=str(out),
                      config=ServeConfig(max_batch_size=SERVE_MAX_BATCH, max_delay_ms=1.0, hot_bytes=hot,
                                         device_shards=8))
    try:
        got_s, failed, _, _ = _submit_all(eng, sub, 8)
        retr = eng.retraces_since_warmup
        shards = {rt: (st.get("device_shards"), st.get("shard_rows")) for rt, st in eng.stats()["store"].items()}
    finally:
        eng.close()
    check(not failed and retr == 0 and np.array_equal(got_s, want[:len(sub)]),
          f"15 device_shards=8 (segments {shards}) at the quarter budget: {len(sub)} rows equal the plain engine's "
          f"(game_scoring's) scores bit for bit, retraces_since_warmup {retr}")
    log(f"  15 peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def _model_files(model_dir: Path) -> dict:
    """Every file of a model directory: an Avro container's decoded records
    (its sync marker is random), any other file's bytes."""
    from photon_tpu_torch.io.avro import read_avro_records

    return {str(p.relative_to(model_dir)): (read_avro_records(str(p)) if p.suffix == ".avro" else p.read_bytes())
            for p in sorted(model_dir.rglob("*")) if p.is_file()}


def _get(url: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def telemetry_phase(dev, smi: str, check, files: dict) -> dict:
    """Phase 16: the telemetry core on the card, on phase 8's files and
    model. 16a phase 8's game_training with a run report and an OTLP
    exporter against phase 8's run; 16b phase 15's engine with telemetry on
    (an exporter, a run-report flusher and the SLO-gated watcher) against
    off, and its /metrics and /v1/traces; 16c obs_tool on both. Returns the
    kernel launches of 16a's training."""
    import re
    import threading

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.cli.game_serving import RolloutOptions, _reload_watcher
    from photon_tpu_torch.obs import MockCollector, install_exporter, uninstall_exporter, validate_record
    from photon_tpu_torch.obs.export import OTLPExporter
    from photon_tpu_torch.obs.report import collect_run_records, write_run_report
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.serve import ServeConfig
    from photon_tpu_torch.serve.engine import load_engine

    log("## phase 16: telemetry (run report, OTLP export, /metrics, /v1/traces, SLO gate, obs_tool)")
    t_phase = time.perf_counter()
    out, work = Path(files["out"]), Path(files["work"]) / "telemetry"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    p8 = files["training"]

    # ---- 16a: game_training with a run report and an OTLP exporter ----
    report_path, out16 = work / "run.jsonl", work / "out"
    collector = MockCollector()
    try:
        kernels.reset_launches()
        fused_newton.LAUNCHES_BY_WIDTH.clear()
        t0 = time.perf_counter()
        with reads_to_finalize() as until_finalize:
            game_training.main(["--input-paths", files["train"], "--validation-paths", files["valid"],
                                "--output-dir", str(out16), "--feature-index-dir", str(files["index"]),
                                "--device", "cuda", "--event-listener", f"{__name__}:record_event",
                                "--telemetry-out", str(report_path), "--otlp-endpoint", collector.endpoint]
                               + list(files["shards"]) + list(files["coords"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        launches.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
        got_spans, got_metrics = collector.spans(), collector.metrics()
    finally:
        collector.close()
    trained = dict(kernels.LAUNCHES, by_width=dict(fused_newton.LAUNCHES_BY_WIDTH))
    records = [json.loads(line) for line in report_path.read_text().splitlines()]
    bad = []
    for rec in records:
        try:
            validate_record(rec)
        except ValueError as exc:
            bad.append(str(exc))
    kinds = {}
    for rec in records:
        kinds[rec["record"]] = kinds.get(rec["record"], 0) + 1
    log(f"  16a game_training with --telemetry-out and --otlp-endpoint: {wall:.2f} s wall (phase 8 without: "
        f"{p8['wall']:.2f} s) on {smi}; report {report_path.stat().st_size} bytes, records {kinds}; collector "
        f"{len(got_spans)} spans, {len(got_metrics)} metrics")
    check(records and not bad, f"16a every one of the {len(records)} report lines passes validate_record {bad[:2]}")
    names = {r["name"].split("]/", 1)[-1] for r in records if r["record"] == "span"}
    missing = [f"cd/iter{it}/{cid}{leaf}" for it in (0, 1) for cid in ("global", "perUser", "perItem")
               for leaf in ("", "/solve", "/score") if f"cd/iter{it}/{cid}{leaf}" not in names]
    check(not missing, f"16a a cd/iter<pass>/<coordinate> span with solve and score under it for both passes of "
                       f"each coordinate (missing {missing[:3]})")
    check(bool(got_spans) and bool(got_metrics),
          f"16a the OTLP collector received spans ({len(got_spans)}) and metrics ({len(got_metrics)})")
    same = _model_files(out16 / "best") == _model_files(out / "best")
    check(same, "16a best/ equals phase 8's (every Avro record, every other file's bytes)")
    check(until_finalize["reads"] == p8["reads"],
          f"16a host reads up to the report's finalize {until_finalize['reads']} = phase 8's {p8['reads']}")
    check(trained["fused_value_grad"] == p8["launches"]["fused_value_grad"]
          and trained["by_width"] == p8["launches"]["by_width"] and trained["fused_value_grad"] > 0,
          f"16a K1 launches {trained['fused_value_grad']} and K3 launches by width {trained['by_width']} = phase "
          f"8's ({p8['launches']['fused_value_grad']}, {p8['launches']['by_width']})")

    # ---- 16b: the serving engine with telemetry off and on ----
    model_dir = out / "best"
    feats, ids, offsets = _serving_rows(files, model_dir)
    n = offsets.shape[0]
    want = _driver_scores(Path(files["scores"]) / "scores.avro")
    reqs = _requests(feats, ids, offsets, range(n))
    eng = load_engine(str(model_dir), artifacts_dir=str(out),
                      config=ServeConfig(max_batch_size=SERVE_MAX_BATCH, max_delay_ms=1.0, hot_bytes=1 << 40,
                                         queue_cap=1 << 16))
    server = t_http = None
    stop = threading.Event()
    serve_report = work / "serve.jsonl"
    collector = MockCollector()
    on = None

    def flush_report():
        write_run_report(str(serve_report), collect_run_records("game_serving"), max_bytes=64 << 20)

    def telemetry_on(report: bool):
        """What game_serving's --otlp-endpoint, --slo-gate and (``report``)
        --telemetry-out with a flush interval start: an exporter, the
        SLO-gated reload watcher and a report flusher."""
        exporter = install_exporter(OTLPExporter(collector.endpoint, service_name="photon-tpu-serving",
                                                 metrics_interval_s=TELEMETRY_FLUSH_S))

        def flush():
            while not stop.wait(TELEMETRY_FLUSH_S):
                flush_report()

        threads = [threading.Thread(target=_reload_watcher, args=(eng, str(out), 0.05, stop,
                                                                  RolloutOptions(slo_gate=True)), daemon=True)]
        if report:
            threads.append(threading.Thread(target=flush, daemon=True))
        for th in threads:
            th.start()
        return exporter, threads

    def telemetry_off(state):
        """Stop them, as game_serving's shutdown does: a last report and a
        last metrics export."""
        exporter, threads = state
        stop.set()
        for th in threads:
            th.join(timeout=30)
        stop.clear()
        flush_report()
        exporter.export_metrics()
        exporter.flush(timeout_s=3.0)
        uninstall_exporter()

    try:
        got, failed, _, _ = _submit_all(eng, reqs, SERVE_CLIENTS)
        check(not failed and np.array_equal(got, want),
              f"16b {n} rows through submit equal game_scoring's scores bit for bit ({len(failed)} failed)")
        # "on": exporter, SLO-gated watcher and report flusher; "export": the
        # same without the report flusher, to tell their costs apart.
        readings = {}
        states = ("off", "on", "export", "off", "on", "export")
        for state in states:
            if on is not None:
                telemetry_off(on)
                on = None
            if state != "off":
                on = telemetry_on(report=state == "on")
            for clients in (1, 64):
                k = min(n, TELEMETRY_LOAD_REQUESTS * clients)
                s, failed, lat, wall = _submit_all(eng, reqs[:k], clients)
                readings.setdefault((state, clients), []).append((k / wall, np.percentile(lat, 50) * 1e3,
                                                                  np.percentile(lat, 99) * 1e3))
                check(not failed and np.array_equal(s, want[:k]),
                      f"16b telemetry {state}, {clients} clients: {k} requests, none failed, scores game_scoring's")
        for clients in (1, 64):
            text = "; ".join(f"{state} " + ", ".join(f"{r:.1f} requests/s p50 {p50:.3f} ms p99 {p99:.3f} ms"
                                                     for r, p50, p99 in readings[(state, clients)])
                             for state in ("off", "on", "export"))
            log(f"  16b submit, {clients} clients, {min(n, TELEMETRY_LOAD_REQUESTS * clients)} requests a run "
                f"({', '.join(states)}): {text} on {smi}")
        server, t_http = _http_server(eng)
        port = server.server_address[1]
        tid = "5e" * 16
        import urllib.request

        body = json.dumps({"features": {s: m[0].tolist() for s, m in feats.items()},
                           "entityIds": {rt: int(v[0]) for rt, v in ids.items()}, "offset": float(offsets[0])})
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/score", data=body.encode(), method="POST",
                                     headers={"Content-Type": "application/json",
                                              "traceparent": f"00-{tid}-{'7a' * 8}-01"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            score = json.loads(resp.read())["score"]
        check(np.float32(score) == want[0], f"16b POST /v1/score with a traceparent: {score} = game_scoring's")
        _, _, raw = _get(f"http://127.0.0.1:{port}/v1/traces?limit=100")
        mine = [e for e in json.loads(raw)["traces"] if e["traceId"] == tid]
        spans = {s["name"] for e in mine for s in e["spans"]}
        check(len(mine) == 1 and {"http/v1/score", "engine/score"} <= spans,
              f"16b /v1/traces returns the request's trace with its spans {sorted(spans)}")
        status, ctype, raw = _get(f"http://127.0.0.1:{port}/metrics")
        text = raw.decode()
        sample = re.compile(r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? [^ ]+( # \{[^}]*\} [^ ]+)?$')
        unparsed = [ln for ln in text.splitlines() if ln and not ln.startswith("#") and not sample.match(ln)]
        families = sorted({ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE serve_")})
        check(status == 200 and ctype.startswith("text/plain") and not unparsed
              and {"serve_requests_total", "serve_request_latency_s", "serve_batches_total"} <= set(families),
              f"16b /metrics: Prometheus text ({len(text.splitlines())} lines, {len(unparsed)} unparsed "
              f"{unparsed[:1]}), serve_* families {families}")
        slo = eng.stats().get("slo") or {}
        check("objectives" in slo, f"16b stats() has the slo block: {json.dumps(slo)[:300]}")
        # ---- 16c: obs_tool on 16a's report and 16b's /metrics ----
        for argv, what in ((["report", str(report_path), "--json"], "16a's run report"),
                           (["--url", f"http://127.0.0.1:{port}", "metrics", "--prefix", "serve_", "--json"],
                            "16b's /metrics")):
            res = subprocess.run([sys.executable, "-m", "photon_tpu_torch.cli.obs_tool"] + argv,
                                 capture_output=True, text=True, timeout=120, cwd=str(Path(__file__).resolve().parent))
            doc = json.loads(res.stdout) if res.returncode == 0 else {}
            size = len(doc.get("spans", doc.get("samples", [])))
            check(res.returncode == 0 and size > 0,
                  f"16c python -m photon_tpu_torch.cli.obs_tool {argv[0] if argv[0] == 'report' else 'metrics'} on "
                  f"{what}: rc {res.returncode}, {size} {'span paths' if argv[0] == 'report' else 'samples'} "
                  f"{res.stderr[-200:]}")
        retr = eng.retraces_since_warmup
        check(retr == 0, f"16b retraces_since_warmup {retr} after all traffic with telemetry off and on (captures "
                         f"after warm-up plus new allocator segments)")
        if on is not None:
            telemetry_off(on)
            on = None
        served = [json.loads(line) for line in serve_report.read_text().splitlines()]
        bad = []
        for rec in served:
            try:
                validate_record(rec)
            except ValueError as exc:
                bad.append(str(exc))
        metrics = collector.metrics()
        check(served and not bad and bool(metrics),
              f"16b the serving run report ({serve_report.stat().st_size} bytes, {len(served)} records) validates "
              f"{bad[:1]}; the collector received {len(metrics)} metrics and {len(collector.spans())} spans")
    finally:
        if on is not None:
            telemetry_off(on)
        if server is not None:
            _stop_http(server, t_http)
        eng.close()
        collector.close()
    log(f"  16 phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def out_of_core_phase(dev, smi: str, check, files: dict) -> dict:
    """Phase 13: out-of-core random effects. 13a in process at 7b's full
    width, fully resident and then twice with a quarter of each random
    effect's footprint as its budget; 13b phase 8's game_training with
    --re-device-budget-mb, --re-spill-dir and --re-spill-member, and
    game_scoring of its model; 13c feature_indexing --num-partitions on
    phase 8's index file, its three readers against each other; 13d an
    injected device OOM at the upload: the budget halves, then at the floor
    DeviceMemoryError. Returns the launches of 13a's budgeted run and 13b."""
    import os

    from photon_tpu_torch.algorithm.re_store import block_device_cost
    from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_tpu_torch.algorithm.solve_cache import SolveCache, block_input_bytes
    from photon_tpu_torch.cli import feature_indexing, game_scoring, game_training
    from photon_tpu_torch.data import native_index
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.io.data_reader import READ_PATHS
    from photon_tpu_torch.io.scores import load_scores
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.types import TaskType
    from photon_tpu_torch.utils import faults, resources

    log("## phase 13: out-of-core random effects (re_store, residency, native index)")
    t_phase = time.perf_counter()

    # ---- 13a: in process at 7b's width, resident against budgeted ----
    Xf, Xr, users, _ = make_data(N, D_FIX, D_RE, E, seed=13, device=dev)
    Xb = Xf.to(torch.bfloat16)
    del Xf
    train, valid = _glmix_batches(dev, smi, Xb, Xr, users, E, seed=13)
    del Xb, Xr, users
    t0 = time.perf_counter()
    host_ds = _ooc_datasets(train)
    log(f"  13a random-effect blocks grouped on the host in {time.perf_counter() - t0:.1f} s "
        f"({OOC_BUCKETS} sample-count buckets)")
    footprint = {c: sum(block_device_cost(b) for b in ds.blocks) for c, ds in host_ds.items()}
    largest = {c: max(block_device_cost(b) for b in ds.blocks) for c, ds in host_ds.items()}
    budgets = {c: footprint[c] // OOC_BUDGET_DIVISOR for c in host_ds}
    static = {c: block_input_bytes(ds.blocks) for c, ds in host_ds.items()}
    for c, ds in host_ds.items():
        before = _static_block_bytes(ds.blocks)
        log(f"  13a {c}: {len(ds.blocks)} blocks {sorted({tuple(b.features.shape) for b in ds.blocks})}; footprint "
            f"{footprint[c] / 1e6:.1f} MB, largest block {largest[c] / 1e6:.1f} MB, budget {budgets[c] / 1e6:.1f} MB; "
            f"the solve cache's static buffers: one set a geometry (the former layout, outside the budget) "
            f"{before / 1e6:.1f} MB ({before / footprint[c]:.1%} of the footprint), one flat buffer an input (inside "
            f"the budget) {static[c] / 1e6:.1f} MB ({static[c] / footprint[c]:.1%})")
    fits = {c: largest[c] + static[c] <= budgets[c] for c in host_ds}
    log(f"  13a the largest block plus the static buffers fit under the configured budget (else the effective budget "
        f"floors there): {fits}")

    resident_cache = SolveCache()
    resident = _ooc_run("13a resident", dev, smi, train, valid, host_ds, None, resident_cache)
    resident_cache.release()
    del resident["blocks"]
    torch.cuda.empty_cache()
    cache = SolveCache()
    budgeted = _ooc_run("13a budgeted", dev, smi, train, valid, host_ds, budgets, cache)
    torch.cuda.empty_cache()
    again = _ooc_run("13a budgeted again (replays)", dev, smi, train, valid, host_ds, budgets, cache)
    cache.release()
    torch.cuda.empty_cache()
    for c in ("per_user", "per_item"):
        st = budgeted["stats"][c]
        check(torch.equal(budgeted["coefs"][c], resident["coefs"][c]),
              f"13a {c}: budgeted coefficients equal the resident ones bit for bit")
        floor = largest[c] + static[c]
        check(st["evictions"] > 0 and st["peak_total_bytes"] <= st["effective_budget_bytes"]
              == max(st["budget_bytes"], floor) and st["static_bytes"] == static[c],
              f"13a {c}: {st['evictions']} evictions (passes {st['pass_evictions']}), store peak "
              f"{st['peak_bytes'] / 1e6:.1f} MB + static buffers held {st['static_bytes'] / 1e6:.1f} MB: peak "
              f"{st['peak_total_bytes'] / 1e6:.1f} MB <= effective budget {st['effective_budget_bytes'] / 1e6:.1f} MB "
              f"(configured {st['budget_bytes'] / 1e6:.1f} MB, floor {floor / 1e6:.1f} MB), {st['uploads']} uploads, "
              f"{st['upload_hits']} hits")
        check(st["eviction_log"] == again["stats"][c]["eviction_log"],
              f"13a {c}: two budgeted runs evict the same blocks in the same order ({len(st['eviction_log'])})")
    check(torch.equal(budgeted["scores"], resident["scores"]),
          f"13a validation scores of the budgeted model equal the resident model's bit for bit ({valid.n} rows)")
    check(budgeted["after_pass0"] == 0 and resident["after_pass0"] == 0,
          f"13a nothing captured after pass 0 (budgeted {budgeted['after_pass0']}, resident {resident['after_pass0']})")
    la = budgeted["launches"]
    check(la["fused_value_grad"] > 0 and la.get(f"newton_system_d{D_RE}", 0) > 0
          and la.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          f"13a the budgeted run launched K1, and K3 at d = {D_RE} and d = {G_D_ITEM}")
    # The resident run holds every block and the static buffers; the
    # budgeted one at most its effective budget of the two.
    saved = sum(footprint[c] + static[c] - max(budgets[c], largest[c] + static[c]) for c in host_ds)
    check(budgeted["peak"] <= resident["peak"] - saved / 2,
          f"13a peak memory of the passes from after construction: budgeted {budgeted['peak'] / 2 ** 30:.3f} GiB, "
          f"resident {resident['peak'] / 2 ** 30:.3f} GiB, {(resident['peak'] - budgeted['peak']) / 1e6:.1f} MB less "
          f">= half of sum(footprint + static buffers - effective budget) = {saved / 2e6:.1f} MB")
    log(f"  13a budgeted/resident wall: {sum(budgeted['walls']) / sum(resident['walls']):.3f} (passes "
        + ", ".join(f"{b / r:.3f}" for b, r in zip(budgeted["walls"], resident["walls"])) + "; not gated)")
    launches_a = budgeted["launches"]
    user_host = host_ds["per_user"]
    del host_ds, budgeted, again, resident
    torch.cuda.empty_cache()

    # ---- 13d: device OOM at the upload, contained, then at the floor ----
    def user_pass(budget, rules=()):
        faults.reset()
        if rules:
            faults.configure(faults.FaultPlan(rules=tuple(rules)))
        try:
            coord = RandomEffectCoordinate(
                "per_user", _on_device(user_host, dev), TaskType.LOGISTIC_REGRESSION,
                GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0),
                config.RandomEffectCoordinateConfig("per_user", "userId", "user").optimizer_spec(),
                device_budget_bytes=budget, solve_cache=oom_cache)
            coord.begin_cd_pass(0)
            model, _ = coord.train(train, None, None)
            return model.coefficients.cpu(), coord.last_residency_stats
        finally:
            faults.reset()

    oom_cache = SolveCache()
    want, _ = user_pass(None)
    budget_u = sum(block_device_cost(b) for b in user_host.blocks) // OOC_BUDGET_DIVISOR
    got, st = user_pass(budget_u, [faults.FaultRule("re_store.upload", kind="oom", at=(2,), max_count=1)])
    floor = st["max_block_bytes"] + st["static_bytes"]
    eff0 = max(budget_u, floor)
    check(torch.equal(got, want) and st["budget_shrinks"] == int(eff0 > floor)
          and st["effective_budget_bytes"] == (max(floor, eff0 // 2) if eff0 > floor else eff0),
          f"13d an injected OOM at the third upload of a budgeted per-user pass: the budget halved toward its floor "
          f"(the largest block and the static buffers, {floor / 1e6:.1f} MB): {eff0 / 1e6:.1f} -> "
          f"{st['effective_budget_bytes'] / 1e6:.1f} MB, the pass finished, coefficients bitwise the unbudgeted "
          f"pass's")
    err = None
    try:
        user_pass(1, [faults.FaultRule("re_store.upload", kind="oom", p=1.0)])
    except resources.DeviceMemoryError as exc:
        err = exc
    check(err is not None and "largest single" in str(err),
          f"13d at the floor budget the same injection raises DeviceMemoryError ({str(err)[:90] if err else 'none'})")
    oom_cache.release()
    del train, valid, user_host
    torch.cuda.empty_cache()

    # ---- 13b: phase 8's game_training out of core, and game_scoring of it ----
    work = files["work"]
    out, spill, scored = work / "ooc-out", work / "ooc-spill", work / "ooc-scores"
    coords = list(files["coords"])
    # A budget refuses variances (the reference's rule): phase 8's model
    # without them, its coefficients bit for bit.
    i = coords.index("--variance-computation")
    del coords[i:i + 2]
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    snap = dict(READ_PATHS.counts)
    EVENTS.clear()
    t0 = time.perf_counter()
    summary = game_training.main(["--input-paths", files["train"], "--validation-paths", files["valid"],
                                  "--output-dir", str(out), "--feature-index-dir", str(files["index"]),
                                  "--device", "cuda", "--re-device-budget-mb", OOC_DRIVER_BUDGET_MB,
                                  "--re-spill-dir", str(spill), "--re-spill-member", OOC_SPILL_MEMBER,
                                  "--event-listener", f"{__name__}:record_event"] + files["shards"] + coords)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches_b = launch_counts()
    launches_b.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    took = read_paths_since(snap)
    residency = [(e.payload["coordinate"], e.payload["cd_iteration"], e.payload["residency"]) for e in EVENTS
                 if e.name == "PhotonOptimizationLogEvent" and e.payload.get("residency")]
    for cid, it, r in residency:
        log(f"    13b {cid} pass {it}: budget {r['budget_bytes'] / 1e6:.2f} MB (effective "
            f"{r['effective_budget_bytes'] / 1e6:.2f} MB, the largest block and the static buffers), {r['uploads']} "
            f"uploads, {r['evictions']} evictions, store peak {r['peak_bytes'] / 1e6:.2f} MB + static buffers "
            f"{r['static_bytes'] / 1e6:.2f} MB")
    want, got = _model_coefficients(files["out"]), _model_coefficients(out)
    same = {cid: torch.equal(got[cid], w) for cid, w in want.items()}
    log(f"  13b game_training out of core: {t_train:.2f} s wall; launches {launches_b}")
    check(all(same.values()) and summary["best"]["config"] == json.loads(
        (files["out"] / "training-summary.json").read_text())["best"]["config"],
          f"13b best/ of game_training --re-device-budget-mb {OOC_DRIVER_BUDGET_MB} --re-spill-dir "
          f"--re-spill-member {OOC_SPILL_MEMBER} equals phase 8's bit for bit ({same})")
    host_dir = spill / f"host-{OOC_SPILL_MEMBER.rsplit(':', 1)[1]}"
    spilled = sorted(os.listdir(host_dir)) if host_dir.is_dir() else []
    check(sorted(os.listdir(spill)) == [host_dir.name] and any(n.startswith("perUser.") for n in spilled)
          and any(n.startswith("perItem.") for n in spilled) and residency
          and all(r["evictions"] > 0 for _c, _i, r in residency),
          f"13b the spill files lie under {host_dir.relative_to(work)}/ ({len(spilled)} files, both random effects); "
          f"every budgeted pass evicted")
    check(took == {"columnar": 2}, f"13b every read took the columnar path ({took})")
    check(launches_b["fused_value_grad"] > 0 and launches_b.get(f"newton_system_d{D_RE}", 0) > 0
          and launches_b.get(f"newton_system_d{G_D_ITEM}", 0) > 0,
          f"13b launched K1, and K3 at d = {D_RE} and d = {G_D_ITEM}")
    res = game_scoring.main(["--input-paths", files["valid"], "--output-dir", str(scored), "--model-input-dir",
                             str(out / "best"), "--evaluators", "AUC", "--device", "cuda"] + files["shards"])
    want_scores = {r["uid"]: r["predictionScore"] for r in load_scores(str(files["scores"] / "scores.avro"))}
    got_scores = load_scores(str(scored / "scores.avro"))
    check(len(got_scores) == len(want_scores) == res["numScored"]
          and all(r["predictionScore"] == want_scores[r["uid"]] for r in got_scores),
          f"13b game_scoring of that model gives phase 8's scores exactly, by uid ({len(got_scores)} rows)")

    # ---- 13c: the partitioned native feature index ----
    t0 = time.perf_counter()
    native_index.build_native_lib(force=True)
    t_build = time.perf_counter() - t0
    idx_out = work / "ooc-index"
    t0 = time.perf_counter()
    sizes = feature_indexing.main(["--input-paths", str(work / "index.avro"), "--output-dir", str(idx_out),
                                   "--num-partitions", str(OOC_PARTITIONS)] + files["shards"])
    t_index = time.perf_counter() - t0
    agree, rates = True, {"native": [], "pure": [], "IndexMap": []}
    for shard, size in sizes.items():
        imap = IndexMap.load(str(files["index"] / f"index-map-{shard}.json"))
        names = [imap.get_feature_name(i) for i in range(len(imap))]
        native = native_index.NativeIndexMap(str(idx_out / f"index-store-{shard}"), use_native=True)
        pure = native_index.NativeIndexMap(str(idx_out / f"index-store-{shard}"), use_native=False)
        agree &= len(native) == len(pure) == len(imap) == size
        agree &= list(native.get_indices(names)) == [pure.get_index(k) for k in names] == list(range(size))
        agree &= [native.get_feature_name(i) for i in range(size)] == [pure.get_feature_name(i)
                                                                       for i in range(size)] == names
        keys = names * max(1, 100_000 // len(names))
        for reader, fn in (("native", lambda: native.get_indices(keys)),
                           ("pure", lambda: [pure.get_index(k) for k in keys[:10_000]]),
                           ("IndexMap", lambda: [imap.get_index(k) for k in keys])):
            t0 = time.perf_counter()
            n_keys = len(fn())
            rates[reader].append(n_keys / (time.perf_counter() - t0))
        native.close()
        pure.close()
    log(f"  13c index library built in {t_build:.2f} s; feature_indexing --num-partitions {OOC_PARTITIONS} "
        f"{sizes} in {t_index:.2f} s; lookups/s by shard: "
        + "; ".join(f"{r} " + ", ".join(f"{x:.3e}" for x in v) for r, v in rates.items()))
    check(agree, f"13c the native reader, the pure reader and the IndexMap agree on every name -> index and "
                 f"index -> name of {sizes}")
    launches = {k: launches_a.get(k, 0) + launches_b.get(k, 0) for k in set(launches_a) | set(launches_b)}
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s wall on {smi}; launches {launches}")
    return launches


def _shard_report(coord) -> list:
    """Per shard of a sharded random effect on this rank: (shard, entities,
    blocks, store bytes (its footprint; budgeted: budget, peak resident),
    static-buffer bytes)."""
    from photon_tpu_torch.algorithm.re_store import block_device_cost

    rows = []
    for s, c in sorted(coord.shards.items()):
        st = c.last_residency_stats
        rows.append(dict(shard=s, entities=int(coord.plan.counts[s]), blocks=len(c.dataset.blocks),
                         footprint=int(sum(block_device_cost(b) for b in c.dataset.blocks)),
                         budget=None if st is None else st["budget_bytes"],
                         effective=None if st is None else st["effective_budget_bytes"],
                         peak_resident=None if st is None else st["peak_bytes"],
                         peak_total=None if st is None else st["peak_total_bytes"],
                         static_held=None if st is None else st["static_bytes"],
                         evictions=None if st is None else st["evictions"],
                         static_bytes=_static_block_bytes(c.dataset.blocks)))
    return rows


def _unsharded_agreement(est, reg, train, model, coords, cache) -> dict:
    """14a's random-effect coordinates against the unsharded ones on the same
    batch: fresh coordinates of each kind, each trained one pass from 14a's
    model against the same residual scores; per coordinate the largest
    |Δc| / (1 + |c|) over the table (inf if the shapes differ)."""
    plain_est, _ = _game_estimator(E, G_ITEMS, G_ITEM_CAP, 1)
    plain_est.solve_cache = cache
    scores = {cid: coords[cid].score(model.get(cid), train) for cid in ("global", "per_user", "per_item")}
    total = sum(scores.values())
    est._prepare_datasets(train)
    plain_est._prepare_datasets(train)
    fresh = (est._build_coordinates(train, reg), plain_est._build_coordinates(train, reg))
    out = {}
    for cid in ("per_user", "per_item"):
        tables = []
        for coords_of_kind in fresh:
            c = coords_of_kind[cid]
            c.begin_cd_pass(0)
            trained, _ = c.train(train, total - scores[cid], model.get(cid))
            tables.append(torch.as_tensor(trained.coefficients).double().cpu().numpy())
        a, b = tables
        out[cid] = float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.shape == b.shape else float("inf")
    return out


def multi_rank_game(rank: int, world: int, device, train, budget_divisor: int, compare: bool = False) -> dict:
    """Phase 14's rank program (14a-c): ``GameEstimator.fit`` of 7b's model
    (fixed + per user + per item, 2 passes, active set) on the mesh of the
    job's ranks, over ``train`` (7b's batch, shared from the parent's card):
    the fixed effect on this rank's rows (K1 on each, one all-reduce), the
    random effects entity-sharded (K3 on this rank's shards; with
    ``budget_divisor`` each shard out of core at that fraction of its
    footprint); then a fixed-effect TRON solve on this rank's rows (K1
    trials, K2 products). With ``compare`` (one rank), the same coordinates
    unsharded beside them (``_unsharded_agreement``, and TRON on the whole
    batch), after the launches are read. Returns host arrays and counts."""
    from photon_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
    from photon_tpu_torch.algorithm.re_store import block_device_cost
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.parallel.mesh import make_mesh
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls
    from photon_tpu_torch.types import OptimizerType, TaskType

    full_precision_matmuls()
    mesh = make_mesh(device=device)
    est, reg = _game_estimator(E, G_ITEMS, G_ITEM_CAP, G_PASSES)
    est.mesh = mesh
    cache = est.solve_cache = SolveCache()
    if budget_divisor:
        est.re_device_budget_bytes = lambda _s, ds: sum(block_device_cost(b) for b in ds.blocks) // budget_divisor
    coords = {}
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (res,) = est.fit(train, optimization_configs=[reg],
                     on_coordinate=lambda it, cid, coord, wall: coords.__setitem__(cid, coord))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(launch_counts(), **{f"newton_system_d{d}": c
                                             for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    fe_routes = [(tuple(i["key"]), i["route"]) for i in cache.entry_info() if i["key"][0] == "fe"]
    eager_calls = cache.stats.eager_calls
    fit_peak = torch.cuda.max_memory_allocated()
    model = res.model
    out = dict(rank=rank, world=world, fit_s=fit_s, fit_peak=fit_peak, fit_launches=fit_launches,
               fe_routes=fe_routes, fe_eager_calls=eager_calls,
               fe=model.get("global").model.coefficients.means.float().cpu().numpy(),
               users=model.get("per_user").coefficients.cpu().numpy(),
               items=model.get("per_item").coefficients.cpu().numpy(),
               shards={cid: _shard_report(coords[cid]) for cid in ("per_user", "per_item")},
               busy={cid: coords[cid].device_busy_seconds() for cid in ("per_user", "per_item")},
               fe_iterations=[int(t.iterations) for t in res.tracker["global"]])

    # A fixed-effect TRON solve on this rank's rows.
    kernels.reset_launches()
    tron = FixedEffectCoordinate("global_tron", "global", TaskType.LOGISTIC_REGRESSION,
                                 GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0),
                                 OptimizerSpec(OptimizerType.TRON, max_iter=5, track_history=False),
                                 solve_cache=cache, mesh=mesh)
    t0 = time.perf_counter()
    tron_model, tron_res = tron.train(train)
    torch.cuda.synchronize()
    out.update(tron_s=time.perf_counter() - t0, tron_launches=launch_counts(),
               tron=tron_model.model.coefficients.means.float().cpu().numpy(),
               tron_iterations=int(tron_res.iterations), peak=torch.cuda.max_memory_allocated(),
               eager_calls=cache.stats.eager_calls)
    if compare:
        from photon_tpu_torch.parallel.distributed import shard_batch

        whole = FixedEffectCoordinate("global_tron_whole", "global", TaskType.LOGISTIC_REGRESSION,
                                      GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0),
                                      OptimizerSpec(OptimizerType.TRON, max_iter=5, track_history=False),
                                      solve_cache=cache)
        whole_model, whole_res = whole.train(train)
        out.update(tron_whole=whole_model.model.coefficients.means.float().cpu().numpy(),
                   tron_value=float(tron_res.value), tron_whole_value=float(whole_res.value))
        # Both solves stepped by hand (the coordinates' objective: fused on the card).
        lb = train.labeled_batch("global")
        obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0, use_fused=True)
        spec = OptimizerSpec(OptimizerType.TRON, max_iter=5, track_history=False)
        w0 = torch.zeros(lb.features.shape[1], device=device)
        out["tron_traces"] = [_tron_trace(obj, spec, w0, b)[1] for b in (shard_batch(lb, mesh), lb)]
        out["unsharded"] = _unsharded_agreement(est, reg, train, model, coords, cache)
    return out


def _probe_point(device) -> torch.Tensor:
    """14d's seeded point of config 6's coefficient space."""
    g = torch.Generator(device=device).manual_seed(14)
    return torch.randn(SP_D, device=device, generator=g) / 8.0


def _search_state(ls: torch.Tensor) -> tuple:
    """(search phase, trial step, trials) of an L-BFGS line-search state."""
    from photon_tpu_torch.optim import linesearch

    return int(ls[linesearch._PHASE]), float(ls[linesearch._A_CUR]), int(ls[linesearch._EVALS])


def multi_rank_feature(rank: int, world: int, device, data, iters: int) -> dict:
    """14d's rank program: config 6 (``data``: its sparse batch, shared from
    the parent's card) with w sharded over a (1, world) feature mesh: the
    value and gradient at ``_probe_point`` (the gradient gathered), then
    ``iters`` L-BFGS iterations from zero through
    ``train_fixed_effect_feature_sharded`` (objective at zero and at the
    end, iterations, wall, peak memory), then the same solve stepped by hand
    with its state read after every step (the trajectory 14d compares)."""
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import OptimizerConfig
    from photon_tpu_torch.optim.lbfgs import LBFGS
    from photon_tpu_torch.optim.problem import CallableOracle
    from photon_tpu_torch.parallel.feature_sharded import (
        FeatureSpace, place_feature_sharded, sparse_value_and_grad_feature_sharded, train_fixed_effect_feature_sharded)
    from photon_tpu_torch.parallel.mesh import FEATURE_AXIS, make_mesh

    mesh = make_mesh(n_data=1, n_feature=world, device=device)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    cfg = OptimizerConfig(max_iter=iters, track_history=False)
    torch.cuda.reset_peak_memory_stats()
    w_probe, b = place_feature_sharded(mesh, _probe_point(device), data)
    val, g = sparse_value_and_grad_feature_sharded(obj, mesh, SP_D)(w_probe, b)
    g = torch.cat(mesh.all_gather(g.contiguous(), FEATURE_AXIS))
    w0, b = place_feature_sharded(mesh, torch.zeros(SP_D, device=device), data)
    fit = train_fixed_effect_feature_sharded(mesh, obj, cfg, SP_D)
    f0 = float(sparse_value_and_grad_feature_sharded(obj, mesh, SP_D)(w0, b)[0])
    t0 = time.perf_counter()
    res = fit(w0, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    w_fit = torch.cat(mesh.all_gather(res.w.contiguous(), FEATURE_AXIS))
    del fit
    vg = sparse_value_and_grad_feature_sharded(obj, mesh, SP_D)
    prog = LBFGS(CallableOracle(lambda w: vg(w, b)), w0, cfg, None, FeatureSpace(mesh))
    prog.init()
    trace = []
    for _ in range(prog.max_steps):
        if not bool(prog.running()):
            break
        prog.step()
        S = prog.s
        trace.append((int(S["it"]), int(S["phase"]), float(S["f"])) + _search_state(S["ls"]))
    prog.finish()
    w_traced = torch.cat(mesh.all_gather(prog.result().w.contiguous(), FEATURE_AXIS))
    return dict(rank=rank, world=world, wall=wall, f0=f0, value=float(res.value), iterations=int(res.iterations),
                probe_value=float(val), probe_grad=g.cpu().numpy() if rank == 0 else None,
                local=int(res.w.shape[0]), peak=peak, trace=trace, traced_equal=bool(torch.equal(w_fit, w_traced)),
                w=w_fit.cpu().numpy() if rank == 0 else None)


def _trajectories(one: list, two: list, decisions: tuple, values: tuple) -> dict:
    """Where two solver traces part: the first step whose decision fields
    (tuple positions ``decisions``) differ, or None, and the largest
    relative difference of each field in ``values`` before it."""
    parted, diff = None, {i: 0.0 for i in values}
    for k, (a, b) in enumerate(zip(one, two)):
        if tuple(a[i] for i in decisions) != tuple(b[i] for i in decisions):
            parted = k
            break
        for i in values:
            diff[i] = max(diff[i], abs(a[i] - b[i]) / max(abs(a[i]), 1e-30))
    if parted is None and len(one) != len(two):
        parted = min(len(one), len(two))
    return dict(parted=parted, diff=diff, steps=(len(one), len(two)),
                at=None if parted is None else (one[parted] if parted < len(one) else None,
                                                two[parted] if parted < len(two) else None))


def _tron_trace(objective, spec, w0, lb) -> tuple:
    """A fixed-effect TRON solve stepped by hand, its state read after every
    step: (result, [(iteration, phase, CG steps, reason, f, radius, trial
    f)])."""
    from photon_tpu_torch.optim.factory import fe_program

    prog = fe_program(objective, spec, w0, lb)
    prog.init()
    trace = []
    for _ in range(prog.max_steps):
        if not bool(prog.running()):
            break
        prog.step()
        S = prog.s
        trace.append((int(S["it"]), int(S["phase"]), int(S["cg_it"]), int(S["reason"]), float(S["f"]),
                      float(S["delta"]), float(S["f_t"])))
    prog.finish()
    return prog.result(), trace


def multi_rank_phase(dev, smi: str, check) -> dict:
    """Phase 14: multiple devices, as torch.distributed ranks on this one
    card, over 7b's batch (made again from its seeds). 14a
    ``GameEstimator.fit(mesh=)`` of 7b's model on one NCCL rank,
    14b on 2 and 4 gloo ranks sharing the card, 14c on 2 gloo ranks with
    each random-effect shard out of core at a quarter of its footprint (each
    with a fixed-effect TRON solve on its rows after the fit), 14d config 6's
    fixed effect feature-sharded over 2 gloo ranks. Fails unless every rank
    of 14a-c launched K1, K2 and K3, the random effects are bitwise equal
    across 14a and 14b's runs and 14c's are 14b's world-2 run's, the fixed
    effect agrees with 7b's (MR_FE_TOL), 14a's coordinates agree with the
    unsharded ones (MR_RE_TOL) and 14a's TRON follows the whole batch's
    step for step (MR_TRAJECTORY_TOL, MR_STEP_TOL), and 14d's value and gradient
    agree with one rank's (MR_FEATURE_TOL) and its fit follows one rank's
    step for step (MR_TRAJECTORY_TOL, MR_STEP_TOL).
    Returns the launches of 14a-c, summed over their ranks."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.data.synthetic import make_data
    from photon_tpu_torch.utils.virtual_devices import RankFailed, run_ranks

    log(f"## phase 14: multiple devices (torch.distributed ranks on this one card: NCCL at world 1, gloo when ranks "
        f"share the card; no check runs on more than one GPU); card {smi}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    Xf, Xr, users, _y = make_data(N, D_FIX, D_RE, E, seed=0, device=dev)
    train, _valid = _glmix_batches(dev, smi, Xf.to(torch.bfloat16), Xr, users, E, seed=7)
    del Xf, Xr, users, _y, _valid
    runs = {}
    plan = [("14a", 1, "nccl", "cuda:0", 0)] + [(f"14b/{n}", n, "gloo", "cuda:0", 0) for n in MR_WORLDS] + [
        ("14c", 2, "gloo", "cuda:0", MR_BUDGET_DIVISOR)]
    for label, n, backend, device, divisor in plan:
        t0 = time.perf_counter()
        try:
            runs[label] = run_ranks(multi_rank_game, n, backend=backend, device=device,
                                    args=(train, divisor, label == "14a"), timeout_s=MR_TIMEOUT_S,
                                    deadline_s=MR_DEADLINE_S)
        except RankFailed as exc:
            check(False, f"{label}: {n} {backend} rank(s) ran to their end ({str(exc)[-1500:]})")
            continue
        log(f"  {label}: {n} {backend} rank(s) on {device}{', each shard budgeted at 1/' + str(divisor) if divisor else ''}"
            f": {time.perf_counter() - t0:.1f} s wall (spawn, dataset grouping, fit, TRON)")
        for r in runs[label]:
            k1, k2, k3 = (ran(r["fit_launches"], k) + ran(r["tron_launches"], k)
                          for k in ("fused_value_grad", "fused_hvp", "newton_system"))
            k3w = {k: v for k, v in r["fit_launches"].items() if k.startswith("newton_system_d")}
            log(f"    rank {r['rank']}: fit {r['fit_s']:.3f} s ({r['fe_iterations']} fixed-effect iterations a pass), "
                f"TRON {r['tron_s']:.3f} s ({r['tron_iterations']} iterations); K1 {k1}, K2 {k2}, K3 {k3} (by width "
                f"{k3w}) launches that ran; fixed-effect solve routes {r['fe_routes']}, {r['eager_calls']} eager "
                f"dispatches; peak memory {r['fit_peak'] / 2 ** 30:.2f} GiB (fit), {r['peak'] / 2 ** 30:.2f} GiB "
                f"(with TRON); random-effect busy seconds by rank {r['busy']}")
            for cid, shards in r["shards"].items():
                log(f"      {cid} shards: " + "; ".join(
                    f"{sh['shard']}: {sh['entities']} entities, {sh['blocks']} blocks, store "
                    f"{sh['footprint'] / 2 ** 20:.1f} MiB"
                    + ("" if sh["budget"] is None else f" (budget {sh['budget'] / 2 ** 20:.1f} MiB, effective "
                       f"{sh['effective'] / 2 ** 20:.1f} MiB, peak resident {sh['peak_resident'] / 2 ** 20:.1f} MiB "
                       f"+ static buffers held {sh['static_held'] / 2 ** 20:.1f} MiB = peak "
                       f"{sh['peak_total'] / 2 ** 20:.1f} MiB, {sh['evictions']} evictions)")
                    + f", static buffers one set a geometry (the former layout) {sh['static_bytes'] / 2 ** 20:.1f} MiB"
                    for sh in shards))
                if any(sh["budget"] is not None for sh in shards):
                    check(all(sh["peak_total"] <= sh["effective"] for sh in shards if sh["budget"] is not None),
                          f"{label} rank {r['rank']} {cid}: every budgeted shard's resident blocks plus its static "
                          f"buffers stay at or under its effective budget")
            check(k1 > 0 and k2 > 0 and k3 > 0, f"{label} rank {r['rank']}: K1 ({k1}), K2 ({k2}) and K3 ({k3}) "
                                                f"launched and ran")
    base = runs.get("14b/2")
    if base is not None:
        ref = base[0]
        for label, rs in runs.items():
            for r in rs:
                same = {k: bool(np.array_equal(r[k], ref[k])) for k in ("users", "items", "fe", "tron")}
                log(f"  {label} rank {r['rank']} vs 14b/2 rank 0, bitwise: {same}")
                check(all(same.values()), f"{label} rank {r['rank']}: random-effect coefficients (per user, per "
                                          f"item), the fixed effect and the TRON solve bitwise 14b's world-2 run's")
        fe7 = PHASE7B.get("global")
        if fe7 is not None:
            err = float(np.abs(ref["fe"] - fe7.numpy()).max()) / max(float(np.abs(fe7.numpy()).max()), 1e-30)
            check(err <= MR_FE_TOL, f"14 fixed effect after {G_PASSES} passes vs 7b's: max |Δw| / max |w| "
                                    f"{err:.3e} (tolerance {MR_FE_TOL:g}; 14's fixed-effect sums run over 8 row shards, 7b's "
                                    f"over the whole batch)")
    one = runs.get("14a")
    if one is not None:
        r = one[0]
        w_whole = r["tron_whole"]
        tron_err = float(np.abs(r["tron"] - w_whole).max()) / max(float(np.abs(w_whole).max()), 1e-30)
        value_rel = abs(r["tron_value"] - r["tron_whole_value"]) / abs(r["tron_whole_value"])
        tr = _trajectories(*r["tron_traces"], (0, 1, 2, 3), (4, 5, 6))
        log(f"  14a: TRON on the rows-sharded batch vs on the whole batch, step by step ({tr['steps']} steps): "
            + ("no decision differs" if tr["parted"] is None else
               f"the first decision that differs is at step {tr['parted']}: (iteration, phase, CG steps, reason, f, "
               f"radius, trial f) {tr['at'][0]} sharded, {tr['at'][1]} whole")
            + f"; before it f rel {tr['diff'][4]:.3e}, radius rel {tr['diff'][5]:.3e}, trial f rel "
              f"{tr['diff'][6]:.3e}; the solves' objectives rel {value_rel:.3e}, max |Δw| / max |w| {tron_err:.3e}")
        check(value_rel <= MR_TRAJECTORY_TOL and max(tr["diff"][4], tr["diff"][6]) <= MR_TRAJECTORY_TOL
              and tr["diff"][5] <= MR_STEP_TOL,
              f"14a: TRON on the rows-sharded batch follows the whole batch's step for step: f and trial f rel "
              f"{max(tr['diff'][4], tr['diff'][6]):.3e} (tolerance {MR_TRAJECTORY_TOL:g}), radius rel "
              f"{tr['diff'][5]:.3e} (tolerance {MR_STEP_TOL:g})"
              + ("" if tr["parted"] is None else f" up to step {tr['parted']}, where a decision differs")
              + f"; the solves' objectives rel {value_rel:.3e} (tolerance {MR_TRAJECTORY_TOL:g})")
        check(max(r["unsharded"].values()) <= MR_RE_TOL,
              f"14a: the sharded random-effect coordinates vs the unsharded ones, one pass from 14a's model on the "
              f"same batch: max |Δc| / (1 + |c|) {', '.join(f'{k} {v:.3e}' for k, v in r['unsharded'].items())} "
              f"(tolerance {MR_RE_TOL:g})")

    # ---- 14d: config 6's fixed effect feature-sharded over 2 gloo ranks, against 1 ----
    idx, vals, y = _sparse_wide_data()
    data = LabeledBatch(torch.from_numpy(y).to(dev),
                        SparseFeatures(torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev), SP_D))
    feat = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        try:
            feat[n] = run_ranks(multi_rank_feature, n, backend="gloo", device="cuda:0",
                                args=(data, MR_FEATURE_ITERS), timeout_s=MR_TIMEOUT_S, deadline_s=MR_DEADLINE_S)
        except RankFailed as exc:
            check(False, f"14d: {n} gloo rank(s) ran to their end ({str(exc)[-1500:]})")
            continue
        log(f"  14d: config 6 (n = d = 2^{SP_D.bit_length() - 1}, {SP_K} nnz a row) with w over {n} gloo rank(s), "
            f"{MR_FEATURE_ITERS} L-BFGS iterations: {time.perf_counter() - t0:.1f} s wall; " + "; ".join(
                f"rank {r['rank']}: {r['local']} coefficients, fit {r['wall']:.3f} s, objective {r['f0']:.6f} -> "
                f"{r['value']:.6f}, {r['iterations']} iterations, peak {r['peak'] / 2 ** 30:.2f} GiB" for r in feat[n]))
        check(all(r["traced_equal"] and r["value"] == feat[n][0]["value"] and np.isfinite(r["value"])
                  and r["value"] < r["f0"] for r in feat[n]),
              f"14d/{n}: the fit lowers the objective, finite and equal on every rank, and the solve stepped by hand "
              f"ends bitwise at the fit's coefficients")
    if len(feat) == 2:
        one, two = feat[1][0], feat[2][0]
        dv = abs(two["probe_value"] - one["probe_value"]) / abs(one["probe_value"])
        dg = float(np.abs(two["probe_grad"] - one["probe_grad"]).max()) / max(float(np.abs(one["probe_grad"]).max()),
                                                                             1e-30)
        check(dv <= MR_FEATURE_TOL and dg <= MR_FEATURE_TOL,
              f"14d: value and gradient at a seeded point, w over 2 ranks vs one rank: value rel {dv:.3e}, gradient "
              f"max |Δg| / max |g| {dg:.3e} (tolerance {MR_FEATURE_TOL:g})")
        tr = _trajectories(one["trace"], two["trace"], (0, 1, 3, 5), (2, 4))
        tr["df"], tr["da"] = tr["diff"][2], tr["diff"][4]
        fit_rel = abs(two["value"] - one["value"]) / abs(one["value"])
        w_rel = float(np.abs(two["w"] - one["w"]).max()) / max(float(np.abs(one["w"]).max()), 1e-30)
        log(f"  14d: 2 ranks vs 1, step by step ({tr['steps']} steps): "
            + (f"no decision differs" if tr["parted"] is None else
               f"the first decision that differs is at step {tr['parted']}: (iteration, phase, objective, search phase, "
               f"trial step, trials) {tr['at'][0]} with 1 rank, {tr['at'][1]} with 2")
            + f"; before it objective rel {tr['df']:.3e}, trial step rel {tr['da']:.3e}; after the fit objective rel "
              f"{fit_rel:.3e}, max |Δw| / max |w| {w_rel:.3e}")
        if tr["parted"] is None:
            # With every decision alike, the whole fit agrees.
            check(fit_rel <= MR_TRAJECTORY_TOL,
                  f"14d: the fit over 2 ranks vs one: objective rel {fit_rel:.3e} (tolerance {MR_TRAJECTORY_TOL:g})")
        check(tr["df"] <= MR_TRAJECTORY_TOL and tr["da"] <= MR_STEP_TOL,
              f"14d: the 2-rank fit follows the 1-rank fit step for step: objective rel {tr['df']:.3e} (tolerance "
              f"{MR_TRAJECTORY_TOL:g}), trial step rel {tr['da']:.3e} (tolerance {MR_STEP_TOL:g})"
              + ("" if tr["parted"] is None else f" up to step {tr['parted']}, where a decision differs"))
    del data, train
    launches: dict = {}
    for rs in runs.values():
        for r in rs:
            for part in (r["fit_launches"], r["tron_launches"]):
                for k, v in part.items():
                    launches[k] = launches.get(k, 0) + v
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s wall on {smi}; launches (all ranks) {launches}")
    return launches


def _add_launches(total: dict) -> None:
    """Add the launches counted since the last reset (``launch_counts``,
    and K3's by width as "newton_system_d<d>") to ``total``."""
    from photon_tpu_torch.ops import fused_newton

    counts = launch_counts()
    counts.update({f"newton_system_d{d}": c for d, c in fused_newton.LAUNCHES_BY_WIDTH.items()})
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _reset_launches() -> None:
    from photon_tpu_torch.ops import fused_newton, kernels

    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()


def _spawn_logged(argv: list, log_path: Path, env=None):
    """A child python process from the repository root (spawned, never a
    fork of this CUDA process), standard error to ``log_path``."""
    import os

    return subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE, stderr=open(log_path, "w"), text=True,
                            cwd=str(Path(__file__).resolve().parent), env=dict(os.environ, **(env or {})))


def _banner(proc, timeout_s: float) -> dict:
    """The first line of a server's standard output (its JSON banner)."""
    import threading

    box = {}
    t = threading.Thread(target=lambda: box.setdefault("line", proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    line = box.get("line") or ""
    return json.loads(line) if line.startswith("{") else {}


def _post_json(port: int, path: str, obj) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _http_loop(port: int, lines, clients: int, stop, out: list) -> list:
    """Clients that POST ``lines`` to /v1/score in turn until ``stop`` is
    set; each answer appends (time, modelVersion) to ``out``, each failure
    its text to the returned list. Returns (threads, failures)."""
    import http.client
    import threading

    failed = []

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        i = k
        try:
            while not stop.is_set():
                try:
                    conn.request("POST", "/v1/score", body=lines[i % len(lines)],
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status != 200:
                        raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
                    out.append((time.perf_counter(), json.loads(body).get("modelVersion")))
                except Exception as exc:  # noqa: BLE001 — counted and reported
                    failed.append(repr(exc))
                i += clients
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(clients)]
    for t in threads:
        t.start()
    return threads, failed


def _copy_root(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


def _root_artifacts(root: Path):
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap

    imaps = {p.name[len("index-map-"):-len(".json")]: IndexMap.load(str(p)) for p in root.glob("index-map-*.json")}
    eidx = {p.name[len("entity-index-"):-len(".json")]: EntityIndex.load(str(p))
            for p in root.glob("entity-index-*.json")}
    return imaps, eidx


def _latest(root: Path) -> str:
    return (root / "LATEST").read_text().strip()


def streaming_phase(dev, smi: str, check, files: dict) -> dict:
    """Phase 17: the streaming freshness loop on the card, on phase 8's
    files and model. 17a: phase 8's best/ published as gen-1 (with its
    holdout AUC) under a publish root, a delta of STREAM_DELTA_ROWS rows
    from phase 8's generator (a subset of the users and items, and new ones
    of each) through ``game_incremental`` in process: K1 and K3 at d = 16
    and 128 launched, every unchanged entity's row the parent's bit for bit,
    the gate passed and LATEST moved; the same run as a spawned process on a
    copy of the root writes the same files (the manifests' sha256), and
    ``incremental_update(emit_delta=True)`` on a third copy publishes a
    delta layer that resolves to the full publish's coefficients bit for
    bit. 17b: ``game_serving --feedback-spool`` spawned on the card serving
    gen-1; STREAM_REQUESTS /v1/score requests with uids, their labels
    through /v1/feedback; once the spool has sealed them, ``game_streaming
    --max-cycles 1`` spawned: it publishes a delta micro-generation with
    its consume cursor, the server's watcher installs it under live
    traffic, and afterwards the served scores are game_scoring's of the
    resolved chain bit for bit, nothing was captured or allocated after the
    delta's warm-up and no request failed (freshness from the last label to
    the first response of the new generation, the cycle's wall, requests/s
    across the flip). 17c: game_streaming killed at ``stream.consume`` (the
    train call) on a copy of 17b's root and spool, then restarted in
    process: the same model files as 17b's unbroken cycle, the cursor
    applied once. 17d: the engine in process on gen-1 with 17b's delta
    promoted and gen-1 pinned as the quality baseline: the quality plane
    counts every joined label under both versions. Returns the launches of
    the in-process runs (17a's two updates, 17c's restart)."""
    import os

    from photon_tpu_torch.cli import game_incremental, game_scoring
    from photon_tpu_torch.cli.common import parse_coordinate_config, parse_feature_shard_config
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.io.data_reader import read_merged
    from photon_tpu_torch.io.model_io import (delta_info, gate_and_publish, load_game_model,
                                              load_generation_manifest, load_resolved_game_model, read_delta_rows,
                                              save_game_model, write_generation_manifest)
    from photon_tpu_torch.ops import fused_newton, kernels
    from photon_tpu_torch.optim.common import HOST_READS
    from photon_tpu_torch.serve import ServeConfig
    from photon_tpu_torch.serve.engine import load_engine
    from photon_tpu_torch.stream.spool import FeedbackSpool, SpoolConfig, read_segment, sealed_segments
    from photon_tpu_torch.stream.updater import StreamingUpdater, StreamingUpdaterConfig
    from photon_tpu_torch.train.incremental import compute_holdout_metrics, incremental_update
    from photon_tpu_torch.types import TaskType

    log("## phase 17: the streaming freshness loop (incremental generations, feedback spool, updater)")
    t_phase = time.perf_counter()
    launches: dict = {}
    out = Path(files["out"])
    work = Path(files["work"]) / "stream"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    shards = files["shards"]
    shard_cfgs: dict = {}
    for spec in shards[1:]:
        shard_cfgs.update(parse_feature_shard_config(spec))
    coord_specs = ["name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=1",
                   "name=perUser,feature.shard=userShard,random.effect.type=userId,reg.weights=1",
                   "name=perItem,feature.shard=itemShard,random.effect.type=itemId,reg.weights=1"]
    coords = ["--coordinate-configurations", *coord_specs, "--update-sequence", "global,perUser,perItem"]
    re_cids = {"perUser": "userId", "perItem": "itemId"}

    # 17a. gen-1: phase 8's best/ with its holdout AUC on phase 8's validation rows.
    t0 = time.perf_counter()
    root0 = work / "root0"
    shutil.copytree(out / "best", root0 / "gen-1")
    for p in list(out.glob("index-map-*.json")) + list(out.glob("entity-index-*.json")):
        shutil.copy(p, root0 / p.name)
    imaps0, eidx0 = _root_artifacts(root0)
    valid, _, _ = read_merged([files["valid"]], shard_cfgs, imaps0, {rt: rt for rt in eidx0}, eidx0,
                              intern_new_entities=False, device=dev)
    suite = EvaluationSuite([EvaluatorSpec.parse("AUC")], {k: len(v) for k, v in eidx0.items()})
    holdout1 = compute_holdout_metrics(load_game_model(str(root0 / "gen-1"), imaps0, eidx0, device=dev), valid, suite)
    write_generation_manifest(str(root0 / "gen-1"), parent=None, holdout_metrics=holdout1)
    gate1 = gate_and_publish(str(root0), "gen-1")
    del valid
    check(gate1.ok and _latest(root0) == "gen-1", f"17a phase 8's best/ published as gen-1 (holdout {holdout1}, "
                                                  f"gate {gate1.reason})")
    roots = {k: _copy_root(root0, work / f"root-{k}") for k in ("cli", "spawned", "delta", "serve", "crash")}
    delta_dir = Path(files["delta"])  # written in phase 8's pool
    delta_files = _split(delta_dir, STREAM_DELTA_ROWS, STREAM_DELTA_FILES)
    touched = {"userId": set(), "itemId": set()}
    for i, (_, n) in enumerate(delta_files):
        _, users, items, _ = _driver_arrays(n, STREAM_DELTA_SEED + i, STREAM_USERS, H_ITEMS)
        u, it = _delta_ids(users, items)
        touched["userId"].update(u)
        touched["itemId"].update(it)
    new = {rt: sum(1 for k in ids if eidx0[rt].lookup(k) < 0) for rt, ids in touched.items()}
    log(f"  gen-1 published in {time.perf_counter() - t0:.1f} s; the delta (written in phase 8): {STREAM_DELTA_ROWS} rows "
        f"touching {len(touched['userId'])} of {len(eidx0['userId'])} users ({new['userId']} new) and "
        f"{len(touched['itemId'])} of {len(eidx0['itemId'])} items ({new['itemId']} new)")

    argv = ["--input-paths", str(delta_dir), "--validation-paths", files["valid"], *shards, *coords,
            "--evaluators", "AUC", "--metric-tolerance", "0.05", "--norm-drift-bound", "1000"]
    # The same update as a spawned process on a copy, beside the in-process
    # runs (its files are compared, not its wall).
    t_spawned = time.perf_counter()
    spawned_proc = _spawn_logged(["-m", "photon_tpu_torch.cli.game_incremental", *argv, "--publish-root",
                                  str(roots["spawned"]), "--device", dev.type], work / "incremental.log")
    torch.cuda.synchronize()
    _reset_launches()
    reads0, t0 = HOST_READS.count, time.perf_counter()
    inc = game_incremental.run(game_incremental.build_parser().parse_args(
        argv + ["--publish-root", str(roots["cli"]), "--device", dev.type]))
    torch.cuda.synchronize()
    inc_wall = time.perf_counter() - t0
    by_width = dict(fused_newton.LAUNCHES_BY_WIDTH)
    k1 = kernels.LAUNCHES["fused_value_grad"]
    _add_launches(launches)
    log(f"  17a game_incremental: {inc_wall:.2f} s wall, {HOST_READS.count - reads0} host reads, generation "
        f"{inc['generation']} over {inc['parent']}, published {inc['published']} ({inc['gateReason']}), changed "
        f"{inc['changedEntities']}, holdout {inc['holdoutMetrics']} (gen-1 {holdout1}); K1 {k1}, K3 by width "
        f"{by_width}")
    check(k1 > 0 and by_width.get(D_RE, 0) > 0 and by_width.get(G_D_ITEM, 0) > 0,
          f"17a game_incremental launched K1, and K3 at d = {D_RE} and d = {G_D_ITEM}")
    gen = inc["generation"]
    check(inc["published"] and inc["parent"] == "gen-1" and _latest(roots["cli"]) == gen,
          f"17a the gate passed ({inc['gateReason']}) and LATEST moved to {gen}")
    imaps_a, eidx_a = _root_artifacts(roots["cli"])
    parent = load_game_model(str(root0 / "gen-1"), imaps0, eidx0, device="cpu")
    child = load_game_model(str(roots["cli"] / gen), imaps_a, eidx_a, device="cpu")
    for cid, rt in re_cids.items():
        p, c = parent.models[cid].coefficients, child.models[cid].coefficients
        changed = torch.zeros(c.shape[0], dtype=torch.bool)
        changed[[eidx_a[rt].lookup(k) for k in touched[rt]]] = True
        keep = ~changed[:p.shape[0]]
        moved = int((c[:p.shape[0]][changed[:p.shape[0]]] != p[changed[:p.shape[0]]]).any(1).sum())
        check(c.shape[0] == len(eidx0[rt]) + new[rt] and torch.equal(c[:p.shape[0]][keep], p[keep])
              and inc["changedEntities"][rt] == int(changed.sum()),
              f"17a {cid}: {int(keep.sum())} unchanged rows the parent's bit for bit, {int(changed.sum())} changed "
              f"({moved} of the known ones moved), {new[rt]} new rows of {c.shape[0]}")

    # incremental_update with emit_delta on a third copy: the layer resolves
    # to the full publish's coefficients.
    imaps_c, eidx_c = _root_artifacts(roots["delta"])
    batch, imaps_c, eidx_c = read_merged([str(delta_dir)], shard_cfgs, imaps_c, {rt: rt for rt in eidx_c}, eidx_c,
                                         intern_new_entities=True, device=dev)
    valid, _, _ = read_merged([files["valid"]], shard_cfgs, imaps_c, {rt: rt for rt in eidx_c}, eidx_c,
                              intern_new_entities=False, device=dev)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res_c = incremental_update(str(roots["delta"]), batch, imaps_c, eidx_c, TaskType.LOGISTIC_REGRESSION,
                               [parse_coordinate_config(c) for c in coord_specs], ["global", "perUser", "perItem"],
                               valid_batch=valid, evaluation_suite=EvaluationSuite(
                                   [EvaluatorSpec.parse("AUC")], {k: len(v) for k, v in eidx_c.items()}),
                               metric_tolerance=0.05, norm_drift_bound=1000.0, emit_delta=True, device=dev)
    torch.cuda.synchronize()
    delta_wall = time.perf_counter() - t0
    _add_launches(launches)
    del batch, valid
    layer = delta_info(res_c.model_dir) or {}
    resolved = load_resolved_game_model(res_c.model_dir, imaps_c, eidx_c, to_device=False,
                                        publish_root=str(roots["delta"]))
    same = all(torch.equal(resolved.models[cid].coefficients, child.models[cid].coefficients) for cid in re_cids)
    same = same and torch.equal(resolved.models["global"].model.coefficients.means,
                                child.models["global"].model.coefficients.means)
    man_a = load_generation_manifest(str(roots["cli"] / gen)) or {}
    check(res_c.published and res_c.is_delta and layer.get("base") == "gen-1" and same,
          f"17a incremental_update(emit_delta=True) ({delta_wall:.2f} s): a delta layer over {layer.get('base')} "
          f"({load_generation_manifest(res_c.model_dir)['totalBytes']} bytes, the full publish "
          f"{man_a.get('totalBytes')}) that resolves to the full publish's coefficients bit for bit")
    del parent, child, resolved
    try:
        spawned_out, _ = spawned_proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        spawned_proc.kill()
        spawned_out, _ = spawned_proc.communicate()
    rc = spawned_proc.returncode
    spawned = json.loads(spawned_out.strip().splitlines()[-1]) if rc == 0 and spawned_out.strip() else {}
    man_b = load_generation_manifest(str(roots["spawned"] / gen)) or {}
    check(rc == 0 and spawned.get("generation") == gen and man_a.get("files") == man_b.get("files")
          and bool(man_a.get("files")),
          f"17a game_incremental spawned on a copy of the root ({time.perf_counter() - t_spawned:.1f} s, rc {rc}, "
          f"beside the in-process runs): {len(man_b.get('files') or {})} model files with the in-process run's "
          f"sha256s" + ("" if rc == 0 else f"; log: {_tail(work / 'incremental.log')}"))

    # 17b. game_serving with the spool, game_streaming for one cycle.
    serve_root, spool = roots["serve"], work / "spool"
    feats, ids, offsets, labels = _serving_rows(files, out / "best", with_labels=True)
    # Entity ids as their names; an entity unseen in training (-1) has none.
    names = {rt: [eidx0[rt].entity_id(int(k)) if k >= 0 else None for k in v] for rt, v in ids.items()}

    def stream_args(spool_dir, root):
        """game_streaming for one cycle, as deployed beside the server: the
        fixed effect locked, micro-batches of any size published."""
        return ["-m", "photon_tpu_torch.cli.game_streaming", "--spool-dir", str(spool_dir), "--publish-root",
                str(root), *coords, "--lock-coordinates", "global", "--max-cycles", "1", "--min-records", "8",
                "--norm-drift-bound", "10000", "--cadence", "0.2", "--device", dev.type]

    def line(i, uid=None):
        body = {"features": {s: m[i].tolist() for s, m in feats.items()},
                "entityIds": {rt: names[rt][i] for rt in ids if names[rt][i] is not None},
                "offset": float(offsets[i])}
        if uid is not None:
            body["uid"] = uid
        return json.dumps(body)

    t0 = time.perf_counter()
    server = _spawn_logged(["-m", "photon_tpu_torch.cli.game_serving", "--model-input-dir", str(serve_root),
                            "--port", "0", "--device", dev.type, "--max-batch-size", str(SERVE_MAX_BATCH),
                            "--feedback-spool", str(spool), "--feedback-segment-records",
                            str(STREAM_SEGMENT_RECORDS), "--feedback-segment-age", str(STREAM_SEGMENT_AGE_S),
                            "--reload-poll-interval", "0.2"], work / "serving.log")
    try:
        banner = _banner(server, 600.0)
        check(bool(banner) and banner.get("modelVersion", "").endswith("gen-1"),
              f"17b game_serving --feedback-spool up in {time.perf_counter() - t0:.1f} s serving "
              f"{banner.get('modelVersion')}" + ("" if banner else f"; log: {_tail(work / 'serving.log')}"))
        port = banner.get("port")
        scored, failed, lat, wall = _http_all(port, [line(i, f"s{i}") for i in range(STREAM_REQUESTS)],
                                              STREAM_CLIENTS)
        log("  17b " + _load_text(f"{STREAM_REQUESTS} /v1/score with uids, {STREAM_CLIENTS} clients", STREAM_REQUESTS,
                                  lat, wall))
        joined = dropped = 0
        for lo in range(0, STREAM_REQUESTS, 256):
            got = _post_json(port, "/v1/feedback", {"labels": [
                {"uid": f"s{i}", "label": float(labels[i])} for i in range(lo, min(lo + 256, STREAM_REQUESTS))]})
            joined, dropped = joined + got["joined"], dropped + got["dropped"]
        t_label = time.perf_counter()
        sealed_records = 0
        while time.perf_counter() - t_label < 60:
            sealed_records = sum(len(read_segment(str(spool / f))) for f in sealed_segments(str(spool)))
            if sealed_records >= joined:
                break
            time.sleep(0.2)
        segments = sealed_segments(str(spool))
        check(not failed and joined == STREAM_REQUESTS and dropped == 0 and sealed_records == joined,
              f"17b {STREAM_REQUESTS} requests scored ({len(failed)} failed), {joined} labels joined, {dropped} "
              f"dropped, {sealed_records} records sealed in {len(segments)} segments "
              f"{time.perf_counter() - t_label:.1f} s after the last label")
        spool_copy = work / "spool-copy"
        spool_copy.mkdir()
        for f in segments:
            shutil.copy(spool / f, spool_copy / f)
        import threading

        stop, answers = threading.Event(), []
        check_lines = [line(i) for i in range(STREAM_CHECK_ROWS)]
        threads, bg_failed = _http_loop(port, check_lines, STREAM_CLIENTS // 2, stop, answers)
        t_stream = time.perf_counter()
        streamer = _spawn_logged(stream_args(spool, serve_root), work / "streaming.log")
        try:
            stream_out, _ = streamer.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            streamer.kill()
            stream_out, _ = streamer.communicate()
        stream_wall = time.perf_counter() - t_stream
        summary = json.loads(stream_out.strip().splitlines()[-1]) if streamer.returncode == 0 else {}
        gen_s = _latest(serve_root)
        man_s = load_generation_manifest(str(serve_root / gen_s)) or {}
        layer = delta_info(str(serve_root / gen_s)) or {}
        check(streamer.returncode == 0 and summary.get("publishes") == 1 and layer.get("base") == "gen-1"
              and (man_s.get("stream") or {}).get("consumedThrough") == len(segments)
              and (man_s.get("gate") or {}).get("status") == "published",
              f"17b game_streaming (rc {streamer.returncode}, {stream_wall:.1f} s with the process): {summary}; "
              f"{gen_s} a delta over {layer.get('base')}, stream block "
              f"{ {k: v for k, v in (man_s.get('stream') or {}).items() if k not in ('segments', 'traceIds')} }"
              + ("" if streamer.returncode == 0 else f"; log: {_tail(work / 'streaming.log')}"))
        t_flip = None
        while time.perf_counter() - t_stream < stream_wall + 60:
            hit = [t for t, v in list(answers) if str(v or "").endswith(gen_s)]
            if hit:
                t_flip = min(hit)
                break
            time.sleep(0.1)
        if t_flip is not None:
            time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        t_end = time.perf_counter()
        n_across = sum(1 for t, _ in answers if t >= t_stream)
        check(t_flip is not None and not bg_failed,
              f"17b the watcher installed {gen_s} under live traffic: {n_across} requests across the flip at "
              f"{n_across / (t_end - t_stream):.1f} requests/s, {len(bg_failed)} failed")
        if t_flip is not None:
            log(f"  17b freshness: {t_flip - t_label:.2f} s from the last label posted to the first response of "
                f"{gen_s}; the updater's cycle {summary.get('busyS', float('nan')):.2f} s (train and publish "
                f"{summary.get('trainS', float('nan')):.2f} s), its process {stream_wall:.1f} s; on {smi}")
        served, failed_after, lat2, wall2 = _http_all(port, check_lines, STREAM_CLIENTS)
        health = json.loads(_get(f"http://127.0.0.1:{port}/healthz")[2])
        check(not failed_after and str(health.get("model_version", "")).endswith(gen_s)
              and health.get("retraces_since_warmup") == 0,
              f"17b after the flip: {STREAM_CHECK_ROWS} requests, {len(failed_after)} failed, serving "
              f"{health.get('model_version')}, retraces_since_warmup {health.get('retraces_since_warmup')}")
    finally:
        import signal

        if server.poll() is None:
            server.send_signal(signal.SIGTERM)
        try:
            server_rc = server.wait(timeout=120)
        except subprocess.TimeoutExpired:
            server.kill()
            server_rc = server.wait()
        server.stdout.close()
    check(server_rc == 0, f"17b game_serving exited {server_rc} at SIGTERM")
    full = work / "resolved"
    imaps_s, eidx_s = _root_artifacts(serve_root)
    save_game_model(load_resolved_game_model(str(serve_root / gen_s), imaps_s, eidx_s, to_device=False,
                                             publish_root=str(serve_root)),
                    str(full / gen_s), imaps_s, eidx_s, sparsity_threshold=0.0)
    for p in list(serve_root.glob("index-map-*.json")) + list(serve_root.glob("entity-index-*.json")):
        shutil.copy(p, full / p.name)
    game_scoring.main(["--input-paths", files["valid"], "--output-dir", str(work / "scores"), "--model-input-dir",
                       str(full / gen_s), "--device", dev.type] + shards)
    want = _driver_scores(work / "scores" / "scores.avro")[:STREAM_CHECK_ROWS]
    check(np.array_equal(served, want),
          f"17b served scores after the flip equal game_scoring's of the resolved chain bit for bit "
          f"({int(np.sum(served != want))} of {STREAM_CHECK_ROWS} differ)")

    # 17c, first half: game_streaming killed at stream.consume's train call,
    # spawned beside 17d (its exit code and the root are checked, not its wall).
    crash_root = roots["crash"]
    plan = json.dumps({"rules": [{"site": "stream.consume", "kind": "kill", "at": [len(segments)]}]})
    t_killed = time.perf_counter()
    killed = _spawn_logged(stream_args(spool_copy, crash_root), work / "killed.log",
                           env={"PHOTON_TPU_FAULT_PLAN": plan})
    # 17d. the quality plane of an engine with a pinned baseline.
    eng = load_engine(str(serve_root / "gen-1"), artifacts_dir=str(serve_root),
                      config=ServeConfig(max_batch_size=SERVE_MAX_BATCH, device=dev.type))
    eng.attach_feedback(FeedbackSpool(str(work / "spool-quality"), SpoolConfig(segment_max_records=1 << 20,
                                                                               segment_max_age_s=3600.0)))
    try:
        payload = read_delta_rows(str(serve_root / gen_s), eng._index_maps, eng._entity_indexes)
        eng.load_delta_version(payload["base"], payload, str(serve_root / gen_s))
        eng.promote(str(serve_root / gen_s))
        eng.enable_quality_baseline("gen-1")
        nq = STREAM_QUALITY_REQUESTS
        reqs = [dataclasses.replace(r, uid=f"q{i}") for i, r in enumerate(_requests(feats, ids, offsets, range(nq)))]
        _, q_failed, _, _ = _submit_all(eng, reqs, STREAM_CLIENTS)
        q_joined = sum(bool(eng.feedback_label(f"q{i}", float(labels[i]))) for i in range(nq))
        st = eng.stats()
        counts = {v["model_version"]: v["count"] for v in st["quality"]["versions"]}
        aucs = {v["model_version"]: v["auc"] for v in st["quality"]["versions"]}
        check(not q_failed and q_joined == nq and counts == {gen_s: nq, "gen-1": nq}
              and st["quality"]["baseline"] == "gen-1" and st["retraces_since_warmup"] == 0,
              f"17d {nq} requests ({len(q_failed)} failed), {q_joined} labels joined; quality counts {counts} "
              f"(AUC {aucs}, baseline {st['quality']['baseline']}); retraces_since_warmup "
              f"{st['retraces_since_warmup']}")
    finally:
        eng.close()
    # 17c, second half: the killed run, then the restart in process.
    killed.communicate(timeout=900)
    check(killed.returncode == -9 and _latest(crash_root) == "gen-1",
          f"17c game_streaming killed at stream.consume call {len(segments)} (train) exited {killed.returncode} "
          f"after {time.perf_counter() - t_killed:.1f} s (beside 17d); LATEST {_latest(crash_root)}")
    imaps_e, eidx_e = _root_artifacts(crash_root)
    upd = StreamingUpdater(StreamingUpdaterConfig(
        publish_root=str(crash_root), spool_dir=str(spool_copy), task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs=[parse_coordinate_config(c) for c in coord_specs],
        update_sequence=["global", "perUser", "perItem"], cadence_s=0.2, min_records=8,
        locked_coordinates=["global"], norm_drift_bound=10000.0, device=dev.type), imaps_e, eidx_e)
    cursor0 = upd.consumed_through()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res_e = upd.run_once()
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    by_width = dict(fused_newton.LAUNCHES_BY_WIDTH)
    _add_launches(launches)
    again = upd.run_once()
    man_e = load_generation_manifest(str(crash_root / res_e.generation)) if res_e is not None else {}
    check(res_e is not None and res_e.published and res_e.generation == gen_s
          and man_e.get("files") == man_s.get("files") and bool(man_s.get("files")),
          f"17c restarted in process ({resume_wall:.2f} s, K3 by width {by_width}): {getattr(res_e, 'generation', None)} "
          f"with the unbroken cycle's model files (sha256s of {len(man_s.get('files') or {})} files)")
    check(cursor0 == 0 and again is None and upd.consumed_through() == len(segments)
          and (man_e.get("stream") or {}).get("consumedThrough") == len(segments),
          f"17c the cursor applied once: {cursor0} before the restart, {upd.consumed_through()} after, and a "
          f"second cycle consumes {'nothing' if again is None else again.records}")

    log(f"  phase 17: {time.perf_counter() - t_phase:.1f} s on {smi}; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a GPU", file=sys.stderr)
        return 1

    from photon_tpu_torch.algorithm.solve_cache import default_cache
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
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
    from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
    from photon_tpu_torch.parallel.train_step import full_precision_matmuls, glmix_train_step
    from photon_tpu_torch.types import OptimizerType

    t_start = time.perf_counter()
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
            print(f"chip_smoke [FAIL] {what}", file=sys.stderr, flush=True)
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
    # The launch flag at the headline shapes and launch plans (every
    # fixed-effect TRON, OWL-QN and L-BFGS step launches with it): on,
    # bitwise the launch without it; off, the zeroed outputs stay zero and
    # the launch is not counted as run.
    flag_on, flag_off = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (1, 0))
    kernels.reset_launches()
    for Xk, tag in ((Xb, "bf16"), (Xf, "f32")):
        k1 = [fused_value_grad(LogisticLoss, w, Xk, y, off, wt, return_margins=True, enable=e)
              for e in (None, flag_on, flag_off)]
        check(all(torch.equal(a, b) for a, b in zip(k1[0], k1[1])) and not any(bool(t.any()) for t in k1[2]),
              f"K1 N=2^21 d=256 {tag} margins with its launch flag: on, value, gradient and margins bitwise "
              f"those of the launch without it; off, all three left zero")
        k2 = [fused_hvp(w, Xk, d2, enable=e) for e in (None, flag_on, flag_off)]
        check(torch.equal(k2[0], k2[1]) and not bool(k2[2].any()),
              f"K2 N=2^21 d=256 {tag} with its launch flag: on, bitwise the launch without it; off, left zero")
        del k1, k2
    flagged = launch_counts()
    check(all(flagged[k] == 6 and flagged[f"{k}_ran"] == 4 for k in ("fused_value_grad", "fused_hvp")),
          f"K1 and K2: 6 launches each, 4 of them run (the flag's count on the card): {flagged}")
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
    built0 = cache_setup("GLMix step")
    reads0, total_visits, total_s = HOST_READS.count, 0, 0.0
    for p in range(1, CD_PASSES + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts0 = default_cache().stats.counts()
        r0, t0 = HOST_READS.count, time.perf_counter()
        w_fixed, re_coefs, scores, fe_evals, re_visits = step(w_fixed, re_coefs, fe_batch, block, Xr, users)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        reads = HOST_READS.count - r0
        visits = N * int(fe_evals) + int(re_visits)
        total_visits, total_s = total_visits + visits, total_s + dt
        losses.append(logloss(scores))
        fe_obj = GLMObjective(**obj).value(w_fixed, fe_batch.add_scores_to_offsets(scores - fe_batch.margins(w_fixed)))
        log(f"  pass {p}: {dt:.3f} s wall, {reads} host reads, fe X passes {int(fe_evals)}, "
            f"re visits {int(re_visits)}, {visits / dt:.4e} samples/s, training logloss {losses[-1]:.6f}, "
            f"FE objective {float(fe_obj):.6e}; {cache_text(default_cache().stats.since(counts0))}; {peak_text()}")
        check(bool(torch.isfinite(scores).all()) and np.isfinite(float(fe_obj)), f"pass {p}: scores and objective finite")
        check(losses[-1] < losses[-2], f"pass {p}: training logloss fell ({losses[-2]:.6f} -> {losses[-1]:.6f})")
    glmix_launches = launch_counts()
    cache_entries(built0)
    log(f"  GLMix {CD_PASSES} passes: {total_s:.3f} s, {HOST_READS.count - reads0} host reads, "
        f"{total_visits / total_s:.4e} samples/s (bench.py visit accounting) on {smi}; launches {glmix_launches}")
    check(glmix_launches["fused_value_grad"] > 0 and glmix_launches["newton_system"] > 0,
          "GLMix path launched K1 and K3")

    # 4c. one more pass under torch.profiler: device busy share, time by kernel.
    profiled("profiled pass", lambda: step(w_fixed, re_coefs, fe_batch, block, Xr, users))

    # ---------------- 5. TRON ----------------
    log("## phase 5: fixed-effect TRON through the solve cache (captured: K1 trials, K2 products)")
    tron_obj = GLMObjective(use_fused=True, **obj)
    spec5 = OptimizerSpec(OptimizerType.TRON, max_iter=5, tol=1e-5)
    w0 = torch.zeros(D_FIX, device=dev)
    f0 = float(tron_obj.value_and_grad(w0, fe_batch)[0])
    eager = make_optimizer(tron_obj, spec5)(w0, fe_batch)  # the same program, eagerly (not counted)
    cache5 = SolveCache()
    built0 = cache_setup("5 TRON", cache5)
    kernels.reset_launches()
    for attempt in ("capture", "replay"):
        torch.cuda.synchronize()
        r0, t0, counts0 = HOST_READS.count, time.perf_counter(), cache5.stats.counts()
        res = cache5.fe_solver(tron_obj, spec5)(w0, fe_batch)
        torch.cuda.synchronize()
        d5 = cache5.stats.since(counts0)
        log(f"  {attempt}: {time.perf_counter() - t0:.4f} s, {int(res.iterations)} iterations, "
            f"{res.convergence_reason.value}, {HOST_READS.count - r0} host reads, {int(res.x_passes)} X passes "
            f"({d5['x_passes_run']} run, masked steps and warm-up included), objective {f0:.6e} -> "
            f"{float(res.value):.6e}; {cache_text(d5)}")
    tron_launches = launch_counts()
    cache_entries(built0, cache5)
    for info, (ms, nodes) in zip(cache5.entry_info(), masked_steps(cache5)):
        log(f"  masked step of {info['key']}: {ms:.4f} ms, {nodes} graph nodes a step; launches {tron_launches}")
    _, r5 = rel_err(res.w, eager.w)
    check(float(res.value) < f0 and np.isfinite(float(res.value)), "TRON lowered the objective")
    check(ran(tron_launches, "fused_value_grad") > 0 and ran(tron_launches, "fused_hvp") > 0,
          "TRON path ran K1 and K2 (launches with their flag on)")
    check(int(res.iterations) == int(eager.iterations) and int(res.reason_code) == int(eager.reason_code)
          and r5 <= 1e-6, f"5 TRON captured vs eager on the card: iterations and reason equal, coefficients rel "
                          f"{r5:.3e} (tolerance 1e-6)")

    # ---------------- 6. train_glm ----------------
    del fe_batch, block, ds
    default_cache().release()  # the GLMix step's entries (a step has no end of its own to release them at)
    torch.cuda.empty_cache()
    glm_launches = train_glm_phase(dev, smi, check)

    # ---------------- 7. GAME ----------------
    torch.cuda.empty_cache()
    game_launches, train, valid, fe_auc = game_phase(dev, smi, check, Xb, Xr, users, E)
    del Xb, Xr, users, y

    # ---------------- 9. GAME with the other solvers ----------------
    torch.cuda.empty_cache()
    solver_launches = game_solvers_phase(dev, smi, check, train, valid, fe_auc)

    # ---------------- 11a. hyperparameter tuning in process ----------------
    torch.cuda.empty_cache()
    tuning_launches = tuning_phase(dev, smi, check, train, valid)

    # ---------------- 10. the sparse wide fixed effect ----------------
    torch.cuda.empty_cache()
    wide = sparse_wide_phase(dev, smi, check)
    log("phase 10a " + json.dumps({k: v for k, v in wide.items()}))
    torch.cuda.empty_cache()
    sparse_launches = sparse_game_phase(dev, smi, check, train, valid)
    del train, valid
    torch.cuda.empty_cache()
    sparse_drivers_phase(dev, smi, check)

    # ---------------- 8. GAME drivers ----------------
    torch.cuda.empty_cache()
    driver_launches, driver_files = game_drivers_phase(dev, smi, check)

    # ---------------- 16. telemetry ----------------
    torch.cuda.empty_cache()
    telemetry_launches = telemetry_phase(dev, smi, check, driver_files)

    # ---------------- 11b. the tuning driver ----------------
    torch.cuda.empty_cache()
    tuning_driver_launches = tuning_driver_phase(dev, smi, check, driver_files)

    # ---------------- 12. durability and streaming ingest ----------------
    torch.cuda.empty_cache()
    durability_launches = durability_phase(dev, smi, check, driver_files)

    # ---------------- 13. out-of-core random effects ----------------
    torch.cuda.empty_cache()
    ooc_launches = out_of_core_phase(dev, smi, check, driver_files)

    # ---------------- 15. online serving ----------------
    torch.cuda.empty_cache()
    serving_launches = serving_phase(dev, smi, check, driver_files)

    # ---------------- 17. the streaming freshness loop ----------------
    torch.cuda.empty_cache()
    stream_launches = streaming_phase(dev, smi, check, driver_files)
    shutil.rmtree(driver_files["work"], ignore_errors=True)

    # ---------------- 14. multiple devices ----------------
    torch.cuda.empty_cache()
    multi_rank_launches = multi_rank_phase(dev, smi, check)

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
    # "ran": the launches that did their work (launches less those whose
    # launch flag was off; K3 has no flag).
    paths = (glmix_launches, tron_launches, glm_launches, game_launches, driver_launches, solver_launches,
             sparse_launches, tuning_launches, tuning_driver_launches, durability_launches, ooc_launches,
             multi_rank_launches, serving_launches, telemetry_launches, stream_launches)
    rows = []
    for name, (src, repl) in sources.items():
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=sum(c.get(name, 0) for c in paths), ran=sum(ran(c, name) for c in paths),
                         max_abs_err=headline_err[name], **timings[name]))
    log(f"# chip_smoke wall {time.perf_counter() - t_start:.1f} s on {smi}")
    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed: {failures}")
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr, flush=True)
        return 1
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
