"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance: f32 sums in another order over up to 1000 terms, rtol 1e-5 with
atol 1e-4.
"""

import dataclasses

import pytest
import torch

from photon_tpu_torch.ops import fused_glm, fused_newton, kernels
from photon_tpu_torch.ops.losses import LogisticLoss, PoissonLoss, SmoothedHingeLoss, SquaredLoss

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_glm_kernels_match_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, d = 1000, 40
    X = torch.randn(n, d, device=cuda_device, generator=g).to(dtype)
    w = torch.randn(d, device=cuda_device, generator=g)
    y = (torch.rand(n, device=cuda_device, generator=g) < 0.5).float()
    off, wt = torch.zeros(n, device=cuda_device), torch.rand(n, device=cuda_device, generator=g)
    kernels.reset_launches()
    for loss in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss):
        got = fused_glm.fused_value_grad(loss, w, X, y, off, wt, return_margins=True)
        want = fused_glm.fused_value_grad_plain(loss, w, X, y, off, wt, return_margins=True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b.float(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(fused_glm.fused_hvp(w, X, wt), fused_glm.fused_hvp_plain(w, X, wt),
                               rtol=RTOL, atol=ATOL)
    assert kernels.LAUNCHES["fused_value_grad"] == 4 and kernels.LAUNCHES["fused_hvp"] == 1


def _value_grad_problem(device, n, d, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, d, device=device, generator=g).to(dtype)
    w = torch.randn(d, device=device, generator=g) / d ** 0.5
    y = (torch.rand(n, device=device, generator=g) < 0.5).float()
    off = torch.randn(n, device=device, generator=g) * 0.1
    wt = torch.rand(n, device=device, generator=g)
    return X, w, y, off, wt


# d = 40 and 256 take the row route, d = 37 (rows not whole 16-byte chunks)
# and d = 2048 the tile route. n = 3001 is no multiple of a tile or a slot;
# n = 5 is less than one tile.
@pytest.mark.parametrize("n", [3001, 5])
@pytest.mark.parametrize("d", [40, 256, 37, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_value_grad_routes_match_plain(cuda_device, dtype, d, n):
    X, w, y, off, wt = _value_grad_problem(cuda_device, n, d, dtype, seed=d + n)
    want_route = "row" if d in (40, 256) else "tile"
    assert fused_glm.value_grad_route(d, X.element_size(), X.data_ptr()) == want_route
    kernels.reset_launches()
    for loss in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss):
        for margins in (True, False):
            got = fused_glm.fused_value_grad(loss, w, X, y, off, wt, return_margins=margins)
            want = fused_glm.fused_value_grad_plain(loss, w, X, y, off, wt, return_margins=margins)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b.float(), rtol=RTOL, atol=ATOL)
    assert kernels.LAUNCHES["fused_value_grad"] == 8


def test_fused_value_grad_unaligned_rows_take_tile_route(cuda_device):
    n, d = 777, 40
    buf = torch.randn(n * d + 1, device=cuda_device)
    X = buf[1:].view(n, d)  # 4 bytes off a 16-byte boundary
    _, w, y, off, wt = _value_grad_problem(cuda_device, n, d, torch.float32, seed=3)
    assert fused_glm.value_grad_route(d, 4, X.data_ptr()) == "tile"
    got = fused_glm.fused_value_grad(LogisticLoss, w, X, y, off, wt, return_margins=True)
    want = fused_glm.fused_value_grad_plain(LogisticLoss, w, X, y, off, wt, return_margins=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_value_grad_is_bitwise_repeatable(cuda_device, dtype):
    X, w, y, off, wt = _value_grad_problem(cuda_device, 100_003, 256, dtype, seed=7)
    first = fused_glm.fused_value_grad(LogisticLoss, w, X, y, off, wt, return_margins=True)
    second = fused_glm.fused_value_grad(LogisticLoss, w, X, y, off, wt, return_margins=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K2 takes the same routes as K1: d = 40 and 256 the row route, d = 37 and
# 2048 the tile route.
@pytest.mark.parametrize("n", [3001, 5])
@pytest.mark.parametrize("d", [40, 256, 37, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_hvp_routes_match_plain(cuda_device, dtype, d, n):
    X, v, _, _, d2 = _value_grad_problem(cuda_device, n, d, dtype, seed=2 * d + n)
    want_route = "row" if d in (40, 256) else "tile"
    assert fused_glm.hvp_route(d, X.element_size(), X.data_ptr()) == want_route
    assert fused_glm.hvp_plan(X)["route"] == want_route
    kernels.reset_launches()
    torch.testing.assert_close(fused_glm.fused_hvp(v, X, d2), fused_glm.fused_hvp_plain(v, X, d2),
                               rtol=RTOL, atol=ATOL)
    assert kernels.LAUNCHES["fused_hvp"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_hvp_is_bitwise_repeatable(cuda_device, dtype):
    X, v, _, _, d2 = _value_grad_problem(cuda_device, 100_003, 256, dtype, seed=8)
    assert torch.equal(fused_glm.fused_hvp(v, X, d2), fused_glm.fused_hvp(v, X, d2))


# K3 over the range of widths, E = 37 (no multiple of the entities per CTA),
# n_max = 77 (the direct route) and 100 (the bulk route, a ragged last chunk);
# past d = 88 the kernel works H in panels.
@pytest.mark.parametrize("n_max", [77, 100])
@pytest.mark.parametrize("d", [1, 6, 13, 16, 33, 64, 88, 89, 96, 128, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_newton_system_widths_match_plain(cuda_device, dtype, d, n_max):
    g = torch.Generator(device=cuda_device).manual_seed(d + n_max)
    E = 37
    X = torch.randn(E, n_max, d, device=cuda_device, generator=g).to(dtype)
    d2 = torch.rand(E, n_max, device=cuda_device, generator=g)
    dz = torch.randn(E, n_max, device=cuda_device, generator=g)
    plan = fused_newton.system_plan(X, d2, dz)
    assert E % plan["teams_per_cta"] != 0 or plan["teams_per_cta"] == 1
    kernels.reset_launches()
    H, gv = fused_newton.newton_system(X, d2, dz)
    H_want, g_want = fused_newton.newton_system_plain(X, d2, dz)
    torch.testing.assert_close(H, H_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gv, g_want, rtol=RTOL, atol=ATOL)
    assert torch.equal(H, H.transpose(1, 2))
    assert kernels.LAUNCHES["newton_system"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_newton_system_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    X = torch.randn(9, 77, 13, device=cuda_device, generator=g).to(dtype)
    d2 = torch.rand(9, 77, device=cuda_device, generator=g)
    dz = torch.randn(9, 77, device=cuda_device, generator=g)
    H, gv = fused_newton.newton_system(X, d2, dz)
    H_want, g_want = fused_newton.newton_system_plain(X, d2, dz)
    torch.testing.assert_close(H, H_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gv, g_want, rtol=RTOL, atol=ATOL)
    assert torch.equal(H, H.transpose(1, 2))


def test_kernels_refuse_bad_inputs(cuda_device):
    X = torch.zeros(8, 4, device=cuda_device, dtype=torch.float64)
    v = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_glm.fused_hvp(v, X, torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        fused_glm.fused_hvp(v, torch.zeros(4, 8, device=cuda_device).t(), torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError, match="tensors on"):
        fused_glm.fused_hvp(v.cpu(), X.float(), torch.zeros(8, device=cuda_device))


def _planted_glm(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    X = torch.ones(n, d)
    X[:, :-1] = torch.randn(n, d - 1, generator=g)
    w = torch.randn(d, generator=g) * 2.0 / d ** 0.5
    y = (torch.rand(n, generator=g) < torch.sigmoid(X @ w)).float()
    return X, y


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_train_glm_lambda_sweep_on_card_matches_cpu_plain_path(cuda_device, optimizer):
    """The driver's λ loop on the card (f32, the fused kernels) against the
    same loop on the CPU in float64 (plain versions): coefficients within
    2e-3 of max |w|, the smoke's tolerance. L-BFGS launches K1 and TRON
    launches K1 and K2."""
    from photon_tpu_torch.cli.train_glm import train_lambda_sweep
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    X, y = _planted_glm(4000, 40, seed=3)
    spec = OptimizerSpec(OptimizerType[optimizer])
    args = dict(intercept_index=39, variance=VarianceComputationType.SIMPLE)
    kernels.reset_launches()
    card = train_lambda_sweep(LabeledBatch(y.to(cuda_device), X.to(cuda_device)), [10.0, 1.0, 0.1],
                              TaskType.LOGISTIC_REGRESSION, spec, **args)
    used = dict(kernels.LAUNCHES)
    plain = train_lambda_sweep(LabeledBatch(y.double(), X.double()), [10.0, 1.0, 0.1],
                               TaskType.LOGISTIC_REGRESSION, spec, **args)
    for rc, rp in zip(card, plain):
        assert rc.w_model.is_cuda
        err = float((rc.w_model.cpu().double() - rp.w_model).abs().max())
        assert err <= 2e-3 * max(1.0, float(rp.w_model.abs().max())), (rc.lam, err)
        torch.testing.assert_close(rc.variances.cpu().double(), rp.variances, rtol=1e-2, atol=0.0)
    assert used["fused_value_grad"] > 0
    assert (used["fused_hvp"] > 0) == (optimizer == "TRON")


def _game_fit(device, dtype, ratio=None, labels=None):
    """A three-coordinate GAME fit (fixed, per user d = 8, per item d = 128)
    on planted data made on the CPU; returns (validation scores, labels)."""
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.types import TaskType

    g = torch.Generator().manual_seed(5)
    n, E_u, E_i = 8192, 48, 24

    def cols(k):
        X = torch.randn(n, k, generator=g, dtype=torch.float64)
        X[:, 0] = 1.0
        return X

    Xf, Xu, Xi = cols(24), cols(8), cols(128)
    users = torch.randint(0, E_u, (n,), generator=g, dtype=torch.int32)
    items = torch.multinomial(1.0 / torch.arange(1, E_i + 1, dtype=torch.float64) ** 1.1, n,
                              replacement=True, generator=g).to(torch.int32)
    logits = (Xf @ torch.randn(24, generator=g, dtype=torch.float64) / 5
              + torch.sum(Xu * torch.randn(E_u, 8, generator=g, dtype=torch.float64)[users.long()], 1)
              + torch.sum(Xi * torch.randn(E_i, 128, generator=g, dtype=torch.float64)[items.long()] * 0.1, 1))
    y = (torch.rand(n, generator=g, dtype=torch.float64) < torch.sigmoid(logits)).to(torch.float64)
    t = lambda a: a.to(device=device, dtype=dtype if a.is_floating_point() else a.dtype)  # noqa: E731
    batch = GameBatch(t(y), t(torch.zeros(n)), t(torch.ones(n)), {"global": t(Xf), "user": t(Xu), "item": t(Xi)},
                      {"userId": t(users), "itemId": t(items)})
    cfgs = [config.FixedEffectCoordinateConfig("global", "global"),
            config.RandomEffectCoordinateConfig("per_user", "userId", "user", features_to_samples_ratio=ratio),
            config.RandomEffectCoordinateConfig("per_item", "itemId", "item", active_upper_bound=512)]
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=2, re_active_set=True,
                        intercept_indices={"global": 0, "user": 0, "item": 0},
                        num_entities={"userId": E_u, "itemId": E_i})
    reg = config.GameOptimizationConfig({c.coordinate_id: config.RegularizationConfig(1.0) for c in cfgs})
    (res,) = est.fit(batch, optimization_configs=[reg])
    return GameTransformer(res.model).transform(batch)


@pytest.mark.parametrize("route", ["newton", "pearson"])
def test_game_fit_on_card_matches_cpu_plain_path(cuda_device, route):
    """GameEstimator.fit on the card (f32; K1, K3 at d = 8 and 128, or the
    batched margin L-BFGS under a Pearson mask) against the same fit on the
    CPU in float64: scores within 2e-3 of max |score|, the smoke's
    tolerance."""
    ratio = 0.02 if route == "pearson" else None
    kernels.reset_launches()
    fused_newton.LAUNCHES_BY_WIDTH.clear()
    card = _game_fit(cuda_device, torch.float32, ratio)
    torch.cuda.synchronize()
    used, by_width = dict(kernels.LAUNCHES), dict(fused_newton.LAUNCHES_BY_WIDTH)
    plain = _game_fit("cpu", torch.float64, ratio)
    err = float((card.cpu().double() - plain).abs().max())
    assert err <= 2e-3 * max(1.0, float(plain.abs().max())), err
    assert used["fused_value_grad"] > 0 and by_width.get(128, 0) > 0
    assert (by_width.get(8, 0) > 0) == (route == "newton")


def _write_driver_file(path, n, seed):
    """TrainingExampleAvro rows with three bags (7, 31 and 127 values: d = 8,
    32 and 128 with the intercepts), 32 users and 16 Zipf-like items, labels
    planted from a fixed, a per-user and a per-item effect."""
    import copy

    import numpy as np

    from photon_tpu_torch.io.avro import write_avro_records
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    bags = {"features": 31, "userFeatures": 7, "itemFeatures": 127}
    model = np.random.default_rng(9)
    w = {b: model.normal(size=(1 if b == "features" else 32 if b == "userFeatures" else 16, k)) / k ** 0.5
         for b, k in bags.items()}
    rng = np.random.default_rng(seed)
    users, items = rng.integers(0, 32, n), rng.choice(16, n, p=(p := 1 / np.arange(1, 17) ** 1.1) / p.sum())
    X = {b: rng.normal(size=(n, k)) for b, k in bags.items()}
    logits = (X["features"] @ w["features"][0] + np.sum(X["userFeatures"] * w["userFeatures"][users], 1)
              + 0.5 * np.sum(X["itemFeatures"] * w["itemFeatures"][items], 1))
    y = rng.uniform(size=n) < 1 / (1 + np.exp(-logits))
    schema = copy.deepcopy(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] += [{"name": b, "type": {"type": "array", "items": "FeatureAvro"}}
                         for b in ("userFeatures", "itemFeatures")]
    write_avro_records(str(path), schema, [
        {"uid": str(i), "label": float(y[i]), "weight": None, "offset": None,
         "metadataMap": {"userId": f"u{users[i]}", "itemId": f"i{items[i]}"},
         **{b: [{"name": f"{b}{j}", "term": "", "value": float(v)} for j, v in enumerate(X[b][i])] for b in bags}}
        for i in range(n)])
    return str(path)


def test_game_drivers_on_card_match_cpu(cuda_device, tmp_path):
    """game_training and game_scoring with --device cuda against --device cpu
    on the same files (both f32): best/ coefficients and scores within 2e-3
    of their largest magnitude, the smoke's tolerance; the training run on
    the card launches K1, and K3 at d = 8 and 128."""
    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.io.avro import read_avro_records
    from photon_tpu_torch.io.scores import load_scores

    train, valid = _write_driver_file(tmp_path / "t.avro", 2048, 1), _write_driver_file(tmp_path / "v.avro", 512, 2)
    shards = ["--feature-shard-configurations", "name=g,feature.bags=features", "name=u,feature.bags=userFeatures",
              "name=i,feature.bags=itemFeatures"]
    argv = ["--input-paths", train, "--validation-paths", valid, *shards, "--coordinate-configurations",
            "name=global,feature.shard=g,reg.weights=1|10", "name=perUser,feature.shard=u,random.effect.type=userId,reg.weights=1",
            "name=perItem,feature.shard=i,random.effect.type=itemId,reg.weights=1", "--update-sequence",
            "global,perUser,perItem", "--coordinate-descent-iterations", "2", "--evaluators", "AUC"]
    runs = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launches()
        fused_newton.LAUNCHES_BY_WIDTH.clear()
        summary = game_training.main(argv + ["--output-dir", str(tmp_path / device), "--device", device])
        used = dict(kernels.LAUNCHES, by_width=dict(fused_newton.LAUNCHES_BY_WIDTH))
        scored = game_scoring.main(["--input-paths", valid, *shards, "--output-dir", str(tmp_path / f"s-{device}"),
                                    "--model-input-dir", str(tmp_path / device / "best"), "--evaluators", "AUC",
                                    "--device", device])
        runs[device] = summary, used, scored
    assert runs["cuda"][1]["fused_value_grad"] > 0
    assert runs["cuda"][1]["by_width"].get(8, 0) > 0 and runs["cuda"][1]["by_width"].get(128, 0) > 0
    assert runs["cpu"][1]["fused_value_grad"] == 0 and runs["cpu"][1]["newton_system"] == 0
    assert runs["cuda"][0]["best"]["config"] == runs["cpu"][0]["best"]["config"]
    assert abs(runs["cuda"][2]["metrics"]["AUC"] - runs["cpu"][2]["metrics"]["AUC"]) <= 2e-3
    for part in sorted((tmp_path / "cpu" / "best").rglob("*.avro")):
        want = read_avro_records(str(part))
        got = read_avro_records(str(tmp_path / "cuda" / "best" / part.relative_to(tmp_path / "cpu" / "best")))
        assert [r["modelId"] for r in got] == [r["modelId"] for r in want]
        scale = max([1.0] + [abs(m["value"]) for r in want for m in r["means"]])
        for g, w in zip(got, want):
            gm, wm = ({(m["name"], m["term"]): m["value"] for m in r["means"]} for r in (g, w))
            for key in set(gm) | set(wm):
                assert abs(gm.get(key, 0.0) - wm.get(key, 0.0)) <= 2e-3 * scale, (part.name, w["modelId"], key)
    got, want = (torch.tensor([r["predictionScore"] for r in load_scores(str(tmp_path / f"s-{d}" / "scores.avro"))])
                 for d in ("cuda", "cpu"))
    assert float((got - want).abs().max()) <= 2e-3 * max(1.0, float(want.abs().max()))


def test_game_training_telemetry_adds_no_reads_on_card(cuda_device, tmp_path):
    """game_training on the card with --telemetry-out against without it:
    every Avro record of best/ and every other file's bytes equal, the same
    host reads up to the run report's finalize, the same K1 launches and K3
    launches by width, and a report whose every line validates with CD pass
    spans for each coordinate."""
    import json

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.io.avro import read_avro_records
    from photon_tpu_torch.obs import report
    from photon_tpu_torch.optim.common import HOST_READS

    train, valid = _write_driver_file(tmp_path / "t.avro", 2048, 1), _write_driver_file(tmp_path / "v.avro", 512, 2)
    shards = ["--feature-shard-configurations", "name=g,feature.bags=features", "name=u,feature.bags=userFeatures",
              "name=i,feature.bags=itemFeatures"]
    argv = ["--input-paths", train, "--validation-paths", valid, *shards, "--coordinate-configurations",
            "name=global,feature.shard=g,reg.weights=1|10", "name=perUser,feature.shard=u,random.effect.type=userId,reg.weights=1",
            "name=perItem,feature.shard=i,random.effect.type=itemId,reg.weights=1", "--update-sequence",
            "global,perUser,perItem", "--coordinate-descent-iterations", "2", "--evaluators", "AUC",
            "--re-active-set", "--device", "cuda"]
    real, seen = report.collect_run_records, {}

    def counting(*args, **kwargs):
        seen.setdefault("reads", HOST_READS.count - seen["reads0"])
        return real(*args, **kwargs)

    runs = {}
    try:
        report.collect_run_records = counting
        for name, extra in (("off", []), ("on", ["--telemetry-out", str(tmp_path / "run.jsonl")])):
            kernels.reset_launches()
            fused_newton.LAUNCHES_BY_WIDTH.clear()
            seen.clear()
            seen["reads0"] = HOST_READS.count
            game_training.main(argv + ["--output-dir", str(tmp_path / name)] + extra)
            best = tmp_path / name / "best"
            files = {str(p.relative_to(best)): (read_avro_records(str(p)) if p.suffix == ".avro" else p.read_bytes())
                     for p in sorted(best.rglob("*")) if p.is_file()}
            runs[name] = (files, seen["reads"], kernels.LAUNCHES["fused_value_grad"],
                          dict(fused_newton.LAUNCHES_BY_WIDTH))
    finally:
        report.collect_run_records = real
    assert runs["on"] == runs["off"] and runs["on"][2] > 0
    records = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    for rec in records:
        report.validate_record(rec)
    assert next(r for r in records if r["record"] == "env")["jax_backend"] == "gpu"
    names = {r["name"].split("]/", 1)[-1] for r in records if r["record"] == "span"}
    for it in (0, 1):
        for cid in ("global", "perUser", "perItem"):
            assert {f"cd/iter{it}/{cid}/solve", f"cd/iter{it}/{cid}/score"} <= names


def _logistic_block(E, n_max, d, seed, device):
    """An EntityBlock of E entities with 16..n_max samples each (ones
    column first), labels planted per entity."""
    from photon_tpu_torch.data.random_effect import EntityBlock

    g = torch.Generator().manual_seed(seed)
    X = torch.randn(E, n_max, d, generator=g)
    X[:, :, 0] = 1.0
    counts = torch.randint(16, n_max + 1, (E,), generator=g)
    wt = (torch.arange(n_max)[None, :] < counts[:, None]).float()
    W = torch.randn(E, d, generator=g) / d ** 0.5
    y = (torch.rand(E, n_max, generator=g) < torch.sigmoid(torch.einsum("end,ed->en", X, W))).float() * wt
    X = X * wt[..., None]
    sidx = torch.where(wt > 0, torch.arange(E * n_max).reshape(E, n_max), -1).int()
    return EntityBlock(torch.arange(E, dtype=torch.int32).to(device), X.to(device), y.to(device), wt.to(device),
                       sidx.to(device), torch.ones(E, dtype=torch.bool, device=device))


def test_captured_margin_lbfgs_matches_eager(cuda_device):
    """Margin L-BFGS through the solve cache (a captured CUDA graph, K1 in
    it) against the same state machine run eagerly on the card, N = 2^16:
    equal iterations and reason, coefficients within 1e-6 relative; a second
    solve on the key captures nothing new, and LAUNCHES rises by the launches
    the replays (and the capture's warm-up) ran. Another λ runs the same
    program (λ is its input) and matches its own eager solve."""
    from photon_tpu_torch.algorithm import solve_cache as sc
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.optim.margin_lbfgs import minimize_lbfgs_margin

    X, y = _planted_glm(1 << 16, 64, seed=21)
    batch = LabeledBatch(y.to(cuda_device), X.to(cuda_device))
    obj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=63, use_fused=True)
    spec = OptimizerSpec(max_iter=40)
    w0 = torch.zeros(64, device=cuda_device)
    eager = minimize_lbfgs_margin(obj, batch, w0, spec.config())
    cache = SolveCache()
    solve = cache.fe_solver(obj, spec)
    for start in (w0, 0.5 * eager.w):
        ref = eager if start is w0 else minimize_lbfgs_margin(obj, batch, start, spec.config())
        k1, replays, captures = kernels.LAUNCHES["fused_value_grad"], cache.stats.replays, cache.stats.captures
        got = solve(start, batch)
        torch.cuda.synchronize()
        it = int(got.iterations)
        assert (it, int(got.reason_code)) == (int(ref.iterations), int(ref.reason_code))
        torch.testing.assert_close(got.w, ref.w, rtol=1e-6, atol=1e-6 * float(ref.w.abs().max()))
        ran = kernels.LAUNCHES["fused_value_grad"] - k1
        chunks = cache.stats.replays - replays - 1
        assert chunks <= -(-it // sc.FE_CHUNK) + 2  # a long line search spans steps
        # init and every step of every chunk (masked ones too); a capture's
        # warm-up runs init and one chunk eagerly
        warm = (1 + sc.FE_CHUNK) * (cache.stats.captures - captures)
        assert ran == 1 + sc.FE_CHUNK * chunks + warm
    assert (cache.stats.traces, cache.stats.calls, cache.stats.hits) == (1, 2, 1)
    assert start.data_ptr() != got.w.data_ptr()
    obj4 = dataclasses.replace(obj, l2_weight=4.0)
    ref = minimize_lbfgs_margin(obj4, batch, w0, spec.config())
    got = cache.fe_solver(obj4, spec)(w0, batch)
    assert (int(got.iterations), int(got.reason_code)) == (int(ref.iterations), int(ref.reason_code))
    torch.testing.assert_close(got.w, ref.w, rtol=1e-6, atol=1e-6 * float(ref.w.abs().max()))
    assert (cache.stats.traces, cache.stats.captures) == (2, 1)


@pytest.mark.parametrize("d", [16, 128])
def test_captured_newton_matches_eager(cuda_device, d):
    """Batched Newton through the solve cache (captured, K3 in it) against
    the eager block solve on the card: equal per-entity iterations and
    reasons, coefficients within 1e-6 relative; the second solve is a hit and
    LAUNCHES counts the K3 launches the replays ran."""
    from photon_tpu_torch.algorithm import solve_cache as sc
    from photon_tpu_torch.algorithm.random_effect import _solve_block
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType

    block = _logistic_block(256, 96, d, seed=d, device=cuda_device)
    obj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0)
    spec = OptimizerSpec(OptimizerType.NEWTON, max_iter=25, tol=1e-7)
    cfg = spec.config()
    cache = SolveCache()
    solve = cache.block_solver(obj, spec, cfg, has_mask=False, re_kernel="cuda")
    offs = torch.zeros_like(block.label)
    for w0 in (torch.zeros(256, d, device=cuda_device), torch.full((256, d), 0.01, device=cuda_device)):
        ref = _solve_block(block, offs, w0, obj, spec, cfg, re_kernel="cuda")
        k3, replays, captures = kernels.LAUNCHES["newton_system"], cache.stats.replays, cache.stats.captures
        w, it, reasons, passes = solve(block, offs, w0.clone())
        torch.cuda.synchronize()
        assert torch.equal(it, ref[1]) and torch.equal(reasons, ref[2]) and torch.equal(passes, ref[3])
        torch.testing.assert_close(w, ref[0], rtol=1e-6, atol=1e-6 * float(ref[0].abs().max()))
        ran = kernels.LAUNCHES["newton_system"] - k3
        chunks = cache.stats.replays - replays - 1
        steps = int(it.max())
        assert chunks == min(-(-steps // sc.CHUNK), -(-cfg.max_iter // sc.CHUNK))
        assert ran == sc.CHUNK * (chunks + cache.stats.captures - captures)  # and the warm-up's chunk
    assert (cache.stats.traces, cache.stats.calls, cache.stats.hits) == (1, 2, 1)


@pytest.mark.parametrize("d", [40, 256, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_launch_flag(cuda_device, dtype, d):
    """K1 and K2 with their launch flag: on, the result of a launch without
    it, bit for bit (both routes: d = 37 takes the tile route); off, the
    launch writes nothing (the zeroed outputs stay zero) and is not counted
    among the launches that ran."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    n = 3001
    X = torch.randn(n, d, device=cuda_device, generator=g).to(dtype)
    w = torch.randn(d, device=cuda_device, generator=g) / d ** 0.5
    y = (torch.rand(n, device=cuda_device, generator=g) < 0.5).float()
    off, wt = torch.randn(n, device=cuda_device, generator=g) * 0.1, torch.rand(n, device=cuda_device, generator=g)
    on, off_flag = (torch.tensor(v, dtype=torch.int32, device=cuda_device) for v in (1, 0))
    kernels.reset_launches()
    plain = fused_glm.fused_value_grad(LogisticLoss, w, X, y, off, wt, return_margins=True)
    flagged = fused_glm.fused_value_grad(LogisticLoss, w, X, y, off, wt, return_margins=True, enable=on)
    assert all(torch.equal(a, b) for a, b in zip(plain, flagged))
    skipped = fused_glm.fused_value_grad(LogisticLoss, w, X, y, off, wt, return_margins=True, enable=off_flag)
    assert all(not bool(t.any()) for t in skipped)
    assert torch.equal(fused_glm.fused_hvp(w, X, wt), fused_glm.fused_hvp(w, X, wt, enable=on))
    assert not bool(fused_glm.fused_hvp(w, X, wt, enable=off_flag).any())
    assert kernels.LAUNCHES == dict(fused_value_grad=3, fused_hvp=3, newton_system=0)
    assert kernels.ran() == dict(fused_value_grad=2, fused_hvp=2, newton_system=0)


def _fe_objective(route, d):
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType

    obj = GLMObjective(LogisticLoss, l2_weight=1.0, l1_weight=2.0 if route == "owlqn" else 0.0,
                       intercept_index=d - 1, use_fused=True)
    box = None
    if route == "lbfgsb":
        box = (torch.full((d,), -0.2, device="cuda"), torch.full((d,), 0.2, device="cuda"))
    opt = dict(tron=OptimizerType.TRON, owlqn=OptimizerType.LBFGS, lbfgsb=OptimizerType.LBFGSB)[route]
    return obj, OptimizerSpec(opt, max_iter=30, box=box)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("route", ["tron", "owlqn", "lbfgsb"])
def test_captured_fixed_effect_programs_match_eager(cuda_device, route, d):
    """TRON (K1 and K2 with their flags), OWL-QN and L-BFGS-B (K1) through
    the solve cache (captured) against the same program run eagerly on the
    card, N = 2^16: equal iterations, reason and evals, coefficients within
    1e-6 relative; a second λ runs the same program."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.optim.factory import make_optimizer

    X, y = _planted_glm(1 << 16, d, seed=31)
    batch = LabeledBatch(y.to(cuda_device), X.to(cuda_device))
    obj, spec = _fe_objective(route, d)
    cache = SolveCache()
    for lam in (1.0, 0.25):
        o = dataclasses.replace(obj, l2_weight=lam, l1_weight=obj.l1_weight * lam)
        w0 = torch.zeros(d, device=cuda_device)
        kernels.reset_launches()
        ref = make_optimizer(o, spec)(w0, batch)
        got = cache.fe_solver(o, spec)(w0, batch)
        torch.cuda.synchronize()
        assert (int(got.iterations), int(got.reason_code), int(got.evals)) == (
            int(ref.iterations), int(ref.reason_code), int(ref.evals))
        torch.testing.assert_close(got.w, ref.w, rtol=1e-6, atol=1e-6 * float(ref.w.abs().max()))
        assert kernels.LAUNCHES["fused_value_grad"] > 0
        assert (kernels.LAUNCHES["fused_hvp"] > 0) == (route == "tron")
    assert (cache.stats.traces, cache.stats.captures) == (2, 1)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("route", ["tron", "tron_pearson", "owlqn", "margin_pearson", "lbfgs_masked_shifts"])
def test_captured_block_programs_match_eager(cuda_device, route, d):
    """Every non-Newton block route through the solve cache (captured)
    against the eager block solve on the card, E·n_max = 2^16: equal
    per-entity iterations, reasons and X passes, coefficients within 1e-6
    relative; the second solve is a hit."""
    from photon_tpu_torch.algorithm.random_effect import _solve_block
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.normalization import NormalizationContext
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType

    block = _logistic_block(512, 128, d, seed=d + len(route), device=cuda_device)
    g = torch.Generator().manual_seed(7)
    norm = None
    if route.endswith("shifts"):
        shifts = torch.randn(d, generator=g) * 0.1
        shifts[0] = 0.0
        norm = NormalizationContext(torch.ones(d, device=cuda_device), shifts.to(cuda_device), 0)
    obj = GLMObjective(LogisticLoss, l2_weight=1.0, l1_weight=0.5 if route == "owlqn" else 0.0, intercept_index=0,
                       normalization=norm)
    spec = OptimizerSpec(OptimizerType.TRON if route.startswith("tron") else OptimizerType.LBFGS, max_iter=25,
                         tol=1e-7)
    cfg = dataclasses.replace(spec.config(), track_history=False)
    mask = None
    if "pearson" in route or "masked" in route:
        mask = (torch.rand(512, d, generator=g) < 0.6).float()
        mask[:, 0] = 1.0
        mask = mask.to(cuda_device)
    cache = SolveCache()
    solve = cache.block_solver(obj, spec, cfg, has_mask=mask is not None)
    offs = torch.zeros_like(block.label)
    for w0 in (torch.zeros(512, d, device=cuda_device), torch.full((512, d), 0.01, device=cuda_device)):
        ref = _solve_block(block, offs, w0, obj, spec, cfg, mask)
        w, it, reasons, passes = solve(block, offs, w0.clone(), mask)
        torch.cuda.synchronize()
        assert torch.equal(it, ref[1]) and torch.equal(reasons, ref[2]) and torch.equal(passes, ref[3])
        torch.testing.assert_close(w, ref[0], rtol=1e-6, atol=1e-6 * float(ref[0].abs().max()))
    assert (cache.stats.traces, cache.stats.calls, cache.stats.hits) == (1, 2, 1)


def _sparse_problem(device, n, d, k, seed, dtype=torch.float32):
    """(SparseFeatures, labels) of config 6's layout at a small size:
    column 0 the intercept, k - 1 uniform columns a row, planted labels."""
    from photon_tpu_torch.data.batch import SparseFeatures

    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, d, (n, k), generator=g, dtype=torch.int32)
    vals = torch.randn(n, k, generator=g)
    idx[:, 0], vals[:, 0] = 0, 1.0
    w = torch.randn(d, generator=g) / 8.0
    y = (torch.rand(n, generator=g) < torch.sigmoid(torch.sum(vals * w[idx.long()], dim=1))).float()
    return SparseFeatures(idx.to(device), vals.to(device=device, dtype=dtype), d), y.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", [False, True], ids=["scatter", "segsum"])
def test_sparse_lowerings_on_card_match_cpu_plain(cuda_device, plan, dtype):
    """The sparse products on the card (gather matvec; index_add_ scatter or
    sorted segment sum) against the same ops on the CPU in float64 from the
    card's values, and the Hessian diagonal likewise: rtol 1e-5."""
    X, _ = _sparse_problem(cuda_device, 1 << 14, 1 << 12, 32, seed=plan + 2 * (dtype == torch.bfloat16), dtype=dtype)
    X = X.with_transpose_plan() if plan else X
    ref = type(X)(X.indices.cpu(), X.values.cpu().double(), X.dim)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    w = torch.randn(X.dim, device=cuda_device, generator=g)
    r = torch.randn(X.shape[0], device=cuda_device, generator=g)
    mv, rmv = X.matvec(w), X.rmatvec(r)
    assert mv.dtype == rmv.dtype == torch.float32 and X.has_plan == plan
    torch.testing.assert_close(mv.cpu().double(), ref.matvec(w.cpu().double()), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(rmv.cpu().double(), ref.rmatvec(r.cpu().double()), rtol=RTOL, atol=ATOL)
    if plan:  # the segment sum sums in one order: bitwise again
        assert torch.equal(rmv, X.rmatvec(r))


@pytest.mark.parametrize("plan", [False, True], ids=["scatter", "segsum"])
@pytest.mark.parametrize("route", ["LBFGS", "TRON"])
def test_captured_sparse_fixed_effect_matches_eager(cuda_device, route, plan):
    """A sparse fixed-effect solve through the solve cache (captured) against
    the same program run eagerly on the card and the float64 plain path on
    the CPU: with the segment sum (one summation order) the eager solve bit
    for bit; with the scatter (float atomics, whose rounding moves the path)
    margins within 2e-3 of the eager solve's; both within 2e-3 of the CPU's."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
    from photon_tpu_torch.types import OptimizerType

    X, y = _sparse_problem(cuda_device, 1 << 14, 1 << 13, 32, seed=7)
    X = X.with_transpose_plan() if plan else X
    batch = LabeledBatch(y, X)
    obj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0, use_fused=True)
    spec = OptimizerSpec(OptimizerType[route], max_iter=20)
    w0 = torch.zeros(X.dim, device=cuda_device)
    eager = make_optimizer(obj, spec)(w0, batch)
    cache = SolveCache()
    got = cache.fe_solver(obj, spec)(w0, batch)
    again = cache.fe_solver(obj, spec)(w0, batch)
    torch.cuda.synchronize()
    assert (cache.stats.captures, cache.stats.hits) == (1, 1)

    def rel(a, b):
        return float((a.cpu().double() - b.cpu().double()).abs().max()) / max(1.0, float(b.abs().max()))

    if plan:
        assert int(got.iterations) == int(eager.iterations) and int(got.reason_code) == int(eager.reason_code)
        assert torch.equal(got.w, eager.w) and torch.equal(got.w, again.w)
    else:
        assert rel(batch.margins(got.w), batch.margins(eager.w)) <= 2e-3
    cpu = LabeledBatch(y.cpu().double(), type(X)(X.indices.cpu(), X.values.cpu().double(), X.dim))
    ref = make_optimizer(obj, spec)(torch.zeros(X.dim, dtype=torch.float64), cpu)
    assert rel(batch.margins(got.w), cpu.margins(ref.w)) <= 2e-3


def test_projected_sparse_random_effect_runs_k3(cuda_device):
    """A sparse per-user shard on the card: projected blocks of d <= 128
    solved by batched Newton with K3 (launched), coefficients within 2e-3 of
    the CPU float64 plain path's."""
    import numpy as np

    from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.types import TaskType

    rng = np.random.default_rng(9)
    n, E, d_full, k = 4096, 24, 6000, 4
    eids = rng.integers(0, E, size=n).astype(np.int32)
    idx = (eids[:, None] * 90 + rng.integers(1, 9, size=(n, k))).astype(np.int32)  # 8 columns an entity
    idx[:, 0] = 0
    vals = rng.normal(size=(n, k))
    vals[:, 0] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-rng.normal(size=E)[eids] - vals[:, 1]))).astype(np.float64)
    models = {}
    for device, dtype in ((cuda_device, torch.float32), (torch.device("cpu"), torch.float64)):
        npt = np.float64 if dtype == torch.float64 else np.float32
        ds = build_random_effect_dataset(eids, (idx, vals.astype(npt), d_full), y.astype(npt), np.ones(n, npt), E,
                                         RandomEffectDataConfig("userId", "wide", n_buckets=2), device=device)
        assert ds.projected and all(b.dim <= 128 for b in ds.blocks)
        sf = SparseFeatures(torch.as_tensor(idx, device=device), torch.as_tensor(vals, device=device, dtype=dtype),
                            d_full)
        batch = GameBatch(torch.as_tensor(y, device=device, dtype=dtype), torch.zeros(n, device=device, dtype=dtype),
                          torch.ones(n, device=device, dtype=dtype), {"wide": sf},
                          {"userId": torch.as_tensor(eids, device=device)})
        kernels.reset_launches()
        model, _ = RandomEffectCoordinate("perUser", ds, TaskType.LOGISTIC_REGRESSION,
                                          GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0)).train(batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["newton_system"] > 0
        models[device.type] = model.to_dense().coefficients.cpu().double()
    err = float((models["cuda"] - models["cpu"]).abs().max()) / max(1.0, float(models["cpu"].abs().max()))
    assert err <= 2e-3


@pytest.mark.parametrize("dense_limit", [4096, 16])  # dense and padded-sparse
def test_columnar_read_to_card_equals_cpu_read(cuda_device, tmp_path, dense_limit):
    """read_merged through the native decoder to the card gives the CPU
    read's tensors bit for bit (same transpose plan on both)."""
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.data_reader import READ_PATHS, FeatureShardConfig, read_merged

    path = _write_driver_file(tmp_path / "t.avro", 1024, 3)
    cfg = {"g": FeatureShardConfig(feature_bags=["features", "itemFeatures"], dense_dim_limit=dense_limit,
                                   transpose_plan=True),
           "u": FeatureShardConfig(feature_bags=["userFeatures"])}
    READ_PATHS.reset()
    got, maps_got, eidx_got = read_merged([path], cfg, entity_id_columns={"userId": "userId"}, device=cuda_device)
    want, maps_want, eidx_want = read_merged([path], cfg, entity_id_columns={"userId": "userId"}, device="cpu")
    assert READ_PATHS.counts == {"columnar": 2}
    assert dict(maps_got["g"].items()) == dict(maps_want["g"].items())
    assert eidx_got["userId"].ids() == eidx_want["userId"].ids()
    for name in ("label", "offset", "weight", "uid"):
        assert getattr(got, name).is_cuda
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert torch.equal(got.entity_ids["userId"].cpu(), want.entity_ids["userId"])
    for k in cfg:
        a, b = got.features[k], want.features[k]
        if isinstance(b, SparseFeatures):
            assert isinstance(a, SparseFeatures) and a.dim == b.dim
            for x, y in zip(a.tensors(), b.tensors()):
                assert x.is_cuda and torch.equal(x.cpu(), y)
        else:
            assert a.is_cuda and torch.equal(a.cpu(), b)


def test_batched_lanes_on_card_match_cpu_plain(cuda_device):
    """Four tuning candidates as lanes on the card (f32, K3 on the lanes)
    against the CPU float64 plain path: each lane's AUC within 2e-3; a
    second round replays its captured programs and builds none."""
    import numpy as np

    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.estimators.config import (
        FixedEffectCoordinateConfig,
        GameOptimizationConfig,
        RandomEffectCoordinateConfig,
        RegularizationConfig,
    )
    from photon_tpu_torch.estimators.evaluation_function import GameEstimatorEvaluationFunction
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.types import TaskType

    rng = np.random.default_rng(13)
    n, e, d_fix, d_re = 8192, 64, 16, 8
    Xf, Xr = rng.normal(size=(n, d_fix)), rng.normal(size=(n, d_re))
    Xf[:, 0] = Xr[:, 0] = 1.0
    users = rng.integers(0, e, size=n).astype(np.int32)
    logits = Xf @ rng.normal(size=d_fix) / 4 + np.sum(Xr * rng.normal(size=(e, d_re))[users], axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    X = np.array([[0.0, 0.0], [1.0, -1.0], [-1.0, 1.0], [2.0, 2.0]])
    out = {}
    for device, dtype in ((cuda_device, torch.float32), (torch.device("cpu"), torch.float64)):
        def batch(sl):
            t = lambda a: torch.as_tensor(a[sl], device=device, dtype=dtype)  # noqa: E731
            m = y[sl].shape[0]
            return GameBatch(t(y), torch.zeros(m, device=device, dtype=dtype), torch.ones(m, device=device, dtype=dtype),
                             {"g": t(Xf), "r": t(Xr)}, {"u": torch.as_tensor(users[sl], device=device)})

        est = GameEstimator(TaskType.LOGISTIC_REGRESSION, [FixedEffectCoordinateConfig("fe", "g"),
                                                           RandomEffectCoordinateConfig("re", "u", "r")],
                            num_iterations=2, intercept_indices={"g": 0, "r": 0}, num_entities={"u": e})
        base = GameOptimizationConfig({"fe": RegularizationConfig(weight=1.0), "re": RegularizationConfig(weight=1.0)})
        fn = GameEstimatorEvaluationFunction(est, base, batch(slice(0, n // 2)), batch(slice(n // 2, None)),
                                             EvaluationSuite([EvaluatorSpec.parse("AUC")]), True)
        kernels.reset_launches()
        lanes = fn._batched_evaluator()
        assert lanes is not None
        out[device.type] = fn.evaluate_batch(X)
        if device.type == "cuda":
            assert kernels.LAUNCHES["newton_system"] > 0
            counts = lanes.cache.stats.counts()
            assert fn.evaluate_batch(X) == out["cuda"]
            since = lanes.cache.stats.since(counts)
            assert since["captures"] == 0 and since["traces"] == 0 and since["replays"] > 0
    assert all(np.isfinite(out["cuda"]))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=2e-3)


@pytest.mark.parametrize("pad_rows_to", [None, 256])
@pytest.mark.parametrize("overlap", [True, False])
def test_pipeline_h2d_chunks_equal_cpu_assembly(cuda_device, tmp_path, overlap, pad_rows_to):
    """The h2d stage (pinned buffers, non-blocking copies on a copy stream,
    the consumer waiting on the copy's event) gives chunks on the card equal
    bit for bit to the CPU assembly, padded or not, threaded or inline; the
    stage threads are gone when the stream ends."""
    import threading

    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.data_reader import FeatureShardConfig, read_merged
    from photon_tpu_torch.io.pipeline import stream_device_batches

    # Three files of one container block each: three chunks.
    paths = [_write_driver_file(tmp_path / f"t{i}.avro", 700, 5 + i) for i in range(3)]
    cfg = {"g": FeatureShardConfig(feature_bags=["features", "itemFeatures"], dense_dim_limit=16,
                                   transpose_plan=True),
           "u": FeatureShardConfig(feature_bags=["userFeatures"])}
    _, maps, _ = read_merged(paths, cfg, entity_id_columns={"userId": "userId"}, device="cpu")
    kw = dict(entity_id_columns={"userId": "userId"}, chunk_rows=300, pad_rows_to=pad_rows_to, overlap=overlap)
    got = list(stream_device_batches(paths, cfg, maps, entity_indexes={}, device=cuda_device, **kw))
    want = list(stream_device_batches(paths, cfg, maps, entity_indexes={}, device="cpu", **kw))
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        assert a.n == b.n and a.event is not None and b.event is None
        x, y = a.batch, b.batch
        for name in ("label", "offset", "weight", "uid"):
            assert getattr(x, name).is_cuda and torch.equal(getattr(x, name).cpu(), getattr(y, name))
        assert torch.equal(x.entity_ids["userId"].cpu(), y.entity_ids["userId"])
        for k in cfg:
            if isinstance(y.features[k], SparseFeatures):
                assert x.features[k].has_plan and y.features[k].has_plan
                for s, t in zip(x.features[k].tensors(), y.features[k].tensors()):
                    assert s.is_cuda and torch.equal(s.cpu(), t)
            else:
                assert torch.equal(x.features[k].cpu(), y.features[k])
    assert not [t for t in threading.enumerate() if t.name.startswith("photon-pipe-") and t.is_alive()]


def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    """load_checkpoint(..., device="cuda") gives bf16 and f32 leaves of a
    CUDA state back on the card with equal bits."""
    from photon_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    g = torch.Generator(device=cuda_device).manual_seed(3)
    state = {"f32": torch.randn(64, 16, device=cuda_device, generator=g),
             "bf16": torch.randn(1000, device=cuda_device, generator=g).to(torch.bfloat16),
             "i32": torch.arange(7, dtype=torch.int32, device=cuda_device), "n": 3}
    save_checkpoint(str(tmp_path), state, 0)
    back, step = load_checkpoint(str(tmp_path), device="cuda")
    assert step == 0 and back["n"] == 3
    for k in ("f32", "bf16", "i32"):
        assert back[k].is_cuda and back[k].dtype == state[k].dtype
        assert torch.equal(back[k].view(torch.int16) if k == "bf16" else back[k],
                           state[k].view(torch.int16) if k == "bf16" else state[k])


def test_real_out_of_memory_is_classified(cuda_device):
    """An allocation larger than the card's free memory raises
    torch.cuda.OutOfMemoryError, which is_device_oom classifies."""
    from photon_tpu_torch.utils import resources

    free, _total = torch.cuda.mem_get_info()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(free + (1 << 30), dtype=torch.uint8, device=cuda_device)
    assert resources.is_device_oom(ei.value)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Out-of-core random effects (algorithm/re_store.py)
# ---------------------------------------------------------------------------


def _ooc_problem(device, seed=13, E=192, d=16):
    import numpy as np

    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset

    rng = np.random.default_rng(seed)
    counts = rng.integers(20, 90, size=E)
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    n = eids.size
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=8)

    def dataset():
        return build_random_effect_dataset(eids, X, y, w, E, cfg, device=device)

    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    batch = GameBatch(label=t(y), offset=torch.zeros(n, device=device), weight=t(w), features={"re": t(X)},
                      entity_ids={"userId": t(eids)})
    return dataset, batch


def _ooc_coordinate(dataset, budget, cache, spill_dir=None):
    from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType, TaskType

    return RandomEffectCoordinate(
        coordinate_id="per_user", dataset=dataset, task=TaskType.LOGISTIC_REGRESSION,
        objective=GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0),
        optimizer_spec=OptimizerSpec(optimizer=OptimizerType.NEWTON, max_iter=10), solve_cache=cache,
        active_set=True, device_budget_bytes=budget, device_spill_dir=spill_dir)


def _ooc_passes(coord, batch, passes=3):
    model = None
    for it in range(passes):
        coord.begin_cd_pass(it)
        model, _ = coord.train(batch, None, model)
    return model


@pytest.mark.parametrize("spill", [False, True], ids=["host_memory", "memmap_spill"])
def test_budgeted_coordinate_on_card_is_bitwise_resident(cuda_device, tmp_path, spill):
    """A budgeted coordinate on the card: pass 0 captures every block key
    while the upload thread uploads (through the pinned staging buffers;
    with a spill, from read-only memory-mapped arrays) and the download
    thread downloads, raises no capture error, captures nothing after pass
    0, and gives the resident coordinate's coefficients bit for bit."""
    import numpy as np

    from photon_tpu_torch.algorithm.re_store import block_device_cost
    from photon_tpu_torch.algorithm.solve_cache import SolveCache

    dataset, batch = _ooc_problem(cuda_device)
    resident = _ooc_passes(_ooc_coordinate(dataset(), None, SolveCache()), batch)
    ds = dataset()
    budget = sum(block_device_cost(b) for b in ds.blocks) // 4
    cache = SolveCache()
    coord = _ooc_coordinate(ds, budget, cache, str(tmp_path) if spill else None)
    assert all(isinstance(b.features, np.memmap) == spill for b in coord.dataset.blocks)
    coord.begin_cd_pass(0)
    model, _ = coord.train(batch, None, None)
    mark = cache.trace_mark()
    assert cache.stats.captures > 0
    for it in (1, 2):
        coord.begin_cd_pass(it)
        model, _ = coord.train(batch, None, model)
    torch.cuda.synchronize()
    st = coord.last_residency_stats
    assert cache.traces_since(mark) == 0
    assert torch.equal(model.coefficients, resident.coefficients.cpu())
    assert torch.equal(model.score(batch), resident.score(batch))
    assert st["evictions"] > 0 and st["peak_total_bytes"] <= st["effective_budget_bytes"]
    assert st["staging_bytes"] > 0 and st["uploads"] > 0


def test_budgeted_capture_runs_beside_the_upload_thread(cuda_device):
    """Pass 0 of a budgeted coordinate with blocks of many shapes: a new
    key's capture runs while the upload thread has later blocks to copy
    (the capture lock orders their CUDA calls); two runs evict the same
    blocks in the same order."""
    import threading

    from photon_tpu_torch.algorithm import solve_cache
    from photon_tpu_torch.algorithm.re_store import block_device_cost

    dataset, batch = _ooc_problem(cuda_device, seed=14, E=384)
    beside = []
    capture = solve_cache._Entry._capture_locked

    def watched(entry):
        beside.append(any(t.name == "photon-pipe-h2d" for t in threading.enumerate()))
        capture(entry)

    logs = []
    for _ in range(2):
        ds = dataset()
        cache = solve_cache.SolveCache()
        coord = _ooc_coordinate(ds, sum(block_device_cost(b) for b in ds.blocks) // 3, cache)
        solve_cache._Entry._capture_locked = watched
        try:
            _ooc_passes(coord, batch, passes=2)
        finally:
            solve_cache._Entry._capture_locked = capture
        assert cache.stats.captures == len({tuple(b.features.shape) for b in ds.blocks}) > 1
        logs.append(coord.last_residency_stats["eviction_log"])
    # Captures ran while the upload thread lived (those of the last keys
    # may come after it has uploaded everything and ended).
    assert sum(beside) >= len(beside) // 2 > 0
    assert logs[0] == logs[1] and logs[0]


def _ranks():
    import torch_ranks
    from photon_tpu_torch.utils.virtual_devices import run_ranks

    return torch_ranks, run_ranks


def test_nccl_refuses_two_ranks_on_one_card(cuda_device):
    torch_ranks, run_ranks = _ranks()
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="NCCL"):
        run_ranks(torch_ranks.report_rank, n, backend="nccl")


def test_rows_sharded_fixed_effect_on_card(cuda_device):
    """A rows-sharded fixed effect on one NCCL rank (captured, its all-reduce
    in the graph) and on 2 gloo ranks sharing the card (eager): the same
    coefficients bit for bit (8 row shards summed in one order), K1 and K2
    run on every rank."""
    torch_ranks, run_ranks = _ranks()
    one = run_ranks(torch_ranks.card_rows_program, 1, backend="nccl", device="cuda", timeout_s=120.0)
    two = run_ranks(torch_ranks.card_rows_program, 2, backend="gloo", device="cuda:0", timeout_s=120.0)
    assert one[0]["routes"] == ["captured", "captured"]
    assert all(r["routes"] == ["eager: its collectives cannot be captured"] * 2 for r in two)
    for r in one + two:
        assert r["ran"]["fused_value_grad"] > 0 and r["ran"]["fused_hvp"] > 0
        for k in ("lbfgs", "tron"):
            assert (r[k] == one[0][k]).all(), k


def test_entity_sharded_on_card_bitwise_across_ranks(cuda_device):
    """The entity-sharded coordinate on one NCCL rank and on 2 and 4 gloo
    ranks sharing the card: bitwise the same, K3 on every rank, no capture
    after the first pass."""
    torch_ranks, run_ranks = _ranks()
    runs = [run_ranks(torch_ranks.card_entity_program, 1, backend="nccl", device="cuda", timeout_s=120.0)]
    runs += [run_ranks(torch_ranks.card_entity_program, n, backend="gloo", device="cuda:0", timeout_s=120.0)
             for n in (2, 4)]
    base = runs[0][0]["coefs"]
    for rs in runs:
        for r in rs:
            assert (r["coefs"] == base).all() and r["marks"][1:] == [0, 0]
            assert r["ran"]["newton_system"] > 0


def test_mesh_defaults_to_the_ranks_card(cuda_device):
    """Gloo ranks that joined on the card and build their mesh with no
    device: the mesh, the placed inputs and every output of the sharded
    GLMix step are on the card."""
    torch_ranks, run_ranks = _ranks()
    for r in run_ranks(torch_ranks.card_default_mesh_program, 2, backend="gloo", device="cuda:0", timeout_s=120.0):
        assert r["mesh"] == "cuda:0"
        assert r["placed"] == ["cuda:0"] * 3 and r["outs"] == ["cuda:0"] * 5


# ---------------------------------------------------------------------------
# Serving on the card: bucket graphs, nothing captured or allocated after
# warm-up, scores that do not depend on the row bucket
# ---------------------------------------------------------------------------


def _serving_model(E=96, d_fix=24, d_re=8, seed=3):
    import numpy as np

    from photon_tpu_torch.data.index_map import EntityIndex
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.types import TaskType

    g = np.random.default_rng(seed)
    model = GameModel({
        "global": FixedEffectModel(GeneralizedLinearModel(
            Coefficients(torch.as_tensor(g.normal(size=d_fix).astype(np.float32))), TaskType.LOGISTIC_REGRESSION),
            "a"),
        "per_user": RandomEffectModel(torch.as_tensor(g.normal(size=(E, d_re)).astype(np.float32)), "userId", "b",
                                      TaskType.LOGISTIC_REGRESSION),
    })
    eidx = EntityIndex()
    for e in range(E):
        eidx.intern(f"u{e}")
    return model, eidx


@pytest.mark.parametrize("hot_bytes", [1 << 30, 1], ids=["pinned", "lru"])
def test_serving_engine_bucket_graphs_on_card(cuda_device, hot_bytes):
    """The engine captures one graph a row bucket at warm-up; traffic of
    every batch size, promotions included, captures and allocates nothing
    after it; each score equals the batch path's on the card (the full
    tables, all rows in one batch) bit for bit, at max_batch_size 1 and 64
    alike."""
    import numpy as np

    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.padding import bucket_grid
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.serve import ScoreRequest, ServeConfig, ServingEngine

    model, eidx = _serving_model()
    n = 200
    g = np.random.default_rng(8)
    xa, xb = g.normal(size=(n, 24)).astype(np.float32), g.normal(size=(n, 8)).astype(np.float32)
    users = g.integers(-1, 96, size=n)
    dev_model = _model_on(model, cuda_device)
    want = GameTransformer(dev_model).transform(GameBatch(
        label=torch.zeros(n, device=cuda_device), offset=torch.zeros(n, device=cuda_device),
        weight=torch.ones(n, device=cuda_device),
        features={"a": torch.as_tensor(xa, device=cuda_device), "b": torch.as_tensor(xb, device=cuda_device)},
        entity_ids={"userId": torch.as_tensor(users, dtype=torch.int32, device=cuda_device)})).cpu().numpy()
    for max_batch in (1, 64):
        eng = ServingEngine(model, entity_indexes={"userId": eidx},
                            config=ServeConfig(max_batch_size=max_batch, max_delay_ms=1.0, hot_bytes=hot_bytes))
        try:
            st = eng.stats()["warm_up"][eng.model_version]
            assert st["graphs"] == len(bucket_grid(max_batch))
            futs = [eng.submit(ScoreRequest({"a": xa[i], "b": xb[i]}, {"userId": f"u{users[i]}" if users[i] >= 0
                                                                       else "cold"})) for i in range(n)]
            got = np.asarray([f.result(timeout=60) for f in futs], np.float32)
            assert eng.retraces_since_warmup == 0, eng.stats()
            np.testing.assert_array_equal(got, want)
        finally:
            eng.close()


def _model_on(model, device):
    from photon_tpu_torch.io.model_io import _submodel_to
    from photon_tpu_torch.models.game import GameModel

    return GameModel({cid: _submodel_to(sub, device) for cid, sub in model.models.items()})


def test_budgeted_static_buffers_within_budget_on_card(cuda_device):
    """On the card the solve cache's static buffers of a budgeted
    coordinate are inside its budget: resident blocks plus held buffers
    peak at or under the effective budget, and the cache's live buffers are
    no more than the store counts."""
    from photon_tpu_torch.algorithm.re_store import block_device_cost
    from photon_tpu_torch.algorithm.solve_cache import SolveCache

    dataset, batch = _ooc_problem(cuda_device)
    ds = dataset()
    cache = SolveCache()
    coord = _ooc_coordinate(ds, sum(block_device_cost(b) for b in ds.blocks) // 2, cache)
    _ooc_passes(coord, batch, passes=2)
    torch.cuda.synchronize()
    st = coord.last_residency_stats
    assert st["static_bytes"] > 0 and cache.static_bytes() <= st["static_bytes"]
    assert st["peak_total_bytes"] <= st["effective_budget_bytes"]


def test_incremental_generation_on_card_matches_cpu(cuda_device, tmp_path):
    """game_incremental on the card and on the CPU over copies of one
    publish root (game_training on the card), on a small delta that touches
    a subset of users and items: the same generation, verdict and changed
    counts; coefficients within f32 1e-3; every unchanged row equal to the
    parent's bit for bit on both; K1 and K3 launched on the card."""
    import shutil

    import numpy as np

    from photon_tpu_torch.cli import game_incremental, game_training
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.io.model_io import load_game_model

    train, valid = _write_driver_file(tmp_path / "t.avro", 2048, 1), _write_driver_file(tmp_path / "v.avro", 512, 2)
    delta = _write_driver_file(tmp_path / "d.avro", 40, 3)
    shards = ["--feature-shard-configurations", "name=g,feature.bags=features", "name=u,feature.bags=userFeatures",
              "name=i,feature.bags=itemFeatures"]
    coords = ["--coordinate-configurations", "name=global,feature.shard=g,reg.weights=1",
              "name=perUser,feature.shard=u,random.effect.type=userId,reg.weights=1",
              "name=perItem,feature.shard=i,random.effect.type=itemId,reg.weights=1", "--update-sequence",
              "global,perUser,perItem"]
    root = tmp_path / "card"
    game_training.main(["--input-paths", train, "--validation-paths", valid, *shards, *coords, "--evaluators", "AUC",
                        "--output-dir", str(root), "--device", "cuda"])
    shutil.copytree(root, tmp_path / "cpu")
    argv = ["--input-paths", delta, "--validation-paths", valid, *shards, *coords, "--evaluators", "AUC",
            "--metric-tolerance", "0.5", "--norm-drift-bound", "1000"]
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        fused_newton.LAUNCHES_BY_WIDTH.clear()
        pub = tmp_path / ("card" if dev == "cuda" else "cpu")
        summary = game_incremental.run(game_incremental.build_parser().parse_args(
            argv + ["--publish-root", str(pub), "--device", dev]))
        out[dev] = (summary, kernels.LAUNCHES["fused_value_grad"], dict(fused_newton.LAUNCHES_BY_WIDTH))
    (tc, k1, k3), (tcpu, _, _) = out["cuda"], out["cpu"]
    assert k1 > 0 and k3.get(8, 0) > 0 and k3.get(128, 0) > 0, (k1, k3)
    for k in ("generation", "published", "gateReason", "parent", "changedEntities"):
        assert tc[k] == tcpu[k], k
    assert tc["published"] and 0 < tc["changedEntities"]["userId"] < 32
    for k, v in tcpu["holdoutMetrics"].items():
        assert abs(tc["holdoutMetrics"][k] - v) <= 1e-3
    imaps = {s: IndexMap.load(str(root / f"index-map-{s}.json")) for s in ("g", "u", "i")}
    eidx = {t: EntityIndex.load(str(root / f"entity-index-{t}.json")) for t in ("userId", "itemId")}
    parent = load_game_model(str(root / "best"), imaps, eidx, device="cpu")
    card = load_game_model(tc["modelDir"], imaps, eidx, device="cpu")
    cpu = load_game_model(tcpu["modelDir"], imaps, eidx, device="cpu")
    delta_users = {f"u{u}" for u in np.random.default_rng(3).integers(0, 32, 40)}
    for cid, sub in card.models.items():
        if hasattr(sub, "re_type"):
            a, b, p = sub.coefficients.numpy(), cpu.models[cid].coefficients.numpy(), parent.models[cid].coefficients
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
            if sub.re_type == "userId":
                for name in {f"u{u}" for u in range(32)} - delta_users:
                    e = eidx["userId"].lookup(name)
                    assert torch.equal(torch.from_numpy(a[e]), p[e]) and torch.equal(torch.from_numpy(b[e]), p[e])
        else:
            np.testing.assert_allclose(sub.model.coefficients.means.numpy(),
                                       cpu.models[cid].model.coefficients.means.numpy(), rtol=1e-3, atol=1e-3)


def test_spawned_experiment_trainer_on_card(cuda_device, tmp_path):
    """The experiment trainer of a serving process: candidates trained in
    its spawned process on the card (the delta read there) have the model
    files, sha256 for sha256, of the same candidates trained in this
    process on the card over a copy of the root; LATEST stays put, and the
    host master the trainer loads feeds an engine on the card whose warm
    candidate scores with nothing captured after warm-up."""
    import functools
    import shutil

    from photon_tpu_torch.cli import game_experiment, game_training
    from photon_tpu_torch.estimators.config import GameOptimizationConfig, RegularizationConfig
    from photon_tpu_torch.experiment import SpawnedCandidateTrainer
    from photon_tpu_torch.io.model_io import load_generation_manifest
    from photon_tpu_torch.serve import ServeConfig, load_engine

    train, valid = _write_driver_file(tmp_path / "t.avro", 2048, 1), _write_driver_file(tmp_path / "v.avro", 512, 2)
    delta = _write_driver_file(tmp_path / "d.avro", 64, 3)
    shards = ["--feature-shard-configurations", "name=g,feature.bags=features", "name=u,feature.bags=userFeatures",
              "name=i,feature.bags=itemFeatures"]
    coords = ["--coordinate-configurations", "name=global,feature.shard=g,reg.weights=1",
              "name=perUser,feature.shard=u,random.effect.type=userId,reg.weights=1",
              "name=perItem,feature.shard=i,random.effect.type=itemId,reg.weights=1", "--update-sequence",
              "global,perUser,perItem"]
    root = tmp_path / "spawned"
    game_training.main(["--input-paths", train, "--validation-paths", valid, *shards, *coords, "--evaluators", "AUC",
                        "--output-dir", str(root), "--device", "cuda"])
    shutil.copytree(root, tmp_path / "inline")
    configs = [GameOptimizationConfig({"global": RegularizationConfig(lg), "perUser": RegularizationConfig(lu),
                                       "perItem": RegularizationConfig(li)})
               for lg, lu, li in ((0.5, 3.0, 8.0), (20.0, 0.2, 1.0))]
    dirs = {}
    for where in ("spawned", "inline"):
        args = game_experiment.build_parser().parse_args(
            ["--publish-root", str(tmp_path / where), "--input-paths", delta, "--validation-paths", valid, *shards,
             *coords, "--experiment-id", "gpu", "--device", "cuda"])
        if where == "spawned":
            trainer = SpawnedCandidateTrainer(args.publish_root, functools.partial(game_experiment.build_trainer, args))
        else:
            trainer = game_experiment.build_trainer(args)
        try:
            dirs[where] = [trainer.train(c, f"exp-gpu-r0-{k}", {"experiment": {"id": "gpu", "index": k}})
                           for k, c in enumerate(configs)]
            if where == "spawned":
                assert trainer.device == "cuda"
                model = trainer.load(dirs[where][0])
        finally:
            if where == "spawned":
                trainer.close()
    for a, b in zip(dirs["spawned"], dirs["inline"]):
        ma, mb = load_generation_manifest(a), load_generation_manifest(b)
        assert ma["files"] == mb["files"] and ma["experiment"] == mb["experiment"] == {"id": "gpu", "index": ma[
            "experiment"]["index"]}
    assert (root / "LATEST").read_text().strip() == "best"
    eng = load_engine(str(root / "best"), artifacts_dir=str(root), config=ServeConfig(max_batch_size=8))
    try:
        eng.load_version(model, model_version="exp-gpu-r0-0")
        assert eng.score({"g": [0.1] * 32}, {"userId": "u3"}, model_version="exp-gpu-r0-0") is not None
        assert eng.retraces_since_warmup == 0
        assert eng.unload_version("exp-gpu-r0-0") and eng.versions == [eng.model_version]
    finally:
        eng.close()


def test_scorer_fleet_on_card_scores_bit_for_bit(cuda_device, tmp_path):
    """A two-replica scorer fleet on the card (each replica a spawned
    process with a CUDA context of its own, the routed type sharded and
    unpinned): every routed score equals the batch path's on the card bit
    for bit, both replicas serve, their owned counts cover the entities,
    and neither captures or allocates after warm-up."""
    import os

    import numpy as np

    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.io.model_io import publish_latest_pointer, save_game_model
    from photon_tpu_torch.serve.fleet import FleetBackend, ScorerFleet

    model, eidx = _serving_model()
    root = str(tmp_path / "pub")
    os.makedirs(root)
    imaps = {"a": IndexMap.build([f"a{j}" for j in range(24)]), "b": IndexMap.build([f"b{j}" for j in range(8)])}
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))
    save_game_model(model, os.path.join(root, "gen-1"), imaps, {"userId": eidx}, sparsity_threshold=0.0)
    publish_latest_pointer(root, "gen-1")
    n = 200
    g = np.random.default_rng(9)
    xa, xb = g.normal(size=(n, 24)).astype(np.float32), g.normal(size=(n, 8)).astype(np.float32)
    users = g.integers(0, 96, size=n)
    want = GameTransformer(_model_on(model, cuda_device)).transform(GameBatch(
        label=torch.zeros(n, device=cuda_device), offset=torch.zeros(n, device=cuda_device),
        weight=torch.ones(n, device=cuda_device),
        features={"a": torch.as_tensor(xa, device=cuda_device), "b": torch.as_tensor(xb, device=cuda_device)},
        entity_ids={"userId": torch.as_tensor(users, dtype=torch.int32, device=cuda_device)})).cpu().numpy()
    fleet = ScorerFleet(os.path.join(root, "gen-1"), str(tmp_path / "work"), artifacts_dir=root,
                        route_re_type="userId", hot_bytes=1, max_batch_size=16, max_delay_ms=1.0,
                        connect_timeout_s=120.0, device="cuda")
    try:
        fleet.start(["r0", "r1"])
        backend = FleetBackend(fleet.router)
        futs = [backend.submit({"features": {"a": xa[i].tolist(), "b": xb[i].tolist()},
                                "entityIds": {"userId": f"u{users[i]}"}}, None, "interactive") for i in range(n)]
        res = [f.result(timeout=60) for f in futs]
        np.testing.assert_array_equal(np.asarray([r["score"] for r in res], np.float32), want)
        assert {r["replica"] for r in res} == {"r0", "r1"}
        stats = fleet.router.replica_stats()
        assert sum(s["partition"]["re_types"]["userId"]["owned"] for s in stats.values()) == 96
        assert all(s["device"] == "cuda" and s["retraces_since_warmup"] == 0 for s in stats.values()), stats
    finally:
        fleet.shutdown()
