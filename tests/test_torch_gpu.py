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
        assert chunks == min(-(-steps // sc.BLOCK_CHUNK), -(-cfg.max_iter // sc.BLOCK_CHUNK))
        assert ran == sc.BLOCK_CHUNK * (chunks + cache.stats.captures - captures)  # and the warm-up's chunk
    assert (cache.stats.traces, cache.stats.calls, cache.stats.hits) == (1, 2, 1)
