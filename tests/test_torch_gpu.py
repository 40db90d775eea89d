"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance: f32 sums in another order over up to 1000 terms, rtol 1e-5 with
atol 1e-4.
"""

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
# n_max = 77 (the direct route) and 100 (the bulk route, a ragged last chunk).
@pytest.mark.parametrize("n_max", [77, 100])
@pytest.mark.parametrize("d", [1, 6, 13, 16, 33, 64])
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
