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
