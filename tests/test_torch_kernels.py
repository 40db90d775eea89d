"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each port wrapper computes its plain PyTorch version; here that
version is held against the JAX kernel run in interpret mode, as
tests/test_pallas_glm.py and tests/test_re_kernel.py run it, on the same
numpy inputs. Tolerances: f32 sums over a few dozen terms taken in another
order, so rtol 1e-5 with atol 1e-5 (bf16 inputs are rounded identically by
both frameworks, and all sums are f32 in both). The CUDA kernels themselves
are held against the plain versions by tests/test_torch_gpu.py and
chip_smoke.py on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from photon_tpu.ops import losses as jlosses
from photon_tpu.ops import pallas_glm
from photon_tpu.ops.pallas_glm import fused_data_hvp, fused_data_value_and_grad
from photon_tpu.ops.pallas_newton import fused_newton_system
from photon_tpu_torch.ops import fused_glm, fused_newton, kernels
from photon_tpu_torch.ops import losses as tlosses

RTOL, ATOL = 1e-5, 1e-5

LOSSES = {
    "logistic": (jlosses.LogisticLoss, tlosses.LogisticLoss),
    "squared": (jlosses.SquaredLoss, tlosses.SquaredLoss),
    "poisson": (jlosses.PoissonLoss, tlosses.PoissonLoss),
    "hinge": (jlosses.SmoothedHingeLoss, tlosses.SmoothedHingeLoss),
}


def _problem(n=37, d=13, seed=0, poisson=False):
    """Deliberately not tile or lane aligned."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 0] = 1.0
    w = (rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    z = X @ w
    if poisson:
        y = rng.poisson(np.exp(np.clip(z, None, 3))).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    offset = (rng.normal(size=n) * 0.2).astype(np.float32)
    return X, y, weight, offset, w


def _jx(X, dtype):
    return jnp.asarray(X).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _tx(X, dtype):
    return torch.from_numpy(X).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64),
        np.asarray(want, np.float64), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("margins", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_value_grad_plain_matches_pallas(loss, dtype, margins, monkeypatch):
    monkeypatch.setattr(pallas_glm, "DEFAULT_TILE_N", 16)  # multi-tile grid
    jl, tl = LOSSES[loss]
    X, y, wt, off, w = _problem(poisson=loss == "poisson")
    want = fused_data_value_and_grad(
        jl, jnp.asarray(w), _jx(X, dtype), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt),
        interpret=True, return_margins=margins,
    )
    t = torch.from_numpy
    got = fused_glm.fused_value_grad(tl, t(w), _tx(X, dtype), t(y), t(off), t(wt), return_margins=margins)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        _close(g, wv)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hvp_plain_matches_pallas(dtype, monkeypatch):
    monkeypatch.setattr(pallas_glm, "DEFAULT_TILE_N", 16)
    X, _, wt, _, w = _problem(seed=1)
    want = fused_data_hvp(jnp.asarray(w), _jx(X, dtype), jnp.asarray(wt), interpret=True)
    got = fused_glm.fused_hvp(torch.from_numpy(w), _tx(X, dtype), torch.from_numpy(wt))
    _close(got, want)


# K2 at widths of its row route (d = 40, 256), with n no multiple of a tile.
@pytest.mark.parametrize("n", [203, 37])
@pytest.mark.parametrize("d", [40, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hvp_plain_matches_pallas_at_row_route_widths(dtype, d, n, monkeypatch):
    monkeypatch.setattr(pallas_glm, "DEFAULT_TILE_N", 64)
    X, _, wt, _, w = _problem(n=n, d=d, seed=d + n)
    assert fused_glm.hvp_route(d, 2 if dtype == "bf16" else 4, 0) == "row"
    want = fused_data_hvp(jnp.asarray(w), _jx(X, dtype), jnp.asarray(wt), interpret=True)
    got = fused_glm.fused_hvp(torch.from_numpy(w), _tx(X, dtype), torch.from_numpy(wt))
    _close(got, want)


@pytest.mark.parametrize("padded", [False, True], ids=["whole_slab_3a", "row_tiled_3b"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_newton_system_plain_matches_pallas(dtype, padded):
    rng = np.random.default_rng(2)
    E, n, d = 5, 29, 7  # d not a multiple of 8, ragged n
    X = rng.normal(size=(E, n, d)).astype(np.float32)
    d2 = rng.uniform(0.0, 0.25, size=(E, n)).astype(np.float32)
    dz = rng.normal(size=(E, n)).astype(np.float32)
    d2[:, -4:] = dz[:, -4:] = 0.0  # padding samples
    jf = jax.vmap(lambda x, a, b: fused_newton_system(x, a, b, interpret=True, padded=padded))
    H_want, g_want = jf(_jx(X, dtype), jnp.asarray(d2), jnp.asarray(dz))
    H, g = fused_newton.newton_system(_tx(X, dtype), torch.from_numpy(d2), torch.from_numpy(dz))
    assert H.shape == (E, d, d) and g.shape == (E, d)
    _close(H, H_want)
    _close(g, g_want)


# K3 at the headline width (d = 16) with a ragged n_max and padding rows,
# against both lowerings of the Pallas kernel.
@pytest.mark.parametrize("padded", [False, True], ids=["whole_slab_3a", "row_tiled_3b"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_newton_system_plain_matches_pallas_at_d16(dtype, padded):
    rng = np.random.default_rng(3)
    E, n, d = 6, 45, 16
    X = rng.normal(size=(E, n, d)).astype(np.float32)
    X[:, :, 0] = 1.0
    d2 = rng.uniform(0.0, 0.25, size=(E, n)).astype(np.float32)
    dz = rng.normal(size=(E, n)).astype(np.float32)
    X[:, -7:] = 0.0
    d2[:, -7:] = dz[:, -7:] = 0.0  # padding rows
    jf = jax.vmap(lambda x, a, b: fused_newton_system(x, a, b, interpret=True, padded=padded))
    H_want, g_want = jf(_jx(X, dtype), jnp.asarray(d2), jnp.asarray(dz))
    H, g = fused_newton.newton_system(_tx(X, dtype), torch.from_numpy(d2), torch.from_numpy(dz))
    _close(H, H_want)
    _close(g, g_want)


# K3 at the widths the reference sends to Newton past d = 64 (bucket_dim
# rounds 65-128 to 96 or 128; an explicit NEWTON spec takes any width, 192
# here), where the kernel cuts H into panels, against both Pallas lowerings.
@pytest.mark.parametrize("padded", [False, True], ids=["whole_slab_3a", "row_tiled_3b"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [96, 128, 192])
def test_newton_system_plain_matches_pallas_at_wide_widths(d, dtype, padded):
    rng = np.random.default_rng(d)
    E, n = 3, 21
    X = rng.normal(size=(E, n, d)).astype(np.float32)
    X[:, :, 0] = 1.0
    d2 = rng.uniform(0.0, 0.25, size=(E, n)).astype(np.float32)
    dz = rng.normal(size=(E, n)).astype(np.float32)
    X[:, -5:] = 0.0
    d2[:, -5:] = dz[:, -5:] = 0.0  # padding rows
    assert fused_newton.newton_plan(E, n, d, 4, "direct", 132, 1).panels > 1
    jf = jax.vmap(lambda x, a, b: fused_newton_system(x, a, b, interpret=True, padded=padded))
    H_want, g_want = jf(_jx(X, dtype), jnp.asarray(d2), jnp.asarray(dz))
    H, g = fused_newton.newton_system(_tx(X, dtype), torch.from_numpy(d2), torch.from_numpy(dz))
    assert H.shape == (E, d, d) and g.shape == (E, d)
    _close(H, H_want)
    _close(g, g_want)


@pytest.mark.parametrize("loss", list(LOSSES))
def test_losses_match_reference(loss):
    jl, tl = LOSSES[loss]
    z = np.linspace(-40.0, 40.0, 161)
    for y in (0.0, 1.0, 3.0):
        yy = np.full_like(z, y)
        with jax.enable_x64(True):
            jz, jy = jnp.asarray(z), jnp.asarray(yy)
            want = [np.asarray(f(jz, jy)) for f in (jl.value, jl.dz, jl.dzz)] + [np.asarray(jl.mean(jz))]
        tz, ty = torch.from_numpy(z), torch.from_numpy(yy)
        got = [f(tz, ty).numpy() for f in (tl.value, tl.dz, tl.dzz)] + [tl.mean(tz).numpy()]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    X, y, wt, off, w = _problem()
    t = torch.from_numpy
    kernels.reset_launches()
    fused_glm.fused_value_grad(tlosses.LogisticLoss, t(w), t(X), t(y), t(off), t(wt))
    fused_glm.fused_hvp(t(w), t(X), t(wt))
    fused_newton.newton_system(t(X)[None], t(wt)[None], t(y)[None])
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}


def test_flagged_launches_count_what_ran_through_capture_and_replay():
    """``kernels.ran``: a flagged launch counts by its flag, an unflagged
    one always; the solve cache's capture bookkeeping (snapshot, restore,
    add) keeps both counts, as it keeps LAUNCHES. The wrappers' bookkeeping
    is driven by hand here (a CPU tensor takes no kernel)."""

    def flagged(name, v):
        kernels.LAUNCHES[name] += 1
        kernels.count_flag(name, torch.tensor(v, dtype=torch.int32))

    kernels.reset_launches()
    kernels.LAUNCHES["fused_value_grad"] += 1
    flagged("fused_value_grad", 0)
    flagged("fused_hvp", 1)
    flagged("fused_hvp", 0)
    assert kernels.ran() == dict(fused_value_grad=1, fused_hvp=1, newton_system=0)
    snap = kernels.snapshot()
    flagged("fused_hvp", 1)
    counted = kernels.counted_since(snap)
    kernels.restore(snap)
    kernels.add(counted, times=2)
    assert kernels.LAUNCHES["fused_hvp"] == 4 and kernels.FLAGGED["fused_hvp"] == 4
    kernels.reset_launches()
    assert kernels.ran() == {name: 0 for name in kernels.KERNELS}


def test_width_limits_raise():
    Xw = torch.zeros(2, fused_glm.MAX_FUSED_DIM + 1)
    v, r = torch.zeros(fused_glm.MAX_FUSED_DIM + 1), torch.zeros(2)
    with pytest.raises(ValueError, match=str(fused_glm.MAX_FUSED_DIM)):
        fused_glm.fused_value_grad(tlosses.LogisticLoss, v, Xw, r, r, r)
    with pytest.raises(ValueError, match=str(fused_glm.MAX_FUSED_DIM)):
        fused_glm.fused_hvp(v, Xw, r)


def test_resolve_re_kernel_routes_and_refuses_cuda_on_cpu():
    assert fused_newton.resolve_re_kernel("auto", "cpu") == "torch"
    assert fused_newton.resolve_re_kernel("auto", "cuda") == "cuda"
    assert fused_newton.resolve_re_kernel("torch", "cpu") == "torch"
    for k in ("cuda", "cuda_bf16x"):
        with pytest.raises(ValueError, match="needs CUDA"):
            fused_newton.resolve_re_kernel(k, "cpu")
    with pytest.raises(ValueError, match="re_kernel must be one of"):
        fused_newton.resolve_re_kernel("pallas", "cpu")


def test_cuda_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.require_cuda("fused_hvp", torch.zeros(3), torch.zeros(3))


# Row-route geometry of fused_value_grad, which the wrapper computes in
# Python: (n, d, element size), including the headline shape and shapes that
# are no multiple of a tile or a slot.
ROW_SHAPES = [
    (1 << 21, 256, 2), (1 << 21, 256, 4), (3001, 40, 4), (3001, 40, 2),
    (5, 40, 2), (100_003, 1024, 4), (777, 8, 2),
]
CARDS = [(132, 3), (132, 1), (114, 2), (16, 4), (1, 1)]  # (SMs, resident CTAs per SM)


# K1 and K2 take the row route on the same shapes, with the same plan.
ROW_KERNELS = {"fused_value_grad": fused_glm.value_grad_route, "fused_hvp": fused_glm.hvp_route}


@pytest.mark.parametrize("kernel", list(ROW_KERNELS))
@pytest.mark.parametrize("n,d,es", ROW_SHAPES)
def test_row_plan_puts_every_row_in_exactly_one_slot(n, d, es, kernel):
    assert ROW_KERNELS[kernel](d, es, 0) == "row"
    for sms, ctas in CARDS:
        plan = fused_glm.row_plan(n, d, es, sms, ctas)
        assert plan.tile_rows % 8 == 0 and plan.tile_rows <= 8 * 32
        assert (plan.tile_rows * d * es) % 16 == 0  # a bulk copy moves whole 16-byte units
        per_slot = np.bincount(np.arange(n) // plan.slot_rows)
        assert len(per_slot) == plan.slots and per_slot.min() > 0 and per_slot.sum() == n
        walked = sorted(s for cta in range(plan.grid) for s in plan.cta_slots(cta))
        assert walked == list(range(plan.slots))  # each slot on exactly one CTA
        assert plan.scratch_rows() == plan.slots + -(-plan.slots // 64)


@pytest.mark.parametrize("kernel", list(ROW_KERNELS))
@pytest.mark.parametrize("n,d,es", ROW_SHAPES)
def test_row_plan_slot_layout_does_not_depend_on_the_card(n, d, es, kernel):
    assert ROW_KERNELS[kernel](d, es, 16) == "row"
    plans = [fused_glm.row_plan(n, d, es, sms, ctas) for sms, ctas in CARDS]
    assert len({(p.tile_rows, p.tiles_per_slot, p.slots, p.stages) for p in plans}) == 1
    assert [p.grid for p in plans] == [min(plans[0].slots, s * c) for s, c in CARDS]


def test_row_plan_at_the_headline_shape():
    plan = fused_glm.row_plan(1 << 21, 256, 2, 132, 3)
    assert (plan.tile_rows, plan.slot_rows, plan.slots, plan.grid) == (32, 512, 4096, 396)


@pytest.mark.parametrize("d,es,ptr,route", [
    (256, 2, 0, "row"), (256, 4, 256, "row"), (40, 4, 0, "row"), (40, 2, 16, "row"),
    (8, 2, 0, "row"), (1024, 4, 0, "row"), (1024, 2, 0, "row"),
    (37, 4, 0, "tile"), (37, 2, 0, "tile"), (12, 2, 0, "tile"),  # rows not whole 16-byte chunks
    (1032, 2, 0, "tile"), (2048, 2, 0, "tile"), (4096, 4, 0, "tile"),  # wider than ROW_MAX_DIM
    (256, 4, 4, "tile"), (40, 2, 8, "tile"),  # X off a 16-byte boundary
])
@pytest.mark.parametrize("kernel", list(ROW_KERNELS))
def test_row_route_by_width_and_alignment(d, es, ptr, route, kernel):
    assert ROW_KERNELS[kernel](d, es, ptr) == route


# K3's launch plan, which the wrapper computes in Python.
BUCKET_DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256]  # bucket_dim's grid
NEWTON_SHAPES = [(4096, 768, 16), (37, 77, 13), (37, 100, 16), (5, 8, 64), (1, 4, 1), (300, 24, 33),
                 (1024, 768, 128), (37, 100, 96), (7, 77, 192)]


@pytest.mark.parametrize("d", BUCKET_DIMS)
def test_newton_plan_takes_every_bucketed_width(d):
    from photon_tpu_torch.data.random_effect import bucket_dim
    assert bucket_dim(d) == d
    for es in (4, 2):
        for route in ("bulk", "direct"):
            p = fused_newton.newton_plan(100, 96, d, es, route, 132, 4)
            nb, blocks = fused_newton.upper_blocks(d)
            assert 4 * nb >= d and blocks == nb * (nb + 1) // 2
            assert 1 <= p.team_warps <= 8 and p.row_groups >= 1
            assert p.lanes_per_unit <= 32 * p.team_warps and p.threads <= 256
            # Panels: one up to 256 blocks (d <= 88), and together they hold every block once.
            assert (p.panels == 1) == (d <= 88)
            assert p.panels * p.panel_blocks >= blocks > (p.panels - 1) * p.panel_blocks
            if route == "bulk":
                assert p.chunk_rows % 4 == 0 and 4 <= p.chunk_rows <= 96 and p.stages >= 1
                assert (p.chunk_rows * d * es) % 16 == 0  # each chunk copy is whole 16-byte units


@pytest.mark.parametrize("E,n_max,d", NEWTON_SHAPES)
def test_newton_plan_puts_every_entity_on_one_cta_and_every_row_in_one_group(E, n_max, d):
    for sms, ctas in CARDS:
        p = fused_newton.newton_plan(E, n_max, d, 4, "bulk" if n_max % 4 == 0 else "direct", sms, ctas)
        walked = sorted(u for cta in range(p.grid) for u in p.cta_units(cta))
        assert walked == list(range(E * p.panels))
        rows = sorted(r for g in range(p.row_groups) for r in p.group_rows(g, n_max))
        assert rows == list(range(n_max))
        # Each (entity, upper block) is computed by exactly one unit.
        blocks = sorted(b for u in range(p.panels) for b in p.unit_blocks(u))
        assert blocks == list(range(p.blocks))


@pytest.mark.parametrize("E,n_max,d", NEWTON_SHAPES)
def test_newton_plan_layout_does_not_depend_on_the_card(E, n_max, d):
    plans = [fused_newton.newton_plan(E, n_max, d, 2, "bulk", sms, ctas) for sms, ctas in CARDS]
    assert len({p.layout() for p in plans}) == 1
    assert [p.grid for p in plans] == [min(plans[0].unit_groups, s * c) for s, c in CARDS]


def test_newton_plan_at_the_headline_shape():
    p = fused_newton.newton_plan(4096, 768, 16, 4, "bulk", 132, 4)
    assert (p.blocks, p.team_warps, p.row_groups, p.teams_per_cta, p.chunk_rows) == (10, 1, 3, 8, 64)
    assert (p.unit_groups, p.grid, p.threads, p.panels) == (512, 512, 256, 1)


def test_newton_plan_at_the_per_item_width():
    p = fused_newton.newton_plan(1024, 768, 128, 4, "bulk", 132, 3)
    assert (p.blocks, p.panels, p.panel_blocks, p.team_warps, p.row_groups) == (528, 3, 176, 6, 1)
    assert (p.teams_per_cta, p.chunk_rows, p.unit_groups, p.grid) == (1, 64, 3072, 396)


@pytest.mark.parametrize("n_max,d,es,ptr,route", [
    (768, 16, 4, 0, "bulk"), (768, 16, 2, 0, "bulk"), (100, 13, 4, 16, "bulk"), (8, 6, 2, 0, "bulk"),
    (77, 16, 4, 0, "direct"), (6, 16, 4, 0, "direct"),  # n_max not a multiple of 4
    (768, 13, 2, 0, "direct"), (768, 1, 2, 0, "direct"),  # bf16 rows of an odd width
    (768, 16, 4, 8, "direct"),  # an array off a 16-byte boundary
])
def test_newton_route_by_shape_and_alignment(n_max, d, es, ptr, route):
    assert fused_newton.newton_route(n_max, d, es, 0, ptr, 0) == route


def test_kernel_sources_are_packaged():
    for src, _, _ in kernels.KERNELS.values():
        assert (kernels.CSRC / src).is_file()
    for header in ("glm_common.h", "row_ring.h"):
        assert (kernels.CSRC / header).is_file()


def test_library_name_follows_every_header(tmp_path, monkeypatch):
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {name: kernels._library_path(name) for name in kernels.KERNELS}
    (tmp_path / "row_ring.h").write_text((tmp_path / "row_ring.h").read_text() + "// edit\n")
    after = {name: kernels._library_path(name) for name in kernels.KERNELS}
    assert all(before[name] != after[name] for name in kernels.KERNELS)
