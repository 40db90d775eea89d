"""The port's GLMix training slice against the JAX package on the CPU.

The same numpy data goes through the JAX functions and their port
counterparts; JAX state is carried into the port by photon_tpu_torch.interop.
Float64 runs use jax's scoped x64 context (never the global flag, which
tests/conftest.py pins off) and hold coefficients and scores at rtol 1e-5,
the bar of the reference's own x64 certification. Float32 tolerances are
stated where they are used.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from photon_tpu.data.batch import LabeledBatch as JBatch
from photon_tpu.data.normalization import NormalizationContext as JNorm
from photon_tpu.data.random_effect import RandomEffectDataConfig as JREConfig
from photon_tpu.data.random_effect import build_random_effect_dataset as j_build
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optim.common import OptimizerConfig as JConfig
from photon_tpu.optim.lbfgs import two_loop_direction as j_two_loop
from photon_tpu.optim.newton import minimize_newton as j_newton
from photon_tpu.optim.tron import minimize_tron as j_tron
from photon_tpu.parallel.train_step import glmix_train_step as j_step

from photon_tpu_torch import interop
from photon_tpu_torch.data.batch import LabeledBatch, matvec, matvec_rounded, rmatvec
from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, bucket_dim, build_random_effect_dataset
from photon_tpu_torch.data.synthetic import make_data
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import OptimizerConfig
from photon_tpu_torch.optim.lbfgs import two_loop_direction
from photon_tpu_torch.optim.newton import minimize_newton
from photon_tpu_torch.optim.tron import minimize_tron
from photon_tpu_torch.parallel.train_step import glmix_train_step

REPO = Path(__file__).resolve().parent.parent
RTOL64 = 1e-5
FE_ITERS, RE_ITERS, PASSES = 30, 8, 2


def _data(n, d, d_re, E, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d))
    Xf[:, 0] = 1.0
    Xr = rng.normal(size=(n, d_re))
    Xr[:, 0] = 1.0
    users = rng.integers(0, E, size=n).astype(np.int32)
    w = rng.normal(size=d) / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(Xf @ w)))).astype(dtype)
    return Xf.astype(dtype), Xr.astype(dtype), users, y


_BLOCK_FIELDS = ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")


def _run_both(Xf, Xr, users, y, E, use_fused=False, shape_bucketing=True):
    """PASSES GLMix passes in JAX and in the port from zero coefficients;
    returns ((w, coefs, scores) jax, (w, coefs, scores) port) as numpy."""
    n, d = Xf.shape
    d_re = Xr.shape[1]
    obj = dict(l2_weight=1.0, intercept_index=0)
    f64 = Xf.dtype == np.float64
    with jax.enable_x64(f64):
        ds = j_build(users, Xr, y, np.ones(n, Xf.dtype), E,
                     JREConfig("userId", "re", n_buckets=1, shape_bucketing=shape_bucketing))
        (blk,) = ds.blocks
        step = jax.jit(j_step(
            JObjective(loss=JLogistic, use_pallas=use_fused, **obj), JObjective(loss=JLogistic, **obj),
            JConfig(max_iter=FE_ITERS, track_history=False),
            JConfig(max_iter=RE_ITERS, tol=1e-6, track_history=False)))
        fb = JBatch(jnp.asarray(y), jnp.asarray(Xf))
        w, c = jnp.zeros(d, Xf.dtype), jnp.zeros((E, d_re), Xf.dtype)
        for _ in range(PASSES):
            w, c, s, _, _ = step(w, c, fb, blk, jnp.asarray(Xr), jnp.asarray(users))
        want = tuple(np.asarray(a) for a in (w, c, s))
        block_arrays = [np.asarray(getattr(blk, f)) for f in _BLOCK_FIELDS]

    pb = interop.entity_block(*block_arrays, device="cpu")
    step = glmix_train_step(
        GLMObjective(LogisticLoss, use_fused=use_fused, **obj), GLMObjective(LogisticLoss, **obj),
        OptimizerConfig(max_iter=FE_ITERS, track_history=False),
        OptimizerConfig(max_iter=RE_ITERS, tol=1e-6, track_history=False))
    fb = LabeledBatch.from_numpy(y, Xf, device="cpu")
    w, c = interop.coefficients(np.zeros(d, Xf.dtype), np.zeros((E, d_re), Xf.dtype), device="cpu")
    for _ in range(PASSES):
        w, c, s, _, _ = step(w, c, fb, pb, torch.from_numpy(Xr), torch.from_numpy(users))
    return want, tuple(a.numpy() for a in (w, c, s))


def test_glmix_step_matches_reference_float64():
    E = 16  # a bucket size: the block has no padding rows
    assert bucket_dim(E) == E
    want, got = _run_both(*_data(640, 6, 3, E), E)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL64, atol=1e-10)


def test_glmix_step_matches_reference_float32():
    # f32 in both packages; sums taken in other orders drift through the
    # solver iterations: 2e-4 relative to the largest entry.
    E = 24
    want, got = _run_both(*_data(1200, 8, 4, E, seed=3, dtype=np.float32), E)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4 * np.abs(w).max())


def test_fused_glmix_step_matches_pallas_reference_float32():
    # use_fused=True: on the CPU the port's K1 wrapper runs its plain version;
    # the reference runs its Pallas kernel in interpret mode. The fused path's
    # fixed-effect stop test (relative improvement <= 1e-7) sits at f32
    # resolution, so the two may stop an iteration apart: 1e-3 of the
    # largest entry.
    E = 8
    want, got = _run_both(*_data(400, 5, 3, E, seed=4, dtype=np.float32), E, use_fused=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


def test_padding_row_does_not_clobber_last_entity():
    """The reference's fault: with bucket_dim(E) > E the block carries a
    padding row (entity_idx -1), and ``re_coefs.at[-1].set(w_init)`` writes
    the last entity's OLD coefficients over its new ones. The port drops
    padding rows, so entity E-1 trains, matching the reference run without
    shape bucketing (no padding rows)."""
    E = 5
    assert bucket_dim(E) > E
    data = _data(300, 4, 3, E, seed=5)
    want_padded, got = _run_both(*data, E)
    want_plain, _ = _run_both(*data, E, shape_bucketing=False)
    _, c_ref, _ = want_padded
    _, c_port, _ = got
    np.testing.assert_array_equal(c_ref[E - 1], np.zeros(3))  # reference: never moved
    assert np.abs(c_port[E - 1]).max() > 1e-3  # port: trained
    np.testing.assert_allclose(c_port, want_plain[1], rtol=RTOL64, atol=1e-10)


@pytest.mark.parametrize("normalized", [False, True])
def test_tron_matches_reference_float64(normalized):
    Xf, _, _, y = _data(500, 7, 2, 4, seed=6)
    rng = np.random.default_rng(7)
    factors = rng.uniform(0.5, 2.0, size=7) if normalized else None
    shifts = rng.normal(size=7) * 0.1 if normalized else None
    if normalized:
        factors[0], shifts[0] = 1.0, 0.0
    cfg = dict(max_iter=10, tol=1e-9)
    with jax.enable_x64(True):
        norm = JNorm(jnp.asarray(factors), jnp.asarray(shifts), 0) if normalized else None
        obj = JObjective(loss=JLogistic, l2_weight=0.5, intercept_index=0, normalization=norm)
        batch = JBatch(jnp.asarray(y), jnp.asarray(Xf))
        res = j_tron(lambda w: obj.value_and_grad(w, batch), None, jnp.zeros(7),
                     JConfig(**cfg), hvp_factory=lambda w: obj.linearized_hvp(w, batch))
        want_w, want_it = np.asarray(res.w), int(res.iterations)
    norm = interop.normalization(factors, shifts, device="cpu") if normalized else None
    obj = GLMObjective(LogisticLoss, l2_weight=0.5, intercept_index=0, normalization=norm)
    batch = LabeledBatch.from_numpy(y, Xf, device="cpu")
    res = minimize_tron(lambda w: obj.value_and_grad(w, batch), None, torch.zeros(7, dtype=torch.float64),
                        OptimizerConfig(**cfg), hvp_factory=lambda w: obj.linearized_hvp(w, batch))
    assert int(res.iterations) == want_it
    np.testing.assert_allclose(res.w.numpy(), want_w, rtol=RTOL64, atol=1e-10)


def test_fused_tron_matches_pallas_reference_float32():
    # K1 (value_and_grad) and K2 (each CG product) routes in f32. TRON's
    # acceptance ratio divides the difference of two f32 objective values,
    # which amplifies reduction-order noise: 1e-3 of the largest entry.
    Xf, _, _, y = _data(300, 6, 2, 4, seed=8, dtype=np.float32)
    cfg = dict(max_iter=4, tol=1e-6)
    obj = JObjective(loss=JLogistic, l2_weight=1.0, intercept_index=0, use_pallas=True)
    batch = JBatch(jnp.asarray(y), jnp.asarray(Xf))
    res = j_tron(lambda w: obj.value_and_grad(w, batch), None, jnp.zeros(6, jnp.float32),
                 JConfig(**cfg), hvp_factory=lambda w: obj.linearized_hvp(w, batch))
    want = np.asarray(res.w)
    tobj = GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0, use_fused=True)
    tb = LabeledBatch.from_numpy(y, Xf, device="cpu")
    got = minimize_tron(lambda w: tobj.value_and_grad(w, tb), None, torch.zeros(6),
                        OptimizerConfig(**cfg), hvp_factory=lambda w: tobj.linearized_hvp(w, tb))
    np.testing.assert_allclose(got.w.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("kernel,ref_kernel", [("torch", "xla"), ("cuda", "pallas"), ("cuda_bf16x", "pallas_bf16x")])
def test_batched_newton_matches_vmapped_reference(kernel, ref_kernel):
    """The port's batched solve (active-lane freezing) against vmap of the
    reference solve. "cuda*" routes run the K3 wrapper, which on the CPU is
    its plain version; the reference runs its Pallas kernel in interpret
    mode. Fully regularized (no intercept), so every lane's problem is well
    posed. f32: 1e-4 relative (5e-3, the reference's own bar, for bf16 X)."""
    rng = np.random.default_rng(9)
    E, n, d = 12, 40, 5
    X = rng.normal(size=(E, n, d)).astype(np.float32)
    X[..., 0] = 1.0
    counts = rng.integers(5, n + 1, size=E)
    wt = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)
    X *= wt[..., None]
    y = (rng.uniform(size=(E, n)) < 0.4).astype(np.float32) * wt
    off = (rng.normal(size=(E, n)) * 0.3).astype(np.float32) * wt
    cfg = dict(max_iter=8, tol=1e-6, track_history=False)
    obj = JObjective(loss=JLogistic, l2_weight=1.0)

    def solve(x, yy, ww, oo):
        return j_newton(obj, JBatch(yy, x, oo, ww), jnp.zeros(d), JConfig(**cfg), kernel=ref_kernel)

    res = jax.jit(jax.vmap(solve))(*(jnp.asarray(a) for a in (X, y, wt, off)))
    t = torch.from_numpy
    got = minimize_newton(GLMObjective(LogisticLoss, 1.0),
                          LabeledBatch(t(y), t(X), t(off), t(wt)), torch.zeros(E, d),
                          OptimizerConfig(**cfg), kernel=kernel)
    tol = 5e-3 if kernel == "cuda_bf16x" else 1e-4
    want = np.asarray(res.w)
    np.testing.assert_allclose(got.w.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(res.iterations))
    np.testing.assert_array_equal(got.evals.numpy(), np.asarray(res.evals))


def test_newton_failed_cholesky_rejects_step():
    """l2 < 0 makes H = XᵀX − 3I negative definite: Cholesky fails, the NaN
    step lands in the reject branch, and w stays at w0."""
    from photon_tpu_torch.ops.losses import SquaredLoss

    X = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    batch = LabeledBatch(torch.tensor([[1.0, 1.0]]), X, torch.zeros(1, 2), torch.ones(1, 2))
    res = minimize_newton(GLMObjective(SquaredLoss, l2_weight=-3.0), batch, torch.zeros(1, 2),
                          OptimizerConfig(max_iter=3))
    np.testing.assert_array_equal(res.w.numpy(), np.zeros((1, 2)))


def test_random_effect_dataset_matches_reference():
    rng = np.random.default_rng(10)
    n, d, E = 700, 3, 21
    X = rng.normal(size=(n, d)).astype(np.float32)
    users = rng.integers(-1, E, size=n).astype(np.int32)  # -1: unknown entity
    y = rng.uniform(size=n).astype(np.float32)
    cfg = dict(active_upper_bound=40, active_lower_bound=30, n_buckets=3)
    ds_ref = j_build(users, X, y, np.ones(n, np.float32), E, JREConfig("u", "re", **cfg))
    ds = build_random_effect_dataset(users, X, y, np.ones(n, np.float32), E,
                                     RandomEffectDataConfig("u", "re", **cfg), device="cpu")
    assert len(ds.blocks) == len(ds_ref.blocks) > 1
    for b, rb in zip(ds.blocks, ds_ref.blocks):
        for f in _BLOCK_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(rb, f)))
        off = rng.normal(size=n).astype(np.float32)
        np.testing.assert_array_equal(b.gather_offsets(torch.from_numpy(off)).numpy(),
                                      np.asarray(rb.gather_offsets(jnp.asarray(off))))


def test_bucket_dim_matches_reference():
    from photon_tpu.data.random_effect import bucket_dim as j_bucket_dim

    assert [bucket_dim(x) for x in range(0, 200)] == [j_bucket_dim(x) for x in range(0, 200)]


def test_bf16_matvecs_follow_reference_promotion():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(300, 9)).astype(np.float32)
    v, r = rng.normal(size=9).astype(np.float32), rng.normal(size=300).astype(np.float32)
    Xj = jnp.asarray(X).astype(jnp.bfloat16)
    Xt = torch.from_numpy(X).to(torch.bfloat16)
    pairs = [
        (matvec(Xt, torch.from_numpy(v)), Xj @ jnp.asarray(v)),  # bf16 @ f32 promotes X
        (rmatvec(Xt, torch.from_numpy(r)), Xj.T @ jnp.asarray(r)),
        (matvec_rounded(Xt, torch.from_numpy(v)),
         jnp.dot(Xj, jnp.asarray(v).astype(jnp.bfloat16), preferred_element_type=jnp.float32)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_two_loop_direction_matches_reference():
    rng = np.random.default_rng(12)
    m, d = 4, 6
    s, yv = rng.normal(size=(m, d)), rng.normal(size=(m, d))
    rho = 1.0 / np.abs(np.einsum("ij,ij->i", s, yv))
    g = rng.normal(size=d)
    for num_stored, head in ((0, 0), (2, 1), (4, 2)):
        with jax.enable_x64(True):
            want = np.asarray(j_two_loop(*(jnp.asarray(a) for a in (g, s, yv, rho)),
                                         jnp.int32(num_stored), jnp.int32(head)))
        got = two_loop_direction(*(torch.from_numpy(a) for a in (g, s, yv, rho)), num_stored, head)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_make_data_is_bench_make_data(monkeypatch):
    import bench

    for k, v in dict(N=500, D_FIX=7, D_RE=3, E=9).items():
        monkeypatch.setattr(bench, k, v)
    want = bench.make_data(seed=3)
    got = make_data(500, 7, 3, 9, seed=3, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_entry_points_default_to_cuda():
    """Without ``device=`` the constructors place tensors on the card; with no
    card they raise instead of falling back to the CPU."""
    y, X = np.zeros(3, np.float32), np.zeros((3, 2), np.float32)
    if torch.cuda.is_available():
        assert LabeledBatch.from_numpy(y, X).features.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            LabeledBatch.from_numpy(y, X)
        with pytest.raises((RuntimeError, AssertionError)):
            make_data(8, 2, 2, 2)


def test_port_imports_no_jax_and_no_reference_package():
    """Import every module of the port in a fresh interpreter (the test
    process already holds jax, imported by conftest)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import photon_tpu_torch\n"
        "for m in pkgutil.walk_packages(photon_tpu_torch.__path__, 'photon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'photon_tpu', 'ml_dtypes')\n"
        "             or k.startswith(('jax.', 'photon_tpu.')))\n"
        "print(len([k for k in sys.modules if k.startswith('photon_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without CUDA, chip_smoke.py
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                                   text=True, timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
