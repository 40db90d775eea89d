"""The port's solver programs (optim/tron.py, owlqn.py, lbfgs.py,
margin_lbfgs.py over the GLM oracles of optim/problem.py) against the JAX
package's solvers on the CPU.

Float64 under jax's scoped x64 context: one solve against the reference's
``minimize_*``, and a program with a lane an entity against ``jax.vmap`` of
the reference's solver over (E, n, d) problems whose lanes stop at
different iterations (the reference's random-effect solve); coefficients
and values at rtol 1e-5, iterations, reasons and ``evals`` equal. Then the
read pattern: ``run_chunked`` at K = 1, 2 and 4 gives the same result bit
for bit with ceil(steps / K) host reads, and ``init``, ``step`` and
``finish`` never read back. K1 and K2 serve the fused routes through their
plain versions.
"""

import inspect
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data.batch import LabeledBatch as JBatch
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optim.common import OptimizerConfig as JConfig
from photon_tpu.optim.lbfgs import minimize_lbfgs as j_lbfgs
from photon_tpu.optim.margin_lbfgs import minimize_lbfgs_margin as j_margin
from photon_tpu.optim.owlqn import minimize_owlqn as j_owlqn
from photon_tpu.optim.tron import minimize_tron as j_tron

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
from photon_tpu_torch.optim.lbfgs import LBFGS
from photon_tpu_torch.optim.margin_lbfgs import MarginLBFGS
from photon_tpu_torch.optim.owlqn import OWLQN
from photon_tpu_torch.optim.problem import GLMOracle, GLMTerms
from photon_tpu_torch.optim.program import run_chunked
from photon_tpu_torch.optim.tron import TRON, minimize_tron
from photon_tpu_torch.types import TaskType

REPO = Path(__file__).resolve().parent.parent
RTOL64 = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL64, atol=1e-9 * max(1.0, float(np.abs(want).max())))


def _glm(n=160, d=7, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 0] = 1.0
    w_true = rng.normal(size=d)
    w_true[4:] = 0.0  # features with no effect, which L1 zeroes
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ w_true))).astype(np.float64)
    return X, y, rng.uniform(0.5, 1.5, size=n), rng.normal(size=n) * 0.1


def _block(E=7, n=40, d=5, seed=4):
    """(X, y, weight, offset, mask) of E entities with 4..n samples each
    (padding rows weight 0), planted models of growing scale, so the lanes
    converge at different iterations; ``mask`` a Pearson-like 0/1 mask that
    keeps the intercept."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(E, n, d))
    X[..., 0] = 1.0
    W = rng.normal(size=(E, d)) * np.linspace(0.3, 3.0, E)[:, None]
    y = (rng.uniform(size=(E, n)) < 1.0 / (1.0 + np.exp(-np.einsum("end,ed->en", X, W)))).astype(np.float64)
    counts = rng.integers(4, n + 1, size=E)
    wt = (np.arange(n)[None, :] < counts[:, None]).astype(np.float64)
    off = rng.normal(size=(E, n)) * 0.1 * wt
    mask = (rng.uniform(size=(E, d)) < 0.7).astype(np.float64)
    mask[:, 0] = 1.0
    return X, y, wt, off, mask


# route: (optimizer, l2, l1, masked)
_LANE_ROUTES = {
    "tron": ("tron", 0.5, 0.0, False),
    "tron_masked": ("tron", 0.5, 0.0, True),
    "owlqn_l1": ("owlqn", 0.0, 0.8, False),
    "owlqn_elastic_net_masked": ("owlqn", 0.4, 0.4, True),
    "lbfgs_masked": ("lbfgs", 0.5, 0.0, True),
    "margin": ("margin", 0.5, 0.0, False),
    "margin_masked": ("margin", 0.5, 0.0, True),
}


def _reference_lanes(route, X, y, wt, off, mask, cfg, max_cg=20):
    """jax.vmap of the reference's solver over the lanes, each lane's
    objective as the reference's random-effect solve builds it."""
    kind, l2, l1, masked = _LANE_ROUTES[route]
    d = X.shape[-1]
    with jax.enable_x64(True):
        obj = JObjective(loss=JLogistic, l2_weight=l2, intercept_index=0)
        jcfg = JConfig(**cfg)
        l1_mask = jnp.ones(d).at[0].set(0.0)

        def one(feat, lab, w_, o, m):
            lb = JBatch(lab, feat, o, w_)
            w0 = jnp.zeros(d)
            m = m if masked else jnp.ones(d)

            def vg(w):
                v, g = obj.value_and_grad(w * m, lb)
                return v, g * m

            def hvp_factory(w):
                hv = obj.linearized_hvp(w * m, lb)
                return lambda v: m * hv(m * v)

            if kind == "tron":
                res = j_tron(vg, None, w0, jcfg, max_cg, hvp_factory=hvp_factory)
            elif kind == "owlqn":
                res = j_owlqn(vg, w0, l1, jcfg, l1_mask)
            elif kind == "lbfgs":
                res = j_lbfgs(vg, w0, jcfg)
            else:
                res = j_margin(obj, JBatch(lab, feat * m[None, :], o, w_), w0, jcfg)
            return res.w * m, res.iterations, res.reason_code, res.evals, res.value

        out = jax.vmap(one)(*(jnp.asarray(a) for a in (X, y, wt, off, mask)))
        return [np.asarray(a) for a in out]


def _lane_program(route, X, y, wt, off, mask, cfg, max_cg=20):
    kind, l2, l1, masked = _LANE_ROUTES[route]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    m = t(mask) if masked else None
    w0 = torch.zeros(X.shape[0], X.shape[-1], dtype=torch.float64)
    config = OptimizerConfig(**cfg)
    if kind == "margin":
        terms = GLMTerms(LogisticLoss, t(X) if m is None else torch.empty_like(t(X)), t(y), t(wt), t(off),
                         source=None if m is None else t(X), col_mask=m)
        return MarginLBFGS(terms, l2, 0, w0, config), m
    oracle = GLMOracle(GLMTerms(LogisticLoss, t(X), t(y), t(wt), t(off)), l2, 0, torch.float64, mask=m)
    if kind == "tron":
        return TRON(oracle, w0, config, max_cg), m
    if kind == "owlqn":
        l1_mask = torch.ones(X.shape[-1], dtype=torch.float64)
        l1_mask[0] = 0.0
        return OWLQN(oracle, w0, l1, config, l1_mask), m
    return LBFGS(oracle, w0, config), m


@pytest.mark.parametrize("route", list(_LANE_ROUTES))
def test_lane_programs_match_vmapped_reference(route):
    X, y, wt, off, mask = _block()
    cfg = dict(max_iter=40, tol=1e-8, track_history=False)
    want_w, want_it, want_reason, want_evals, want_value = _reference_lanes(route, X, y, wt, off, mask, cfg)
    prog, m = _lane_program(route, X, y, wt, off, mask, cfg)
    run_chunked(prog, 4)
    got = prog.result()
    _close(got.w if m is None else got.w * m, want_w)
    _close(got.value, want_value)
    np.testing.assert_array_equal(got.iterations.numpy(), want_it)
    np.testing.assert_array_equal(got.reason_code.numpy(), want_reason)
    np.testing.assert_array_equal(got.evals.numpy(), want_evals)
    assert len(set(want_it.tolist())) > 1, "the lanes must stop at different iterations"


# name: (kind, l2, l1, intercept unpenalized by L1, box)
_SINGLE = {
    "tron": ("tron", 0.3, 0.0, None),
    "tron_box": ("tron", 0.3, 0.0, 0.25),
    "owlqn_l1": ("owlqn", 0.0, 8.0, None),
    "owlqn_elastic_net": ("owlqn", 0.5, 6.0, None),
    "lbfgs": ("lbfgs", 0.3, 0.0, None),
    "lbfgsb": ("lbfgs", 0.3, 0.0, 0.25),
}


@pytest.mark.parametrize("name", list(_SINGLE))
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_single_programs_match_reference(name, fused):
    """A GLM program (no lanes) against the reference's ``minimize_*`` on
    the objective's closures; ``fused`` takes K1 and K2 (plain versions
    here). The intercept is not penalized by L1."""
    kind, l2, l1, box = _SINGLE[name]
    X, y, wt, off = _glm()
    d = X.shape[1]
    cfg = dict(max_iter=60, tol=1e-9)
    with jax.enable_x64(True):
        jo = JObjective(loss=JLogistic, l2_weight=l2, intercept_index=0)
        jb = JBatch(jnp.asarray(y), jnp.asarray(X), jnp.asarray(off), jnp.asarray(wt))
        vg = lambda w: jo.value_and_grad(w, jb)  # noqa: E731
        jbox = None if box is None else (-box * jnp.ones(d), box * jnp.ones(d))
        if kind == "tron":
            want = j_tron(vg, None, jnp.zeros(d), JConfig(**cfg), box=jbox,
                          hvp_factory=lambda w: jo.linearized_hvp(w, jb))
        elif kind == "owlqn":
            want = j_owlqn(vg, jnp.zeros(d), l1, JConfig(**cfg), jnp.ones(d).at[0].set(0.0))
        else:
            want = j_lbfgs(vg, jnp.zeros(d), JConfig(**cfg), box=jbox)
    obj = GLMObjective(LogisticLoss, l2_weight=l2, intercept_index=0, use_fused=fused)
    batch = LabeledBatch.from_numpy(y, X, off, wt, device="cpu")
    oracle = obj.oracle(batch, torch.float64)
    w0 = torch.zeros(d, dtype=torch.float64)
    tbox = None if box is None else (-box * torch.ones(d, dtype=torch.float64), box * torch.ones(d, dtype=torch.float64))
    if kind == "tron":
        prog = TRON(oracle, w0, OptimizerConfig(**cfg), box=tbox)
    elif kind == "owlqn":
        mask = torch.ones(d, dtype=torch.float64)
        mask[0] = 0.0
        prog = OWLQN(oracle, w0, l1, OptimizerConfig(**cfg), mask)
    else:
        prog = LBFGS(oracle, w0, OptimizerConfig(**cfg), tbox)
    run_chunked(prog, 3)
    got = prog.result()
    _close(got.w, want.w)
    _close(got.value, want.value)
    _close(got.loss_history, want.loss_history)
    assert (int(got.iterations), int(got.reason_code), int(got.evals)) == (
        int(want.iterations), int(want.reason_code), int(want.evals))
    if kind == "owlqn":
        np.testing.assert_array_equal(got.w.numpy() == 0.0, np.asarray(want.w) == 0.0)
        assert int((got.w == 0).sum()) >= 1
    if box is not None:
        assert float(got.w.abs().max()) <= box


def test_black_box_tron_calls_only_what_a_step_needs():
    """``minimize_tron`` over a black box: ``value_and_grad`` at the start
    and once an outer iteration (its trial), the Hessian product on each CG
    and ρ step, nothing once the solve has ended, and the product built once
    for each point H is taken at (the start and each accepted step)."""
    X, y, wt, off = _glm()
    obj = GLMObjective(LogisticLoss, l2_weight=0.3, intercept_index=0)
    batch = LabeledBatch.from_numpy(y, X, off, wt, device="cpu")
    calls = dict(vg=0, factory=0, product=0)

    def vg(w):
        calls["vg"] += 1
        return obj.value_and_grad(w, batch)

    def factory(w):
        calls["factory"] += 1
        hv = obj.linearized_hvp(w, batch)

        def product(v):
            calls["product"] += 1
            return hv(v)

        return product

    res = minimize_tron(vg, None, torch.zeros(X.shape[1], dtype=torch.float64),
                        OptimizerConfig(max_iter=30, tol=1e-9), hvp_factory=factory)
    it = int(res.iterations)
    assert it > 2 and calls["vg"] == 1 + it
    assert calls["product"] == int(res.evals) - 1 - it  # evals = 1 + Σ (2 + cg_iters)
    assert 2 <= calls["factory"] <= 1 + it


def _steps_to_end(prog) -> int:
    """Steps until the program's loop flag is false, one read a step."""
    prog.init()
    steps = 0
    while steps < prog.max_steps:
        prog.step()
        steps += 1
        if not bool(prog.running()):
            break
    return steps


@pytest.mark.parametrize("route", ["tron", "owlqn_elastic_net_masked", "lbfgs_masked", "margin"])
def test_run_chunked_is_the_same_at_every_k_with_one_read_a_chunk(route):
    X, y, wt, off, mask = _block(seed=5)
    cfg = dict(max_iter=30, tol=1e-8, track_history=False)
    steps = _steps_to_end(_lane_program(route, X, y, wt, off, mask, cfg)[0])
    results = []
    for k in (1, 2, 4):
        prog = _lane_program(route, X, y, wt, off, mask, cfg)[0]
        reads0 = HOST_READS.count
        ran = run_chunked(prog, k)
        assert HOST_READS.count - reads0 == math.ceil(steps / k) < math.ceil(prog.max_steps / k)
        assert ran == k * math.ceil(steps / k)
        results.append(prog.result())
    for r in results[1:]:
        for f in ("w", "value", "iterations", "reason_code", "evals", "loss_history"):
            assert torch.equal(getattr(r, f), getattr(results[0], f)), f


@pytest.mark.parametrize("route", list(_LANE_ROUTES))
def test_init_step_and_finish_never_read_back(route, monkeypatch):
    """No host read inside a program: ``HOST_READS`` is not called, and no
    tensor is turned into a host value (bool, item, tolist, numpy)."""
    X, y, wt, off, mask = _block(seed=6)
    prog, _ = _lane_program(route, X, y, wt, off, mask, dict(max_iter=10, track_history=False))

    def refuse(*_a, **_k):
        raise AssertionError("a host read inside a program")

    monkeypatch.setattr(HOST_READS, "read", refuse)
    monkeypatch.setattr(HOST_READS, "fetch", refuse)
    for name in ("__bool__", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    prog.init()
    for _ in range(12):
        prog.step()
    prog.running()
    prog.finish()
    monkeypatch.undo()
    assert int(prog.result().iterations.max()) > 0


def test_f32_data_value_is_the_exact_sum_rounded_once():
    """An f32 data term's value is the exact sum of the per-sample terms,
    rounded once to f32: the same for every order of the samples (so for
    every CPU vector width), as TRON's ratio test near the optimum needs."""
    rng = np.random.default_rng(41)
    n = 4099
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    z, y, wt = t(rng.normal(size=n)), t((rng.uniform(size=n) < 0.5).astype(float)), t(rng.uniform(0.5, 2, n))
    terms = GLMTerms(LogisticLoss, torch.zeros(n, 1), y, wt, torch.zeros(n))
    got = terms.data_value(z)
    assert got.dtype == torch.float32
    per_sample = (wt * LogisticLoss.value(z, y)).double().numpy()
    assert got.item() == float(np.float32(math.fsum(per_sample)))
    for _ in range(3):
        p = torch.from_numpy(rng.permutation(n))
        shuffled = GLMTerms(LogisticLoss, torch.zeros(n, 1), y[p], wt[p], torch.zeros(n))
        assert shuffled.data_value(z[p]).item() == got.item()


def test_glm_zeros_defaults_to_the_card():
    """``GeneralizedLinearModel.zeros`` runs on the card unless asked for
    the CPU, like every entry point of the package; the fixed effect's zero
    model is made on the coordinate's (the batch's) device."""
    from photon_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate

    assert inspect.signature(GeneralizedLinearModel.zeros).parameters["device"].default == "cuda"
    assert GeneralizedLinearModel.zeros(3, TaskType.LOGISTIC_REGRESSION, device="cpu").coefficients.means.device \
        == torch.device("cpu")
    meta = torch.device("meta")
    coord = FixedEffectCoordinate("global", None, "global", TaskType.LOGISTIC_REGRESSION,
                                  GLMObjective(LogisticLoss), dim=4, device=meta)
    means = coord.zero_model().model.coefficients.means
    assert means.device == meta and tuple(means.shape) == (4,)


def test_solver_modules_import_without_jax():
    """The solver modules load in a process where jax and photon_tpu never
    load (tests/conftest.py imports jax here, so this runs in a subprocess)."""
    code = (
        "import sys\n"
        "import photon_tpu_torch.optim.problem, photon_tpu_torch.optim.tron, photon_tpu_torch.optim.owlqn\n"
        "import photon_tpu_torch.optim.lbfgs, photon_tpu_torch.optim.margin_lbfgs, photon_tpu_torch.optim.factory\n"
        "import photon_tpu_torch.optim.linesearch, photon_tpu_torch.optim.program\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'photon_tpu'"
        " or m.startswith('photon_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("track_history", [True, False])
def test_newton_histories_match_reference(track_history):
    """Batched Newton's per-iteration histories against ``jax.vmap`` of the
    reference's ``minimize_newton`` in float64: the loss and gradient-norm
    histories (history_len slots; past a lane's end its final value, entry
    0 of the gradient history |g| at the start) at rtol 1e-5, iterations
    equal, lanes stopping at different iterations."""
    from photon_tpu.optim.newton import minimize_newton as j_newton

    from photon_tpu_torch.optim.newton import minimize_newton

    X, y, wt, off, _ = _block(seed=8)
    E, _, d = X.shape
    cfg = dict(max_iter=12, tol=1e-9, track_history=track_history)
    with jax.enable_x64(True):
        jo = JObjective(loss=JLogistic, l2_weight=0.5, intercept_index=0)
        res = jax.vmap(lambda f, lab, w_, o: j_newton(jo, JBatch(lab, f, o, w_), jnp.zeros(d), JConfig(**cfg)))(
            *(jnp.asarray(a) for a in (X, y, wt, off)))
        want = [np.asarray(a) for a in (res.loss_history, res.grad_norm_history, res.iterations, res.value)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = minimize_newton(GLMObjective(LogisticLoss, l2_weight=0.5, intercept_index=0), LabeledBatch(t(y), t(X), t(off),
                          t(wt)), torch.zeros(E, d, dtype=torch.float64), OptimizerConfig(**cfg))
    assert got.loss_history.shape == got.grad_norm_history.shape == (E, 13 if track_history else 1)
    _close(got.loss_history, want[0])
    _close(got.grad_norm_history, want[1])
    _close(got.value, want[3])
    np.testing.assert_array_equal(got.iterations.numpy(), want[2])
    assert len(set(want[2].tolist())) > 1
