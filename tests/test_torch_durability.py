"""Durability in the port: checkpoint and resume, fault injection, resource
containment, graceful shutdown and lifecycle events, against the JAX
package on the CPU.

The cases of the reference's tests/test_checkpoint.py, tests/test_faults.py
(without its pipeline cases, which tests/test_torch_pipeline.py holds, and
its serving and breaker cases, which go with serving) and
tests/test_resources.py (without its re_store, spill and serving cases,
which go with the out-of-core store and serving, the run-report case, which
goes with telemetry, and its replay-cache and dead-letter cases, which
tests/test_torch_pipeline.py holds), ported to the port's API. Where a
reference case asserts a metrics-registry counter (device OOM retries, RSS
pressure events, the quarantine count), the port's case asserts the same
behaviour without the counter: the port has no registry.

Beside them: a resumed coordinate descent against an unbroken one in both
packages (float64, rtol 1e-5; jax's scoped x64 context, never the global
flag) and against each other; a SIGKILLed ``train_glm --device cpu``
resumed with ``--resume`` against the unbroken sweep (rel 1e-6); the same
for ``game_training``; a checkpoint file written by either package loaded
by the other; and the events a listener registered by dotted path receives,
against the reference's.
"""

import errno
import glob
import json
import logging
import os
import signal as _signal
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.algorithm.solve_cache import SolveCache
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.types import ConvergenceReason, OptimizerType, TaskType
from photon_tpu_torch.utils import checkpoint as ckpt
from photon_tpu_torch.utils import faults, resources
from photon_tpu_torch.utils import shutdown as shut
from photon_tpu_torch.utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
from photon_tpu_torch.utils.events import EventEmitter
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule, PermanentInjectedFault, TransientInjectedFault

REPO = Path(__file__).resolve().parent.parent
TASK = TaskType.LOGISTIC_REGRESSION
rng = np.random.default_rng(23)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No fault plan, no watchdog and no keep-last default leak between
    tests: the hooks and the watchdog are process-global."""
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(ckpt.CHECKPOINT_KEEP_LAST_ENV, raising=False)
    faults.reset()
    resources.stop_watchdog()
    yield
    faults.reset()
    resources.stop_watchdog()


def _plan(*rules, seed=0):
    return faults.configure(FaultPlan(seed=seed, rules=tuple(rules)))


# ---------------------------------------------------------------------------
# Checkpoint format (reference tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_pytree_roundtrip(tmp_path):
    glm = GeneralizedLinearModel(task=TASK, coefficients=Coefficients(means=torch.arange(4.0)))
    state = dict(
        model=GameModel({"fixed": FixedEffectModel(model=glm, feature_shard="g"),
                         "re": RandomEffectModel(coefficients=torch.ones((3, 2)), re_type="u", feature_shard="r",
                                                 task=TASK)}),
        scores={"fixed": torch.arange(5.0)},
        history=[{"AUC": 0.9}, {"AUC": 0.95}],
        none_field=None,
        bf=torch.arange(6, dtype=torch.bfloat16),
    )
    save_checkpoint(str(tmp_path), state, 3)
    assert latest_step(str(tmp_path)) == 3
    restored, step = load_checkpoint(str(tmp_path), device="cpu")
    assert step == 3
    assert isinstance(restored["model"].models["fixed"], FixedEffectModel)
    assert restored["model"].models["re"].re_type == "u"
    np.testing.assert_array_equal(restored["model"].models["fixed"].model.coefficients.means.numpy(), np.arange(4.0))
    assert restored["none_field"] is None
    assert [float(h["AUC"]) for h in restored["history"]] == [0.9, 0.95]
    assert restored["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["bf"].float().numpy(), np.arange(6.0))


def test_latest_step_empty(tmp_path):
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), device="cpu")


def test_latest_step_recovers_from_torn_pointer(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, {"x": torch.arange(3.0)}, 2)
    save_checkpoint(d, {"x": torch.arange(4.0)}, 7)
    (tmp_path / "LATEST").write_text("7\x00\xf3garbage")
    assert latest_step(d) == 7
    (tmp_path / "LATEST").write_text("99")  # stale pointer at a pruned step
    assert latest_step(d) == 7
    restored, step = load_checkpoint(d, device="cpu")
    assert step == 7
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(4.0))
    (tmp_path / "LATEST").unlink()
    assert latest_step(d) == 7
    (tmp_path / "LATEST").write_text("2")  # a valid pointer wins over the scan
    assert latest_step(d) == 2


def _glmix_setup(seed=0, dtype=np.float32, active_set=False):
    """The reference's two-coordinate GLMix of tests/test_checkpoint.py, in
    the port (CPU tensors of ``dtype``); also returns the numpy arrays."""
    r = np.random.default_rng(seed)
    n, d_fix, d_re, E = 512, 8, 4, 16
    Xf = r.normal(size=(n, d_fix)).astype(np.float32)
    Xf[:, 0] = 1.0
    Xr = r.normal(size=(n, d_re)).astype(np.float32)
    Xr[:, 0] = 1.0
    users = (np.arange(n) % E).astype(np.int32)
    logits = Xf @ (r.normal(size=d_fix).astype(np.float32) / np.sqrt(d_fix))
    y = (r.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    arrays = dict(Xf=Xf.astype(dtype), Xr=Xr.astype(dtype), y=y.astype(dtype), users=users, E=E)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    batch = GameBatch(label=t(arrays["y"]), offset=torch.zeros(n, dtype=t(arrays["y"]).dtype),
                      weight=torch.ones(n, dtype=t(arrays["y"]).dtype),
                      features={"global": t(arrays["Xf"]), "per_user": t(arrays["Xr"])},
                      entity_ids={"userId": t(users)})
    fixed = FixedEffectCoordinate("global", "global", TASK,
                                  GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0), OptimizerSpec())
    ds = build_random_effect_dataset(users, arrays["Xr"], arrays["y"], np.ones(n, dtype), E,
                                     RandomEffectDataConfig(re_type="userId", feature_shard="per_user"),
                                     device="cpu")
    rand = RandomEffectCoordinate("per_user", ds, TASK,
                                  GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0),
                                  active_set=active_set)
    return batch, {"global": fixed, "per_user": rand}, arrays


def _cd_coefs(result):
    return (result.model.models["global"].model.coefficients.means.numpy(),
            result.model.models["per_user"].coefficients.numpy())


def test_cd_resume_matches_uninterrupted(tmp_path):
    """3 passes == 2 passes, a crash, and a resumed third."""
    batch, coords, _ = _glmix_setup()
    seq = ["global", "per_user"]
    full = CoordinateDescent(dict(coords), seq, num_iterations=3).run(batch)
    ck = str(tmp_path / "ck")
    CoordinateDescent(dict(coords), seq, num_iterations=2).run(batch, checkpoint_dir=ck)
    assert latest_step(ck) == 1
    resumed = CoordinateDescent(dict(coords), seq, num_iterations=3).run(batch, checkpoint_dir=ck)
    for got, want in zip(_cd_coefs(resumed), _cd_coefs(full)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cd_checkpoint_tag_mismatch_raises(tmp_path):
    batch, coords, _ = _glmix_setup()
    seq = ["global", "per_user"]
    ck = str(tmp_path / "ck")
    CoordinateDescent(dict(coords), seq, num_iterations=1).run(batch, checkpoint_dir=ck, checkpoint_tag="lambda=1.0")
    with pytest.raises(ValueError, match="different configuration"):
        CoordinateDescent(dict(coords), seq, num_iterations=1).run(batch, checkpoint_dir=ck,
                                                                   checkpoint_tag="lambda=2.0")


def test_cd_checkpoint_every_validated(tmp_path):
    batch, coords, _ = _glmix_setup()
    with pytest.raises(ValueError, match="checkpoint_every"):
        CoordinateDescent(dict(coords), ["global", "per_user"], num_iterations=1).run(
            batch, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=0)


def test_cd_resume_preserves_tracker(tmp_path):
    batch, coords, _ = _glmix_setup()
    seq = ["global", "per_user"]
    ck = str(tmp_path / "ck")
    CoordinateDescent(dict(coords), seq, num_iterations=2).run(batch, checkpoint_dir=ck)
    resumed = CoordinateDescent(dict(coords), seq, num_iterations=3).run(batch, checkpoint_dir=ck)
    assert len(resumed.tracker["global"]) == 3 and len(resumed.tracker["per_user"]) == 3
    assert int(resumed.tracker["per_user"][0].num_entities) == 16


def test_cd_completed_run_replays_from_checkpoint(tmp_path):
    batch, coords, _ = _glmix_setup()
    seq = ["global", "per_user"]
    ck = str(tmp_path / "ck")
    first = CoordinateDescent(dict(coords), seq, num_iterations=2).run(batch, checkpoint_dir=ck)
    again = CoordinateDescent(dict(coords), seq, num_iterations=2).run(batch, checkpoint_dir=ck)
    np.testing.assert_array_equal(_cd_coefs(first)[0], _cd_coefs(again)[0])


def test_checkpoint_survives_class_rename(tmp_path):
    """The registry key, not the class name, is the durable identity."""
    import dataclasses

    ckpt.save_checkpoint(str(tmp_path), {"c": Coefficients(torch.arange(4, dtype=torch.float32))}, 0)

    @dataclasses.dataclass(frozen=True)
    class RenamedCoefficients:
        means: object
        variances: object = None

    old = ckpt._REGISTRY["coefficients"]
    try:
        ckpt.register_checkpoint_node("coefficients", RenamedCoefficients)
        loaded, _ = ckpt.load_checkpoint(str(tmp_path), device="cpu")
        assert isinstance(loaded["c"], RenamedCoefficients)
        np.testing.assert_array_equal(loaded["c"].means.numpy(), np.arange(4))
    finally:
        ckpt.register_checkpoint_node("coefficients", old)


def test_checkpoint_rejects_unregistered_and_pickle(tmp_path):
    """No pickle on either path: an unregistered class fails at save, and an
    object-dtype array (the npz pickle vector) fails at load."""

    class Evil:
        pass

    with pytest.raises(TypeError, match="not registered"):
        ckpt.save_checkpoint(str(tmp_path), {"x": Evil()}, 0)
    manifest = {"version": 2, "root": {"t": "array", "i": 0, "shape": [], "dtype": "object"}}
    np.savez(tmp_path / "step_7.npz", __manifest__=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
             leaf_0=np.array({"pwn": True}, dtype=object))
    (tmp_path / "LATEST").write_text("7")
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(str(tmp_path), device="cpu")


def test_checkpoint_shape_validation(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), {"a": torch.ones((3,))}, 0)
    data = dict(np.load(path))
    data["leaf_0"] = np.ones((5,), np.float32)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="manifest"):
        ckpt.load_checkpoint(str(tmp_path), 0, device="cpu")


def test_cd_legacy_checkpoint_restarts_instead_of_crashing(tmp_path, caplog):
    batch, coords, _ = _glmix_setup()
    ck = tmp_path / "ck"
    ck.mkdir()
    np.savez(ck / "step_0.npz", models=np.zeros(3))  # an npz without the v2 manifest
    (ck / "LATEST").write_text("0")
    with caplog.at_level(logging.WARNING):
        result = CoordinateDescent(dict(coords), ["global", "per_user"], num_iterations=1).run(
            batch, checkpoint_dir=str(ck))
    assert result.model is not None
    assert any("legacy" in r.message for r in caplog.records)
    state, step = load_checkpoint(str(ck), device="cpu")
    assert step == 0 and state["tag"] == "global,per_user"


def test_load_skips_torn_newest_step(tmp_path, caplog):
    d = str(tmp_path)
    save_checkpoint(d, {"x": torch.arange(3.0)}, 0)
    save_checkpoint(d, {"x": torch.arange(5.0)}, 1)
    (tmp_path / "step_1.npz").write_bytes(b"PK\x03\x04torn-checkpoint")
    from photon_tpu_torch.obs.metrics import registry

    before = registry().counter("checkpoint_corrupt_skipped_total").value
    with caplog.at_level(logging.WARNING):
        state, step = load_checkpoint(d, device="cpu")
    assert step == 0
    assert registry().counter("checkpoint_corrupt_skipped_total").value == before + 1
    np.testing.assert_array_equal(state["x"].numpy(), np.arange(3.0))
    assert any("unreadable" in r.message for r in caplog.records)
    with pytest.raises((ValueError, OSError, zipfile.BadZipFile)):
        load_checkpoint(d, step=1, device="cpu")


def test_load_all_steps_corrupt_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, {"x": torch.arange(3.0)}, 0)
    (tmp_path / "step_0.npz").write_bytes(b"\x00garbage")
    with pytest.raises((ValueError, OSError, zipfile.BadZipFile)):
        load_checkpoint(d, device="cpu")


def test_torn_fault_injected_save_recovers(tmp_path):
    d = str(tmp_path)
    _plan(FaultRule("checkpoint.save", kind="torn", at=(0,)))
    with pytest.raises(PermanentInjectedFault):
        save_checkpoint(d, {"x": torch.arange(3.0)}, 0)
    assert (tmp_path / "step_0.npz").exists() and not (tmp_path / "LATEST").exists()
    assert latest_step(d) == 0
    save_checkpoint(d, {"x": torch.arange(4.0)}, 1)
    state, step = load_checkpoint(d, device="cpu")
    assert step == 1
    np.testing.assert_array_equal(state["x"].numpy(), np.arange(4.0))


def _format_state(pkg):
    """Containers, arrays, literals and a bf16 leaf, in one package's types."""
    if pkg == "jax":
        return {"f32": jnp.arange(6.0, dtype=jnp.float32).reshape(2, 3), "i64": np.arange(4, dtype=np.int64),
                "bf": jnp.asarray([1.5, -2.25, 3.0], dtype=jnp.bfloat16), "n": np.int64(7),
                "lits": [1, 2.5, "x", None, True], "tup": (np.float32(0.5), {"k": np.zeros(2, np.float32)})}
    return {"f32": torch.arange(6.0, dtype=torch.float32).reshape(2, 3), "i64": np.arange(4, dtype=np.int64),
            "bf": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16), "n": np.int64(7),
            "lits": [1, 2.5, "x", None, True], "tup": (np.float32(0.5), {"k": np.zeros(2, np.float32)})}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_file_format_across_packages(tmp_path, writer):
    """A step file written by either package loads in the other: the same
    leaves (bf16 bit for bit), literals and containers, and the manifests
    agree."""
    from photon_tpu.utils import checkpoint as jckpt

    if writer == "jax":
        path = jckpt.save_checkpoint(str(tmp_path), _format_state("jax"), 4)
        state, step = load_checkpoint(str(tmp_path), device="cpu")
        as_np = lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()  # noqa: E731
        bf_bits = state["bf"].view(torch.int16).numpy().view(np.uint16)
    else:
        path = save_checkpoint(str(tmp_path), _format_state("port"), 4)
        state, step = jckpt.load_checkpoint(str(tmp_path))
        as_np = lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a)  # noqa: E731
        bf_bits = np.asarray(state["bf"]).view(np.uint16)
    assert step == 4
    np.testing.assert_array_equal(as_np(state["f32"]), np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(as_np(state["i64"]), np.arange(4))
    np.testing.assert_array_equal(bf_bits, np.array([1.5, -2.25, 3.0], dtype=np.float32).view(np.uint32) >> 16)
    assert state["n"] == 7 and state["lits"] == [1, 2.5, "x", None, True]
    assert state["tup"][0] == 0.5 and as_np(state["tup"][1]["k"]).tolist() == [0.0, 0.0]
    # Both writers produce the same manifest for the same state.
    other = tmp_path / "other"
    (save_checkpoint(str(other), _format_state("port"), 4) if writer == "jax"
     else jckpt.save_checkpoint(str(other), _format_state("jax"), 4))
    manifests = [json.loads(np.load(p)["__manifest__"].tobytes()) for p in (path, other / "step_4.npz")]
    assert manifests[0] == manifests[1]


# ---------------------------------------------------------------------------
# Resumed coordinate descent against the reference (float64)
# ---------------------------------------------------------------------------


def _jax_glmix(arrays, active_set):
    from photon_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
    from photon_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
    from photon_tpu.data.game_data import GameBatch as JGameBatch
    from photon_tpu.data.random_effect import RandomEffectDataConfig as JConfig
    from photon_tpu.data.random_effect import build_random_effect_dataset as jbuild
    from photon_tpu.ops.losses import LogisticLoss as JLogistic
    from photon_tpu.ops.objective import GLMObjective as JObjective
    from photon_tpu.optim.factory import OptimizerSpec as JSpec
    from photon_tpu.types import TaskType as JTask

    n = arrays["y"].shape[0]
    batch = JGameBatch(label=jnp.asarray(arrays["y"]), offset=jnp.zeros(n), weight=jnp.ones(n),
                       features={"global": jnp.asarray(arrays["Xf"]), "per_user": jnp.asarray(arrays["Xr"])},
                       entity_ids={"userId": jnp.asarray(arrays["users"])})
    fixed = JFixed("global", "global", JTask.LOGISTIC_REGRESSION,
                   JObjective(loss=JLogistic, l2_weight=1.0, intercept_index=0), JSpec())
    ds = jbuild(arrays["users"], arrays["Xr"], arrays["y"], np.ones(n), arrays["E"],
                JConfig(re_type="userId", feature_shard="per_user"))
    rand = JRandom("per_user", ds, JTask.LOGISTIC_REGRESSION,
                   JObjective(loss=JLogistic, l2_weight=0.5, intercept_index=0), active_set=active_set)
    return batch, {"global": fixed, "per_user": rand}


@pytest.mark.parametrize("active_set", [False, True], ids=["full", "active_set"])
def test_resumed_cd_matches_unbroken_and_reference(tmp_path, active_set):
    """(a) In both packages a 3-pass descent equals 2 passes and a resumed
    third, at float64 rtol 1e-5. (b) The port's resumed coefficients equal
    the reference's. With the active set the restored gate state decides
    which entities the resumed pass solves: the same ones as unbroken."""
    from photon_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD

    seq = ["global", "per_user"]
    batch, coords, arrays = _glmix_setup(seed=4, dtype=np.float64, active_set=active_set)
    full = CoordinateDescent(dict(coords), seq, num_iterations=3).run(batch)
    full_active = coords["per_user"].last_active_set_stats
    CoordinateDescent(dict(coords), seq, num_iterations=2).run(batch, checkpoint_dir=str(tmp_path / "t"))
    resumed = CoordinateDescent(dict(coords), seq, num_iterations=3).run(batch, checkpoint_dir=str(tmp_path / "t"))
    if active_set:
        got = coords["per_user"].last_active_set_stats
        assert got["gated"] and got["entities_active"] == full_active["entities_active"]
    with jax.enable_x64(True):
        jbatch, jcoords = _jax_glmix(arrays, active_set)
        jfull = JCD(dict(jcoords), seq, num_iterations=3).run(jbatch)
        JCD(dict(jcoords), seq, num_iterations=2).run(jbatch, checkpoint_dir=str(tmp_path / "j"))
        jres = JCD(dict(jcoords), seq, num_iterations=3).run(jbatch, checkpoint_dir=str(tmp_path / "j"))
        j_full = [np.asarray(jfull.model.models["global"].model.coefficients.means),
                  np.asarray(jfull.model.models["per_user"].coefficients)]
        j_res = [np.asarray(jres.model.models["global"].model.coefficients.means),
                 np.asarray(jres.model.models["per_user"].coefficients)]
    for t_r, t_f, j_r, j_f in zip(_cd_coefs(resumed), _cd_coefs(full), j_res, j_full):
        np.testing.assert_allclose(t_r, t_f, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(j_r, j_f, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(t_r, j_r[: t_r.shape[0]], rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# Fault harness (reference tests/test_faults.py)
# ---------------------------------------------------------------------------


def test_rule_at_indices_and_max_count():
    inj = faults.FaultInjector(FaultPlan(rules=(FaultRule("s.y", kind="transient", at=(1, 3), max_count=1),)))
    assert [inj.fire("s.y") is not None for _ in range(5)] == [False, True, False, False, False]
    assert inj.counts() == {"s.y": 1}


def test_probabilistic_rules_are_deterministic():
    plan = FaultPlan(seed=7, rules=(FaultRule("s.x", kind="transient", p=0.3),))

    def seq():
        inj = faults.FaultInjector(plan)
        return [inj.fire("s.x") is not None for _ in range(200)]

    a, b = seq(), seq()
    assert a == b and 20 < sum(a) < 120
    # The same plan fires the same sequence in the reference's injector.
    from photon_tpu.utils import faults as jfaults

    jinj = jfaults.FaultInjector(jfaults.FaultPlan(seed=7, rules=(jfaults.FaultRule("s.x", kind="transient",
                                                                                    p=0.3),)))
    assert [jinj.fire("s.x") is not None for _ in range(200)] == a


def test_plan_from_env_inline_and_file(tmp_path, monkeypatch):
    plan = {"seed": 3, "rules": [{"site": "demo.site", "kind": "permanent", "at": [0]}]}
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, json.dumps(plan))
    faults.reset()
    assert faults.active("demo.site") and not faults.active("other.site")
    with pytest.raises(PermanentInjectedFault):
        faults.check("demo.site")
    faults.check("demo.site")  # at=[0] fired once
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(plan))
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, str(p))
    faults.reset()
    with pytest.raises(PermanentInjectedFault):
        faults.check("demo.site")


def test_poison_numpy_and_torch_and_original_untouched():
    _plan(FaultRule("s.p", kind="nan", p=1.0))
    a = np.ones((3, 2), np.float32)
    out = faults.poison("s.p", a)
    assert np.isnan(out[0]).all() and np.isfinite(out[1:]).all() and np.isfinite(a).all()
    t = torch.ones((3, 2), dtype=torch.float32)
    got = faults.poison("s.p", t)
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1:]).all()
    assert torch.isfinite(t).all()  # the caller's tensor is never written
    v = faults.poison("s.p", torch.ones((4,)))
    assert torch.isnan(v[0]) and torch.isfinite(v[1:]).all()


def test_rule_validation():
    with pytest.raises(ValueError):
        FaultRule("s", kind="bogus")
    with pytest.raises(ValueError):
        FaultRule("s", p=1.5)
    assert isinstance(faults.exception_for(FaultRule("s"), "s"), TransientInjectedFault)


E_RE, D_RE = 12, 4


def _re_problem():
    eids = np.repeat(np.arange(E_RE, dtype=np.int32), 30)
    n = eids.size
    X = rng.normal(size=(n, D_RE)).astype(np.float32)
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return eids, X, y, np.ones(n, np.float32)


def _re_batch(eids, X, y, w):
    return GameBatch(label=torch.from_numpy(y), offset=torch.zeros(y.shape[0]), weight=torch.from_numpy(w),
                     features={"re": torch.from_numpy(X)}, entity_ids={"userId": torch.from_numpy(eids)})


def _re_coordinate(eids, X, y, w, **kw):
    ds = build_random_effect_dataset(eids, X, y, w, E_RE,
                                     RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=2),
                                     device="cpu")
    return RandomEffectCoordinate(
        coordinate_id="per_user", dataset=ds, task=TASK,
        objective=GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0),
        optimizer_spec=OptimizerSpec(optimizer=OptimizerType.NEWTON, max_iter=25, tol=1e-9),
        solve_cache=SolveCache(), **kw)


def test_re_nan_poison_quarantines_then_recovers():
    """A poisoned block dispatch quarantines only the affected entities
    (they keep their warm start); the next pass, fault spent, heals them."""
    eids, X, y, w = _re_problem()
    _plan(FaultRule("solve.re_block", kind="nan", at=(0,)))
    coord = _re_coordinate(eids, X, y, w)
    batch = _re_batch(eids, X, y, w)
    model, stats = coord.train(batch)
    coefs = model.coefficients.numpy()[:E_RE]
    assert np.isfinite(coefs).all()
    q = int(stats.num_quarantined)
    assert q >= 1
    assert int(np.sum(~np.any(coefs != 0.0, axis=-1))) == q
    model2, stats2 = coord.train(batch, None, model)
    assert int(stats2.num_quarantined) == 0
    coefs2 = model2.coefficients.numpy()[:E_RE]
    assert np.isfinite(coefs2).all() and np.all(np.any(coefs2 != 0.0, axis=-1))


def test_quarantine_accounting_is_sync_free(monkeypatch):
    """With a quarantine firing, run(profile=False) makes no synchronization
    of its own, and the active-set stats report the quarantined entities
    (the reference's registry count is not ported)."""
    from photon_tpu_torch.algorithm import coordinate_descent as cd_mod

    eids, X, y, w = _re_problem()
    _plan(FaultRule("solve.re_block", kind="nan", at=(0,)))
    coord = _re_coordinate(eids, X, y, w, active_set=True, convergence_tol=1e-4)
    calls = {"n": 0}
    monkeypatch.setattr(cd_mod, "_sync", lambda t: calls.__setitem__("n", calls["n"] + 1))
    CoordinateDescent({"per_user": coord}, ["per_user"], num_iterations=2).run(_re_batch(eids, X, y, w),
                                                                              profile=False)
    assert calls["n"] == 0
    st = coord.last_active_set_stats
    assert st is not None and st["entities_quarantined"] >= 1


def test_fe_solver_rolls_back_non_finite_to_warm_start():
    n, d = 64, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[0, 1] = np.nan  # every objective evaluation goes non-finite
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    solve = SolveCache().fe_solver(GLMObjective(loss=LogisticLoss, l2_weight=0.1, intercept_index=0),
                                   OptimizerSpec())
    res = solve(torch.zeros(d), LabeledBatch(torch.from_numpy(y), torch.from_numpy(X)))
    w = res.w.numpy()
    assert np.isfinite(w).all() and (w == 0.0).all()
    assert res.convergence_reason == ConvergenceReason.DIVERGED


def test_handle_termination_converts_first_signal():
    assert shut.shutdown_requested() is None
    with shut.handle_termination():
        os.kill(os.getpid(), _signal.SIGTERM)
        deadline = time.monotonic() + 5
        while shut.shutdown_requested() is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert shut.shutdown_requested() == _signal.SIGTERM
    assert shut.shutdown_requested() is None


def test_cd_graceful_shutdown_checkpoints_then_raises(tmp_path, monkeypatch):
    from photon_tpu_torch.algorithm import coordinate_descent as cd_mod

    monkeypatch.setattr(cd_mod, "shutdown_requested", lambda: int(_signal.SIGTERM))
    eids, X, y, w = _re_problem()
    ck = str(tmp_path / "ck")
    with pytest.raises(shut.GracefulShutdown):
        CoordinateDescent({"per_user": _re_coordinate(eids, X, y, w)}, ["per_user"], num_iterations=5).run(
            _re_batch(eids, X, y, w), checkpoint_dir=ck)
    assert latest_step(ck) == 0  # stopped at the first pass boundary, that pass durable


# ---------------------------------------------------------------------------
# Driver kill and resume (subprocesses)
# ---------------------------------------------------------------------------


def _write_libsvm(path, n=48, d=3, seed=5):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d))
    beta = r.normal(size=d)
    y = (r.uniform(size=n) < 1 / (1 + np.exp(-X @ beta))).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{y[i]} " + " ".join(f"{j + 1}:{X[i, j]:.6f}" for j in range(d)) + "\n")


def _env(plan=None):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop(faults.FAULT_PLAN_ENV, None)
    if plan is not None:
        env[faults.FAULT_PLAN_ENV] = json.dumps(plan)
    return env


def _run_train_glm(data, outdir, ckpt=None, resume=False, plan=None):
    cmd = [sys.executable, "-m", "photon_tpu_torch.cli.train_glm", "--training-data", str(data), "--format",
           "libsvm", "--output-dir", str(outdir), "--regularization-weights", "10,1,0.1", "--max-iterations", "15",
           "--device", "cpu"]
    if ckpt:
        cmd += ["--checkpoint-dir", str(ckpt)]
    if resume:
        cmd += ["--resume"]
    return subprocess.run(cmd, env=_env(plan), capture_output=True, text=True, timeout=300, cwd=str(REPO))


KILL_AFTER_FIRST_SAVE = {"rules": [{"site": "checkpoint.after_save", "kind": "kill", "at": [0]}]}


def test_train_glm_kill_and_resume_parity(tmp_path):
    """SIGKILL right after the first λ's checkpoint is durable, then
    --resume: the losses equal the unbroken sweep's at rel 1e-6."""
    data = tmp_path / "train.libsvm"
    _write_libsvm(data)
    base = _run_train_glm(data, tmp_path / "base")
    assert base.returncode == 0, base.stderr
    killed = _run_train_glm(data, tmp_path / "out", ckpt=tmp_path / "ck", plan=KILL_AFTER_FIRST_SAVE)
    assert killed.returncode == -_signal.SIGKILL, killed.stderr
    assert latest_step(str(tmp_path / "ck")) == 0
    resumed = _run_train_glm(data, tmp_path / "out", ckpt=tmp_path / "ck", resume=True)
    assert resumed.returncode == 0, resumed.stderr
    assert "resuming" in (resumed.stderr + resumed.stdout).lower()
    sa = json.loads((tmp_path / "base" / "training-summary.json").read_text())
    sb = json.loads((tmp_path / "out" / "training-summary.json").read_text())
    assert sa["best_lambda"] == sb["best_lambda"]
    assert len(sa["models"]) == len(sb["models"]) == 3
    for ma, mb in zip(sa["models"], sb["models"]):
        assert ma["lambda"] == mb["lambda"] and mb["loss"] == pytest.approx(ma["loss"], rel=1e-6)
    assert sb["checkpoint"]["resumed_lambdas"] == 1


def test_train_glm_resume_without_state_fails(tmp_path):
    data = tmp_path / "train.libsvm"
    _write_libsvm(data)
    out = _run_train_glm(data, tmp_path / "out", ckpt=tmp_path / "empty-ck", resume=True)
    assert out.returncode != 0 and "no checkpoint state" in out.stderr


def _libsvm_argv(data, out, *extra):
    return ["--training-data", str(data), "--format", "libsvm", "--output-dir", str(out),
            "--regularization-weights", "10,1,0.1", "--max-iterations", "15", "--device", "cpu", *extra]


def test_train_glm_shutdown_at_lambda_boundary_then_resume(tmp_path, monkeypatch):
    """A SIGTERM stops the sweep after the current λ with its checkpoint
    durable and exit code 128 + SIGTERM; a resume finishes the sweep with
    the unbroken losses."""
    from photon_tpu_torch.cli import train_glm

    data = tmp_path / "train.libsvm"
    _write_libsvm(data)
    base = train_glm.main(_libsvm_argv(data, tmp_path / "base"))
    monkeypatch.setattr(train_glm, "shutdown_requested", lambda: int(_signal.SIGTERM))
    with pytest.raises(SystemExit) as exc:
        train_glm.main(_libsvm_argv(data, tmp_path / "out", "--checkpoint-dir", str(tmp_path / "ck")))
    assert exc.value.code == 128 + _signal.SIGTERM
    assert latest_step(str(tmp_path / "ck")) == 0
    monkeypatch.undo()
    resumed = train_glm.main(_libsvm_argv(data, tmp_path / "out", "--checkpoint-dir", str(tmp_path / "ck"),
                                          "--resume"))
    assert [m["loss"] for m in resumed["models"]] == pytest.approx([m["loss"] for m in base["models"]], rel=1e-6)


def test_train_glm_checkpoint_keep_last_and_enospc(tmp_path):
    """--checkpoint-keep-last keeps the newest steps; a full disk at one
    save (after the writer's prune and retry) costs that step, not the
    sweep."""
    from photon_tpu_torch.cli import train_glm

    data = tmp_path / "train.libsvm"
    _write_libsvm(data)
    base = train_glm.main(_libsvm_argv(data, tmp_path / "base"))
    ck = tmp_path / "ck"
    train_glm.main(_libsvm_argv(data, tmp_path / "keep", "--checkpoint-dir", str(ck), "--checkpoint-keep-last", "2"))
    assert sorted(p.name for p in ck.glob("step_*.npz")) == ["step_1.npz", "step_2.npz"]
    from photon_tpu_torch.obs.metrics import registry

    # The driver's run starts a fresh registry: its counts are this run's.
    assert registry().find("checkpoint_pruned_total").value == 1
    _plan(FaultRule("checkpoint.io", kind="enospc", at=(2, 3)))  # the second save, and its retry
    out = train_glm.main(_libsvm_argv(data, tmp_path / "full", "--checkpoint-dir", str(tmp_path / "ck2")))
    # The writer records the first failure, then prunes and retries once.
    assert registry().find("disk_enospc_total", site="checkpoint.io").value == 1
    assert registry().find("faults_injected_total", site="checkpoint.io", kind="enospc").value == 2
    assert registry().find("checkpoint_write_failures_total").value == 1
    assert [m["loss"] for m in out["models"]] == pytest.approx([m["loss"] for m in base["models"]], rel=1e-6)
    assert not glob.glob(str(tmp_path / "ck2" / "*.tmp"))


# ---------------------------------------------------------------------------
# game_training kill and resume
# ---------------------------------------------------------------------------


def _game_fixture(tmp_path):
    """Avro training/validation files of the GAME driver tests and the
    feature-indexing output over them."""
    from test_torch_game_drivers import SHARDS, _records, _write

    from photon_tpu_torch.cli import feature_indexing

    d = tmp_path / "data"
    d.mkdir()
    train = _write(d / "train.avro", _records(400, 23, list(range(8))))
    valid = _write(d / "valid.avro", _records(200, 24, list(range(10))))
    feature_indexing.main(["--input-paths", train, "--output-dir", str(d / "index"), *SHARDS])
    return train, valid, str(d / "index")


def _game_argv(train, valid, out, *extra):
    from test_torch_game_drivers import GLOBAL, PER_ITEM, PER_USER, SHARDS

    return ["--input-paths", train, "--validation-paths", valid, "--output-dir", str(out), *SHARDS,
            "--coordinate-configurations", GLOBAL, PER_USER, PER_ITEM, "--update-sequence", "global,perUser,perItem",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC", "--re-active-set", "--device", "cpu",
            *extra]


def _best_records(out):
    from test_torch_game_drivers import _coefficient_records

    from photon_tpu_torch.io.avro import read_avro_records

    return _coefficient_records(Path(out) / "best", read_avro_records)


def test_game_training_kill_and_resume_matches_unbroken(tmp_path):
    """A game_training subprocess SIGKILLed right after config 0's pass 0 is
    durable (under cfg_0/), then resumed in process: the same best model,
    record for record, and the same summary as an unbroken run."""
    from photon_tpu_torch.cli import game_training

    train, valid, _ = _game_fixture(tmp_path)
    base = game_training.main(_game_argv(train, valid, tmp_path / "base"))
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "photon_tpu_torch.cli.game_training",
           *_game_argv(train, valid, tmp_path / "out", "--checkpoint-dir", str(ck))]
    killed = subprocess.run(cmd, env=_env(KILL_AFTER_FIRST_SAVE), capture_output=True, text=True, timeout=300,
                            cwd=str(REPO))
    assert killed.returncode == -_signal.SIGKILL, killed.stderr[-2000:]
    assert (ck / "cfg_0" / "step_0.npz").exists() and (ck / "cfg_0" / "LATEST").exists()
    assert not (ck / "cfg_1").exists()
    resumed = game_training.main(_game_argv(train, valid, tmp_path / "out", "--checkpoint-dir", str(ck),
                                            "--resume"))
    assert resumed == base
    want, got = _best_records(tmp_path / "base"), _best_records(tmp_path / "out")
    assert got == want
    assert latest_step(str(ck / "cfg_0")) == 1 and latest_step(str(ck / "cfg_1")) == 1


def test_game_training_resume_requires_state(tmp_path):
    from photon_tpu_torch.cli import game_training

    train, valid, _ = _game_fixture(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoint state"):
        game_training.main(_game_argv(train, valid, tmp_path / "out", "--checkpoint-dir", str(tmp_path / "none"),
                                      "--resume"))
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        game_training.main(_game_argv(train, valid, tmp_path / "out", "--resume"))


def test_game_training_sigterm_exits_143_with_checkpoint(tmp_path, monkeypatch):
    from photon_tpu_torch.algorithm import coordinate_descent as cd_mod
    from photon_tpu_torch.cli import game_training

    train, valid, _ = _game_fixture(tmp_path)
    monkeypatch.setattr(cd_mod, "shutdown_requested", lambda: int(_signal.SIGTERM))
    with pytest.raises(SystemExit) as exc:
        game_training.main(_game_argv(train, valid, tmp_path / "out", "--checkpoint-dir", str(tmp_path / "ck")))
    assert exc.value.code == 128 + _signal.SIGTERM
    assert latest_step(str(tmp_path / "ck" / "cfg_0")) == 0


# ---------------------------------------------------------------------------
# Resource containment (reference tests/test_resources.py)
# ---------------------------------------------------------------------------


def test_enospc_fault_kind_raises_oserror_with_enospc_errno():
    _plan(FaultRule("w.x", kind="enospc", at=(0,)))
    with pytest.raises(OSError) as ei:
        faults.check("w.x")
    assert ei.value.errno == errno.ENOSPC and resources.is_enospc(ei.value)
    assert isinstance(ei.value, faults.EnospcInjectedFault)


def test_oom_fault_kind_matches_resource_exhausted_classifier():
    _plan(FaultRule("u.y", kind="oom", at=(0,)))
    with pytest.raises(RuntimeError) as ei:
        faults.check("u.y")
    assert "RESOURCE_EXHAUSTED" in str(ei.value) and resources.is_device_oom(ei.value)
    assert not resources.is_device_oom(RuntimeError("boom"))
    assert not resources.is_enospc(OSError(errno.EIO, "io error"))


def test_torch_out_of_memory_is_classified_by_type():
    """The card's allocator error reads "CUDA out of memory": the port
    classifies it by type; the reference's message test (case-sensitive
    "Out of memory") would miss it, which is why the port does not copy it."""
    from photon_tpu.utils import resources as jresources

    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert resources.is_device_oom(oom)
    assert not jresources.is_device_oom(oom)
    assert not resources.is_device_oom(RuntimeError("CUDA error: an illegal memory access was encountered"))


def test_rss_fault_kind_is_inert_outside_the_watchdog():
    _plan(FaultRule("rss.sample", kind="rss", p=1.0))
    faults.check("rss.sample")
    assert not np.isnan(faults.poison("rss.sample", np.ones(3))).any()


def test_oom_retry_calls_evict_hook():
    """Each contained OOM calls the evict hook before the retry (the
    reference's retry counter is not ported)."""
    calls = []

    def attempt():
        calls.append("try")
        if calls.count("try") < 3:
            raise RuntimeError("RESOURCE_EXHAUSTED: arena full")
        return 42

    assert resources.oom_retry(attempt, site="t", evict=lambda i: calls.append(f"evict{i}"), retries=2) == 42
    assert calls == ["try", "evict0", "try", "evict1", "try"]
    with pytest.raises(RuntimeError):
        resources.oom_retry(lambda: (_ for _ in ()).throw(RuntimeError("RESOURCE_EXHAUSTED: no")), site="t",
                            retries=1)
    with pytest.raises(ValueError):
        resources.oom_retry(lambda: (_ for _ in ()).throw(ValueError("x")), site="t")


def _no_tmp(directory):
    return glob.glob(os.path.join(directory, "*.tmp"))


def test_save_checkpoint_failure_leaves_no_tmp_file(tmp_path):
    d = str(tmp_path)
    _plan(FaultRule("checkpoint.io", kind="transient", at=(0,)))
    with pytest.raises(TransientInjectedFault):
        save_checkpoint(d, dict(w=np.arange(4.0)), 0)
    assert _no_tmp(d) == [] and latest_step(d) is None


def test_save_checkpoint_keep_last_prunes_oldest(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        save_checkpoint(d, dict(w=np.arange(3.0) + s), s, keep_last=2)
    assert sorted(os.listdir(d)) == ["LATEST", "step_3.npz", "step_4.npz"]
    state, step = load_checkpoint(d, device="cpu")
    assert step == 4 and state["w"].tolist() == [4.0, 5.0, 6.0]


def test_save_checkpoint_keep_last_env_default(tmp_path, monkeypatch):
    monkeypatch.setenv(ckpt.CHECKPOINT_KEEP_LAST_ENV, "1")
    d = str(tmp_path)
    for s in range(3):
        save_checkpoint(d, dict(w=np.arange(2.0)), s)
    assert sorted(os.listdir(d)) == ["LATEST", "step_2.npz"]


def test_save_checkpoint_enospc_prunes_and_retries(tmp_path):
    d = str(tmp_path)
    for s in range(3):
        save_checkpoint(d, dict(w=np.arange(2.0)), s)
    _plan(FaultRule("checkpoint.io", kind="enospc", at=(0,)))  # the first write fails, the retry lands
    save_checkpoint(d, dict(w=np.arange(2.0) * 9), 3)
    assert latest_step(d) == 3 and _no_tmp(d) == []
    # The retry pruned down to the newest older step before writing.
    assert sorted(os.listdir(d)) == ["LATEST", "step_2.npz", "step_3.npz"]


def test_save_checkpoint_persistent_enospc_raises_without_tmp(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, dict(w=np.arange(2.0)), 0)
    _plan(FaultRule("checkpoint.io", kind="enospc", p=1.0))
    with pytest.raises(OSError) as ei:
        save_checkpoint(d, dict(w=np.arange(2.0)), 1)
    assert resources.is_enospc(ei.value) and _no_tmp(d) == [] and latest_step(d) == 0


def test_watchdog_levels_from_injected_rss_rules():
    wd = resources.RssWatchdog(limit_bytes=1 << 62)
    assert wd.sample() == resources.LEVEL_OK
    _plan(FaultRule("rss.sample", kind="rss", at=(0,), message="soft squeeze"),
          FaultRule("rss.sample", kind="rss", at=(1,), message="hard limit"))
    assert wd.sample() == resources.LEVEL_SOFT
    wd.check()  # soft: advisory only
    assert wd.sample() == resources.LEVEL_HARD
    with pytest.raises(resources.HostMemoryPressureError) as ei:
        wd.check("unit test")
    assert "OOM-killer" in str(ei.value) and "unit test" in str(ei.value)
    assert wd.sample() == resources.LEVEL_OK


def test_watchdog_real_thresholds(monkeypatch):
    readings = iter([80, 90, 99])
    monkeypatch.setattr(resources, "_read_rss_bytes", lambda: next(readings))
    wd = resources.RssWatchdog(limit_bytes=100, soft_fraction=0.85, hard_fraction=0.95)
    assert [wd.sample() for _ in range(3)] == [resources.LEVEL_OK, resources.LEVEL_SOFT, resources.LEVEL_HARD]


def test_watchdog_inert_without_a_limit(monkeypatch):
    monkeypatch.setattr(resources, "_cgroup_mem_limit", lambda: None)
    monkeypatch.delenv(resources.RSS_LIMIT_ENV, raising=False)
    wd = resources.RssWatchdog()
    assert wd.limit_bytes is None and wd.sample() == resources.LEVEL_OK
    wd.check()


def test_pressure_tightens_depth_and_cap():
    assert resources.tightened_depth(4) == 4 and resources.tightened_cap(64) == 64
    wd = resources.start_watchdog(limit_bytes=1 << 62, interval_s=3600)
    _plan(FaultRule("rss.sample", kind="rss", at=(0,), message="soft"))
    wd.sample()
    assert resources.memory_pressure() and resources.pressure_level() == resources.LEVEL_SOFT
    assert resources.tightened_depth(4) == 1 and resources.tightened_cap(64) == 32
    _plan(FaultRule("rss.sample", kind="rss", at=(0,), message="hard"))
    wd.sample()
    assert resources.tightened_cap(64) == 16
    with pytest.raises(resources.HostMemoryPressureError):
        resources.check_memory("here")


def test_cd_raises_clean_host_memory_error_at_pass_boundary(tmp_path):
    batch, coords, _ = _glmix_setup()
    wd = resources.start_watchdog(limit_bytes=1 << 62, interval_s=3600)
    _plan(FaultRule("rss.sample", kind="rss", p=1.0, message="hard"))
    wd.sample()
    ck = str(tmp_path / "ck")
    with pytest.raises(resources.HostMemoryPressureError):
        CoordinateDescent({"global": coords["global"]}, ["global"], num_iterations=3).run(batch, checkpoint_dir=ck)
    assert latest_step(ck) == 0  # checkpointed before raising: resumable


# ---------------------------------------------------------------------------
# Lifecycle events
# ---------------------------------------------------------------------------

RECEIVED = []


def record_event(event):
    """A listener the drivers register by dotted path."""
    RECEIVED.append((event.name, sorted(event.payload)))


def test_event_emitter_isolates_a_failing_listener():
    """A raising listener is logged and the others still get the event;
    ``register_by_name`` takes 'module:attr' and 'module.attr'."""
    from photon_tpu_torch.utils.events import setup_event

    got = []
    em = EventEmitter()
    em.register(lambda e: (_ for _ in ()).throw(RuntimeError("bad listener")))
    em.register(got.append)
    em.register_by_name("test_torch_durability.record_event")
    RECEIVED.clear()
    em.emit(setup_event(driver="x"))
    assert [e.name for e in got] == ["PhotonSetupEvent"]
    assert RECEIVED == [("PhotonSetupEvent", ["driver"])]


def _events_of(run):
    RECEIVED.clear()
    run()
    # The reference's last event is its run report's (telemetry, not ported).
    return [e for e in RECEIVED if "records" not in e[1]]


def test_driver_events_match_reference(tmp_path):
    """A listener registered by dotted path gets the same event names and
    payload keys from the port's train_glm and game_scoring as from the
    reference's."""
    from photon_tpu.cli import train_glm as j_train_glm

    from photon_tpu_torch.cli import train_glm

    data = tmp_path / "train.libsvm"
    _write_libsvm(data)
    listener = ["--event-listener", "test_torch_durability:record_event"]
    argv = ["--training-data", str(data), "--format", "libsvm", "--regularization-weights", "10,1",
            "--max-iterations", "10", *listener]
    want = _events_of(lambda: j_train_glm.run(j_train_glm.build_parser().parse_args(
        argv + ["--output-dir", str(tmp_path / "j")])))
    got = _events_of(lambda: train_glm.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]))
    assert got == want
    assert [n for n, _ in got] == ["PhotonSetupEvent", "TrainingStartEvent", "PhotonOptimizationLogEvent",
                                   "PhotonOptimizationLogEvent", "TrainingFinishEvent"]


def test_durability_modules_import_without_jax():
    """The slice's modules load where jax and photon_tpu never do, and the
    checkpoint code reads and writes without pickle (a subprocess: this
    process has jax loaded)."""
    code = (
        "import sys\n"
        "import photon_tpu_torch.io.pipeline, photon_tpu_torch.utils.checkpoint, photon_tpu_torch.utils.faults\n"
        "import photon_tpu_torch.utils.resources, photon_tpu_torch.utils.shutdown, photon_tpu_torch.utils.events\n"
        "import photon_tpu_torch.cli.train_glm, photon_tpu_torch.cli.game_training, photon_tpu_torch.cli.game_scoring\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'photon_tpu'"
        " or m.startswith('photon_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    src = (REPO / "photon_tpu_torch" / "utils" / "checkpoint.py").read_text()
    for call in ("import pickle", "pickle.", "torch.save(", "torch.load(", "allow_pickle=True"):
        assert call not in src, call
