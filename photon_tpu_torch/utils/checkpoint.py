"""Mid-training checkpoint and resume for coordinate descent and the λ sweep
(port of photon_tpu/utils/checkpoint.py, the same on-disk format).

Format: one ``step_<N>.npz`` holding the tensor leaves plus a declarative
JSON ``__manifest__`` (format version 2) describing the structure:
containers, literals, enums by registry key + value, and framework objects
by REGISTRY KEY + field names, with each leaf's shape, dtype and sha256. No
``torch.save`` and no pickle anywhere: loading can only construct the
classes allow-listed in ``_REGISTRY``, so an untrusted checkpoint directory
cannot execute code, and a renamed class keeps loading while its key stays.
A file written by either package loads in the other.

bfloat16 leaves are stored as uint16 views (npz has no bf16). A CUDA leaf
comes to the host with the others in one synchronization for the whole
state. ``load_checkpoint(..., device=)`` puts every tensor leaf on the
device the caller names; numpy scalars come back as Python numbers. A
``LATEST`` file names the newest step; step files are self-contained, so
``latest_step`` recovers by a scan when the pointer is torn. Writes are
atomic (tmp + fsync + ``os.replace``); ENOSPC prunes older steps and
retries once; ``PHOTON_TPU_CHECKPOINT_KEEP_LAST`` caps the kept steps. The
fault sites are ``checkpoint.save`` (before the write; ``torn`` leaves a
truncated file at the final name), ``checkpoint.io`` (inside the write) and
``checkpoint.after_save`` (right after a step is durable).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import logging
import os
import signal
import zipfile
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from photon_tpu_torch.utils import faults, resources

logger = logging.getLogger(__name__)

_LATEST = "LATEST"
_FORMAT_VERSION = 2

CHECKPOINT_KEEP_LAST_ENV = "PHOTON_TPU_CHECKPOINT_KEEP_LAST"

# Checkpoints sit at the top of the degradation priority (they are the
# model artifact), so their ENOSPC policy is the aggressive one: prune, retry.
_DISK_GUARD = resources.DiskBudgetGuard("checkpoint.io")


class LegacyCheckpointError(ValueError):
    """Raised for v1 (pickle-era) checkpoints, so resume sites can restart
    from scratch on upgrades without string-matching messages."""


# ---------------------------------------------------------------------------
# Registry: stable key ↔ class. Keys are the durable identity.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type] = {}
_KEY_OF: Dict[Type, str] = {}


def register_checkpoint_node(key: str, cls: Type) -> None:
    """Allow-list ``cls`` under ``key``. Dataclasses round-trip by field
    names; Enums by value."""
    _REGISTRY[key] = cls
    _KEY_OF[cls] = key


def _register_builtin_nodes() -> None:
    from photon_tpu_torch.algorithm.random_effect import RandomEffectTrackerStats
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.game import (
        FixedEffectModel,
        GameModel,
        ProjectedRandomEffectModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.optim.common import OptimizeResult, OptimizerConfig
    from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    for key, cls in {
        "game_model": GameModel,
        "fixed_effect_model": FixedEffectModel,
        "random_effect_model": RandomEffectModel,
        "projected_random_effect_model": ProjectedRandomEffectModel,
        "glm": GeneralizedLinearModel,
        "coefficients": Coefficients,
        "optimize_result": OptimizeResult,
        "optimizer_config": OptimizerConfig,
        "re_tracker_stats": RandomEffectTrackerStats,
        "task_type": TaskType,
        "optimizer_type": OptimizerType,
        "variance_type": VarianceComputationType,
    }.items():
        register_checkpoint_node(key, cls)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) or (
        isinstance(x, np.generic) and not isinstance(x, (np.str_, np.bytes_)))


def _encode(obj: Any, leaves: list) -> Any:
    """The manifest spec of ``obj``; each array leaf is appended to
    ``leaves`` as (spec, leaf) and its spec completed by ``_gather``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "v": obj}
    if _is_array(obj):
        # numpy scalars (counters, metrics) come back as Python scalars.
        scalar = isinstance(obj, np.generic) or (isinstance(obj, np.ndarray) and obj.ndim == 0)
        spec = {"t": "scalar" if scalar else "array", "i": len(leaves)}
        leaves.append((spec, obj))
        return spec
    if isinstance(obj, (list, tuple)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list", "items": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, dict):
        bad = [k for k in obj if not isinstance(k, str)]
        if bad:
            raise TypeError(f"checkpoint dicts need string keys; got {type(bad[0]).__name__}")
        return {"t": "dict", "items": {k: _encode(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, enum.Enum):
        key = _KEY_OF.get(type(obj))
        if key is None:
            raise TypeError(f"enum {type(obj).__name__} is not checkpoint-registered; call register_checkpoint_node")
        return {"t": "enum", "cls": key, "v": obj.value}
    key = _KEY_OF.get(type(obj))
    if key is not None and dataclasses.is_dataclass(obj):
        return {"t": "node", "cls": key,
                "fields": {f.name: _encode(getattr(obj, f.name), leaves) for f in dataclasses.fields(obj)}}
    raise TypeError(f"cannot checkpoint object of type {type(obj).__name__}: not a primitive/array/container and "
                    "not registered via register_checkpoint_node")


def _gather(leaves: list) -> List[np.ndarray]:
    """The host arrays of every leaf, the card's copied in one
    synchronization, with each spec's shape, dtype and sha256 filled in."""
    host = [leaf.detach().to("cpu", non_blocking=True) if isinstance(leaf, torch.Tensor) else leaf
            for _spec, leaf in leaves]
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda for _spec, leaf in leaves):
        torch.cuda.synchronize()
    arrays = []
    for (spec, _leaf), h in zip(leaves, host):
        if isinstance(h, torch.Tensor):
            bf16 = h.dtype == torch.bfloat16
            arr = h.view(torch.int16).numpy().view(np.uint16) if bf16 else h.numpy()
            dt = "bfloat16" if bf16 else str(arr.dtype)
        else:
            arr = np.asarray(h)
            dt = str(arr.dtype)
            if dt == "bfloat16":
                arr = arr.view(np.uint16)
        # Payload digest: shape/dtype validation catches structural
        # corruption, but bit rot inside the data blocks would deserialize
        # fine and silently poison a resume.
        spec.update(shape=list(arr.shape), dtype=dt,
                    sha256=hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest())
        arrays.append(arr)
    return arrays


def _decode(spec: Any, z, device) -> Any:
    t = spec["t"]
    if t == "lit":
        return spec["v"]
    if t in ("array", "scalar"):
        arr = z[f"leaf_{spec['i']}"]
        if list(arr.shape) != spec["shape"] or (spec["dtype"] != "bfloat16" and str(arr.dtype) != spec["dtype"]):
            raise ValueError(f"checkpoint corrupt: leaf {spec['i']} is {arr.dtype}{arr.shape}, manifest says "
                             f"{spec['dtype']}{tuple(spec['shape'])}")
        want = spec.get("sha256")
        if want is not None:
            got = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
            if got != want:
                raise ValueError(f"checkpoint corrupt: leaf {spec['i']} sha256 mismatch (payload bit-rot): "
                                 f"{got[:12]} != manifest {want[:12]}")
        if spec["dtype"] == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
        if t == "scalar":
            return arr[()].item()
        return torch.from_numpy(np.array(arr, copy=True)).to(device)
    if t == "list":
        return [_decode(x, z, device) for x in spec["items"]]
    if t == "tuple":
        return tuple(_decode(x, z, device) for x in spec["items"])
    if t == "dict":
        return {k: _decode(v, z, device) for k, v in spec["items"].items()}
    if t == "enum":
        cls = _REGISTRY.get(spec["cls"])
        if cls is None:
            raise ValueError(f"unknown checkpoint enum key {spec['cls']!r}")
        return cls(spec["v"])
    if t == "node":
        cls = _REGISTRY.get(spec["cls"])
        if cls is None:
            raise ValueError(f"unknown checkpoint node key {spec['cls']!r} — register it with "
                             "register_checkpoint_node")
        fields = {k: _decode(v, z, device) for k, v in spec["fields"].items()}
        unknown = set(fields) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"checkpoint field(s) {sorted(unknown)} not on {cls.__name__} — incompatible schema "
                             "change")
        return cls(**fields)
    raise ValueError(f"unknown checkpoint tag {t!r}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _write_step(path: str, manifest: dict, arrays: list) -> None:
    """Atomically write one step file; any failure removes the partial tmp
    file before propagating (a failed save must not eat the space a retry
    needs)."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            # ``enospc`` rules fire here, after the tmp exists but before its
            # data does: the worst place a real full disk bites.
            _DISK_GUARD.check()
            np.savez(f, __manifest__=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
                     **{f"leaf_{i}": a for i, a in enumerate(arrays)})
            # Durability before visibility: without the fsync a machine crash
            # can publish a rename whose data blocks never hit disk.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        _DISK_GUARD.cleanup(tmp)
        raise


def prune_checkpoints(directory: str, keep_last: Optional[int]) -> int:
    """Delete the oldest ``step_<N>.npz`` files so at most ``keep_last``
    remain; returns how many were removed."""
    if keep_last is None or keep_last < 1:
        return 0
    steps = _scan_steps(directory)
    removed = 0
    for s in steps[:-keep_last] if len(steps) > keep_last else []:
        try:
            os.unlink(os.path.join(directory, f"step_{s}.npz"))
            removed += 1
        except OSError:
            pass
    if removed:
        try:
            from photon_tpu_torch.obs import registry

            registry().counter("checkpoint_pruned_total").inc(removed)
        except Exception:
            pass
    return removed


def save_checkpoint(directory: str, state: Any, step: int, keep_last: Optional[int] = None) -> str:
    """Persist ``state`` (containers, tensors, numpy arrays, registered
    objects) as step ``step``; returns the file path. ``keep_last`` (or
    ``PHOTON_TPU_CHECKPOINT_KEEP_LAST`` when None) caps the step files kept
    after a successful publish. ENOSPC during the write prunes down to the
    newest older step and retries once."""
    if not _REGISTRY:
        _register_builtin_nodes()
    if keep_last is None:
        env = os.environ.get(CHECKPOINT_KEEP_LAST_ENV, "").strip()
        keep_last = int(env) if env else None
    os.makedirs(directory, exist_ok=True)
    leaves: list = []
    root = _encode(state, leaves)
    arrays = _gather(leaves)
    manifest = {"version": _FORMAT_VERSION, "root": root}
    path = os.path.join(directory, f"step_{step}.npz")
    rule = faults.injector().fire("checkpoint.save")
    if rule is not None:
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if rule.kind == "torn":
            with open(path, "wb") as f:
                f.write(b"PK\x03\x04torn-checkpoint")
            raise faults.PermanentInjectedFault(f"injected torn checkpoint at {path}")
        raise faults.exception_for(rule, "checkpoint.save")
    try:
        _write_step(path, manifest, arrays)
    except OSError as exc:
        if not _DISK_GUARD.record(exc):
            raise
        pruned = prune_checkpoints(directory, keep_last=1)
        logger.warning("disk full writing checkpoint step %d; pruned %d older step(s) and retrying once: %s",
                       step, pruned, exc)
        _write_step(path, manifest, arrays)  # a second failure propagates
    latest_tmp = os.path.join(directory, _LATEST + ".tmp")
    try:
        with open(latest_tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(directory, _LATEST))
    except BaseException:
        _DISK_GUARD.cleanup(latest_tmp)
        raise
    prune_checkpoints(directory, keep_last)
    # Post-publish hook: right after a step becomes durable.
    faults.check("checkpoint.after_save")
    return path


def _scan_steps(directory: str) -> list:
    """Step numbers of every step_<N>.npz present."""
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and name.endswith(".npz"):
            try:
                steps.append(int(name[len("step_"):-len(".npz")]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest resumable step: the ``LATEST`` pointer when it names an
    existing step file, else a scan of the step files."""
    p = os.path.join(directory, _LATEST)
    if os.path.exists(p):
        with open(p) as f:
            raw = f.read().strip()
        try:
            step = int(raw)
        except ValueError:
            step = None  # torn pointer: recover by scan below
        if step is not None and os.path.exists(os.path.join(directory, f"step_{step}.npz")):
            return step
    if not os.path.isdir(directory):
        return None
    steps = _scan_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None, device="cuda") -> Tuple[Any, int]:
    """Load a checkpoint back into typed objects, tensors on ``device``.
    Only JSON and numpy arrays are read.

    With an explicit ``step`` a corrupt file raises. With ``step=None`` the
    load is resume-robust: it walks the steps newest to oldest and skips
    unreadable ones with a warning, so a torn newest step resumes one step
    earlier. Raises ``FileNotFoundError`` when no step exists,
    :class:`LegacyCheckpointError` when only v1 files remain, or the last
    decode error when every step is corrupt."""
    if not _REGISTRY:
        _register_builtin_nodes()
    if step is not None:
        return _load_step(directory, step, device)
    newest = latest_step(directory)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    candidates = sorted(set(_scan_steps(directory)) | {newest}, reverse=True)
    legacy_exc: Optional[LegacyCheckpointError] = None
    last_exc: Optional[Exception] = None
    for s in candidates:
        try:
            return _load_step(directory, s, device)
        except LegacyCheckpointError as exc:
            legacy_exc = exc
        except (ValueError, OSError, KeyError, EOFError, zipfile.BadZipFile) as exc:
            last_exc = exc
            logger.warning("skipping unreadable checkpoint step %d under %s: %s", s, directory, exc)
            try:
                from photon_tpu_torch.obs import registry

                registry().counter("checkpoint_corrupt_skipped_total").inc()
            except Exception:
                pass
    if legacy_exc is not None:
        raise legacy_exc
    assert last_exc is not None
    raise last_exc


def _load_step(directory: str, step: int, device) -> Tuple[Any, int]:
    # allow_pickle stays False (numpy's default): object arrays are rejected.
    path = os.path.join(directory, f"step_{step}.npz")
    try:
        z_ctx = np.load(path)
    except (ValueError, OSError) as exc:
        if "pickle" in str(exc):  # a v1 pickle file, not an npz at all
            raise LegacyCheckpointError(f"legacy (pickle-based) checkpoint at {path} — not loadable by this "
                                        "version; retrain or re-save") from exc
        raise
    with z_ctx as z:
        if "__manifest__" not in z:
            raise LegacyCheckpointError("legacy (pickle-based) checkpoint format — not loadable by this version; "
                                        "retrain or re-save")
        manifest = json.loads(z["__manifest__"].tobytes().decode())
        if manifest.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {manifest.get('version')}")
        return _decode(manifest["root"], z, torch.device(device)), step
