"""Copy of photon_tpu/utils/faults.py (framework-free; the port does not import it), with
``poison`` taking numpy arrays or torch tensors and without the metrics registry.

Deterministic, plan-driven fault injection: a seeded injector with named
hook points in the ingest pipeline (``ingest.source``/``ingest.assemble``/
``ingest.h2d``), the solve engine (``solve.re_block``), the checkpoint writer
(``checkpoint.save``/``checkpoint.after_save``/``checkpoint.io``) and the
other writers (``spool.write``/``deadletter.write``).

A **plan** is JSON, inline or a file path, selected by the
``PHOTON_TPU_FAULT_PLAN`` environment variable (or by :func:`configure`):

    {"seed": 7, "rules": [
        {"site": "ingest.source", "kind": "transient", "p": 0.2},
        {"site": "solve.re_block", "kind": "nan", "at": [1]},
        {"site": "checkpoint.after_save", "kind": "kill", "at": [0]}
    ]}

Rules fire either probabilistically (``p``, through a per-rule
``np.random.default_rng`` seeded from plan seed + site, so runs are
reproducible and independent of call order elsewhere) or at explicit
per-site call indices (``at``), optionally bounded by ``max_count``. Kinds:

- ``transient``  raises :class:`TransientInjectedFault` (an ``OSError``, so
  IO retry classification treats it as retryable);
- ``permanent``  raises :class:`PermanentInjectedFault`;
- ``nan``        the hook poisons a tensor (first row → NaN);
- ``torn``       the checkpoint writer leaves a truncated file at the final
  step path and raises;
- ``kill``       ``SIGKILL`` the process at the hook;
- ``enospc``     raises :class:`EnospcInjectedFault` (``errno == ENOSPC``);
- ``oom``        raises :class:`DeviceOomInjectedFault`;
- ``rss``        only acts at the ``rss.sample`` site of the host memory
  watchdog (``"hard"`` in its message → hard pressure, else soft).

With no plan configured the hooks cost one attribute read.
"""

from __future__ import annotations

import dataclasses
import errno
import fnmatch
import json
import logging
import os
import signal
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

FAULT_PLAN_ENV = "PHOTON_TPU_FAULT_PLAN"

KINDS = ("transient", "permanent", "nan", "torn", "kill", "enospc", "oom", "rss")


class InjectedFault(Exception):
    """Base class for all injected failures (never raised directly)."""


class TransientInjectedFault(InjectedFault, OSError):
    """Retryable injected failure (an OSError, so the pipeline's transient
    classification catches it without special cases)."""


class PermanentInjectedFault(InjectedFault, RuntimeError):
    """Non-retryable injected failure."""


class EnospcInjectedFault(InjectedFault, OSError):
    """Injected disk-full failure: an ``OSError`` carrying ``errno ==
    ENOSPC``, so every writer's real ENOSPC policy handles it unchanged."""

    def __init__(self, message: str):
        OSError.__init__(self, errno.ENOSPC, message)


class DeviceOomInjectedFault(InjectedFault, RuntimeError):
    """Injected device allocator failure. The message embeds
    ``RESOURCE_EXHAUSTED``, the marker :func:`photon_tpu_torch.utils.
    resources.is_device_oom` classifies it by."""

    def __init__(self, message: str):
        RuntimeError.__init__(self, f"RESOURCE_EXHAUSTED: {message}")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule. ``site`` may be exact or an ``fnmatch`` glob."""

    site: str
    kind: str = "transient"
    p: float = 0.0
    at: Tuple[int, ...] = ()
    max_count: Optional[int] = None
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault probability must be in [0,1], got {self.p}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    rules: Tuple[FaultRule, ...] = ()

    @staticmethod
    def from_obj(obj: Dict[str, Any]) -> "FaultPlan":
        rules = tuple(
            FaultRule(site=r["site"], kind=r.get("kind", "transient"), p=float(r.get("p", 0.0)),
                      at=tuple(int(i) for i in r.get("at", ())), max_count=r.get("max_count"),
                      message=r.get("message", "injected fault"))
            for r in obj.get("rules", ())
        )
        return FaultPlan(seed=int(obj.get("seed", 0)), rules=rules)

    @staticmethod
    def from_env() -> Optional["FaultPlan"]:
        raw = os.environ.get(FAULT_PLAN_ENV, "").strip()
        if not raw:
            return None
        if not raw.startswith("{"):  # a file path, not inline JSON
            with open(raw) as f:
                raw = f.read()
        return FaultPlan.from_obj(json.loads(raw))


def _site_rng(seed: int, site: str) -> np.random.Generator:
    # Stable across processes (hash() is salted; crc32 is not).
    return np.random.default_rng((seed << 32) ^ zlib.crc32(site.encode()))


class FaultInjector:
    """Evaluates a :class:`FaultPlan`. Thread-safe; per-(rule, site) call
    counters and RNG streams make firing sequences deterministic for a given
    plan regardless of what other sites do."""

    def __init__(self, plan: Optional[FaultPlan]):
        self._plan = plan
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[int, str], int] = {}
        self._fired: Dict[Tuple[int, str], int] = {}
        self._rngs: Dict[Tuple[int, str], np.random.Generator] = {}
        self.enabled = bool(plan and plan.rules)

    def _matches(self, rule: FaultRule, site: str) -> bool:
        if rule.site == site:
            return True
        return any(c in rule.site for c in "*?[") and fnmatch.fnmatch(site, rule.site)

    def fire(self, site: str, label: Optional[str] = None) -> Optional[FaultRule]:
        """Advance per-rule call counters for ``site``; return the first rule
        that fires here (and count it), else None."""
        if not self.enabled:
            return None
        hit: Optional[FaultRule] = None
        with self._lock:
            assert self._plan is not None
            for idx, rule in enumerate(self._plan.rules):
                if not self._matches(rule, site):
                    continue
                key = (idx, site)
                n = self._calls.get(key, 0)
                self._calls[key] = n + 1
                if hit is not None:
                    continue  # still advance counters for later rules
                fired = self._fired.get(key, 0)
                if rule.max_count is not None and fired >= rule.max_count:
                    continue
                trigger = n in rule.at
                if not trigger and rule.p > 0.0:
                    rng = self._rngs.get(key)
                    if rng is None:
                        rng = self._rngs[key] = _site_rng(self._plan.seed, site)
                    trigger = bool(rng.random() < rule.p)
                if trigger:
                    self._fired[key] = fired + 1
                    hit = rule
        if hit is not None:
            self._record(site, hit, label)
        return hit

    def _record(self, site: str, rule: FaultRule, label: Optional[str]) -> None:
        try:
            from photon_tpu_torch.obs import registry

            registry().counter("faults_injected_total", site=site, kind=rule.kind).inc()
        except Exception:  # metrics must never mask the fault path itself
            pass
        logger.warning("fault injected at %s%s: kind=%s", site, f" ({label})" if label else "", rule.kind)

    def counts(self) -> Dict[str, int]:
        """Total injections per site."""
        with self._lock:
            out: Dict[str, int] = {}
            for (_, site), n in self._fired.items():
                out[site] = out.get(site, 0) + n
            return out


def exception_for(rule: FaultRule, site: str) -> InjectedFault:
    if rule.kind == "permanent":
        return PermanentInjectedFault(f"{rule.message} [{site}]")
    if rule.kind == "enospc":
        return EnospcInjectedFault(f"{rule.message} [{site}]")
    if rule.kind == "oom":
        return DeviceOomInjectedFault(f"{rule.message} [{site}]")
    return TransientInjectedFault(f"{rule.message} [{site}]")


# ---------------------------------------------------------------------------
# Process-wide injector + hook helpers (the only API hook sites use)
# ---------------------------------------------------------------------------

_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def injector() -> FaultInjector:
    global _injector
    inj = _injector
    if inj is None:
        with _injector_lock:
            inj = _injector
            if inj is None:
                inj = _injector = FaultInjector(FaultPlan.from_env())
    return inj


def configure(plan: Optional[FaultPlan], seed: Optional[int] = None) -> FaultInjector:
    """Install an explicit plan. ``configure(None)`` disables injection
    until :func:`reset`."""
    global _injector
    if plan is not None and seed is not None:
        plan = dataclasses.replace(plan, seed=seed)
    with _injector_lock:
        _injector = FaultInjector(plan)
        return _injector


def reset() -> None:
    """Drop any configured injector; the next hook re-reads the environment."""
    global _injector
    with _injector_lock:
        _injector = None


def active(site: Optional[str] = None) -> bool:
    """Cheap guard for hook sites that need setup work before injecting."""
    inj = injector()
    if not inj.enabled:
        return False
    if site is None:
        return True
    assert inj._plan is not None
    return any(inj._matches(r, site) for r in inj._plan.rules)


def _kill(site: str) -> None:
    logger.warning("fault plan: SIGKILL self at %s", site)
    os.kill(os.getpid(), signal.SIGKILL)


def check(site: str, label: Optional[str] = None) -> None:
    """Raise the planned fault for ``site`` if one fires on this call;
    ``kill`` rules SIGKILL the process (no cleanup)."""
    inj = injector()
    if not inj.enabled:
        return
    rule = inj.fire(site, label)
    if rule is None:
        return
    if rule.kind == "kill":
        _kill(site)
    if rule.kind in ("nan", "rss"):
        # nan rules act only through poison(), rss rules only through the
        # watchdog's sampler.
        return
    raise exception_for(rule, site)


def poison(site: str, array, label: Optional[str] = None):
    """If a ``nan`` rule fires at ``site``, a copy of ``array`` (numpy or
    torch) with its first row (or element) NaN; else ``array`` itself. The
    caller's array is never written."""
    inj = injector()
    if not inj.enabled:
        return array
    rule = inj.fire(site, label)
    if rule is None:
        return array
    if rule.kind == "kill":
        _kill(site)
    if rule.kind == "rss":
        return array
    if rule.kind != "nan":
        raise exception_for(rule, site)
    if isinstance(array, np.ndarray):
        out = np.array(array, copy=True)
        out[(0,) * max(out.ndim - 1, 1)] = np.nan
        return out
    out = array.clone()
    if out.dim() == 0:
        return out.fill_(float("nan"))
    out[0] = float("nan")
    return out


__all__ = [
    "FAULT_PLAN_ENV", "DeviceOomInjectedFault", "EnospcInjectedFault", "FaultInjector", "FaultPlan", "FaultRule",
    "InjectedFault", "PermanentInjectedFault", "TransientInjectedFault", "active", "check", "configure",
    "exception_for", "injector", "poison", "reset",
]
