"""Copy of photon_tpu/utils/resources.py (framework-free; the port does not import it),
with a device OOM classified by type.

Resource-exhaustion containment: one policy for device OOM, disk-full and
host memory pressure, under one degradation priority:

    model artifacts (checkpoints, published models)
        > training progress
        > observability (dead letters, reports)

- **Device OOM**: :func:`is_device_oom` is true for ``torch.cuda.
  OutOfMemoryError`` (by type: its message reads "CUDA out of memory",
  which the reference's case-sensitive "Out of memory" test would miss) and
  for the injected :class:`~photon_tpu_torch.utils.faults.
  DeviceOomInjectedFault` (by its ``RESOURCE_EXHAUSTED`` marker);
  :func:`oom_retry` evicts, collects and empties the caching allocator,
  then retries.
- **Disk full** (``ENOSPC``/``EDQUOT``): observability writers degrade to
  logged drops; the replay spool falls back to re-streaming; the checkpoint
  writer prunes older steps and retries before giving up.
- **Host RSS pressure**: a cgroup-aware sampling thread (:class:`RssWatchdog`)
  publishes a pressure level: pipeline queue depths tighten at *soft*
  pressure, and at *hard* pressure the training loops' pass-boundary check
  raises :class:`HostMemoryPressureError` instead of letting the kernel
  OOM-killer SIGKILL the process.
"""

from __future__ import annotations

import errno
import gc
import logging
import os
import threading
from typing import Callable, Optional

from photon_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

RSS_LIMIT_ENV = "PHOTON_TPU_RSS_LIMIT_BYTES"
RSS_SOFT_ENV = "PHOTON_TPU_RSS_SOFT_FRACTION"
RSS_HARD_ENV = "PHOTON_TPU_RSS_HARD_FRACTION"

#: Pressure levels published by the watchdog (monotone: OK < SOFT < HARD).
LEVEL_OK, LEVEL_SOFT, LEVEL_HARD = 0, 1, 2
_LEVEL_NAMES = {LEVEL_OK: "ok", LEVEL_SOFT: "soft", LEVEL_HARD: "hard"}


class ResourceExhaustedError(RuntimeError):
    """Base for clean, actionable exhaustion failures raised by this layer."""


class DeviceMemoryError(ResourceExhaustedError):
    """Device memory exhausted even after evicting down to the floor."""


class HostMemoryPressureError(ResourceExhaustedError):
    """Host RSS crossed the hard-pressure threshold; raised at a cooperative
    check point (pass boundary) before the OOM-killer would act."""


# ---------------------------------------------------------------------------
# Failure classification
# ---------------------------------------------------------------------------


def is_device_oom(exc: BaseException) -> bool:
    """True for a device allocator OOM: a ``torch.cuda.OutOfMemoryError``
    (by type) or the injected ``DeviceOomInjectedFault`` (by its marker)."""
    if not isinstance(exc, Exception):
        return False
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    return "RESOURCE_EXHAUSTED" in str(exc)


def is_enospc(exc: BaseException) -> bool:
    """True for a disk-full/quota failure (``ENOSPC`` or ``EDQUOT``),
    including the injected ``enospc`` kind, which carries the errno."""
    return isinstance(exc, OSError) and exc.errno in (errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC))


def _metrics():
    from photon_tpu_torch.obs import registry

    return registry()


# ---------------------------------------------------------------------------
# Device OOM containment
# ---------------------------------------------------------------------------


def _release_device_memory() -> None:
    gc.collect()
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def oom_retry(attempt: Callable[[], object], *, site: str, evict: Optional[Callable[[int], None]] = None,
              retries: int = 1, counter: str = "device_oom_retries_total", **labels):
    """Run ``attempt``; on a device OOM count it in ``counter{site=...}``,
    call ``evict(attempt_index)``, free the dropped buffers
    (``gc.collect()`` then ``torch.cuda.empty_cache()``) and retry, up to
    ``retries`` times. Non-OOM exceptions and the final OOM propagate
    untouched."""
    for i in range(retries + 1):
        try:
            return attempt()
        except Exception as exc:  # noqa: BLE001 — classified below
            if not is_device_oom(exc) or i >= retries:
                raise
            logger.warning("device OOM at %s (attempt %d/%d): evicting harder and retrying: %s",
                           site, i + 1, retries + 1, exc)
            try:
                _metrics().counter(counter, site=site, **labels).inc()
            except Exception:
                pass
            if evict is not None:
                evict(i)
            _release_device_memory()
    raise AssertionError("unreachable")  # pragma: no cover


# ---------------------------------------------------------------------------
# Disk-full containment
# ---------------------------------------------------------------------------


class DiskBudgetGuard:
    """Shared ENOSPC policy for one writer site: ``check()`` runs the fault
    hook for the site (an ``enospc`` rule raises exactly where a real full
    disk would), ``record(exc)`` logs an ``OSError`` and says whether it was
    a disk-space failure, ``cleanup(*paths)`` removes partial artifacts. The
    policy on failure (drop, fall back, prune and retry) stays with the
    caller."""

    def __init__(self, site: str):
        self.site = site

    def check(self) -> None:
        faults.check(self.site)

    def record(self, exc: BaseException) -> bool:
        full = is_enospc(exc)
        try:
            name = "disk_enospc_total" if full else "disk_write_failures_total"
            _metrics().counter(name, site=self.site).inc()
        except Exception:
            pass
        logger.warning("%s at %s: %s", "disk full" if full else "write failure", self.site, exc)
        return full

    def cleanup(self, *paths: Optional[str]) -> None:
        for p in paths:
            if not p:
                continue
            try:
                os.unlink(p)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Host RSS watchdog
# ---------------------------------------------------------------------------


def _cgroup_mem_limit() -> Optional[int]:
    """Container memory limit, cgroup v2 then v1; None when unlimited."""
    for path in ("/sys/fs/cgroup/memory.max", "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            continue
        if raw == "max":
            continue
        try:
            limit = int(raw)
        except ValueError:
            continue
        # v1 reports ~PTRDIFF_MAX when unlimited.
        if 0 < limit < (1 << 60):
            return limit
    return None


def _read_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource as _resource

        return _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


class RssWatchdog:
    """Samples host RSS against a limit (env override, else the cgroup's)
    on a daemon thread and publishes a pressure level: ``level()`` reads
    it, ``check(site)`` raises :class:`HostMemoryPressureError` at hard
    pressure. The ``rss.sample`` fault site simulates pressure (``"hard"``
    in the fired rule's message → hard, else soft). Without a detectable
    limit the watchdog is inert."""

    def __init__(self, limit_bytes: Optional[int] = None, soft_fraction: Optional[float] = None,
                 hard_fraction: Optional[float] = None, interval_s: float = 0.5):
        if limit_bytes is None:
            env = os.environ.get(RSS_LIMIT_ENV, "").strip()
            limit_bytes = int(env) if env else _cgroup_mem_limit()
        self.limit_bytes = limit_bytes
        self.soft_fraction = float(soft_fraction if soft_fraction is not None
                                   else os.environ.get(RSS_SOFT_ENV, 0.85))
        self.hard_fraction = float(hard_fraction if hard_fraction is not None
                                   else os.environ.get(RSS_HARD_ENV, 0.95))
        self.interval_s = interval_s
        self._level = LEVEL_OK
        self._last_rss = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> int:
        """Take one sample and return the new level."""
        rss = _read_rss_bytes() or 0
        self._last_rss = rss
        level = LEVEL_OK
        if self.limit_bytes:
            frac = rss / self.limit_bytes
            if frac >= self.hard_fraction:
                level = LEVEL_HARD
            elif frac >= self.soft_fraction:
                level = LEVEL_SOFT
        rule = faults.injector().fire("rss.sample")
        if rule is not None and rule.kind == "rss":
            level = LEVEL_HARD if "hard" in rule.message else LEVEL_SOFT
        prev, self._level = self._level, level
        try:
            m = _metrics()
            m.gauge("host_rss_bytes").set(rss)
            m.gauge("host_rss_limit_bytes").set(self.limit_bytes or 0)
            m.gauge("host_rss_pressure_level").set(level)
            if level != prev and level != LEVEL_OK:
                m.counter("rss_pressure_events_total", level=_LEVEL_NAMES[level]).inc()
        except Exception:
            pass
        if level != prev and level != LEVEL_OK:
            logger.warning("host memory pressure %s: rss=%d limit=%s (queue depths tighten; hard pressure "
                           "fails the run cleanly at the next pass boundary)",
                           _LEVEL_NAMES[level], rss, self.limit_bytes)
        return level

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # the watchdog must never kill its host
                logger.exception("rss watchdog sample failed")

    def start(self) -> "RssWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="rss-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def level(self) -> int:
        return self._level

    def check(self, site: str = "") -> None:
        if self._level >= LEVEL_HARD:
            raise HostMemoryPressureError(
                f"host RSS {self._last_rss} of limit {self.limit_bytes} crossed the hard-pressure fraction "
                f"{self.hard_fraction:.2f}" + (f" at {site}" if site else "")
                + "; stopping cleanly before the kernel OOM-killer does it for us. Lower --replay-cache-mb / "
                  f"queue depths, raise the container memory limit, or tune {RSS_SOFT_ENV}/{RSS_HARD_ENV}.")


# ---------------------------------------------------------------------------
# Process-wide watchdog + pressure helpers
# ---------------------------------------------------------------------------

_watchdog: Optional[RssWatchdog] = None
_watchdog_lock = threading.Lock()


def watchdog() -> Optional[RssWatchdog]:
    return _watchdog


def start_watchdog(**kwargs) -> RssWatchdog:
    """Install and start the process-wide watchdog (idempotent)."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is None:
            _watchdog = RssWatchdog(**kwargs).start()
        return _watchdog


def stop_watchdog() -> None:
    global _watchdog
    with _watchdog_lock:
        wd, _watchdog = _watchdog, None
    if wd is not None:
        wd.stop()


def pressure_level() -> int:
    wd = _watchdog
    return wd.level() if wd is not None else LEVEL_OK


def memory_pressure() -> bool:
    """True at soft pressure or worse."""
    return pressure_level() >= LEVEL_SOFT


def tightened_depth(depth: int) -> int:
    """Queue depth under the current pressure: unchanged when OK, 1 under
    any pressure (each queue slot pins a decoded host chunk)."""
    return 1 if (pressure_level() >= LEVEL_SOFT and depth > 1) else depth


def tightened_cap(cap: int) -> int:
    """Admission cap under the current pressure: unchanged when OK, halved
    at soft pressure, quartered (min 1) at hard."""
    level = pressure_level()
    if level >= LEVEL_HARD:
        return max(1, cap // 4)
    if level >= LEVEL_SOFT:
        return max(1, cap // 2)
    return cap


def check_memory(site: str = "") -> None:
    """Raise :class:`HostMemoryPressureError` at hard pressure (training
    loops call this at pass boundaries, beside the shutdown poll)."""
    wd = _watchdog
    if wd is not None:
        wd.check(site)


__all__ = [
    "LEVEL_HARD", "LEVEL_OK", "LEVEL_SOFT", "DeviceMemoryError", "DiskBudgetGuard", "HostMemoryPressureError",
    "ResourceExhaustedError", "RssWatchdog", "check_memory", "is_device_oom", "is_enospc", "memory_pressure",
    "oom_retry", "pressure_level", "start_watchdog", "stop_watchdog", "tightened_cap", "tightened_depth",
    "watchdog",
]
