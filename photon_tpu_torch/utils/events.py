"""Copy of photon_tpu/utils/events.py (framework-free; the port does not import it).

Lifecycle event bus: the reference's ``EventEmitter`` and its event types
(PhotonSetupEvent, TrainingStartEvent, TrainingFinishEvent,
PhotonOptimizationLogEvent). Listeners can be registered by dotted path.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import threading
from typing import Any, Callable, Dict, List

logger = logging.getLogger("photon_tpu_torch")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


def setup_event(**kw) -> Event:
    return Event("PhotonSetupEvent", kw)


def training_start_event(**kw) -> Event:
    return Event("TrainingStartEvent", kw)


def training_finish_event(**kw) -> Event:
    return Event("TrainingFinishEvent", kw)


def optimization_log_event(**kw) -> Event:
    return Event("PhotonOptimizationLogEvent", kw)


Listener = Callable[[Event], None]


class EventEmitter:
    """Thread-safe listener registry + emit."""

    def __init__(self):
        self._listeners: List[Listener] = []
        self._lock = threading.Lock()

    def register(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def register_by_name(self, dotted_path: str) -> None:
        """Register a listener class/function by module path
        ('pkg.module:attr' or 'pkg.module.attr')."""
        if ":" in dotted_path:
            mod, attr = dotted_path.split(":", 1)
        else:
            mod, _, attr = dotted_path.rpartition(".")
        obj = getattr(importlib.import_module(mod), attr)
        listener = obj() if isinstance(obj, type) else obj
        self.register(listener)

    def clear(self) -> None:
        with self._lock:
            self._listeners.clear()

    def emit(self, event: Event) -> None:
        """Deliver to every listener. Each call is isolated: one raising
        listener is logged (with traceback) and the rest still receive the
        event — a misbehaving observer must never abort the run or starve
        later listeners of lifecycle events."""
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            try:
                l(event)
            except Exception:
                logger.exception(
                    "event listener %r failed on %s (delivery continues)",
                    l, event.name,
                )
