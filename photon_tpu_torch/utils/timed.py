"""Phase timer (the ``Timed`` class of photon_tpu/utils/timed.py, copied
without its trace spans and pipeline statistics)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict

logger = logging.getLogger("photon_tpu_torch")


class Timed:
    """Context-manager timer that logs and records the wall time of a phase
    in the process-global ``records`` (cleared by ``reset``)."""

    records: Dict[str, float] = {}
    _records_lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    @classmethod
    def reset(cls) -> None:
        with cls._records_lock:
            cls.records.clear()

    def __enter__(self) -> "Timed":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.monotonic() - self._t0
        with Timed._records_lock:
            Timed.records[self.name] = self.elapsed
        logger.info("[timed] %s: %.3fs", self.name, self.elapsed)
