"""Copy of photon_tpu/utils/shutdown.py (framework-free; the port does not import it).

Cooperative SIGTERM/SIGINT handling for the training drivers. One signal
requests a graceful stop: work loops poll :func:`shutdown_requested` at safe
boundaries (a coordinate-descent pass boundary, a λ-sweep step), persist a
final checkpoint, and raise :class:`GracefulShutdown`; the driver catches it
and exits ``128 + signum``. A SECOND signal keeps its default (fatal)
behaviour: the handler restores the previous handlers on first receipt.
"""

from __future__ import annotations

import contextlib
import logging
import os as _os
import signal as _signal
import threading
import time as _time
from typing import Dict, Iterable, Optional


class GracefulShutdown(Exception):
    """A SIGTERM/SIGINT was received and the cooperative shutdown point was
    reached: the work loop stopped at a safe boundary (checkpoint written).
    Drivers catch this, finalize telemetry, and exit 128+signum."""

    def __init__(self, signum: int):
        super().__init__(f"terminated by signal {signum}")
        self.signum = signum


_TERM_STATE = {"signum": None}


def shutdown_requested() -> Optional[int]:
    """Signum of a received SIGTERM/SIGINT inside :func:`handle_termination`,
    else None."""
    return _TERM_STATE["signum"]


def terminate_children(
    pids: Iterable[int],
    timeout_s: float = 10.0,
    poll_s: float = 0.05,
) -> Dict[int, int]:
    """Graceful multi-process drain: SIGTERM every child, wait up to
    ``timeout_s`` for ALL to exit (polling ``waitpid(WNOHANG)``), then
    SIGKILL stragglers. Returns {pid: exit code} (negative = killed by
    signal, per ``waitstatus_to_exitcode``). Safe against children that
    already died — ESRCH/ECHILD are treated as 'gone'."""
    log = logging.getLogger("photon_tpu_torch")
    pending = {}
    exits: Dict[int, int] = {}
    for pid in pids:
        try:
            _os.kill(pid, _signal.SIGTERM)
            pending[pid] = True
        except ProcessLookupError:
            pending[pid] = True  # already dead; still needs reaping
    deadline = _time.monotonic() + timeout_s
    while pending:
        for pid in list(pending):
            try:
                done, status = _os.waitpid(pid, _os.WNOHANG)
            except ChildProcessError:
                exits[pid] = 0  # reaped elsewhere (or not our child)
                del pending[pid]
                continue
            if done == pid:
                exits[pid] = _os.waitstatus_to_exitcode(status)
                del pending[pid]
        if not pending:
            break
        if _time.monotonic() >= deadline:
            for pid in list(pending):
                log.warning(
                    "child pid %d ignored SIGTERM for %.1fs; escalating "
                    "to SIGKILL", pid, timeout_s,
                )
                try:
                    _os.kill(pid, _signal.SIGKILL)
                except ProcessLookupError:
                    pass
                try:
                    _, status = _os.waitpid(pid, 0)
                    exits[pid] = _os.waitstatus_to_exitcode(status)
                except ChildProcessError:
                    exits[pid] = 0
                del pending[pid]
            break
        _time.sleep(poll_s)
    return exits


@contextlib.contextmanager
def handle_termination():
    """Convert the FIRST SIGTERM/SIGINT into a cooperative shutdown request
    (see :func:`shutdown_requested`); previous handlers are restored
    immediately, so a second signal is fatal. No-op off the main thread
    (signal handlers are main-thread-only in CPython)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    _TERM_STATE["signum"] = None
    prev = {}

    def _restore():
        for sig, h in prev.items():
            try:
                _signal.signal(sig, h)
            except (ValueError, OSError):
                pass

    def _on_signal(signum, frame):
        _TERM_STATE["signum"] = signum
        logging.getLogger("photon_tpu_torch").warning(
            "received signal %d: finishing the current step, writing a "
            "final checkpoint, then exiting (send again to kill now)",
            signum,
        )
        _restore()  # second signal falls through to the default handler

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        prev[sig] = _signal.signal(sig, _on_signal)
    try:
        yield
    finally:
        _restore()
        _TERM_STATE["signum"] = None
