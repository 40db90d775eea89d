"""Ranks of a torch.distributed job: the counterpart of
photon_tpu/utils/virtual_devices.py.

The reference exercises its distributed code on one process with n virtual
XLA CPU devices under one controller. The port is SPMD: one process per
rank, each owning one device, joined by a ``torch.distributed`` process
group. This module starts and joins such processes:

- ``run_ranks(fn, n, backend, device, init_file)`` spawns ``n`` processes
  (``torch.multiprocessing``, start method ``spawn``) that meet through a
  ``file://`` rendezvous (no TCP port, so concurrent jobs on one host never
  collide) and runs ``fn(rank, world, device, *args)`` in each; it returns
  the ranks' results in rank order and raises ``RankFailed`` when any rank
  fails or the job outlives its deadline, after stopping every rank;
- ``init_from_env()`` joins the group a launcher such as ``torchrun``
  describes in the environment (RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR, MASTER_PORT).

The default is NCCL with rank r on ``cuda:<local rank>``. The CPU takes
``device="cpu", backend="gloo"``; ranks that share one card take
``device="cuda:0", backend="gloo"``. NCCL refuses two ranks on one card, so
asking for that raises here; nothing switches backend or device on its own.
Every group gets a finite timeout: a rank that dies fails its peers'
collectives within it instead of hanging them. The function a rank runs
must live in a module that a fresh interpreter can import (``spawn``
imports it): keep such modules free of anything heavy at import.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0
BACKENDS = ("nccl", "gloo")

_JOINED_DEVICE: Optional[torch.device] = None  # set by init_rank


class RankFailed(RuntimeError):
    """A rank of ``run_ranks`` raised, died or outlived the deadline."""


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``None`` or "cuda" is ``cuda:<local_rank>``; a
    device with an index ("cuda:0", "cpu") is taken as given, whatever the
    rank."""
    if device is None or str(device) == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device(device)


def _check(backend: str, world: int, devices: Sequence[torch.device]) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    cuda = [d for d in devices if d.type == "cuda"]
    if cuda and not torch.cuda.is_available():
        raise ValueError(f"ranks on {cuda[0]} need a CUDA device, and this process sees none; pass device='cpu' "
                         "with backend='gloo' to run on the CPU")
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError("backend='nccl' runs on CUDA devices only; the CPU takes backend='gloo'")
    count = torch.cuda.device_count()
    idx = [d.index if d.index is not None else 0 for d in devices]
    if len(set(idx)) < len(idx) or max(idx) >= count:
        raise ValueError(f"NCCL needs one card a rank: {world} rank(s) on {count} visible card(s) would share one "
                         f"({sorted(idx)}); NCCL refuses that. Ranks that share a card take backend='gloo'")


def joined_device() -> Optional[torch.device]:
    """The device this process joined its group on (``init_rank``), or
    None."""
    return _JOINED_DEVICE if dist.is_available() and dist.is_initialized() else None


def init_rank(rank: int, world: int, backend: str = "nccl", device=None, init_method: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S, local_rank: Optional[int] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return this
    rank's device (set as the current CUDA device on the card)."""
    local = rank if local_rank is None else local_rank
    dev = rank_device(device, local)
    _check(backend, world, [dev])
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL needs one card a rank: world {world} on {torch.cuda.device_count()} visible card(s)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    global _JOINED_DEVICE
    _JOINED_DEVICE = dev
    return dev


def init_from_env(backend: str = "nccl", device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the group a launcher such as ``torchrun`` set up (``env://``):
    one NCCL rank a card by default."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    return init_rank(rank, world, backend, device, "env://", timeout_s, local_rank=local)


def _rank_main(rank: int, world: int, fn: Callable, args: tuple, backend: str, device, init_method: str,
               timeout_s: float, threads: Optional[int], out_dir: str) -> None:
    """A spawned rank: join, run ``fn``, leave; the result (or the error's
    traceback) goes to ``<out_dir>/rank<r>.pkl``."""
    if threads is not None:
        torch.set_num_threads(threads)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dev = init_rank(rank, world, backend, device, init_method, timeout_s)
        try:
            out = ("ok", fn(rank, world, dev, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise SystemExit(1)
    with open(path, "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn: Callable, n: int, backend: str = "nccl", device=None, init_file: Optional[str] = None,
              args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s: Optional[float] = None,
              threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``n`` spawned ranks and
    return their results in rank order.

    ``init_file``: the rendezvous file (absent; default a fresh name in a
    temporary directory). ``timeout_s``: the process group's timeout.
    ``deadline_s``: the whole job's (default: ``timeout_s`` plus a margin).
    ``threads``: each rank's ``torch.set_num_threads``. ``args`` and the
    results are pickled (CUDA tensors in ``args`` are shared with the ranks,
    not copied). Raises ``RankFailed``, with each failed rank's traceback,
    when a rank raises or exits non-zero or the deadline passes; the other
    ranks are stopped first."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    _check(backend, n, [rank_device(device, r) for r in range(n)])
    deadline = time.monotonic() + (deadline_s if deadline_s is not None else timeout_s + 60.0)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="photon-ranks-") as out_dir:
        init_file = init_file or os.path.join(out_dir, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, n, fn, tuple(args), backend, device, f"file://{init_file}",
                                                      timeout_s, threads, out_dir), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        failed = expired = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    failed = True
                    break
                if time.monotonic() > deadline:
                    expired = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
            else:
                status, value = "error", f"rank {r} exited with code {p.exitcode} and left no result"
            if status != "ok":
                errors.append(f"--- rank {r} ---\n{value}")
            results.append(value)
        if expired:
            errors.insert(0, f"the job outlived its deadline; ranks stopped")
        if errors or failed:
            raise RankFailed(f"{len(errors)} of {n} rank(s) failed ({backend}, {device}):\n" + "\n".join(errors))
        return results
