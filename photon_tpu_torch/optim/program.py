"""Solvers as device-side state machines: the port's counterpart of the
reference's ``lax.while_loop`` (no file of the reference has this shape).

A ``Program`` keeps its whole loop state in tensors it owns and updates in
place: ``init`` starts a solve from the inputs, ``step`` runs one pass of
the loop body (an iteration, or for margin L-BFGS a part of one),
``running`` is the loop condition as a device bool, ``finish`` writes the
outputs and ``result`` views them as an OptimizeResult. Nothing in ``init``,
``step`` or ``finish`` reads back to the host, allocates outside the
tensor allocator or copies from the host, so the same calls run eagerly (on
the CPU, and on the card outside the solve cache) or inside a captured CUDA
graph (algorithm/solve_cache.py).

A step that must not run (the loop has ended, or a line-search trial is not
needed) runs all the same and keeps its writes only where its predicate
holds (``Commit``, by ``torch.where``), as a vmapped while_loop keeps its
finished lanes: where the predicate holds the state is the new value bit for
bit, elsewhere the old one. (A CUDA graph conditional node would skip the
work instead; the torch of the card, 2.11, has no capture into one.)

``chunk_loop`` is the loop of host reads: a chunk of K steps, then one read
of the flag, until the loop has ended. ``run_chunked`` drives a Program
eagerly through it; the solve cache drives its captured chunks through it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from photon_tpu_torch.optim.common import HOST_READS, OptimizeResult

Tensor = torch.Tensor

# Steps between reads of the loop flag when a program runs eagerly
# (``run_chunked`` from the ``minimize_*`` functions and the eager solves).
EAGER_CHUNK = 4


def lanewise(pred: Tensor, like: Tensor) -> Tensor:
    """``pred`` (one value a lane, shape lanes) shaped to broadcast over
    ``like`` (lanes + the state's own axes)."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


class Commit:
    """Writes of one part of a step: ``set(dst, new)`` keeps ``new`` where
    the part's predicate holds and ``dst`` elsewhere. The predicate is one
    value a lane (shape lanes, () for a single solve) and broadcasts over
    the state's own axes."""

    def __init__(self, pred: Tensor):
        self.pred = pred

    def set(self, dst: Tensor, new: Tensor) -> None:
        dst.copy_(torch.where(lanewise(self.pred, dst), new, dst))

    def update(self, dst: Dict[str, Tensor], new: Dict[str, Tensor]) -> None:
        for k, v in new.items():
            self.set(dst[k], v)


class Program:
    """A solver's loop as in-place steps over tensors it owns (see the module
    docstring). ``max_steps`` bounds the steps (the loop has ended after
    that many, whatever ``running`` says). ``init_passes`` and
    ``step_passes`` are the X passes ``init`` and one ``step`` run, a masked
    step included."""

    max_steps: int
    init_passes: int = 1
    step_passes: int = 2
    # The unit of the result's ``evals`` (common.OptimizeResult).
    eval_unit: str = "objective_evals"
    # The program's L2 weight (and OWL-QN's L1 weight): device scalars the
    # steps read, filled per solve by the solve cache; None where the
    # objective is a black box.
    l2: Optional[Tensor] = None
    l1: Optional[Tensor] = None

    def init(self) -> None:
        raise NotImplementedError

    def step(self) -> None:
        raise NotImplementedError

    def running(self) -> Tensor:
        raise NotImplementedError

    def finish(self) -> None:
        """Write the outputs ``result`` views (after the last step)."""

    def result(self) -> OptimizeResult:
        raise NotImplementedError


def chunk_loop(start: Callable[[], None], chunk: Callable[[], Tensor], k: int, max_steps: int) -> int:
    """Run ``start``, then ``chunk`` (k steps; returns the loop flag) and one
    host read of the flag, until the flag is false or ``max_steps`` steps
    have run (which needs no read): a solve of s steps makes ceil(s / k)
    reads. Returns the steps run, masked ones included."""
    start()
    steps = 0
    while True:
        flag = chunk()
        steps += k
        if steps >= max_steps or not bool(HOST_READS.read(flag)[0]):
            return steps


def run_chunked(prog: Program, k: int) -> int:
    """Run ``prog`` eagerly, ``k`` steps between host reads of the loop flag,
    and write its outputs (``prog.result()``). Returns the steps run. A step
    past the end of the loop is masked, so whole chunks leave the result as
    it is."""

    def chunk() -> Tensor:
        for _ in range(k):
            prog.step()
        return prog.running()

    steps = chunk_loop(prog.init, chunk, k, prog.max_steps)
    prog.finish()
    return steps
