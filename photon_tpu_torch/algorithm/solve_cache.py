"""Capture-once solve cache for the GLMix solver hot paths (port of
photon_tpu/algorithm/solve_cache.py).

The reference keeps one jitted executable per static configuration, each a
``lax.while_loop`` that makes no host read between the start of a solve and
its result. Here a key's entry is the solver's device state machine
(optim/program.py) over buffers it reads:
  - on the card, two CUDA graphs captured after one warm-up: ``init`` (the
    start of a solve) and ``chunk`` (K loop steps, then the outputs and the
    loop flag). A solve replays ``init``, then ``chunk`` and one read of the
    flag, until the loop has ended: ceil(steps / K) host reads. A step past
    the end of its loop runs masked (optim/program.py), so K trades reads
    against wasted steps. All entries of a cache share one graph memory
    pool, since they replay in turn on one stream;
  - on the CPU, the same steps run eagerly with the same read pattern.
K1 (fused_value_grad) and K3 (newton_system) are launched while capturing
and run by every replay; ``kernels.LAUNCHES`` counts the launches that ran.

Keys follow the reference: (objective, optimizer spec, solver config,
has-mask, active-set tol, re_kernel); objects keyed by identity are pinned,
so an id is never recycled while its entry lives. A graph also fixes its
inputs' shapes, dtypes and device, so those are in the key too (the
reference's trace records the shape and retraces on a new one, which counts
as a trace here as there). The objective's L2 and L1 weights are in the
key, as in the reference, but not in the graph: the state machines read
them from device scalars (``prog.l2``, OWL-QN's ``prog.l1``), so the keys of
one λ sweep, L2, L1 or elastic net, share one captured program
(``captures`` counts those; ``traces`` counts keys, as the reference does).

The fixed effect's X and label, the same tensors in every pass, are keyed
by identity and read in place (a sparse X by its indices, values and
transpose plan). Everything else a solve reads (offsets,
weights, warm starts, the random-effect blocks, which the active-set repack
rebuilds) is copied into static buffers, one per input name and signature
in a cache, shared by the programs that read such an input (they replay in
turn, each loading its inputs first); a copy is skipped when the source is
the tensor the buffer loaded last, unchanged. A random-effect block's
inputs share one flat buffer per input name and dtype, sized for the
largest block (``reserve_block_inputs``): each program reads a view of its
block's exact shape at the buffer's front, so the buffers cost one block
whatever the number of block geometries, and no solve pads. The
out-of-core store counts them inside its budget (``block_input_bytes``).
A caller's warm start is
copied in, never aliased (the reference's donation), and outputs are
cloned, since the next replay overwrites them. ``release`` drops every
entry with its graphs, buffers and pinned tensors: the GAME estimator and
the λ sweep of cli/train_glm.py release the shared cache when they return.

Every route is a program: margin L-BFGS, TRON, OWL-QN, L-BFGS-B and
gradient-form L-BFGS on the fixed effect (optim/factory.py::fe_program),
and the same plus batched Newton on a block, one lane an entity
(random_effect.py::block_program). A capture or replay that fails raises;
nothing falls back to an eager solve. A rows-sharded fixed effect
(parallel/distributed.py) reduces over the mesh inside its steps: under
NCCL those all-reduces are captured with the rest, under gloo (which cannot
be captured) its entry runs eagerly on the card, by the backend and never
because a capture failed; the route is in ``entry_info`` and counted
(``eager_calls``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
import math
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.ops import kernels
from photon_tpu_torch.optim.common import REASON_DIVERGED
from photon_tpu_torch.optim.program import Program, chunk_loop, run_chunked

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

# Bounded-cache opt-in: entry cap for every SolveCache constructed without an
# explicit ``max_entries`` (default unbounded; a λ sweep is one entry per λ).
MAX_ENTRIES_ENV = "PHOTON_TPU_TORCH_SOLVE_CACHE_MAX_ENTRIES"
# Loop steps per captured chunk (one host read per chunk), read when a
# program is built (``chunk_of``): FE_CHUNK for the fixed effect's margin
# L-BFGS, CHUNK for every other program. Both chosen by sweeps of K on the
# card (PERF.md §6).
FE_CHUNK = 2
CHUNK = 4
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
# Held by a capture from its warm-up to its end. The captures run in the
# default global error mode, where a CUDA call from any other thread
# invalidates them: a thread that works on the card beside the solves (the
# out-of-core store's upload and download stages, algorithm/re_store.py)
# makes its CUDA calls under this lock.
CAPTURE_LOCK = threading.RLock()


@dataclasses.dataclass
class SolveCacheStats:
    """Counters of the cache, reported by chip_smoke.py.

    traces:   keys built (the reference's traces).
    captures: programs built: a CUDA graph capture on the card, an eager
              state machine on the CPU. Keys that differ only in the L2
              weight share one.
    calls:    solver dispatches routed through the cache.
    hits:     dispatches that reused an entry (calls - traces).
    trace_keys: shape/kind descriptor recorded at each trace.
    replays:  CUDA graph replays (init and chunks).
    eager_calls: dispatches on the card that ran eagerly, not as graphs:
              a rows-sharded fixed effect whose reductions run on a backend
              that cannot be captured (gloo).
    copied_bytes: bytes copied into the static input buffers.
    x_passes_run: X passes the programs ran, masked steps and capture
              warm-ups included; a result's ``evals`` counts the passes of
              its iterations only (2 an iteration, as the reference does).
    """

    traces: int = 0
    captures: int = 0
    calls: int = 0
    hits: int = 0
    evictions: int = 0
    trace_keys: List[Tuple] = dataclasses.field(default_factory=list)
    replays: int = 0
    eager_calls: int = 0
    copied_bytes: int = 0
    x_passes_run: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.counts(), trace_keys=[list(k) for k in self.trace_keys])

    def counts(self) -> Dict[str, int]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if f.name != "trace_keys"}

    def since(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The counts added since ``counts`` (an earlier ``counts()``)."""
        return {k: v - counts[k] for k, v in self.counts().items()}


def _scalar(x):
    """Coerce a numeric config field to a hashable Python scalar; arrays and
    other unhashables fall back to identity (pinned by the cache entry)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    try:
        hash(x)
        return x
    except TypeError:
        return ("id", id(x))


def _sig(t: Optional[Tensor]) -> Optional[Tuple]:
    return None if t is None else (tuple(t.shape), str(t.dtype), str(t.device))


def _gate(w: Tensor, w0: Tensor, reasons: Tensor, entity_idx: Tensor, tol: Optional[float]):
    """The reference's in-trace divergence quarantine: rows whose solve went
    non-finite keep their warm start and are flagged DIVERGED. With ``tol``,
    also (active, quarantined): an entity stays active while its
    coefficients moved by more than tol relative to max(1, ‖w0‖); padding
    rows are never active."""
    row_finite = torch.isfinite(w).all(dim=-1)
    w = torch.where(row_finite[:, None], w, w0)
    reasons = torch.where(row_finite, reasons, REASON_DIVERGED).to(torch.int32)
    if tol is None:
        return w, reasons
    delta = torch.linalg.norm((w - w0).float(), dim=-1)
    ref = torch.clamp(torch.linalg.norm(w0.float(), dim=-1), min=1.0)
    valid = entity_idx >= 0
    return w, reasons, (delta > tol * ref) & valid, (reasons == REASON_DIVERGED) & valid


_BLOCK_INPUTS = ("features", "label", "weight", "offsets", "w0", "train_mask", "entity_idx", "feature_mask")


def _block_input_sizes(block, has_mask: bool = False) -> Dict[str, Tuple[int, int]]:
    """(elements, bytes an element) of each input a solve of ``block``
    reads (host numpy or torch blocks): offsets and the warm start in the
    label's type."""
    size = lambda t: t.dtype.itemsize if isinstance(t, np.ndarray) else t.element_size()  # noqa: E731
    E, n, d = block.num_entities, block.n_max, block.dim
    out = dict(features=(E * n * d, size(block.features)), label=(E * n, size(block.label)),
               weight=(E * n, size(block.weight)), offsets=(E * n, size(block.label)), w0=(E * d, size(block.label)),
               train_mask=(E, 1), entity_idx=(E, size(block.entity_idx)))
    if has_mask:
        out["feature_mask"] = (E * d, size(block.label))
    return out


def block_input_bytes(blocks, has_mask: bool = False) -> int:
    """Device bytes of the static buffers the solves of ``blocks`` read: per
    input, its largest block's."""
    most: Dict[str, int] = {}
    for b in blocks:
        for name, (k, item) in _block_input_sizes(b, has_mask).items():
            most[name] = max(most.get(name, 0), k * item)
    return int(sum(most.values()))


class _Slot:
    """A static input buffer: flat storage that programs of a cache reading
    an input of one name (and dtype) share; each reads a view of its input's
    shape at the front, loading its input first (they replay in turn on one
    stream)."""

    def __init__(self, numel: int, dtype: torch.dtype, device):
        self.t = torch.empty(max(int(numel), 1), dtype=dtype, device=device)
        self._src: Optional[Tuple[Any, int]] = None  # (weak ref to the tensor loaded last, its version)

    def view(self, shape) -> Tensor:
        return self.t[:math.prod(shape)].view(tuple(shape))

    def load(self, v: Tensor) -> int:
        """Copy ``v`` in; returns the bytes copied (none when ``v`` is the
        tensor loaded last, unchanged since)."""
        if self._src is not None and self._src[0]() is v and self._src[1] == v._version:
            return 0
        self.view(v.shape).copy_(v)
        self._src = (weakref.ref(v), v._version)
        return v.numel() * v.element_size()


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> Optional[int]:
    """Node count of a kept graph (driver ``cuGraphGetNodes``), or None
    where the driver library is not found."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    count = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    return int(count.value) if err == 0 else None


def chunk_of(prog: Program, fixed_effect: bool) -> int:
    """K of a program (the module's constants, read now)."""
    from photon_tpu_torch.optim.margin_lbfgs import MarginLBFGS

    return FE_CHUNK if fixed_effect and isinstance(prog, MarginLBFGS) else CHUNK


class _Started(Program):
    """``prog`` whose ``init`` first runs ``start`` (which writes the
    program's warm start from the entry's buffers)."""

    def __init__(self, prog: Program, start: Callable[[], Any]):
        self.prog, self.start, self.max_steps = prog, start, prog.max_steps
        self.init_passes, self.step_passes = prog.init_passes, prog.step_passes
        self.l2, self.l1 = prog.l2, prog.l1

    def init(self) -> None:
        self.start()
        self.prog.init()

    def step(self) -> None:
        self.prog.step()

    def running(self) -> Tensor:
        return self.prog.running()

    def finish(self) -> None:
        self.prog.finish()

    def result(self):
        return self.prog.result()


class _Entry:
    """One program: a Program over static input buffers (``slots``), with
    ``post`` (the outputs from the program's result, capturable), run by
    graph replays on the card and eagerly on the CPU. ``prog.l2`` (and
    ``prog.l1`` where the program has one) are its weights, filled per
    solve from ``weights`` = (L2, L1)."""

    def __init__(self, cache: "SolveCache", prog: Program, slots: Dict[str, _Slot], post: Callable[[], tuple],
                 chunk: int, inputs: Dict[str, Tensor], weights: Tuple[float, float], capturable: bool = True):
        # The cache by a weak reference (it holds its entries; a solver handle
        # that holds an entry holds the cache too).
        self._cache = weakref.ref(cache)
        self.prog, self.slots, self.post = prog, slots, post
        self.chunk = max(1, min(chunk, prog.max_steps))
        device = self.device = inputs["w0"].device
        self._load(inputs, weights)  # the warm-up solves the first call's problem
        self.captured = device.type == "cuda" and capturable
        self.flag = torch.zeros((), dtype=torch.bool, device=device)
        self.route = ("captured" if self.captured else "eager" if device.type != "cuda"
                      else "eager: its collectives cannot be captured")
        self.info: Dict[str, Any] = dict(chunk=self.chunk, route=self.route)
        if device.type == "cuda" and not capturable:
            logger.info("solve on %s runs eagerly: its collectives cannot be captured", device)
        if self.captured:
            self._capture()

    def _load(self, inputs: Dict[str, Tensor], weights: Tuple[Optional[float], Optional[float]]) -> None:
        for t, v in zip((self.prog.l2, self.prog.l1), weights):
            if t is not None and v is not None:
                t.fill_(v)
        self._cache().stats.copied_bytes += sum(self.slots[k].load(v) for k, v in inputs.items())

    def _chunk_body(self) -> tuple:
        for _ in range(self.chunk):
            self.prog.step()
        self.prog.finish()
        out = self.post()
        self.flag.copy_(self.prog.running())
        return out

    def _capture(self) -> None:
        with CAPTURE_LOCK:
            self._capture_locked()

    def _capture_locked(self) -> None:
        t0 = time.perf_counter()
        cache = self._cache()
        pool, side = cache._pool(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up: plans, occupancy, library handles
            self.prog.init()
            self._chunk_body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        cache.stats.x_passes_run += self.prog.init_passes + self.chunk * self.prog.step_passes
        # The capture launches nothing: its counts go, and every replay adds
        # the launches it runs.
        snap = kernels.snapshot()
        self.g_init = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.g_init, pool=pool):
            self.prog.init()
        self.init_launches = kernels.counted_since(snap)
        kernels.restore(snap)
        self.g_chunk = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.g_chunk, pool=pool):
            self.out = self._chunk_body()
        self.chunk_launches = kernels.counted_since(snap)
        kernels.restore(snap)
        self.g_chunk.instantiate()
        self.info.update(capture_s=time.perf_counter() - t0, chunk_nodes=_graph_nodes(self.g_chunk))

    def _replay_init(self) -> None:
        self.g_init.replay()
        kernels.add(self.init_launches)
        self._cache().stats.replays += 1

    def _replay_chunk(self) -> Tensor:
        self.g_chunk.replay()
        kernels.add(self.chunk_launches)
        self._cache().stats.replays += 1
        return self.flag

    def __call__(self, inputs: Dict[str, Tensor], weights: Tuple[float, float]) -> tuple:
        self._load(inputs, weights)
        if self.captured:
            steps = chunk_loop(self._replay_init, self._replay_chunk, self.chunk, self.prog.max_steps)
            out = self.out
        else:
            steps = run_chunked(self.prog, self.chunk)
            out = self.post()
            if self.device.type == "cuda":
                self._cache().stats.eager_calls += 1
        self._cache().stats.x_passes_run += self.prog.init_passes + steps * self.prog.step_passes
        return tuple(t.clone() for t in out)


class SolveCache:
    """Entry cache for block (random-effect) and fixed-effect solves.

    One instance may be shared across coordinates: the module-level
    :func:`default_cache` serves every coordinate not given one. The
    reference's ``donate`` flag has no counterpart: a warm start is always
    copied into a buffer of the cache.
    """

    def __init__(self, max_entries: Optional[int] = None):
        if max_entries is None:
            env = os.environ.get(MAX_ENTRIES_ENV, "").strip()
            max_entries = int(env) if env else None
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.stats = SolveCacheStats()
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._pins: Dict[Tuple, Tuple] = {}  # keep id()-keyed objects alive
        # Programs and buffers live while an entry (or a solver handle) uses them.
        self._programs: "weakref.WeakValueDictionary[Tuple, _Entry]" = weakref.WeakValueDictionary()
        self._slots: "weakref.WeakValueDictionary[Tuple, _Slot]" = weakref.WeakValueDictionary()
        self._reserved: List[_Slot] = []  # buffers sized ahead of their first program
        self._pools: Dict[Any, Any] = {}
        self._built: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # ---- static keys -----------------------------------------------------

    @staticmethod
    def _norm_key(norm) -> Optional[Tuple]:
        if norm is None:
            return None
        return (
            bool(norm.is_identity),
            None if norm.factors is None else ("id", id(norm.factors)),
            None if norm.shifts is None else ("id", id(norm.shifts)),
            _scalar(getattr(norm, "intercept_index", None)),
        )

    @classmethod
    def _objective_key(cls, objective) -> Tuple:
        """The objective's key without its L2 and L1 weights (inputs of the
        program), but with whether it has each."""
        return (
            objective.loss,
            objective.l2_weight != 0.0,
            objective.l1_weight != 0.0,
            _scalar(objective.intercept_index),
            bool(objective.use_fused),
            cls._norm_key(objective.normalization),
        )

    @staticmethod
    def _spec_key(spec) -> Tuple:
        return (
            spec.optimizer,
            _scalar(spec.max_iter),
            _scalar(spec.tol),
            _scalar(spec.memory),
            _scalar(spec.max_cg_iter),
            None if spec.box is None else (("id", id(spec.box[0])), ("id", id(spec.box[1]))),
            bool(spec.track_history),
        )

    @staticmethod
    def _config_key(config) -> Tuple:
        return (
            _scalar(config.max_iter),
            _scalar(config.tol),
            _scalar(config.memory),
            _scalar(config.max_line_search_evals),
            bool(config.track_history),
        )

    # ---- entries ---------------------------------------------------------

    def _pool(self, device: torch.device):
        """The graph memory pool of ``device`` and the stream of the capture
        warm-ups (one a device for the process: each new stream gets
        library workspaces of its own, kept for the life of the process)."""
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
        if device not in _WARMUP_STREAMS:
            _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        return self._pools[device], _WARMUP_STREAMS[device]

    def _slots_for(self, inputs: Dict[str, Tensor], shared: bool = False) -> Dict[str, _Slot]:
        """The static buffers of ``inputs``: one per name and signature, or
        with ``shared`` (a block's inputs) one per name and dtype, grown to
        the largest input it has held (``reserve_block_inputs`` sizes it
        for a coordinate's largest block up front)."""
        out = {}
        for name, v in inputs.items():
            k = ("block", name, str(v.dtype), str(v.device)) if shared else (name, _sig(v))
            with self._lock:
                slot = self._slots.get(k)
                if slot is None or slot.t.numel() < v.numel():
                    slot = self._slots[k] = _Slot(v.numel(), v.dtype, v.device)
            out[name] = slot
        return out

    def reserve_block_inputs(self, blocks, device, has_mask: bool = False) -> None:
        """Size the shared block buffers for the largest of ``blocks`` (on
        ``device``), so that no later block grows them: a grown buffer is a
        new one, while the programs built on the old one keep it."""
        if not blocks:
            return
        most: Dict[str, int] = {}
        for b in blocks:
            for name, (k, _item) in _block_input_sizes(b, has_mask).items():
                most[name] = max(most.get(name, 0), k)

        def as_torch(x) -> torch.dtype:
            return x.dtype if isinstance(x, torch.Tensor) else torch.from_numpy(np.empty(0, x.dtype)).dtype

        b = blocks[0]
        data = as_torch(b.label)
        dtypes = dict(features=as_torch(b.features), label=data, weight=as_torch(b.weight), offsets=data, w0=data,
                      train_mask=torch.bool, entity_idx=as_torch(b.entity_idx), feature_mask=data)
        device = torch.device(device)
        with self._lock:
            for name, k in most.items():
                key = ("block", name, str(dtypes[name]), str(device))
                slot = self._slots.get(key)
                if slot is None or slot.t.numel() < k:
                    slot = self._slots[key] = _Slot(k, dtypes[name], device)
                    self._reserved.append(slot)

    def _get_or_build(self, pkey: Tuple, weights: Tuple[float, float], build: Callable[[], Any], pins: Tuple,
                      trace_key: Tuple):
        """The entry of (``pkey``, ``weights``), the reference's key: if
        absent, the live program of ``pkey``, else one built (``build``);
        counted as a trace, and a program built as a capture. The least
        recently used entries past ``max_entries`` are evicted."""
        key = pkey + tuple(_scalar(w) for w in weights)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)  # LRU touch
                return entry, False
            entry = self._programs.get(pkey)
        if entry is None:
            entry = build()
            with self._lock:
                entry.info["key"] = trace_key
                self._built.append(entry.info)
                self._programs[pkey] = entry
                self.stats.captures += 1
        with self._lock:
            self.stats.traces += 1
            self.stats.trace_keys.append(trace_key)
            self._entries[key] = entry
            self._pins[key] = pins
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    old_key, _old = self._entries.popitem(last=False)
                    self._pins.pop(old_key, None)
                    self.stats.evictions += 1
                    registry().counter("solve_cache_evictions_total").inc()
        return entry, True

    def _dispatch(self, handle_entries: Dict, pkey: Tuple, weights: Tuple[float, float], build, pins, trace_key):
        """An entry for one dispatch of a handle: the one the handle used
        for this key before (kept through eviction, as a jitted handle keeps
        its executable), else the cache's; counts the call and the hit."""
        entry = handle_entries.get(pkey)
        built = False
        if entry is None:
            entry, built = self._get_or_build(pkey, weights, build, pins, trace_key)
            handle_entries[pkey] = entry
        self.stats.calls += 1
        if not built:
            self.stats.hits += 1
        return entry

    def block_solver(self, objective, spec, config, has_mask: bool, convergence_tol: Optional[float] = None,
                     re_kernel: str = "torch") -> Callable:
        """``solve(block, offsets, w0[, feature_mask])`` → (w, iterations,
        reasons, X passes), plus (active, quarantined) with
        ``convergence_tol`` (the active-set gate of
        algorithm/random_effect.py): an entity stays active while its
        coefficients moved by more than tol relative to max(1, ‖w0‖);
        padding rows are never active. Every dispatch carries the divergence
        quarantine. ``re_kernel`` is resolved
        (ops.fused_newton.resolve_re_kernel). Every route is a program
        (random_effect.py::block_program)."""
        from photon_tpu_torch.algorithm.random_effect import _block_end, _block_start, block_program

        has_mask = bool(has_mask)
        tol = None if convergence_tol is None else float(convergence_tol)
        re_kernel = str(re_kernel)
        base = ("block", self._objective_key(objective), self._spec_key(spec), self._config_key(config),
                has_mask, tol, re_kernel)
        weights = (float(objective.l2_weight), float(objective.l1_weight))
        entries: Dict = {}

        def solve(block, offsets: Tensor, w0: Tensor, feature_mask: Optional[Tensor] = None):
            if (feature_mask is not None) != has_mask:
                raise ValueError(f"block_solver(has_mask={has_mask}) got feature_mask={feature_mask is not None}")
            shapes = tuple(_sig(t) for t in (block.features, block.label, offsets, w0, feature_mask))
            key = base + shapes
            trace_key = ("block",) + tuple(block.features.shape) + (has_mask,)
            inputs = dict(features=block.features, label=block.label, weight=block.weight, offsets=offsets, w0=w0,
                          train_mask=block.train_mask, entity_idx=block.entity_idx)
            if has_mask:
                inputs["feature_mask"] = feature_mask

            def build():
                slots = self._slots_for(inputs, shared=True)
                t = {k: slot.view(inputs[k].shape) for k, slot in slots.items()}
                blk = dataclasses.replace(block, **{k: t[k] for k in ("features", "label", "weight", "train_mask",
                                                                      "entity_idx")})
                mask = t.get("feature_mask")
                w_start = torch.empty_like(t["w0"])
                prog = _Started(block_program(objective, spec, config, blk, t["offsets"], w_start, mask, re_kernel),
                                lambda: w_start.copy_(_block_start(t["w0"], objective)))

                def post():
                    res = prog.result()
                    w = _block_end(res.w, t["w0"], blk, objective, mask)
                    w, reasons, *masks = _gate(w, t["w0"], res.reason_code, t["entity_idx"], tol)
                    return (w, res.iterations, reasons, res.x_passes, *masks)

                return _Entry(self, prog, slots, post, chunk_of(prog.prog, False), inputs, weights)

            entry = self._dispatch(entries, key, weights, build, (objective, spec, config), trace_key)
            return entry(inputs, weights)

        return solve

    def fe_solver(self, objective, spec) -> Callable:
        """Fixed-effect solve ``(w0, labeled_batch) -> OptimizeResult`` for
        one (objective, spec), with the reference's divergence backstop: a
        non-finite final point falls back to w0 with reason DIVERGED. Every
        route is a program (optim/factory.py::fe_program)."""
        from photon_tpu_torch.optim.common import OptimizeResult
        from photon_tpu_torch.optim.factory import fe_program

        base = ("fe", self._objective_key(objective), self._spec_key(spec))
        config = spec.config()
        weights = (float(objective.l2_weight), float(objective.l1_weight))
        entries: Dict = {}

        def solve(w0: Tensor, lb) -> OptimizeResult:
            X, label, rows = lb.features, lb.label, lb.rows
            # X's tensors (a sparse X's indices, values and plan) and the
            # label are read in place: keyed by identity and signature; a
            # rows-sharded batch also by its layout and mesh.
            xs = X.tensors() if isinstance(X, SparseFeatures) else (X,)
            key = base + tuple(("id", id(t)) for t in xs + (label,)) + tuple(
                _sig(t) for t in xs + (label, lb.weight, lb.offset, w0)) + (
                None if rows is None else (rows, ("id", id(rows.mesh))),)
            inputs = dict(w0=w0, weight=lb.weight, offset=lb.offset)

            def build():
                slots = self._slots_for(inputs)
                t = {k: slot.view(inputs[k].shape) for k, slot in slots.items()}
                prog = fe_program(objective, spec, t["w0"], LabeledBatch(label, X, t["offset"], t["weight"], rows),
                                  config)

                def post():
                    res = prog.result()
                    ok = torch.isfinite(res.w).all()
                    return (torch.where(ok, res.w, t["w0"]), res.value, res.grad_norm, res.iterations,
                            torch.where(ok, res.reason_code, REASON_DIVERGED).to(torch.int32), res.loss_history,
                            res.grad_norm_history, res.evals)

                # A rows-sharded solve's all-reduces are in its steps: NCCL's
                # are captured with them, gloo's cannot be (the solve runs
                # eagerly, its route logged and counted).
                entry = _Entry(self, prog, slots, post, chunk_of(prog, True), inputs, weights,
                               capturable=rows is None or rows.capturable)
                entry.eval_unit = prog.eval_unit
                return entry

            entry = self._dispatch(entries, key, weights, build, (objective, spec, X, label, rows) + xs,
                                   ("fe", int(w0.shape[0])))
            return OptimizeResult(*entry(inputs, weights), eval_unit=entry.eval_unit)

        return solve

    def lane_solver(self, name: Tuple, make: Callable[[Dict[str, Tensor]], Tuple[Program, Callable, Callable]],
                    fixed_effect: bool, pins: Tuple = ()) -> Callable:
        """``solve(inputs)`` → the outputs of a program over candidate lanes
        (the q candidates of a tuning round, estimators/batched_tuning.py).
        ``make(t)`` builds (program, start, post) over ``t``, the static
        buffers of ``inputs`` (a dict of tensors, ``w0`` among them), which
        every solve copies in: ``start`` runs first in the program's ``init``
        and ``post`` gives the outputs. The lanes' L2 weights are such an
        input, which ``start`` loads, so one captured program serves every round
        of the same shapes. Keyed by ``name`` (what ``make`` closes over) and
        the inputs' signatures; ``pins`` keep what ``name`` names by id."""
        entries: Dict = {}
        none = (None, None)

        def solve(inputs: Dict[str, Tensor]) -> tuple:
            key = ("lanes",) + tuple(name) + tuple((k, _sig(v)) for k, v in inputs.items())

            def build():
                slots = self._slots_for(inputs)
                prog, start, post = make({k: slot.view(inputs[k].shape) for k, slot in slots.items()})
                return _Entry(self, _Started(prog, start), slots, post, chunk_of(prog, fixed_effect), inputs, none)

            entry = self._dispatch(entries, key, none, build, pins, ("lanes", str(name[0])) + tuple(inputs["w0"].shape))
            return entry(inputs, none)

        return solve

    # ---- introspection ---------------------------------------------------

    @contextlib.contextmanager
    def expect_cached(self, what: str = "dispatch"):
        """Assert no NEW entry is built (traced) inside the context: the
        active-set path packs its dispatches onto block shapes the first full
        pass already captured, so a build here is a bug."""
        traces0, nkeys = self.stats.traces, len(self.stats.trace_keys)
        yield
        if self.stats.traces != traces0:
            raise AssertionError(
                f"{what}: expected a cache hit but built {self.stats.traces - traces0} new entr(y/ies): "
                f"{self.stats.trace_keys[nkeys:]}")

    def trace_mark(self) -> int:
        """Snapshot of the cumulative build count, for ``traces_since``."""
        return int(self.stats.traces)

    def traces_since(self, mark: int) -> int:
        """New entries built since :meth:`trace_mark`."""
        return int(self.stats.traces) - int(mark)

    @property
    def num_entries(self) -> int:
        return len(self._entries)

    def static_bytes(self) -> int:
        """Device bytes of the live static input buffers (one a name and
        signature; a block's, one a name and dtype)."""
        with self._lock:
            slots = list(self._slots.values())
        return sum(s.t.numel() * s.t.element_size() for s in slots)

    def entry_info(self) -> List[Dict[str, Any]]:
        """Per program built, in build order: its K and, on the card, its
        capture seconds and the node count of its chunk graph."""
        return [dict(i) for i in self._built]

    def release(self) -> None:
        """Drop every entry, keeping the counters: the graphs, buffers and
        pinned tensors go once no solver handle holds them (the end of a fit
        or a sweep)."""
        with self._lock:
            self._entries.clear()
            self._pins.clear()
            self._pools.clear()
            self._reserved.clear()

    def clear(self) -> None:
        self.release()
        with self._lock:
            self._built.clear()
            self.stats = SolveCacheStats()

    def reset_stats(self) -> None:
        """Zero the counters, keeping the entries (in place: handles hold
        this object)."""
        with self._lock:
            s = self.stats
            for k in s.counts():
                setattr(s, k, 0)
            s.trace_keys.clear()


_default_cache = SolveCache()


def default_cache() -> SolveCache:
    """The process-wide cache shared by coordinates without an explicit one."""
    return _default_cache


def reset_default_cache(max_entries: Optional[int] = None) -> SolveCache:
    """Replace the shared cache (tests, A-B sections of a run)."""
    global _default_cache
    _default_cache = SolveCache(max_entries=max_entries)
    return _default_cache


def cache_stats() -> Dict[str, Any]:
    """Shared-cache counters."""
    return _default_cache.stats.as_dict()
