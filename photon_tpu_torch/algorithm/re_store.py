"""Out-of-core random-effect training store: host master, device working set
(port of photon_tpu/algorithm/re_store.py).

A coordinate with a byte budget keeps its entity blocks in a host master
(numpy arrays, optionally memory-mapped read-only from ``.npy`` files under
``spill_dir``), and only a byte-budgeted working set of blocks lives on the
device, under the shared residency core (data/residency.py
``ByteBudgetLru``). The active set is the residency policy: blocks whose
entities all converged are retired at the pass boundary.

Traffic rides the ingest pipeline's machinery (io/pipeline.py): the upload
(h2d) stage runs on a ``_run_staged`` thread ahead of the dispatch loop, the
download (d2h) stage on a ``StageWorker`` behind it, both with bounded
queues, so device residency is capped by budget + queue depth.

On the card an upload copies a block's fields (and its warm start) from the
host master into a pinned staging buffer (a memory-mapped array is copied,
never wrapped: ``torch.from_numpy`` refuses arrays that are not writable),
then to the device with ``non_blocking`` copies on a copy stream of the
store's own, and records an event; a staging buffer is reused only after its
last copy's event has completed. The consumer's stream waits on that event,
and every device tensor is ``record_stream``-ed onto it, before the block is
handed over (``handover``, the pattern of io/pipeline.py's h2d stage). A
download waits on the event recorded after its solve, on a stream of its
own, and reads through ``HOST_READS``. The solve cache captures CUDA graphs
in the default global mode, where a CUDA call from another thread during a
capture invalidates it: every CUDA call of the stage threads (allocation,
copies, events, the release of device buffers) is made under
``solve_cache.CAPTURE_LOCK``, which a capture holds from its warm-up to its
end. On the CPU an upload is a copy into a CPU tensor.

Invariants (the reference's):

* **No capture across evictions** — a re-uploaded block has the shapes and
  dtypes of its first upload, so the solve cache hits its entry.
* **Deterministic eviction sequence** — one upload thread walks the dispatch
  plan in order and releases happen in dispatch order, and an admission
  evicts what it would evict once every earlier key were released
  (``_settled_victims``), so the ``eviction_log`` does not depend on how
  far the downloads have got.
* **Budget honesty** — a block's cost counts its data arrays plus the warm
  start and result coefficients that coexist with it in flight, and the
  solve cache's static buffers count too: one flat buffer per input, sized
  for the coordinate's largest block (``solve_cache.block_input_bytes``),
  held for the whole fit, so the blocks are admitted against the budget
  less those bytes. Resident blocks plus the buffers stay at or under the
  effective budget, floored (with a warning) at the largest block plus the
  buffers. The graph pool lies outside the budget.

The reference's metrics registry is not ported: every number it published
is in ``stats()``.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.algorithm.solve_cache import CAPTURE_LOCK, block_input_bytes
from photon_tpu_torch.data.random_effect import EntityBlock
from photon_tpu_torch.data.residency import ByteBudgetLru
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.optim.common import HOST_READS
from photon_tpu_torch.utils import faults, resources

logger = logging.getLogger(__name__)

_SPILL_GUARD = resources.DiskBudgetGuard("re_store.spill")

_BLOCK_FIELDS = (
    "entity_idx",
    "features",
    "label",
    "weight",
    "sample_index",
    "train_mask",
)

# Staging offsets are aligned so that a typed view of the pinned bytes is
# legal for every dtype.
_ALIGN = 64


def spill_partition_tag(member) -> str:
    """Stable short tag naming a ring partition's spill directory. Ints and
    ``name:k`` members use the integer (``updater:3`` → ``3``); any other
    member id gets a short blake2b hex, a filesystem-safe, process-stable
    name."""
    if isinstance(member, int):
        return str(member)
    m = str(member)
    tail = m.rsplit(":", 1)[-1]
    if tail.isdigit():
        return tail
    return hashlib.blake2b(m.encode("utf-8"), digest_size=4).hexdigest()


def partition_spill_dir(spill_root: str, member) -> str:
    """Per-ring-partition spill directory ``<spill_root>/host-<k>/``: a
    partition handed to another owner on the same filesystem is adopted by
    ``os.replace`` of its files, never by re-streaming rows. Placement is a
    locality hint only; ownership is re-derived from the ring."""
    path = os.path.join(spill_root, f"host-{spill_partition_tag(member)}")
    os.makedirs(path, exist_ok=True)
    return path


def rebalance_spill_layout(spill_root: str, before, after) -> Dict[str, Dict]:
    """Move departed ring members' spill partitions to their successors by
    file rename.

    ``before``/``after`` are rings (anything with ``members`` and
    ``owner``). For each member present before but not after, its
    ``host-<k>/`` files are adopted by the member owning the departed id's
    hash on the AFTER ring. Files move with ``os.replace``; a name collision
    in the successor's directory keeps both by prefixing the adopted file
    with ``from-<k>__``. Returns ``{member: {"successor": str, "moved":
    int}}``. Some adopted rows may be foreign to their new directory: that
    is safe, since placement is a locality hint (``partition_spill_dir``)."""
    out: Dict[str, Dict] = {}
    survivors = set(after.members)
    for member in before.members:
        if member in survivors:
            continue
        src = os.path.join(spill_root, f"host-{spill_partition_tag(member)}")
        if not os.path.isdir(src):
            continue
        successor = after.owner(str(member))
        if successor is None:
            continue
        dst = partition_spill_dir(spill_root, successor)
        moved = 0
        for name in sorted(os.listdir(src)):
            src_path = os.path.join(src, name)
            if not os.path.isfile(src_path):
                continue
            dst_path = os.path.join(dst, name)
            if os.path.exists(dst_path):
                dst_path = os.path.join(dst, f"from-{spill_partition_tag(member)}__{name}")
            os.replace(src_path, dst_path)
            moved += 1
        try:
            os.rmdir(src)
        except OSError:
            pass  # non-file leftovers keep the dir; harmless
        registry().counter("re_spill_rebalance_moves_total").inc(moved)
        logger.info("re_store spill rebalance: %s -> %s (%d files renamed)", member, successor, moved)
        out[str(member)] = dict(successor=str(successor), moved=moved)
    return out


def _host_fields(block: EntityBlock) -> List[np.ndarray]:
    """The block's data fields as host numpy arrays: device tensors in one
    read, host arrays as they are."""
    values = [getattr(block, f) for f in _BLOCK_FIELDS]
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    fetched = iter(HOST_READS.fetch(*tensors)) if tensors else iter(())
    return [next(fetched) if isinstance(v, torch.Tensor) else v for v in values]


def _same_file(arr, path: str) -> bool:
    filename = getattr(arr, "filename", None)
    return filename is not None and os.path.abspath(filename) == os.path.abspath(path)


def host_entity_block(block: EntityBlock, spill_dir: Optional[str] = None, index: int = 0,
                      prefix: str = "") -> EntityBlock:
    """``block`` with host numpy fields (dense blocks only).

    With ``spill_dir``, each array round-trips through an ``.npy`` file,
    ``<prefix>block<index>_<field>.npy``, and comes back memory-mapped
    read-only: the host master then costs file cache, not RSS. An array
    already mapped from its own file stays as it is (a file is never
    rewritten under its own mapping)."""
    if block.col_map is not None:
        raise ValueError("out-of-core residency supports dense blocks only")
    fields = {}
    for name, arr in zip(_BLOCK_FIELDS, _host_fields(block)):
        if spill_dir is not None:
            path = os.path.join(spill_dir, f"{prefix}block{index:05d}_{name}.npy")
            if not _same_file(arr, path):
                try:
                    _SPILL_GUARD.check()  # ``enospc`` rules for --re-spill-dir
                    np.save(path, arr)
                    arr = np.load(path, mmap_mode="r")
                except OSError as exc:
                    # Disk full under the spill dir: keep this array in host
                    # RAM (values identical, RSS higher) and remove the
                    # partial .npy so it can neither strand space nor be
                    # mapped torn.
                    _SPILL_GUARD.record(exc)
                    _SPILL_GUARD.cleanup(path)
                    registry().counter("re_spill_fallbacks_total").inc()
                    logger.warning("re_store spill of block %d field %s to %s failed; keeping it in host memory: %s",
                                   index, name, spill_dir, exc)
        fields[name] = arr
    return EntityBlock(col_map=None, **fields)


def _nbytes(x) -> int:
    return int(x.nbytes) if isinstance(x, np.ndarray) else int(x.numel() * x.element_size())


def block_data_bytes(block: EntityBlock) -> int:
    """Bytes of a block's data arrays."""
    return int(sum(_nbytes(getattr(block, f)) for f in _BLOCK_FIELDS))


def block_device_cost(block: EntityBlock) -> int:
    """Budgeted device cost of holding ``block`` in flight: its data arrays
    plus the warm start w0 and the solver's result, both (E, dim) in the
    data's floating type (f32 in the reference), which coexist with the
    block between upload and download."""
    label = block.label
    itemsize = label.dtype.itemsize if isinstance(label, np.ndarray) else label.element_size()
    return block_data_bytes(block) + 2 * block.num_entities * block.dim * int(itemsize)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class _Staging:
    """A pinned host buffer and the event of the last copy out of it."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.event = None


class ReDeviceStore:
    """Residency manager for one coordinate's entity blocks.

    Keys are block indices into the coordinate's dataset (cacheable across
    passes: a resident block is a free upload next pass) or transient tuples
    for a gated pass's compacted blocks (always discarded at release).

    Thread contract: ``acquire`` runs on the h2d stage thread, ``release``
    and ``download`` on the d2h worker thread, ``handover`` on the consumer
    (training) thread, ``retire``/``begin_pass``/``end_pass`` on the
    training thread between passes. All residency state is serialized under
    one condition variable, which doubles as the budget's backpressure:
    ``acquire`` sleeps until enough protected (in-flight) bytes release.
    """

    def __init__(
        self,
        blocks: Sequence[EntityBlock],
        budget_bytes: int,
        coordinate_id: str,
        spill_dir: Optional[str] = None,
        device=None,
        spill_member=None,
    ):
        # ``spill_member`` opts into the host-owned per-ring-partition
        # layout: spill files land under ``<spill_dir>/host-<k>/``.
        if spill_dir is not None and spill_member is not None:
            spill_dir = partition_spill_dir(spill_dir, spill_member)
        elif spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self.spill_dir = spill_dir
        self.coordinate_id = coordinate_id
        # Where the working set lives: the device the blocks were built on.
        self.device = torch.device(device if device is not None else "cpu")
        # The coordinate's id prefixes its spill files: the coordinates of
        # one model share the spill directory (the reference's unprefixed
        # names let a second coordinate overwrite the first's mapped files).
        prefix = coordinate_id.replace(os.sep, "_") + "."
        self.blocks: List[EntityBlock] = [host_entity_block(b, spill_dir, i, prefix) for i, b in enumerate(blocks)]
        self.block_cost = [block_device_cost(b) for b in self.blocks]
        self.total_cost = int(sum(self.block_cost))
        self.budget = int(budget_bytes)
        # The solve cache's static buffers of these blocks (held all fit).
        self.static_bytes = block_input_bytes(self.blocks)
        max_cost = max(self.block_cost, default=0)
        self._max_cost = max_cost
        self._floor = max_cost + self.static_bytes
        self.effective_budget = max(self.budget, self._floor)
        if self.effective_budget > self.budget:
            logger.warning("re_store[%s]: budget %d B below the largest block %d B plus the static buffers %d B; "
                           "flooring the effective budget there", coordinate_id, self.budget, max_cost,
                           self.static_bytes)
        self.lru = ByteBudgetLru(self.effective_budget - self.static_bytes, on_evict=self._on_evict)
        self.peak_total_bytes = 0
        self._resident: Dict[Hashable, EntityBlock] = {}
        self._protected: set = set()
        self._transient: Dict[Hashable, int] = {}  # in-flight transient key -> its cost
        self._cond = threading.Condition()
        self._abort = False
        self._inflight_solves = 0
        self._ready: Dict[Hashable, list] = {}  # key -> events of its in-flight copies
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
            self._staging = {"block": [_Staging(), _Staging()], "w0": [_Staging(), _Staging()]}
            self._turn = {"block": 0, "w0": 0}
        # Cumulative traffic counters.
        self.uploads = 0
        self.upload_hits = 0
        self.overlapped_uploads = 0
        self.upload_bytes = 0
        self.upload_s = 0.0
        self.budget_shrinks = 0
        self.retired = 0
        self.pass_evictions: List[int] = []
        self._pass_eviction_mark = 0
        self._labels = dict(coordinate=coordinate_id)
        self._publish()

    # ------------------------------------------------------------------
    # Pass lifecycle (training thread).
    # ------------------------------------------------------------------

    def begin_pass(self, cd_iteration: int) -> None:
        with self._cond:
            self._abort = False
            self._pass_eviction_mark = self.lru.evictions
        self._publish()

    def end_pass(self) -> None:
        with self._cond:
            self.pass_evictions.append(self.lru.evictions - self._pass_eviction_mark)
        self._publish()

    def abort_pass(self) -> None:
        """Unstick a blocked upload thread on the error path."""
        with self._cond:
            self._abort = True
            self._cond.notify_all()

    def retire(self, keys: Sequence[Hashable]) -> int:
        """Active-set residency hook: evict the blocks whose entities all
        converged (at the pass-boundary mask fetch). Returns how many were
        resident."""
        dropped = []
        with self._cond:
            for key in keys:
                if key in self._protected:
                    continue
                if self.lru.evict(key):
                    dropped.append(self._resident.pop(key, None))
            if dropped:
                self._cond.notify_all()
        self.retired += len(dropped)
        self._free(dropped)
        if dropped:
            registry().counter("re_store_retired_total", **self._labels).inc(len(dropped))
            self._publish()
        return len(dropped)

    # ------------------------------------------------------------------
    # Upload / download (pipeline stage threads).
    # ------------------------------------------------------------------

    def acquire(self, key, host_block: EntityBlock, w0_host: np.ndarray, cacheable: bool):
        """h2d stage: make ``key`` resident under the budget (blocking on
        in-flight releases when needed) and return ``(device_block, w0)``.
        ``w0`` is always a fresh device buffer. On the card the copies are
        in flight until the consumer's ``handover``."""
        cost = self.block_cost[key] if isinstance(key, int) else block_device_cost(host_block)
        dropped = []
        with self._cond:
            while True:
                if self._abort:
                    raise RuntimeError(f"re_store[{self.coordinate_id}]: pass aborted")
                if key in self.lru:
                    self.lru.touch(key)
                    break
                victims = self._settled_victims(cost)
                if victims is not None:
                    for victim in victims:
                        self.lru.evict(victim)
                        dropped.append(self._resident.pop(victim, None))
                    self.lru.admit(key, cost, self._protected)  # fits now, or floor admission
                    break
                self._cond.wait(0.05)
            self._protected.add(key)
            self.peak_total_bytes = max(self.peak_total_bytes, self.lru.resident_bytes + self.static_bytes)
            if not cacheable:
                self._transient[key] = cost
            overlapped = self._inflight_solves > 0
            dev_block = self._resident.get(key)
        self._free(dropped)
        events: list = []
        t0 = time.perf_counter()
        reg = registry()
        if dev_block is not None:
            self.upload_hits += 1
            reg.counter("re_store_upload_hits_total", **self._labels).inc()
        else:
            dev_block = self._upload_contained(lambda: self._upload_block(host_block, events), f"block {key}")
            nbytes = block_data_bytes(host_block)
            self.uploads += 1
            self.upload_bytes += nbytes
            reg.counter("re_store_uploads_total", **self._labels).inc()
            reg.counter("re_store_upload_bytes_total", **self._labels).inc(nbytes)
            if overlapped:
                self.overlapped_uploads += 1
            if cacheable:
                with self._cond:
                    self._resident[key] = dev_block
        w0 = np.ascontiguousarray(w0_host)
        (w0_dev,) = self._upload_contained(lambda: self._upload_arrays("w0", [w0], events), f"w0 for block {key}")
        self.upload_s += time.perf_counter() - t0
        with self._cond:
            self._ready[key] = events
        self._publish()
        return dev_block, w0_dev

    def _settled_victims(self, cost: int) -> Optional[list]:
        """The blocks to evict for an admission of ``cost`` bytes, or None
        while the admission must wait (caller holds ``_cond``).

        The victims are those of the settled state, in which every earlier
        key of the plan has been released: the least recently used cacheable
        blocks, until the admission fits. Transient blocks leave at their
        release, so how many are still in flight depends on the download
        thread's timing; counting them would make the eviction log timing-
        dependent. The admission waits instead, until the victims are out of
        flight and the in-flight transient bytes no longer stand in the way.
        Protected blocks are always the most recently acquired (one upload
        thread, FIFO releases), so waiting cannot deadlock."""
        budget = self.lru.budget
        settled = self.lru.resident_bytes - sum(self._transient.values())
        victims, freed = [], 0
        for k in self.lru.resident:
            if settled - freed + cost <= budget:
                break
            if k in self._transient:
                continue
            victims.append(k)
            freed += self.block_cost[k]
        if any(v in self._protected for v in victims):
            return None
        if self.lru.resident_bytes - freed + cost > budget and self._protected:
            return None
        return victims

    def handover(self, key, dev_block: EntityBlock, w0: torch.Tensor) -> None:
        """Consumer thread: order the consumer's stream after ``key``'s
        copies and mark every device tensor as used by that stream, so the
        caching allocator cannot recycle it (allocated on the copy stream)
        while the consumer's kernels still read it."""
        with self._cond:
            events = self._ready.pop(key, [])
        if not self._cuda:
            return
        consumer = torch.cuda.current_stream(self.device)
        for ev in events:
            consumer.wait_event(ev)
        for t in [getattr(dev_block, f) for f in _BLOCK_FIELDS] + [w0]:
            t.record_stream(consumer)

    def _upload_block(self, host_block: EntityBlock, events: list) -> EntityBlock:
        arrays = [np.asarray(getattr(host_block, f)) for f in _BLOCK_FIELDS]
        return EntityBlock(*self._upload_arrays("block", arrays, events), col_map=None)

    def _upload_arrays(self, ring: str, arrays: List[np.ndarray], events: list) -> List[torch.Tensor]:
        """Copies of ``arrays`` on the store's device: CPU tensors of their
        own on the CPU; on the card, through a pinned staging buffer of
        ``ring`` and ``non_blocking`` copies on the copy stream, the event
        after them appended to ``events``."""
        if not self._cuda:
            return [torch.from_numpy(np.array(a)) for a in arrays]
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        with CAPTURE_LOCK, torch.cuda.device(self.device):
            slots = self._staging[ring]
            st = slots[self._turn[ring]]
            self._turn[ring] = (self._turn[ring] + 1) % len(slots)
            if st.event is not None:
                st.event.synchronize()  # its last copy has read the buffer
            if st.buf is None or st.buf.numel() < total:
                st.buf = None
                st.buf = torch.empty(max(total, _ALIGN), dtype=torch.uint8, pin_memory=True)
        host = st.buf.numpy()
        for a, off in zip(arrays, offsets):
            np.copyto(host[off:off + a.nbytes].view(a.dtype).reshape(a.shape), a)
        outs = []
        with CAPTURE_LOCK, torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            try:
                for a, off in zip(arrays, offsets):
                    dtype = _torch_dtype(a.dtype)
                    out = torch.empty(a.shape, dtype=dtype, device=self.device)
                    out.copy_(st.buf[off:off + a.nbytes].view(dtype).view(a.shape), non_blocking=True)
                    outs.append(out)
            finally:
                # Also after a failed allocation: the buffer is reused only
                # once the copies already issued from it have run.
                st.event = torch.cuda.Event()
                st.event.record(self._copy_stream)
        events.append(st.event)
        return outs

    def _upload_contained(self, upload, what: str):
        """Run a device upload with OOM containment: on a device OOM, evict
        every unprotected resident block, halve the effective budget toward
        the floor (the largest single block plus the static buffers:
        admitting less would deadlock), release the dropped buffers and retry. The allocator can
        fail before the budget does (it also serves fragments, graphs and
        other coordinates' working sets), and training is value-identical at
        any budget, so shrinking is bit-safe. A
        :class:`~photon_tpu_torch.utils.resources.DeviceMemoryError` is
        raised only when the floor itself cannot fit. Any other failure
        propagates."""
        floor_retry = True
        while True:
            try:
                faults.check("re_store.upload")  # ``oom`` injection site
                return upload()
            except Exception as exc:
                if not resources.is_device_oom(exc):
                    raise
                shrunk = self._evict_harder_and_shrink()
                if not shrunk:
                    if not floor_retry:
                        raise resources.DeviceMemoryError(
                            f"re_store[{self.coordinate_id}]: device OOM uploading {what} at the floor budget "
                            f"({self._floor} B — the largest single block and the static buffers). Containment "
                            "already evicted the "
                            "whole working set; shrink the block geometry or add device memory.") from exc
                    floor_retry = False
                logger.warning("re_store[%s]: device OOM uploading %s; evicted working set, effective budget now "
                               "%d B, retrying: %s", self.coordinate_id, what, self.effective_budget, exc)
                with CAPTURE_LOCK:
                    resources._release_device_memory()

    def _evict_harder_and_shrink(self) -> bool:
        """OOM response: drop every unprotected resident block and halve
        the effective budget (floored at the largest single block plus the
        static buffers). Returns
        False when the budget was already at the floor: the caller gets one
        more eviction-only retry before failing hard."""
        dropped = []
        with self._cond:
            for victim in list(self.lru.resident):
                if victim in self._protected:
                    continue
                if self.lru.evict(victim):
                    dropped.append(self._resident.pop(victim, None))
            shrunk = self.effective_budget > self._floor
            if shrunk:
                self.effective_budget = max(self._floor, self.effective_budget // 2)
                self.lru.budget = self.effective_budget - self.static_bytes
                self.budget_shrinks += 1
            self._cond.notify_all()
        self._free(dropped)
        if shrunk:
            registry().counter("re_device_budget_shrinks_total", **self._labels).inc()
        self._publish()
        return shrunk

    def solve_event(self):
        """Consumer thread, after a solve's dispatch: an event on the
        consumer's stream that ``download`` waits on (None on the CPU)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def download(self, tensors: Sequence[torch.Tensor], event) -> list:
        """d2h worker: the solve's outputs as host arrays, one read through
        ``HOST_READS``; on the card on the download stream once ``event``
        (``solve_event``) has completed, so only that solve is waited for."""
        if not self._cuda:
            return HOST_READS.fetch(*tensors)
        with CAPTURE_LOCK, torch.cuda.device(self.device):
            return HOST_READS.fetch_after(event, self._d2h_stream, *tensors)

    def release(self, key, cacheable: bool) -> None:
        """d2h worker: the solve's results are on the host; the block's
        in-flight protection (and, for transient compacted blocks, its
        residency) can go."""
        dropped = []
        with self._cond:
            self._protected.discard(key)
            self._transient.pop(key, None)
            if not cacheable:
                self.lru.discard(key)
                dropped.append(self._resident.pop(key, None))
            self._cond.notify_all()
        self._free(dropped)
        self._publish()

    def _free(self, dropped: list) -> None:
        """Drop device blocks under the capture lock (their release may
        touch the card's allocator)."""
        if dropped and self._cuda:
            with CAPTURE_LOCK:
                dropped.clear()

    def mark_solve_start(self) -> None:
        with self._cond:
            self._inflight_solves += 1

    def mark_solve_done(self) -> None:
        with self._cond:
            self._inflight_solves -= 1

    # ------------------------------------------------------------------
    # Introspection.
    # ------------------------------------------------------------------

    def staging_bytes(self) -> int:
        """Pinned host bytes of the staging buffers."""
        if not self._cuda:
            return 0
        return sum(st.buf.numel() for ring in self._staging.values() for st in ring if st.buf is not None)

    def stats(self) -> Dict:
        return dict(
            coordinate=self.coordinate_id,
            budget_bytes=self.budget,
            effective_budget_bytes=self.effective_budget,
            footprint_bytes=self.total_cost,
            max_block_bytes=self._max_cost,
            resident_bytes=self.lru.resident_bytes,
            peak_bytes=self.lru.peak_bytes,
            static_bytes=self.static_bytes,
            peak_total_bytes=self.peak_total_bytes,
            resident_blocks=len(self.lru),
            evictions=self.lru.evictions,
            eviction_log=list(self.lru.eviction_log),
            uploads=self.uploads,
            upload_hits=self.upload_hits,
            overlapped_uploads=self.overlapped_uploads,
            upload_bytes=self.upload_bytes,
            upload_s=self.upload_s,
            budget_shrinks=self.budget_shrinks,
            retired=self.retired,
            staging_bytes=self.staging_bytes(),
            pass_evictions=list(self.pass_evictions),
        )

    def _on_evict(self, key) -> None:
        registry().counter("re_store_evictions_total", **self._labels).inc()

    def _publish(self) -> None:
        reg = registry()
        reg.gauge("re_device_resident_bytes", **self._labels).set(self.lru.resident_bytes)
        reg.gauge("re_device_resident_bytes_peak", **self._labels).set(self.lru.peak_bytes)
        reg.gauge("re_device_resident_blocks", **self._labels).set(len(self.lru))
        reg.gauge("re_device_budget_bytes", **self._labels).set(self.effective_budget)
