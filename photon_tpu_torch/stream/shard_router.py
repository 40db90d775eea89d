"""Copy of photon_tpu/stream/shard_router.py (host code; the port does not import it).

Entity-hash shard routing for the streaming freshness plane.

One ``StreamingUpdater`` process consumes every spool, so
freshness throughput is flat while serving QPS scales with the fleet. The
fix is the same move that made fleet cache hit rate a routing property:
give each updater shard a DISJOINT entity subset via the consistent-hash
ring (``serve/routing.py``), so shards never contend on a model row and
their per-entity delta layers commute (``io/model_io.layers_commute``).

The routing key is load-bearing: a record routes on the SAME per-entity
string ``serve/store._owned_mask`` hashes — the raw entity id when the
record carries one (``entityIds[re_type]``), else the decimal index form a
pre-interned int key serializes to. ``serve/routing.route_key`` already
encodes exactly that contract, so this module reuses it verbatim; an
updater shard's working set is therefore literally a serving replica's
entity shard, just over a ring with ``updater:k`` members instead of
replica ids.

Two routing topologies share the same ring:

- READ-SIDE (:func:`read_owned_segment`): every shard worker lists the
  same sealed segments and keeps only the rows it owns, routing on the
  raw line without a full parse. Zero extra writes, works over multi-dir
  spool globs — but every shard still scans every line, so aggregate
  throughput plateaus at the scan cost.
- MATERIALIZING (:func:`route_segments`): a router splits each sealed
  segment ONCE into per-shard sub-spool segments (same sequence numbers,
  atomic tmp+rename, idempotent re-runs), and each worker consumes only
  its own sub-spool (``pre_routed=True``) — per-shard cost is then
  proportional to owned records, which is what lets aggregate throughput
  actually scale with shard count.

MIXED segments split at record level in both modes; whole-segment routing
falls out for free when a segment happens to be single-entity. Records
with no entity ids at all (FE-only feedback; nothing row-level to train)
deterministically home on shard 0 so exactly one worker counts them.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

from photon_tpu_torch.serve.routing import HashRing, route_key

logger = logging.getLogger(__name__)

MEMBER_PREFIX = "updater:"


def shard_members(num_shards: int) -> List[str]:
    """Ring member names for ``num_shards`` updater shards. Stable strings
    (``updater:k``) — the ring snapshot, the manifest shard block, and the
    per-shard metric labels all agree on the same identity."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return [f"{MEMBER_PREFIX}{k}" for k in range(num_shards)]


def shard_ring(
    num_shards: int, vnodes: int = 64, seed: int = 0
) -> HashRing:
    """The updater plane's ring. Every shard worker builds this from the
    same ``(num_shards, vnodes, seed)`` — blake2b makes owner assignment
    identical across processes, so N independently started workers derive
    the same disjoint partition with no coordination traffic."""
    return HashRing(shard_members(num_shards), vnodes=vnodes, seed=seed)


def member_index(member: str) -> int:
    """``updater:k`` -> k."""
    return int(member.rsplit(":", 1)[1])


def shard_of_record(
    record: dict,
    ring: HashRing,
    route_re_type: Optional[str] = None,
) -> int:
    """Owning shard index for one joined spool record. Hashes the identical
    string serving routes and ``_owned_mask`` masks on; entity-less records
    home on shard 0."""
    key = route_key(record.get("entityIds"), route_re_type)
    if key is None:
        return 0
    return member_index(ring.owner(key))


def owned_records(
    records: Sequence[dict],
    ring: HashRing,
    shard_index: int,
    route_re_type: Optional[str] = None,
) -> List[dict]:
    """The subset of ``records`` shard ``shard_index`` owns — a shard
    worker's view of a (possibly mixed) sealed segment."""
    return [
        r for r in records
        if shard_of_record(r, ring, route_re_type) == shard_index
    ]


_ENTITY_IDS_TOKEN = '"entityIds":'
_DECODER = json.JSONDecoder()


def entity_ids_of_line(line: str) -> Tuple[bool, Optional[dict]]:
    """Cheap ``entityIds`` extraction from one raw spool JSON line —
    ``(ok, ids)``.

    Read-side routing's scaling ceiling is the parse: every shard lists
    every sealed segment, and ``json.loads`` on records it will throw away
    costs more than the routing hash itself. This decodes ONLY the (tiny)
    ``entityIds`` object and leaves the rest of the line untouched, so a
    non-owner spends ~a hash per foreign record instead of a full parse.

    The token search is sound, not heuristic: ``json.dumps`` escapes every
    quote inside a string value (``\\"``), so the unescaped byte sequence
    ``"entityIds":`` can only occur as a real object key. Absence therefore
    means an entity-less record (``ids=None``, routes to shard 0). Any
    decode surprise returns ``ok=False`` — callers must fall back to the
    full parse, never guess.
    """
    i = line.find(_ENTITY_IDS_TOKEN)
    if i < 0:
        return True, None
    j = i + len(_ENTITY_IDS_TOKEN)
    n = len(line)
    while j < n and line[j] in " \t":
        j += 1
    try:
        ids, _ = _DECODER.raw_decode(line, j)
    except ValueError:
        return False, None
    if ids is not None and not isinstance(ids, dict):
        return False, None
    return True, ids


def read_owned_segment(
    path: str,
    ring: HashRing,
    shard_index: int,
    route_re_type: Optional[str] = None,
) -> Tuple[List[dict], int]:
    """One shard worker's view of a sealed segment: ``(owned_records,
    total_records)``.

    Routes on the raw line via :func:`entity_ids_of_line` and fully parses
    ONLY owned rows (plus the rare ambiguous line). Mirrors
    ``spool.read_segment``'s bit-rot discipline — a corrupt line is skipped
    and counted, never poisons the cycle. ``total_records`` counts every
    routable line (the whole segment's record count, not just this shard's
    subset), so per-shard manifests can record how much traffic they
    routed past.
    """
    from photon_tpu_torch.obs.metrics import registry

    owned: List[dict] = []
    total = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ok, ids = entity_ids_of_line(line)
            if ok:
                key = route_key(ids, route_re_type)
                shard = 0 if key is None else member_index(ring.owner(key))
                total += 1
                if shard != shard_index:
                    continue
                try:
                    owned.append(json.loads(line))
                except ValueError:
                    total -= 1
                    registry().counter(
                        "feedback_spool_bad_lines_total").inc()
                    logger.warning("unparseable spool line in %s", path)
                continue
            # Ambiguous prefix: full parse decides (and validates) routing.
            try:
                record = json.loads(line)
            except ValueError:
                registry().counter("feedback_spool_bad_lines_total").inc()
                logger.warning("unparseable spool line in %s", path)
                continue
            total += 1
            if shard_of_record(record, ring, route_re_type) == shard_index:
                owned.append(record)
    return owned, total


def updater_spill_dir(spill_root: str, shard_index: int) -> str:
    """Shard ``k``'s host-owned spill partition — ``<spill_root>/host-k/``
    (re_store.partition_spill_dir over the ``updater:k`` member). An
    updater shard parks its out-of-core host masters here so a shard-count
    rebalance relocates them by file rename, not row re-stream."""
    from photon_tpu_torch.algorithm.re_store import partition_spill_dir

    return partition_spill_dir(spill_root, f"{MEMBER_PREFIX}{shard_index}")


def rebalance_updater_spill(
    spill_root: str,
    old_num_shards: int,
    new_num_shards: int,
    vnodes: int = 64,
    seed: int = 0,
) -> Dict[str, Dict]:
    """Re-home spill partitions across a shard-count change: every
    ``updater:k`` partition departed by the resize is adopted by its
    deterministic successor on the new ring via ``os.replace`` (see
    re_store.rebalance_spill_layout — and its locality-hint caveat: the
    owned-record filter, not file placement, remains the correctness
    boundary). Shrinking from 4 to 2 shards moves ``host-2``/``host-3``
    files under the survivors; growing moves nothing (new shards start
    cold) — either way, zero rows are decoded."""
    from photon_tpu_torch.algorithm.re_store import rebalance_spill_layout

    return rebalance_spill_layout(
        spill_root,
        shard_ring(old_num_shards, vnodes=vnodes, seed=seed),
        shard_ring(new_num_shards, vnodes=vnodes, seed=seed),
    )


def shard_spool_dir(out_root: str, shard_index: int) -> str:
    """Per-shard sub-spool directory the materializing router writes —
    ``out_root/shard-k/``. Shard worker k points its ``spool_dir`` here
    (with ``pre_routed=True``) to skip read-side filtering entirely."""
    return os.path.join(out_root, f"shard-{shard_index}")


def route_segments(
    src_dir: str,
    out_root: str,
    num_shards: int,
    vnodes: int = 64,
    seed: int = 0,
    route_re_type: Optional[str] = None,
    ring: Optional[HashRing] = None,
) -> int:
    """Materialize the shard partition: split every sealed segment in
    ``src_dir`` into per-shard sub-spool segments under
    ``out_root/shard-k/`` and return how many segments were routed this
    call.

    Read-side filtering (:func:`read_owned_segment`) keeps every shard
    scanning every line, so its aggregate throughput plateaus at the
    routing-scan cost no matter how many shards run. This router pays the
    scan ONCE, upstream — each raw line is appended verbatim to exactly one
    shard's copy of the segment, so a worker's parse cost is proportional
    to the records it actually owns. Routing hashes the identical
    per-entity string as serving (:func:`entity_ids_of_line` +
    ``route_key``); entity-less records land on shard 0; a corrupt line is
    counted and dropped for every shard alike.

    Crash-safe and idempotent by construction: each shard file is written
    to a dot-tmp sibling, fsync'd, then renamed, and a segment counts as
    routed only when ALL ``num_shards`` outputs exist — a re-run after a
    mid-split crash rewrites the incomplete segment byte-identically (the
    ring is deterministic) and never touches completed ones. Output
    segments keep the SOURCE sequence numbers, so the per-shard
    manifest-as-cursor chain (``stream.consumedThrough``) means the same
    thing against a routed sub-spool as against the raw spool.
    """
    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.stream.spool import sealed_segments

    if ring is None:
        ring = shard_ring(num_shards, vnodes=vnodes, seed=seed)
    routed = 0
    shard_dirs = [shard_spool_dir(out_root, k) for k in range(num_shards)]
    for d in shard_dirs:
        os.makedirs(d, exist_ok=True)
    memo: Dict[str, int] = {}  # entity route-key -> shard
    for fn in sealed_segments(src_dir):
        finals = [os.path.join(d, fn) for d in shard_dirs]
        if all(os.path.exists(p) for p in finals):
            continue
        tmps = [p + ".routing" for p in finals]
        outs = [open(t, "w") for t in tmps]
        try:
            with open(os.path.join(src_dir, fn)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    ok, ids = entity_ids_of_line(line)
                    if ok:
                        key = route_key(ids, route_re_type)
                    else:
                        try:
                            record = json.loads(line)
                        except ValueError:
                            registry().counter(
                                "feedback_spool_bad_lines_total").inc()
                            logger.warning(
                                "unparseable spool line in %s", fn)
                            continue
                        key = route_key(
                            record.get("entityIds"), route_re_type)
                    if key is None:
                        shard = 0
                    else:
                        shard = memo.get(key)
                        if shard is None:
                            shard = member_index(ring.owner(key))
                            memo[key] = shard
                    outs[shard].write(line + "\n")
            for out in outs:
                out.flush()
                os.fsync(out.fileno())
        finally:
            for out in outs:
                out.close()
        for tmp, final in zip(tmps, finals):
            os.replace(tmp, final)
        routed += 1
        registry().counter("stream_router_segments_total").inc()
    return routed


def split_records(
    records: Sequence[dict],
    ring: HashRing,
    num_shards: int,
    route_re_type: Optional[str] = None,
) -> Dict[int, List[dict]]:
    """Partition a segment's records across all shards in one pass —
    ``{shard_index: [records]}``, every input record in exactly one bucket.
    The routing smoke uses this to assert the partition is disjoint AND
    complete against per-shard ``owned_records`` views."""
    out: Dict[int, List[dict]] = {k: [] for k in range(num_shards)}
    for r in records:
        out[shard_of_record(r, ring, route_re_type)].append(r)
    return out
