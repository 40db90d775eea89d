"""Copy of photon_tpu/serve/routing.py (framework-free; the port does not import it).

Consistent-hash request routing for the scorer fleet.

Photon ML's premise is that no single machine holds the model: random
effects shard by entity across the cluster (PAPER.md §2.9). The serving
analogue is this module — a consistent-hash ring over ENTITY IDS that maps
every ``/v1/score`` request to the scorer replica owning that entity's
shard. Cache hit rate becomes a *routing* property instead of a *budget*
property: each replica's hot set is the disjoint slice of entities the ring
assigns it, so the fleet-wide hot set is the union of N disjoint
per-replica working sets (Snap ML's hierarchical node-local/cluster split,
PAPERS.md, is the shape).

Determinism is the load-bearing property. The ring hash is
``blake2b`` — stable across processes, platforms, and Python hash
randomization — so the HTTP front end, every scorer replica, and an
offline test all derive the SAME owner for a key from the same
``(members, vnodes, seed)`` snapshot. tests/test_fleet.py asserts this
across a subprocess boundary, plus the classic consistent-hashing bound:
adding/removing one member moves ≤ 1/N + ε of keys.

Snapshots are plain JSON dicts (members + vnodes + seed + version) and
travel over the existing framed IPC as the ``ring`` op — a replica whose
membership view changes rebuilds the ring locally and re-derives its
:class:`~photon_tpu_torch.serve.store.StorePartition` predicate from it.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

HASH_BITS = 64
HASH_SPACE = 1 << HASH_BITS


def stable_hash(key: str, seed: int = 0) -> int:
    """Process-stable 64-bit hash of a string key. ``blake2b`` keyed by the
    ring seed — NOT Python's ``hash`` (randomized per process) and NOT
    ``crc32`` (too little dispersion for vnode placement)."""
    h = hashlib.blake2b(
        str(key).encode("utf-8"),
        digest_size=8,
        key=seed.to_bytes(8, "big", signed=False),
    )
    return int.from_bytes(h.digest(), "big")


class HashRing:
    """Consistent-hash ring: ``vnodes`` virtual points per member, owner of
    a key = member of the first point clockwise from the key's hash.

    Mutations (:meth:`add` / :meth:`remove`) bump ``version`` — the fleet
    broadcasts the snapshot and every holder rebuilds, so two processes
    with the same version always agree on every assignment. Not
    thread-safe; holders mutate under their own lock (the router's) or
    replace the instance wholesale (replicas, via ``from_snapshot``).
    """

    def __init__(
        self,
        members: Sequence[str] = (),
        vnodes: int = 64,
        seed: int = 0,
        version: int = 0,
        weights: Optional[Dict[str, int]] = None,
    ):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        self.version = int(version)
        # Per-member vnode counts for heterogeneous hosts: a member with
        # weight 2 places 2×vnodes points and owns ~2× the hash space.
        # Members absent from the map get the default count, so old
        # snapshots (no ``weights`` key) rebuild bit-identically.
        self._weights: Dict[str, int] = {
            str(m): int(w) for m, w in (weights or {}).items()
        }
        self._members: List[str] = []
        self._points: List[Tuple[int, str]] = []  # sorted (hash, member)
        self._hashes: List[int] = []
        for m in members:
            self._insert(str(m))

    # -- membership --------------------------------------------------------

    def member_vnodes(self, member: str) -> int:
        """Virtual-point count for ``member``: ``vnodes × weight``."""
        w = self._weights.get(str(member), 1)
        if w < 1:
            raise ValueError(f"member weight must be >= 1, got {w}")
        return self.vnodes * w

    def _insert(self, member: str) -> None:
        if member in self._members:
            raise ValueError(f"ring member {member!r} already present")
        self._members.append(member)
        for v in range(self.member_vnodes(member)):
            h = stable_hash(f"{member}#{v}", self.seed)
            bisect.insort(self._points, (h, member))
        self._hashes = [h for h, _ in self._points]

    def add(self, member: str, weight: Optional[int] = None) -> int:
        """Add a member (optionally weighted); returns the new ring
        version."""
        member = str(member)
        if weight is not None:
            self._weights[member] = int(weight)
        self._insert(member)
        self.version += 1
        return self.version

    def remove(self, member: str) -> int:
        """Remove a member; returns the new ring version."""
        member = str(member)
        if member not in self._members:
            raise ValueError(f"ring member {member!r} not present")
        self._members.remove(member)
        self._points = [(h, m) for h, m in self._points if m != member]
        self._hashes = [h for h, _ in self._points]
        self.version += 1
        return self.version

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def __contains__(self, member: str) -> bool:
        return str(member) in self._members

    def __len__(self) -> int:
        return len(self._members)

    # -- assignment --------------------------------------------------------

    def owner(self, key) -> Optional[str]:
        """The member owning ``key`` (None on an empty ring)."""
        if not self._points:
            return None
        h = stable_hash(str(key), self.seed)
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._points):
            i = 0  # wrap
        return self._points[i][1]

    def preference(self, key, n: Optional[int] = None) -> List[str]:
        """Failover order for ``key``: the owner, then each DISTINCT member
        met walking clockwise. A dead owner's traffic drains onto ring
        successors (who score the foreign entities FE-only) instead of
        erroring."""
        if not self._points:
            return []
        n = len(self._members) if n is None else min(n, len(self._members))
        h = stable_hash(str(key), self.seed)
        i = bisect.bisect_right(self._hashes, h)
        out: List[str] = []
        for step in range(len(self._points)):
            m = self._points[(i + step) % len(self._points)][1]
            if m not in out:
                out.append(m)
                if len(out) >= n:
                    break
        return out

    # -- introspection ------------------------------------------------------

    def shard_ranges(self, max_arcs_per_member: int = 8) -> Dict[str, dict]:
        """Per-member arc summary for ``/healthz``: owned fraction of the
        hash space, arc count, and the first few ``[lo, hi)`` arcs in hex
        (arcs beyond ``max_arcs_per_member`` are elided — vnode counts make
        the full list noise)."""
        out: Dict[str, dict] = {
            m: dict(fraction=0.0, arcs=0, ranges=[]) for m in self._members
        }
        if not self._points:
            return out
        for j, (hi, member) in enumerate(self._points):
            lo = self._points[j - 1][0] if j > 0 else self._points[-1][0]
            span = (hi - lo) % HASH_SPACE
            if span == 0 and len(self._points) == 1:
                span = HASH_SPACE
            rec = out[member]
            rec["fraction"] += span / HASH_SPACE
            rec["arcs"] += 1
            if len(rec["ranges"]) < max_arcs_per_member:
                rec["ranges"].append([f"{lo:016x}", f"{hi:016x}"])
        for rec in out.values():
            rec["fraction"] = round(rec["fraction"], 6)
        return out

    # -- wire format --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able ring state. ``from_snapshot`` on ANY process rebuilds
        an identical assignment — members are sorted so the snapshot is
        canonical regardless of join order."""
        snap = dict(
            members=sorted(self._members),
            vnodes=self.vnodes,
            seed=self.seed,
            version=self.version,
        )
        live_weights = {
            m: w
            for m, w in sorted(self._weights.items())
            if m in self._members and w != 1
        }
        if live_weights:  # omit when uniform: old consumers stay compatible
            snap["weights"] = live_weights
        return snap

    @classmethod
    def from_snapshot(cls, snap: dict) -> "HashRing":
        return cls(
            members=snap.get("members") or (),
            vnodes=int(snap.get("vnodes", 64)),
            seed=int(snap.get("seed", 0)),
            version=int(snap.get("version", 0)),
            weights=snap.get("weights") or None,
        )


def route_key(
    entity_ids: Optional[dict], route_re_type: Optional[str]
) -> Optional[str]:
    """The string key a request routes on: its entity id for the routing
    RE type. Falls back to the lexicographically-first entity id when the
    routing type is absent (so multi-type requests still route
    deterministically), and None for entity-less requests (any replica
    scores those identically — they are FE-only by construction)."""
    if not entity_ids:
        return None
    if route_re_type is not None:
        key = entity_ids.get(route_re_type)
        if key is not None:
            return str(key)
    for rt in sorted(entity_ids):
        if entity_ids[rt] is not None:
            return str(entity_ids[rt])
    return None


def moved_keys(
    before: HashRing, after: HashRing, keys: Sequence[str]
) -> List[str]:
    """Keys whose owner differs between two rings — the ring-stability
    tests' measurement (≤ 1/N + ε of keys move on a single join/leave)."""
    return [k for k in keys if before.owner(k) != after.owner(k)]
