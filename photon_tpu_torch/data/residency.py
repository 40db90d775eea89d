"""Copy of photon_tpu/data/residency.py (framework-free; the port does not import it).

Shared residency core: deterministic LRU policies for device working sets.

Serving (serve/store.py) and training (algorithm/re_store.py) manage the
same resource — a bounded device-resident subset of a host-resident master —
under the same policy: least-recently-used eviction with protection for
entries the caller is actively using. This module is the single home for
that policy so the two sides cannot drift.

Two shapes of the same idea:

``SlotLru``
    A fixed pool of SLOTS (serving hot tables): every resident key occupies
    exactly one row of a preallocated device table, so admission means
    assigning a slot and eviction means demoting some other key out of its
    slot. Used by the serving hot/cold store for both dense and projected
    random-effect tables.

``ByteBudgetLru``
    Variable BYTE costs under a budget (training working set): each key is a
    whole entity block whose device arrays differ in size, so admission
    evicts least-recently-used keys until the newcomer's bytes fit. Used by
    the out-of-core training store (algorithm/re_store.py).

Both are deliberately clock- and hash-free: iteration and eviction order
depend only on the call sequence (OrderedDict insertion/touch order), never
on wall time or hashing — the out-of-core determinism contract (same seed +
budget ⇒ identical eviction sequence) rests on this.

Neither class is thread-safe by itself; callers serialize access (the
serving engine under its batch lock, the training store under its budget
condition variable).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, List, Optional


class SlotLru:
    """Key → slot assignment over a fixed pool of ``capacity`` slots.

    Free slots are handed out in ascending order (0, 1, …); once the pool is
    exhausted, ``claim`` demotes the least-recently-used key that is not in
    the caller's ``protected`` set and reuses its slot. ``on_demote`` fires
    for every demotion (metric counters live with the caller, which knows
    its label space).

    ``base`` offsets every slot this pool hands out: a store whose hot
    table is split into per-device-shard segments runs one SlotLru per
    segment over the segment's global slot range [base, base + capacity) —
    segments stay disjoint by construction and the upload scatter keeps
    addressing one (sharded) table.
    """

    def __init__(
        self,
        capacity: int,
        on_demote: Optional[Callable[[Hashable, int], None]] = None,
        base: int = 0,
    ):
        self.capacity = int(capacity)
        self.base = int(base)
        self._slot_of: "OrderedDict[Hashable, int]" = OrderedDict()
        # Popped from the end: slots assign in ascending order.
        self._free: List[int] = list(
            range(self.base + self.capacity - 1, self.base - 1, -1)
        )
        self._on_demote = on_demote

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, key) -> bool:
        return key in self._slot_of

    @property
    def resident(self) -> List:
        """Resident keys, least- to most-recently used."""
        return list(self._slot_of)

    def get(self, key) -> Optional[int]:
        """Slot of ``key`` (touching it most-recently-used), None if cold."""
        slot = self._slot_of.get(key)
        if slot is not None:
            self._slot_of.move_to_end(key)
        return slot

    def peek(self, key) -> Optional[int]:
        """Slot of ``key`` WITHOUT touching recency (upload index lookups)."""
        return self._slot_of.get(key)

    def claim(self, key, protected=()) -> int:
        """Make ``key`` resident and return its slot, demoting the LRU
        victim outside ``protected`` when the pool is full. Raises
        RuntimeError (message contains "exhausted") when every resident key
        is protected — the caller's working set exceeds the pool."""
        if self._free:
            slot = self._free.pop()
        else:
            slot = None
            for victim in self._slot_of:
                if victim not in protected:
                    slot = self._slot_of.pop(victim)
                    if self._on_demote is not None:
                        self._on_demote(victim, slot)
                    break
            if slot is None:
                raise RuntimeError(
                    f"slot pool exhausted: all {self.capacity} resident "
                    "entries are protected by the current batch"
                )
        self._slot_of[key] = slot
        return slot


class ByteBudgetLru:
    """Byte-budgeted LRU over variable-cost keys (training working set).

    ``admit`` evicts least-recently-used unprotected keys until the new
    entry's cost fits under ``budget``, then marks it resident. A single
    entry larger than everything evictable is still admitted (floor
    semantics: refusing would deadlock the pipeline) — callers size budgets
    to at least their largest entry so the resident-bytes gauge stays under
    the configured value.

    ``eviction_log`` records every policy eviction in order; the out-of-core
    determinism tests compare these sequences across runs.
    """

    def __init__(
        self,
        budget_bytes: int,
        on_evict: Optional[Callable[[Hashable], None]] = None,
    ):
        self.budget = int(budget_bytes)
        self._cost: "OrderedDict[Hashable, int]" = OrderedDict()
        self.resident_bytes = 0
        self.peak_bytes = 0
        self.evictions = 0
        self.eviction_log: List = []
        self._on_evict = on_evict

    def __len__(self) -> int:
        return len(self._cost)

    def __contains__(self, key) -> bool:
        return key in self._cost

    @property
    def resident(self) -> List:
        """Resident keys, least- to most-recently used."""
        return list(self._cost)

    def touch(self, key) -> bool:
        """Mark ``key`` most-recently-used; False if not resident."""
        if key in self._cost:
            self._cost.move_to_end(key)
            return True
        return False

    def would_fit(self, cost: int, protected=()) -> bool:
        """True when admitting ``cost`` bytes can respect the budget after
        evicting every unprotected resident. False means only protected
        bytes stand in the way — the caller should wait for releases before
        admitting. (With zero protected bytes this is always True: there is
        nothing to wait for, so the floor-admission path applies.)"""
        protected_bytes = sum(
            c for k, c in self._cost.items() if k in protected
        )
        return protected_bytes + int(cost) <= self.budget or not protected_bytes

    def admit(self, key, cost: int, protected=()) -> List:
        """Make ``key`` resident at ``cost`` bytes, evicting unprotected LRU
        keys as needed. Returns the eviction victims in order. Re-admitting
        a resident key refreshes recency and evicts nothing."""
        cost = int(cost)
        if key in self._cost:
            self._cost.move_to_end(key)
            return []
        victims: List = []
        while self.resident_bytes + cost > self.budget:
            victim = next((k for k in self._cost if k not in protected), None)
            if victim is None:
                break  # floor admission: nothing evictable remains
            victims.append(victim)
            self._evict(victim)
        self._cost[key] = cost
        self.resident_bytes += cost
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)
        return victims

    def evict(self, key) -> bool:
        """Policy-initiated eviction (counted and logged) — e.g. dropping a
        block whose entities all converged. False if not resident."""
        if key not in self._cost:
            return False
        self._evict(key)
        return True

    def discard(self, key) -> bool:
        """Drop ``key`` without counting an eviction (caller-initiated
        release of a transient entry). False if not resident."""
        if key not in self._cost:
            return False
        self.resident_bytes -= self._cost.pop(key)
        return True

    def _evict(self, key) -> None:
        self.resident_bytes -= self._cost.pop(key)
        self.evictions += 1
        self.eviction_log.append(key)
        if self._on_evict is not None:
            self._on_evict(key)
