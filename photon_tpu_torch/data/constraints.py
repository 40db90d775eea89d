"""Copy of photon_tpu/data/constraints.py (framework-free; the port does not import it).

Per-feature box-constraint maps.

Parity target: reference ``GLMSuite.createConstraintFeatureMap`` (photon-client
io/deprecated/GLMSuite.scala:49-126, 190-260): the constraint string is a JSON
array of ``{"name", "term", "lowerBound", "upperBound"}`` maps resolved
against the feature index map into per-index bounds. Reference rules kept:

1. ``name`` and ``term`` are required in every entry.
2. ``lowerBound`` / ``upperBound`` default to ∓∞; at least one must be
   finite, and lower < upper.
3. A wildcard name requires a wildcard term ("*"/"*" = all features except
   the intercept) and must be the only constraint.
4. A wildcard term applies to every feature whose key starts with
   ``name + DELIM``; overlapping constraints are an error.

Shape: instead of a sparse index→(lo, hi) map consumed by a
per-iteration projection loop, the result is a dense per-coordinate
``(lower, upper)`` vector pair fed straight into the box-constrained solvers
(L-BFGS-B / projected L-BFGS / TRON projection) as arrays.
"""

from __future__ import annotations

import json
import math
from typing import List, Optional, Tuple

import numpy as np

from photon_tpu_torch.data.index_map import IndexMap

WILDCARD = "*"

_NAME, _TERM = "name", "term"
_LOWER, _UPPER = "lowerBound", "upperBound"


def parse_constraint_entries(constraint_string: str) -> List[dict]:
    parsed = json.loads(constraint_string)
    if not isinstance(parsed, list):
        raise ValueError(
            f"constraint string must be a JSON array of maps, got: "
            f"{type(parsed).__name__}"
        )
    return parsed


def constraint_bound_vectors(
    constraint_string: Optional[str],
    index_map: IndexMap,
    dim: int,
    intercept_index: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Resolve a constraint JSON string to dense (lower, upper) vectors of
    length ``dim`` (unconstrained coordinates get ∓∞), or None if empty."""
    if not constraint_string:
        return None
    entries = parse_constraint_entries(constraint_string)
    lower = np.full((dim,), -np.inf, np.float32)
    upper = np.full((dim,), np.inf, np.float32)
    constrained: set = set()

    def add(idx: int, lo: float, hi: float, what: str) -> None:
        if idx in constrained:
            raise ValueError(
                f"conflicting constraints: feature {what} (index {idx}) is "
                f"constrained more than once"
            )
        constrained.add(idx)
        lower[idx], upper[idx] = lo, hi

    for entry in entries:
        if _NAME not in entry or _TERM not in entry:
            raise ValueError(
                f"every constraint map must carry '{_NAME}' and '{_TERM}' "
                f"keys; malformed entry: {entry}"
            )
        name, term = str(entry[_NAME]), str(entry[_TERM])
        lo = float(entry.get(_LOWER, -math.inf))
        hi = float(entry.get(_UPPER, math.inf))
        if not (lo > -math.inf or hi < math.inf):
            raise ValueError(
                f"both bounds infinite for feature name [{name}] term "
                f"[{term}] — an empty constraint"
            )
        if lo >= hi:
            raise ValueError(
                f"lower bound [{lo}] must be below upper bound [{hi}] for "
                f"feature name [{name}] term [{term}]"
            )

        if name == WILDCARD:
            if term != WILDCARD:
                raise ValueError(
                    "a wildcard name requires a wildcard term (reference "
                    "GLMSuite constraint semantics)"
                )
            if constrained:
                raise ValueError(
                    "an all-feature wildcard constraint cannot be combined "
                    "with other constraints"
                )
            for key, idx in index_map.items():
                if key == IndexMap.INTERCEPT or idx == intercept_index:
                    continue
                add(idx, lo, hi, key)
        elif term == WILDCARD:
            prefix = name + IndexMap.DELIM
            hits = [
                (key, idx)
                for key, idx in index_map.items()
                if key.startswith(prefix) or key == name
            ]
            if not hits:
                continue  # constraints for absent features are ignored
            for key, idx in hits:
                add(idx, lo, hi, key)
        else:
            idx = index_map.get_index(IndexMap.key(name, term))
            if idx < 0:
                continue  # absent feature: nothing to constrain
            add(idx, lo, hi, f"{name}/{term}")

    if not constrained:
        return None
    return lower, upper
