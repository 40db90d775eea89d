"""Copy of photon_tpu/hyperparameter/serialization.py (numpy and scipy only).

Hyperparameter configuration / prior-observation JSON (de)serialization.

Parity target: reference ``HyperparameterSerialization``
(photon-lib hyperparameter/HyperparameterSerialization.scala) and the
transform/scaling rules of ``VectorRescaling``
(hyperparameter/VectorRescaling.scala): a JSON config names the tuning mode
and the variables with {type, min, max, transform}; prior observations are
records of {param: value, ..., "evaluationValue": v}; transforms are LOG
(log10) and SQRT, applied per-index forward (raw → search space) and
backward (search space → raw).

Addition over the reference: ``observations_to_json`` — the tuner's search
history is persisted alongside TUNED models so later runs can seed
``prior_from_json`` with it (the reference can only read priors, not write
them).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_tpu_torch.hyperparameter.tuner import TuningMode

LOG_TRANSFORM = "LOG"
SQRT_TRANSFORM = "SQRT"


@dataclasses.dataclass(frozen=True)
class HyperparameterConfig:
    """Parsed tuning config (reference HyperparameterConfig)."""

    mode: Optional[TuningMode]  # None = NONE
    names: List[str]
    lower: np.ndarray  # raw-space bounds, per variable
    upper: np.ndarray
    discrete: Dict[int, int]  # index -> number of grid points (INT vars)
    transforms: Dict[int, str]  # index -> LOG | SQRT


def _apply(v: float, transform: str, forward: bool) -> float:
    if transform == LOG_TRANSFORM:
        return math.log10(v) if forward else 10.0**v
    if transform == SQRT_TRANSFORM:
        return math.sqrt(v) if forward else v * v
    raise ValueError(f"unknown transformation: {transform}")


def transform_forward(x: np.ndarray, transforms: Dict[int, str]) -> np.ndarray:
    """Raw values → search space (VectorRescaling.transformForward)."""
    out = np.array(x, float)
    for i, t in transforms.items():
        out[i] = _apply(float(out[i]), t, forward=True)
    return out


def transform_backward(x: np.ndarray, transforms: Dict[int, str]) -> np.ndarray:
    """Search space → raw values (VectorRescaling.transformBackward)."""
    out = np.array(x, float)
    for i, t in transforms.items():
        out[i] = _apply(float(out[i]), t, forward=False)
    return out


def config_from_json(json_config: str) -> HyperparameterConfig:
    """Parse a tuning config (HyperparameterSerialization.configFromJson)."""
    raw = json.loads(json_config)
    if not isinstance(raw, dict):
        raise ValueError("JSON config is not an object")
    mode_str = raw.get("tuning_mode", "NONE")
    mode = TuningMode[mode_str] if mode_str in TuningMode.__members__ else None

    variables = raw.get("variables")
    if not isinstance(variables, dict):
        raise ValueError("the hyper-parameter configurations must be a map")
    names, lower, upper = [], [], []
    discrete: Dict[int, int] = {}
    transforms: Dict[int, str] = {}
    for idx, (name, spec) in enumerate(variables.items()):
        if not isinstance(spec, dict) or "min" not in spec or "max" not in spec:
            raise ValueError(f"variable {name!r} needs numeric min/max")
        names.append(name)
        lo, hi = float(spec["min"]), float(spec["max"])
        lower.append(lo)
        upper.append(hi)
        if spec.get("type") == "INT":
            discrete[idx] = int(hi - lo) + 1
        t = spec.get("transform")
        if t is not None:
            if t not in (LOG_TRANSFORM, SQRT_TRANSFORM):
                raise ValueError(f"the transformation is not valid: {t}")
            transforms[idx] = t
    return HyperparameterConfig(
        mode=mode,
        names=names,
        lower=np.asarray(lower),
        upper=np.asarray(upper),
        discrete=discrete,
        transforms=transforms,
    )


def prior_from_json(
    prior_json: str,
    prior_default: Dict[str, float],
    names: Sequence[str],
) -> List[Tuple[np.ndarray, float]]:
    """Parse prior observations (HyperparameterSerialization.priorFromJson):
    {"records": [{<param>: <value>, ..., "evaluationValue": v}, ...]} →
    [(raw-space vector ordered by ``names``, value)]. Missing parameters
    fall back to ``prior_default``."""
    raw = json.loads(prior_json)
    if not isinstance(raw, dict) or not isinstance(raw.get("records"), list):
        raise ValueError('prior JSON must be {"records": [...]}')
    out = []
    for rec in raw["records"]:
        value = float(rec["evaluationValue"])
        vec = np.asarray(
            [float(rec[n]) if n in rec else float(prior_default[n]) for n in names],
            float,
        )
        out.append((vec, value))
    return out


def observations_to_json(
    observations: Sequence[Tuple[np.ndarray, float]],
    names: Sequence[str],
) -> str:
    """Serialize a search history to the prior-observation format."""
    records = []
    for x, v in observations:
        rec = {n: float(xi) for n, xi in zip(names, np.asarray(x, float))}
        rec["evaluationValue"] = float(v)
        records.append(rec)
    return json.dumps({"records": records}, indent=2)
