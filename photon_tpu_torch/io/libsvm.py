"""Copy of photon_tpu/io/libsvm.py (framework-free; the port does not import it).

LIBSVM text format support.

Parity targets: reference ``LibSVMInputDataFormat``
(photon-client io/deprecated/LibSVMInputDataFormat.scala) and the dev script
``libsvm_text_to_trainingexample_avro.py`` (dev-scripts/) used by the README's
a1a demo workload (README.md:240-304).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from photon_tpu_torch.io.avro import write_avro_records
from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA


def read_libsvm(
    path: str, dim: Optional[int] = None, zero_based: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a LIBSVM file → (dense X (n, d), y (n,)). Labels -1/+1 map to
    0/1; multi-label values pass through."""
    rows: List[List[Tuple[int, float]]] = []
    labels: List[float] = []
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            y = float(parts[0])
            labels.append(1.0 if y > 0 else 0.0 if y in (-1.0, 0.0) else y)
            feats = []
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break
                k, v = tok.split(":")
                j = int(k) - (0 if zero_based else 1)
                feats.append((j, float(v)))
                max_idx = max(max_idx, j)
            rows.append(feats)
    d = dim if dim is not None else max_idx + 1
    X = np.zeros((len(rows), d), np.float32)
    for i, feats in enumerate(rows):
        for j, v in feats:
            if j < d:
                X[i, j] = v
    return X, np.asarray(labels, np.float32)


def libsvm_to_training_example_avro(
    libsvm_path: str, avro_path: str, zero_based: bool = False
) -> int:
    """LIBSVM text → TrainingExampleAvro container (dev-script parity).
    Feature names are the 1-based libsvm indices as strings, matching the
    converter's convention. Returns the number of records written."""
    records = []
    with open(libsvm_path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            y = float(parts[0])
            feats = []
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break
                k, v = tok.split(":")
                feats.append({"name": k, "term": "", "value": float(v)})
            records.append(
                {
                    "uid": str(i),
                    "label": 1.0 if y > 0 else 0.0,
                    "features": feats,
                    "metadataMap": None,
                    "weight": 1.0,
                    "offset": 0.0,
                }
            )
    write_avro_records(avro_path, TRAINING_EXAMPLE_SCHEMA, records)
    return len(records)
