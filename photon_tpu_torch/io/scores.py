"""Copy of photon_tpu/io/scores.py (framework-free; the port does not import it).

Score output (ScoringResultAvro writer/reader).

Parity target: reference ``ScoreProcessingUtils``
(photon-client data/avro/ScoreProcessingUtils.scala).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from photon_tpu_torch.io.avro import read_avro_records, write_avro_records
from photon_tpu_torch.io.schemas import SCORING_RESULT_SCHEMA


def save_scores(
    path: str,
    scores: np.ndarray,
    model_id: str,
    uids: Optional[Sequence[str]] = None,
    labels: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
) -> None:
    scores = np.asarray(scores)

    def records():
        # Generator: the block writer consumes rows as produced, so the
        # per-row record dicts never materialize all at once.
        for i, s in enumerate(scores):
            yield {
                "uid": None if uids is None else str(uids[i]),
                "label": None if labels is None else float(labels[i]),
                "modelId": model_id,
                "predictionScore": float(s),
                "weight": None if weights is None else float(weights[i]),
                "metadataMap": None,
            }

    write_avro_records(path, SCORING_RESULT_SCHEMA, records())


def load_scores(path: str) -> List[dict]:
    return read_avro_records(path)
