"""Streaming freshness loop (port of photon_tpu/stream/): serve-side feedback spool, continuous
micro-generation updater, per-entity delta model artifacts.

The three parts close the label → fresher-model-serving-traffic loop:

- :mod:`photon_tpu_torch.stream.spool` — crash-safe segment-rotated JSONL spool
  where the serving engine lands scored requests joined with later-arriving
  labels;
- :mod:`photon_tpu_torch.stream.updater` — long-running consumer that batches
  spool segments into warm-started per-entity solves and publishes
  micro-generations (delta artifacts, ``io/model_io.py``) through the
  existing validation gate and rollout watcher;
- the serving side applies delta layers in place
  (``serve/store.py:clone_with_delta`` + ``serve/engine.py:
  load_delta_version``) so multi-version residency and bit-exact shadow
  sampling keep working at micro-generation cadence.
"""

from photon_tpu_torch.stream.spool import (  # noqa: F401
    FeedbackSpool,
    SpoolConfig,
    read_segment,
    recover_segments,
    sealed_segments,
    segment_seq,
)
from photon_tpu_torch.stream.updater import (  # noqa: F401
    StreamingUpdater,
    StreamingUpdaterConfig,
)
