"""Training-side orchestration above the estimators (port of
photon_tpu/train/): incremental generation-over-generation updates
(train/incremental.py). The estimators fit models; this package owns the
lifecycle around them — parent loading, changed-entity selection, merge,
manifest, validation gate.
"""
