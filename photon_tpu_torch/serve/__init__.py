"""Online GAME serving (port of photon_tpu/serve): micro-batched scoring,
hot/cold entity residency, zero-downtime reload, the HTTP front end, and
the consistent-hash ring that the entity-sharded training path shares with
serving. See serve/engine.py for the composition; ``/v1/experiment``
(serve/frontend.py) rolls up the experiments of photon_tpu_torch/experiment.
The scorer fleet (serve/fleet.py) is not ported yet."""

from photon_tpu_torch.serve.admission import (
    BATCH,
    INTERACTIVE,
    AdmissionConfig,
    AdmissionController,
    FleetAdmissionLedger,
    QuotaExceededError,
    TokenBucket,
    parse_tenant_rates,
)
from photon_tpu_torch.serve.batcher import BackpressureError, DeadlineExceededError, MicroBatcher, ScoreRequest
from photon_tpu_torch.serve.engine import ReloadError, ServeConfig, ServingEngine, load_engine
from photon_tpu_torch.serve.frontend import ScorerClient, ScorerServer, ServingFrontend
from photon_tpu_torch.serve.routing import HashRing, route_key, stable_hash
from photon_tpu_torch.serve.store import HotColdEntityStore, StorePartition

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "BackpressureError",
    "BATCH",
    "DeadlineExceededError",
    "FleetAdmissionLedger",
    "HashRing",
    "HotColdEntityStore",
    "INTERACTIVE",
    "MicroBatcher",
    "QuotaExceededError",
    "ReloadError",
    "ScoreRequest",
    "ScorerClient",
    "ScorerServer",
    "ServeConfig",
    "ServingEngine",
    "ServingFrontend",
    "StorePartition",
    "TokenBucket",
    "load_engine",
    "parse_tenant_rates",
    "route_key",
    "stable_hash",
]
