"""Online GAME serving (port of photon_tpu/serve): micro-batched scoring,
hot/cold entity residency, zero-downtime reload, the HTTP front end, and
the consistent-hash ring that the entity-sharded training path shares with
serving, and the scorer fleet. See serve/engine.py for the single-process
composition, serve/fleet.py for the multi-replica topology (its replicas
spawned processes, each with a CUDA context of its own; the fleet relay
server is not ported yet); ``/v1/experiment`` (serve/frontend.py) rolls up
the experiments of photon_tpu_torch/experiment."""

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
from photon_tpu_torch.serve.fleet import (
    DEAD,
    DRAINING,
    LIVE,
    FleetBackend,
    FleetHTTPFrontend,
    FleetRouter,
    ReplicaScorerServer,
    ScorerFleet,
    partition_from_snapshot,
)
from photon_tpu_torch.serve.frontend import ScorerClient, ScorerServer, ServingFrontend
from photon_tpu_torch.serve.routing import HashRing, route_key, stable_hash
from photon_tpu_torch.serve.store import HotColdEntityStore, StorePartition

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "BackpressureError",
    "BATCH",
    "DEAD",
    "DRAINING",
    "DeadlineExceededError",
    "FleetAdmissionLedger",
    "FleetBackend",
    "FleetHTTPFrontend",
    "FleetRouter",
    "HashRing",
    "HotColdEntityStore",
    "INTERACTIVE",
    "LIVE",
    "MicroBatcher",
    "QuotaExceededError",
    "ReloadError",
    "ReplicaScorerServer",
    "ScoreRequest",
    "ScorerClient",
    "ScorerFleet",
    "ScorerServer",
    "ServeConfig",
    "ServingEngine",
    "ServingFrontend",
    "StorePartition",
    "TokenBucket",
    "load_engine",
    "parse_tenant_rates",
    "partition_from_snapshot",
    "route_key",
    "stable_hash",
]
