"""Streaming GAME updater driver: continuous gated micro-generations (port of
photon_tpu/cli/game_streaming.py; micro-batches and solves on ``--device``,
cuda unless ``--device cpu`` is given).

The driver closes the freshness loop at traffic speed. Where
``game_incremental`` runs ONE guarded generation per invocation from delta
files, this driver runs as a long-lived process against a *publish root*
and the serving side's feedback spool (``game_serving --feedback-spool``):

1. polls the spool for sealed segments of joined (request, label) records,
2. warm-starts from ``LATEST`` and re-trains only the entities those
   records touched (the same incremental machinery — row-level merge,
   active-set solves),
3. publishes each result as a per-entity DELTA layer (base + changed rows;
   ``--no-delta`` forces full generations) through the same validation gate
   and fsync'd ``LATEST`` pointer,
4. repeats on ``--cadence`` until stopped (or ``--max-cycles`` publishes,
   for bounded runs and tests).

The consume cursor lives in the generation manifests themselves
(``stream.consumedThrough``), so a killed and restarted updater never
double-applies a segment — see ``photon_tpu/stream/updater.py``.

Usage:

  python -m photon_tpu_torch.cli.game_streaming \\
    --publish-root out/ --spool-dir out/feedback/ \\
    --coordinate-configurations name=global,feature.shard=globalShard \\
      name=perUser,feature.shard=globalShard,random.effect.type=userId \\
    --update-sequence global,perUser --cadence 5 --lock-coordinates global
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import threading
from typing import Dict

from photon_tpu_torch.cli.common import (
    add_device_arg,
    close_otlp,
    drop_otlp,
    install_otlp,
    parse_coordinate_config,
    resolve_device,
    setup_logging,
    task_of,
)
from photon_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("game-streaming")
    p.add_argument("--publish-root", required=True,
                   help="a game_training output dir: generations + LATEST "
                        "pointer + index-map-*.json / entity-index-*.json; "
                        "micro-generations are written as subdirs here")
    p.add_argument("--spool-dir", required=True,
                   help="the feedback spool directory game_serving writes "
                        "(sealed segment-*.jsonl files are consumed)")
    p.add_argument("--coordinate-configurations", nargs="+", required=True)
    p.add_argument("--update-sequence", required=True,
                   help="comma-separated coordinate ids")
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.name for t in TaskType])
    p.add_argument("--cadence", type=float, default=5.0,
                   help="seconds between spool polls")
    p.add_argument("--min-records", type=int, default=8,
                   help="skip the solve until at least this many joined "
                        "records are pending (segments accumulate)")
    p.add_argument("--max-segments", type=int, default=64,
                   help="cap on segments folded into one micro-generation")
    p.add_argument("--max-cycles", type=int, default=None,
                   help="stop after this many publishes (default: run until "
                        "signalled)")
    p.add_argument("--lock-coordinates", default="",
                   help="comma-separated coordinate ids to keep fixed "
                        "(typically the fixed effects: micro-batches are "
                        "too small to re-fit the global model)")
    p.add_argument("--updater-shards", type=int, default=1,
                   help="total updater shards in the freshness plane: "
                        "records route to shards by entity hash on the "
                        "serving ring, so each shard owns a disjoint entity "
                        "subset and publishes commuting delta layers")
    p.add_argument("--shard-index", type=int, default=None,
                   help="run ONLY this shard worker (one process per shard, "
                        "the fleet layout); default with --updater-shards>1 "
                        "runs every shard as a thread in this process")
    p.add_argument("--route-re-type", default=None,
                   help="random-effect type whose entity id records route "
                        "on (default: route_key's deterministic fallback "
                        "order, same as serving)")
    p.add_argument("--route-spool", action="store_true",
                   help="materialize the shard partition: a router thread "
                        "splits each sealed segment once into per-shard "
                        "sub-spools under <spool-dir>/.shards/ and workers "
                        "consume only their own — aggregate throughput then "
                        "scales with shard count instead of plateauing at "
                        "the read-side routing scan (threads mode only; a "
                        "--shard-index fleet process should point "
                        "--spool-dir at its pre-routed shard dir instead)")
    p.add_argument("--no-delta", action="store_true",
                   help="publish full generations instead of delta layers")
    p.add_argument("--full-every", type=int, default=0,
                   help="force every k-th publish to be a full generation, "
                        "bounding delta-chain length (0: never force)")
    p.add_argument("--holdout-fraction", type=float, default=0.0,
                   help="fraction of records held out (deterministically) "
                        "for the gate's regression bound; 0 disables")
    p.add_argument("--late-replay-cadence", type=float, default=0.0,
                   help="seconds between late-label replay passes: the "
                        "spool sidecar's (evicted, late_label) pairs "
                        "re-join and retrain into a corrective delta "
                        "through the unchanged gate; 0 disables")
    p.add_argument("--late-replay-min-pairs", type=int, default=8,
                   help="skip a replay pass until at least this many fresh "
                        "joined sidecar pairs exist")
    p.add_argument("--fe-retrain", action="store_true",
                   help="actuate stream_fe_retrain_wanted: when the locked "
                        "fixed effect exceeds --fe-max-age, publish a "
                        "cooldown-guarded full generation with the FE "
                        "coordinate unlocked (counts in "
                        "stream_fe_retrains_total)")
    p.add_argument("--fe-max-age", type=float, default=3600.0,
                   help="seconds before the locked FE's age burns the "
                        "fe_age_s objective and raises the retrain trigger")
    p.add_argument("--fe-retrain-cooldown", type=float, default=600.0,
                   help="minimum seconds between FE retrain attempts "
                        "(failed attempts burn the cooldown too)")
    p.add_argument("--evaluators", nargs="*", default=["AUC"])
    p.add_argument("--metric-tolerance", type=float, default=0.02)
    p.add_argument("--norm-drift-bound", type=float, default=10.0)
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--re-convergence-tol", type=float, default=1e-4)
    p.add_argument(
        "--re-device-budget-mb", type=float, default=None,
        help="device byte budget for random-effect block data during "
             "per-cycle fits (out-of-core residency; None = fully "
             "resident)",
    )
    p.add_argument(
        "--re-spill-dir", default=None,
        help="spill root for the out-of-core host master; sharded "
             "updaters spill under host-<shard>/ (host-owned layout) so "
             "a shard-count rebalance is a file move, not a re-stream "
             "(shard_router.rebalance_updater_spill)",
    )
    p.add_argument("--telemetry-out", default=None)
    p.add_argument("--otlp-endpoint", default=None,
                   help="base URL of an OTLP/HTTP collector accepting JSON; "
                        "updater cycle spans and the metrics registry export "
                        "there (bounded queue, drop-and-count on outage)")
    p.add_argument("--otlp-metrics-interval", type=float, default=15.0,
                   help="seconds between registry-snapshot exports (0 = "
                        "spans only)")
    add_device_arg(p)
    p.add_argument("--verbose", action="store_true")
    return p


def run(args) -> Dict:
    setup_logging(args.verbose)
    from photon_tpu_torch.obs import begin_run

    begin_run()
    device = resolve_device(args.device)
    exporter = install_otlp(args, "photon-tpu-streaming")
    try:
        return _stream(args, device, exporter)
    except BaseException:
        drop_otlp(exporter)
        raise


def _stream(args, device, exporter) -> Dict:
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.obs import finalize_run_report
    from photon_tpu_torch.stream.updater import (
        StreamingUpdater,
        StreamingUpdaterConfig,
    )

    task = task_of(args)
    coord_configs = [
        parse_coordinate_config(s) for s in args.coordinate_configurations
    ]
    update_sequence = [
        s.strip() for s in args.update_sequence.split(",") if s.strip()
    ]
    by_id = {c.coordinate_id: c for c in coord_configs}
    coord_configs = [by_id[cid] for cid in update_sequence]

    # The publish root's artifacts are authoritative — the updater joins a
    # lineage the batch trainer started, it never invents a feature space.
    index_maps = {}
    for fn in os.listdir(args.publish_root):
        if fn.startswith("index-map-") and fn.endswith(".json"):
            shard = fn[len("index-map-"):-len(".json")]
            index_maps[shard] = IndexMap.load(
                os.path.join(args.publish_root, fn)
            )
    entity_indexes = {}
    for fn in os.listdir(args.publish_root):
        if fn.startswith("entity-index-") and fn.endswith(".json"):
            re_type = fn[len("entity-index-"):-len(".json")]
            entity_indexes[re_type] = EntityIndex.load(
                os.path.join(args.publish_root, fn)
            )
    if not index_maps:
        raise SystemExit(
            f"no index-map-*.json under {args.publish_root!r}: the publish "
            "root must come from a game_training run"
        )

    num_shards = max(1, int(args.updater_shards))
    route_spool = bool(getattr(args, "route_spool", False)) and num_shards > 1
    if route_spool and args.shard_index is not None:
        raise SystemExit(
            "--route-spool runs the router in-process (threads mode); a "
            "fleet shard process should point --spool-dir at its "
            "pre-routed <spool-dir>/.shards/shard-<k> directory instead"
        )
    if route_spool and any(c in args.spool_dir for c in "*?["):
        raise SystemExit(
            "--route-spool needs a single literal --spool-dir (the router "
            "splits one raw spool); multi-spool globs use read-side "
            "routing, which needs no router"
        )
    routed_root = os.path.join(args.spool_dir, ".shards")
    if args.shard_index is not None:
        # One process per shard — the fleet layout. Siblings run elsewhere
        # against the same publish root; the flock'd publish tail and the
        # per-shard manifest cursors are the only coordination.
        shard_indexes = [int(args.shard_index)]
    else:
        shard_indexes = list(range(num_shards))

    def make_updater(shard_index: int) -> StreamingUpdater:
        # Each worker gets its OWN artifact copies (the process-per-shard
        # semantics, emulated in threads): interning is then shard-local,
        # and disjoint routing means no entity id is ever interned by two
        # workers — artifacts stay string-keyed and composable.
        imaps = copy.deepcopy(index_maps)
        eidxs = copy.deepcopy(entity_indexes)
        from photon_tpu_torch.stream.shard_router import shard_spool_dir

        spool_dir = (
            shard_spool_dir(routed_root, shard_index)
            if route_spool else args.spool_dir
        )
        return StreamingUpdater(
            StreamingUpdaterConfig(
                publish_root=args.publish_root,
                spool_dir=spool_dir,
                task=task,
                coordinate_configs=coord_configs,
                update_sequence=update_sequence,
                cadence_s=args.cadence,
                min_records=args.min_records,
                max_segments_per_cycle=args.max_segments,
                locked_coordinates=[
                    s for s in args.lock_coordinates.split(",") if s
                ],
                delta_artifacts=not args.no_delta,
                full_every=args.full_every,
                holdout_fraction=args.holdout_fraction,
                evaluators=list(args.evaluators),
                metric_tolerance=args.metric_tolerance,
                norm_drift_bound=args.norm_drift_bound,
                num_iterations=args.coordinate_descent_iterations,
                re_convergence_tol=args.re_convergence_tol,
                re_device_budget_mb=args.re_device_budget_mb,
                re_spill_dir=args.re_spill_dir,
                num_shards=num_shards,
                shard_index=shard_index,
                route_re_type=args.route_re_type,
                pre_routed=route_spool,
                fe_max_age_s=args.fe_max_age,
                fe_retrain=bool(args.fe_retrain),
                fe_retrain_cooldown_s=args.fe_retrain_cooldown,
                late_replay_cadence_s=args.late_replay_cadence,
                late_replay_min_pairs=args.late_replay_min_pairs,
                device=str(device),
            ),
            imaps if num_shards > 1 else index_maps,
            eidxs if num_shards > 1 else entity_indexes,
        )

    updaters = [make_updater(k) for k in shard_indexes]
    router_stop = threading.Event()
    router_thread = None
    if route_spool:
        from photon_tpu_torch.stream.shard_router import route_segments

        # Route everything already sealed BEFORE workers start (so bounded
        # --max-cycles runs see their traffic), then keep splitting new
        # segments as they seal. Routing is idempotent, so a crash or
        # restart anywhere in this loop is harmless.
        def _route_loop():
            while not router_stop.is_set():
                try:
                    route_segments(
                        args.spool_dir, routed_root, num_shards,
                        route_re_type=args.route_re_type,
                    )
                except Exception:  # noqa: BLE001 — retried next pass
                    logger.exception("spool routing pass failed")
                router_stop.wait(min(float(args.cadence), 1.0))

        route_segments(
            args.spool_dir, routed_root, num_shards,
            route_re_type=args.route_re_type,
        )
        router_thread = threading.Thread(
            target=_route_loop, name="spool-router", daemon=True
        )
        router_thread.start()
    cycles = 0
    try:
        if len(updaters) == 1:
            cycles = updaters[0].run_forever(max_cycles=args.max_cycles)
        else:
            threads = [
                threading.Thread(
                    target=u.run_forever,
                    kwargs={"max_cycles": args.max_cycles},
                    name=f"updater-shard-{u.config.shard_index}",
                    daemon=True,
                )
                for u in updaters
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            cycles = sum(u.stats()["cycles"] for u in updaters)
    except KeyboardInterrupt:
        for u in updaters:
            u.stop()
        cycles = sum(u.stats()["cycles"] for u in updaters)
    finally:
        router_stop.set()
        if router_thread is not None:
            router_thread.join(timeout=5.0)
    finalize_run_report("game_streaming", path=args.telemetry_out)
    close_otlp(exporter)
    all_stats = [u.stats() for u in updaters]
    out = {
        "cycles": cycles,
        "publishes": sum(s["publishes"] for s in all_stats),
        "consumedThrough": max(s["consumed_through"] for s in all_stats),
        # Seconds inside cycles and inside their train-and-publish steps.
        "busyS": sum(s["busy_s"] for s in all_stats),
        "trainS": sum(s["train_s"] for s in all_stats),
    }
    if num_shards > 1:
        out["shards"] = {
            str(u.config.shard_index): {
                "cycles": s["cycles"],
                "publishes": s["publishes"],
                "consumedThrough": s["consumed_through"],
            }
            for u, s in zip(updaters, all_stats)
        }
    return out


def main(argv=None):
    summary = run(build_parser().parse_args(argv))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
