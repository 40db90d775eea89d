"""Port of photon_tpu/experiment/manager.py: the candidates train on the
torch device, and a serving process trains them in one spawned process.

Continuous online experiment plane: GP-EI rounds over live traffic.

1. propose — ``hyperparameter.search.GaussianProcessSearch.next_batch(q)``
   proposes q regularization points per round (top-q EI from one posterior).
2. train — each point trains a WARM-STARTED candidate generation via
   ``train/incremental.py`` (``optimization_config`` pins the exact λ), with
   ``publish=False``: a candidate never touches ``LATEST``.
3. serve — candidates load into the multi-version ``ServingEngine`` and
   shadow live primary traffic as N CONCURRENT lanes (engine lanes are
   deterministic fractional splits; versions differ only by table values,
   so N candidates add no capture on the request path).
4. observe — the GP's observation is the candidate's ONLINE quality
   (streaming AUC / loss from the quality plane's per-model-version
   windows), not an offline holdout.
5. gate — a candidate whose online quality burns against the primary is
   POISONED (``mark_poisoned`` + lane stop; the same poison list the
   rollout watcher honors); the winner promotes through the unchanged
   generation-manifest gate (``gate_and_publish`` → LATEST).

Crash-safety: the generation manifests ARE the experiment store. Every
candidate's manifest carries an ``experiment`` tag
(``{id, round, params, paramsKey, observation?, status}``, byte for byte the
reference's); a killed manager re-proposes each round deterministically
(seeded Sobol + GP), matches proposals against the tags by ``paramsKey``,
and re-trains only what has no durable record. There is no side state file
to lose, and a root written by either package resumes in the other.

Where the candidates train. A fit in the serving process would allocate on
the card while the engine serves (the engine counts new allocator segments
as retraces) and its captures would hold the solve cache's capture lock
against live scoring, so :class:`SpawnedCandidateTrainer` runs the fits in
ONE spawned process kept for the whole run; the engine-less train-only
mode trains in process (:class:`IncrementalCandidateTrainer`). After each
round the engine drops the round's losers (only the best candidate so far
stays resident), so device memory returns to its level round after round.

Fault sites (utils/faults.py plans):
- ``experiment.trained`` — fired after a candidate's training is durably
  complete (kill rules SIGKILL the manager mid-round; the resume drill).
- ``experiment.regress`` — fired before a candidate trains; a hit swaps
  the proposed point for a pathologically over-regularized configuration
  (the injected-regression candidate the quality burn must catch).
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import logging
import math
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.estimators.config import GameOptimizationConfig, RegularizationConfig
from photon_tpu_torch.hyperparameter.search import GaussianProcessSearch, SearchRange
from photon_tpu_torch.io.model_io import (
    experiment_generations,
    gate_and_publish,
    mark_poisoned,
    update_generation_manifest,
)
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.obs.trace import span
from photon_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

# Reference defaults (GameEstimatorEvaluationFunction.scala:242-243).
DEFAULT_REG_WEIGHT_RANGE = (1e-4, 1e4)
DEFAULT_REG_ALPHA_RANGE = (0.0, 1.0)


def _short(version: object) -> str:
    return os.path.basename(str(version or "").rstrip("/"))


class ExperimentSpace:
    """Hyperparameter space of one experiment: per coordinate (sorted by
    id), log10(regularization weight) — plus the elastic-net alpha when the
    base configuration mixes (same tunable-slot rule as the offline
    adapter, estimators/evaluation_function.py). Maps GP vectors ↔
    ``GameOptimizationConfig`` and defines the stable ``paramsKey`` the
    crash-resume matching keys on."""

    def __init__(
        self,
        base_config: GameOptimizationConfig,
        reg_weight_range: Tuple[float, float] = DEFAULT_REG_WEIGHT_RANGE,
        reg_alpha_range: Tuple[float, float] = DEFAULT_REG_ALPHA_RANGE,
    ):
        self.base_config = base_config
        self._slots: List[Tuple[str, str]] = []  # (coordinate id, kind)
        lowers: List[float] = []
        uppers: List[float] = []
        for cid in sorted(base_config.reg):
            reg = base_config.reg[cid]
            if reg.weight <= 0.0:
                continue  # unregularized in the base config: not tuned
            self._slots.append((cid, "weight"))
            lowers.append(math.log10(reg_weight_range[0]))
            uppers.append(math.log10(reg_weight_range[1]))
            if reg.alpha > 0.0:
                self._slots.append((cid, "alpha"))
                lowers.append(reg_alpha_range[0])
                uppers.append(reg_alpha_range[1])
        if not self._slots:
            raise ValueError(
                "experiment space is empty: no coordinate in the base "
                "configuration carries a positive regularization weight"
            )
        self.search_range = SearchRange(np.asarray(lowers, float), np.asarray(uppers, float))

    @property
    def dim(self) -> int:
        return len(self._slots)

    @property
    def names(self) -> List[str]:
        return [f"{cid}.{kind}" for cid, kind in self._slots]

    def params_from_vector(self, x: np.ndarray) -> Dict[str, float]:
        return {name: float(v) for name, v in zip(self.names, np.asarray(x, float))}

    def vector_to_config(self, x: np.ndarray) -> GameOptimizationConfig:
        if len(x) != self.dim:
            raise ValueError(f"dimension mismatch: {len(x)} != {self.dim}")
        reg = dict(self.base_config.reg)
        for (cid, kind), v in zip(self._slots, np.asarray(x, float)):
            old = reg[cid]
            if kind == "weight":
                reg[cid] = RegularizationConfig(weight=float(10.0 ** v), alpha=old.alpha)
            else:
                reg[cid] = RegularizationConfig(weight=old.weight, alpha=float(v))
        return GameOptimizationConfig(reg)

    def regressed_config(self) -> GameOptimizationConfig:
        """A pathologically over-regularized configuration (every tuned
        weight → 1e8): the tuned coordinates shrink to ~zero, which is the
        injected-regression candidate the quality burn must poison."""
        reg = dict(self.base_config.reg)
        for cid, kind in self._slots:
            if kind == "weight":
                reg[cid] = RegularizationConfig(weight=1e8, alpha=reg[cid].alpha)
        return GameOptimizationConfig(reg)


def point_key(params: Dict[str, float]) -> str:
    """Stable identity of one proposed point: sha1 over the
    name-sorted, 6-decimal-rounded params JSON. Rounding keeps the key
    identical across platforms whose float repr differs in the last ulps;
    6 decimals in log10-λ space is far below any training-visible
    difference."""
    canon = json.dumps({k: round(float(v), 6) for k, v in sorted(params.items())}, sort_keys=True)
    return hashlib.sha1(canon.encode()).hexdigest()[:12]


@dataclasses.dataclass
class Candidate:
    """One proposed point's lifecycle within a round."""

    round: int
    index: int  # position within the round's proposal batch
    point: np.ndarray  # search-space vector (log10 weights / alphas)
    params: Dict[str, float]
    key: str
    generation: str
    model_dir: Optional[str] = None
    observation: Optional[float] = None
    source: Optional[str] = None  # online | stamped | penalty
    status: str = "proposed"  # proposed|trained|observed|poisoned
    poison_reason: Optional[str] = None
    reused: bool = False  # resumed from a durable manifest record
    train_s: Optional[float] = None  # wall of this run's training call


@dataclasses.dataclass
class ExperimentConfig:
    experiment_id: str
    publish_root: str
    rounds: int = 3
    candidates_per_round: int = 4
    seed: int = 7
    shadow_fraction: float = 0.5
    # Online observation: candidates must accumulate this many label-joined
    # events before their quality reading counts (None = the quality
    # plane's own min_events).
    min_events: Optional[int] = None
    observe_timeout_s: float = 120.0
    observe_poll_s: float = 0.25
    # Objective read from the quality plane, lower-is-better for the GP:
    # "loss" = windowed mean loss (logloss / Poisson deviance / task loss),
    # "auc" = 1 − windowed AUC (classification tasks).
    objective: str = "loss"
    # Quality burn (per-candidate poison gate): a candidate is poisoned
    # after `burn_checks` consecutive polls where its pooled windowed
    # quality is worse than the PRIMARY's by more than the bound
    # (auc_drop_bound for AUC; relative loss excess for loss objectives).
    auc_drop_bound: Optional[float] = None  # None = quality config's bound
    loss_burn_ratio: float = 0.5  # cand_loss > prim_loss · (1 + ratio)
    burn_checks: int = 2
    # Observation stamped for a poisoned candidate: worst finite
    # observation so far + this margin (recorded durably, so a resumed
    # manager replays the identical value).
    poison_margin: float = 1.0
    promote_winner: bool = True
    metric_tolerance: float = 0.02
    norm_drift_bound: float = 10.0
    gp_num_candidates: int = 256
    gp_min_observations: int = 3


class ExperimentManager:
    """Drives one experiment: GP rounds → warm-started candidate
    generations → concurrent shadow lanes → online observations → poison /
    promote. ``trainer`` must provide ``train(config, generation,
    extra_manifest) -> model_dir`` and ``load(model_dir) -> GameModel``
    (the engine's host master; see :class:`IncrementalCandidateTrainer`);
    ``engine`` is the live :class:`~photon_tpu_torch.serve.ServingEngine`
    (may be None for the train-only resume path — a manager without an
    engine can rebuild round state and train missing candidates but never
    observes). ``round_log`` records each round's walls and, with an
    engine, the versions resident and the device bytes allocated after the
    round's losers were dropped."""

    def __init__(self, config: ExperimentConfig, space: ExperimentSpace, trainer, engine=None):
        self.cfg = config
        self.space = space
        self.trainer = trainer
        self.engine = engine
        self.search = GaussianProcessSearch(
            dim=space.dim,
            evaluator=None,  # observations arrive from the quality plane
            search_range=space.search_range,
            seed=config.seed,
            num_candidates=config.gp_num_candidates,
            min_observations=config.gp_min_observations,
        )
        self.candidates: List[Candidate] = []
        self.reused_trained = 0
        self.reused_observed = 0
        self.trained = 0
        self.poisoned: List[str] = []
        self.winner: Optional[Candidate] = None
        self.round_log: List[dict] = []

    # -- naming / durable records -------------------------------------------

    def _generation_name(self, rnd: int, key: str) -> str:
        return f"exp-{self.cfg.experiment_id}-r{rnd}-{key}"

    def _scan(self) -> Dict[Tuple[int, str], dict]:
        recs = experiment_generations(self.cfg.publish_root, self.cfg.experiment_id)
        return {(int(r["round"]), str(r["paramsKey"])): r for r in recs if "paramsKey" in r}

    def _experiment_tag(self, cand: Candidate) -> dict:
        return dict(
            id=self.cfg.experiment_id,
            round=cand.round,
            index=cand.index,
            params=cand.params,
            paramsKey=cand.key,
            status=cand.status,
        )

    def _stamp(self, cand: Candidate, **extra) -> None:
        if cand.model_dir is None:
            return
        tag = self._experiment_tag(cand)
        if cand.observation is not None:
            tag["observation"] = float(cand.observation)
            tag["observationSource"] = cand.source
        if cand.poison_reason:
            tag["poisonReason"] = cand.poison_reason
        tag.update(extra)
        update_generation_manifest(cand.model_dir, {"experiment": tag})

    # -- the round loop ------------------------------------------------------

    def run(self, train_only: bool = False) -> dict:
        """Run (or RESUME) the experiment to completion. Every round is
        re-proposed deterministically and matched against durable manifest
        records, so a crashed manager continues exactly where the disk
        says it stopped — completed candidates are never re-trained,
        stamped observations are never re-measured.

        ``train_only=True`` trains missing candidates round by round but
        never observes; it stops at the first round whose observations are
        not already durable (an engine-less manager cannot measure)."""
        reg = registry()
        recs = self._scan()
        for rnd in range(self.cfg.rounds):
            reg.gauge("experiment_round", experiment=self.cfg.experiment_id).set(rnd)
            t_round = time.perf_counter()
            with span(f"experiment/round{rnd}"):
                cands = self._propose_round(rnd, recs)
                self._train_missing(cands)
                t_trained = time.perf_counter()
                pending = [c for c in cands if c.observation is None]
                if pending:
                    if train_only:
                        logger.info(
                            "experiment %s: train-only mode stopping at round %d (%d candidates lack "
                            "observations)", self.cfg.experiment_id, rnd, len(pending),
                        )
                        self._log_round(rnd, t_round, t_trained)
                        return self.summary()
                    self._observe_round(cands)
                for c in sorted(cands, key=lambda c: c.index):
                    self.search.observe(c.point, float(c.observation))
                self._release_losers()
            self._log_round(rnd, t_round, t_trained)
            reg.counter("experiment_rounds_total", experiment=self.cfg.experiment_id).inc()
        if not train_only and self.cfg.promote_winner:
            self._promote_winner()
        return self.summary()

    def _log_round(self, rnd: int, t_round: float, t_trained: float) -> None:
        now = time.perf_counter()
        entry = dict(round=rnd, wallS=now - t_round, trainS=t_trained - t_round, observeS=now - t_trained,
                     trained={c.generation: c.train_s for c in self.candidates
                              if c.round == rnd and c.train_s is not None})
        if self.engine is not None:
            entry["resident"] = [_short(v) for v in self.engine.versions]
            device = getattr(self.engine, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                entry["deviceBytes"] = int(torch.cuda.memory_allocated(device))
        self.round_log.append(entry)

    def _propose_round(self, rnd: int, recs: Dict[Tuple[int, str], dict]) -> List[Candidate]:
        X = self.search.next_batch(self.cfg.candidates_per_round)
        cands: List[Candidate] = []
        for i, x in enumerate(np.asarray(X, float)):
            params = self.space.params_from_vector(x)
            key = point_key(params)
            cand = Candidate(round=rnd, index=i, point=x, params=params, key=key,
                             generation=self._generation_name(rnd, key))
            rec = recs.get((rnd, key))
            if rec is not None:
                model_dir = os.path.join(self.cfg.publish_root, rec["generation"])
                if os.path.isdir(model_dir):
                    cand.model_dir = model_dir
                    cand.status = "trained"
                    cand.reused = True
                    self.reused_trained += 1
                if rec.get("observation") is not None:
                    cand.observation = float(rec["observation"])
                    cand.source = "stamped"
                    cand.status = str(rec.get("status") or "observed")
                    if cand.status == "poisoned":
                        cand.poison_reason = rec.get("poisonReason")
                    self.reused_observed += 1
            cands.append(cand)
        self.candidates.extend(cands)
        return cands

    def _train_missing(self, cands: Sequence[Candidate]) -> None:
        reg = registry()
        for cand in cands:
            if cand.model_dir is not None:
                continue
            config = self.space.vector_to_config(cand.point)
            regress = faults.injector().fire("experiment.regress", label=cand.generation)
            tag = self._experiment_tag(cand)
            if regress is not None:
                config = self.space.regressed_config()
                tag["regressed"] = True
                logger.warning("fault experiment.regress: candidate %s trains the over-regularized configuration",
                               cand.generation)
            t0 = time.perf_counter()
            with span("experiment/train"):
                cand.model_dir = self.trainer.train(config, cand.generation, {"experiment": tag})
            cand.train_s = time.perf_counter() - t0
            cand.status = "trained"
            self.trained += 1
            reg.counter("experiment_candidates_trained_total", experiment=self.cfg.experiment_id).inc()
            # The kill site sits AFTER the durable train record: a SIGKILL
            # here is the worst case the resume discipline must absorb —
            # trained, observed by nobody, manifest already on disk.
            faults.check("experiment.trained", label=cand.generation)

    # -- online observation --------------------------------------------------

    def _quality_pool(self, version: str):
        """Pooled (over tenant / re_type) windowed accumulator for one
        model version, or None when the plane has nothing for it."""
        short = _short(version)
        out = None
        for key, acc in self.engine.quality.window_totals().items():
            if _short(key[0]) != short:
                continue
            if out is None:
                from photon_tpu_torch.obs.quality import QualityAccumulator

                out = QualityAccumulator(acc.score_bins, acc.calibration_bins)
            out.merge(acc)
        return out

    def _objective_value(self, acc) -> Optional[float]:
        if acc is None or acc.count <= 0:
            return None
        if self.cfg.objective == "auc":
            auc = acc.auc()
            return None if auc is None else 1.0 - float(auc)
        loss = acc.mean_loss()
        return None if loss is None else float(loss)

    def _min_events(self) -> int:
        if self.cfg.min_events is not None:
            return int(self.cfg.min_events)
        return int(self.engine.quality.config.min_events)

    def _burns(self, cand_acc, prim_acc) -> Optional[str]:
        """Quality-burn verdict for one candidate vs the live primary over
        the same windows; None = healthy (or not enough evidence)."""
        min_events = self._min_events()
        if (cand_acc is None or prim_acc is None or cand_acc.count < min_events
                or prim_acc.count < min_events):
            return None
        bound = self.cfg.auc_drop_bound
        if bound is None:
            bound = float(self.engine.quality.config.auc_drop_bound)
        # AUC only separates the classification family; for linear /
        # Poisson the 0.5-threshold pos/neg split makes it noise, so the
        # burn verdict drops straight to the loss-ratio test.
        if self.engine.quality.config.task == "logistic":
            c_auc, p_auc = cand_acc.auc(), prim_acc.auc()
            if c_auc is not None and p_auc is not None:
                if c_auc < p_auc - bound:
                    return f"quality burn: candidate AUC {c_auc:.4f} < primary {p_auc:.4f} - {bound:.4f}"
                # A healthy AUC does NOT clear the candidate: ranking
                # survives a calibration collapse (scores shrunk toward
                # zero keep their sign and most of their order), so the
                # loss-ratio test below still applies.
        c_loss, p_loss = cand_acc.mean_loss(), prim_acc.mean_loss()
        if c_loss is not None and p_loss is not None and c_loss > p_loss * (1.0 + self.cfg.loss_burn_ratio):
            return (f"quality burn: candidate loss {c_loss:.4f} > primary {p_loss:.4f} × "
                    f"{1.0 + self.cfg.loss_burn_ratio:.2f}")
        return None

    def _observe_round(self, cands: Sequence[Candidate]) -> None:
        """Load the round's unobserved candidates as concurrent shadow
        lanes, wait for their online quality windows to fill, poison
        burners, stamp every observation durably. Every candidate is loaded
        (and warmed) before the first lane starts, so no version builds on
        the card while a lane is observed."""
        if self.engine is None:
            raise RuntimeError(
                "experiment manager has no engine: cannot observe candidates online (train_only resume is the "
                "only engine-less mode)"
            )
        reg = registry()
        loaded: List[Candidate] = []
        for cand in cands:
            if cand.observation is not None or cand.model_dir is None:
                continue
            try:
                with span("experiment/load_candidate"):
                    self.engine.load_version(self.trainer.load(cand.model_dir), model_version=cand.generation)
                loaded.append(cand)
            except Exception as exc:  # noqa: BLE001 — candidate, not caller
                logger.warning("experiment %s: candidate %s failed to load (%s); poisoning",
                               self.cfg.experiment_id, cand.generation, exc)
                self._poison(cand, f"load failed: {exc}")
        pending: List[Candidate] = []
        for cand in loaded:
            try:
                self.engine.start_shadow(cand.generation, self.cfg.shadow_fraction)
                pending.append(cand)
            except Exception as exc:  # noqa: BLE001 — candidate, not caller
                logger.warning("experiment %s: candidate %s failed to start its lane (%s); poisoning",
                               self.cfg.experiment_id, cand.generation, exc)
                self._poison(cand, f"load failed: {exc}")
        reg.gauge("experiment_candidates_resident", experiment=self.cfg.experiment_id).set(len(pending))
        burn_strikes: Dict[str, int] = {}
        deadline = time.monotonic() + float(self.cfg.observe_timeout_s)
        min_events = self._min_events()
        while pending and time.monotonic() < deadline:
            time.sleep(self.cfg.observe_poll_s)
            prim_acc = self._quality_pool(self.engine.model_version)
            for cand in list(pending):
                acc = self._quality_pool(cand.generation)
                reason = self._burns(acc, prim_acc)
                if reason is not None:
                    strikes = burn_strikes.get(cand.key, 0) + 1
                    burn_strikes[cand.key] = strikes
                    if strikes >= max(1, int(self.cfg.burn_checks)):
                        self._poison(cand, reason)
                        pending.remove(cand)
                    continue
                burn_strikes[cand.key] = 0
                if acc is not None and acc.count >= min_events:
                    value = self._objective_value(acc)
                    if value is None:
                        continue  # e.g. single-class AUC window: keep waiting
                    cand.observation = value
                    cand.source = "online"
                    cand.status = "observed"
                    self._stamp(cand, events=acc.count)
                    self.engine.stop_shadow(cand.generation)
                    pending.remove(cand)
        for cand in pending:
            # Timed out: take whatever the window holds; a candidate with
            # zero joined labels observes the poison penalty (it measured
            # nothing, and the GP must not revisit blind spots for free).
            acc = self._quality_pool(cand.generation)
            value = self._objective_value(acc)
            if value is not None:
                cand.observation = value
                cand.source = "online"
                cand.status = "observed"
                self._stamp(cand, events=acc.count, timedOut=True)
                self.engine.stop_shadow(cand.generation)
            else:
                self._poison(cand, "no online observations before timeout")
        reg.gauge("experiment_candidates_resident", experiment=self.cfg.experiment_id).set(0)

    def _release_losers(self) -> None:
        """Drop every resident candidate but the best so far (its lanes
        have stopped), so the next round loads onto the memory this one
        freed."""
        if self.engine is None:
            return
        best = self.best_candidate()
        dropped = [c.generation for c in self.candidates
                   if c is not best and c.model_dir is not None and self.engine.unload_version(c.generation)]
        if dropped:
            gc.collect()  # graphs and static tensors in cycles go now, not at the next collection
            logger.info("experiment %s: dropped %d losing candidate(s): %s", self.cfg.experiment_id, len(dropped),
                        dropped)

    def _penalty_value(self) -> float:
        finite = [c.observation for c in self.candidates if c.observation is not None]
        worst = max(finite) if finite else 1.0
        return float(worst + self.cfg.poison_margin)

    def _poison(self, cand: Candidate, reason: str) -> None:
        cand.status = "poisoned"
        cand.poison_reason = reason
        cand.observation = self._penalty_value()
        cand.source = "penalty"
        self.poisoned.append(cand.generation)
        mark_poisoned(self.cfg.publish_root, cand.generation, reason)
        self._stamp(cand)
        if self.engine is not None:
            try:
                self.engine.stop_shadow(cand.generation)
            except Exception:  # noqa: BLE001 — lane may never have started
                pass
        registry().counter("experiment_candidates_poisoned_total", experiment=self.cfg.experiment_id).inc()
        logger.warning("experiment %s: POISONED candidate %s (%s)", self.cfg.experiment_id, cand.generation, reason)

    # -- promotion -----------------------------------------------------------

    def best_candidate(self) -> Optional[Candidate]:
        live = [c for c in self.candidates if c.observation is not None and c.status != "poisoned"]
        return min(live, key=lambda c: c.observation) if live else None

    def _promote_winner(self) -> None:
        best = self.best_candidate()
        if best is None:
            logger.warning("experiment %s: no promotable candidate (all poisoned or unobserved)",
                           self.cfg.experiment_id)
            return
        gate = gate_and_publish(self.cfg.publish_root, best.generation, metric_tolerance=self.cfg.metric_tolerance,
                                norm_drift_bound=self.cfg.norm_drift_bound)
        self._stamp(best, winner=bool(gate.ok), gateReason=gate.reason)
        if not gate.ok:
            logger.warning("experiment %s: winner %s REFUSED by the manifest gate (%s); LATEST unchanged",
                           self.cfg.experiment_id, best.generation, gate.reason)
            return
        self.winner = best
        registry().counter("experiment_promotions_total", experiment=self.cfg.experiment_id).inc()
        if self.engine is not None:
            try:
                if best.generation not in self.engine.versions:
                    self.engine.load_version(self.trainer.load(best.model_dir), model_version=best.generation)
                self.engine.promote(best.generation)
            except Exception as exc:  # noqa: BLE001 — LATEST already moved
                logger.warning("experiment %s: engine promotion of %s failed (%s); the published LATEST pointer "
                               "stands and the serving watcher will adopt it", self.cfg.experiment_id,
                               best.generation, exc)
        logger.info("experiment %s: winner %s promoted (observation %.5f, %s)", self.cfg.experiment_id,
                    best.generation, best.observation, json.dumps(best.params, sort_keys=True))

    def summary(self) -> dict:
        best = self.best_candidate()
        return dict(
            experiment_id=self.cfg.experiment_id,
            rounds=self.cfg.rounds,
            candidates=[
                dict(
                    round=c.round, index=c.index, generation=c.generation,
                    params=c.params, paramsKey=c.key,
                    observation=c.observation, source=c.source,
                    status=c.status, poisonReason=c.poison_reason,
                    reused=c.reused,
                )
                for c in self.candidates
            ],
            trained=self.trained,
            reused_trained=self.reused_trained,
            reused_observed=self.reused_observed,
            poisoned=list(self.poisoned),
            winner=None if self.winner is None else self.winner.generation,
            best=None if best is None else dict(
                generation=best.generation, params=best.params,
                observation=best.observation,
            ),
        )


def _load_candidate(publish_root: str, model_dir: str, index_maps: Dict, entity_indexes: Dict):
    """A candidate generation as the engine's host master (CPU tensors)."""
    from photon_tpu_torch.io.model_io import load_resolved_game_model

    return load_resolved_game_model(model_dir, index_maps, entity_indexes, to_device=False,
                                    publish_root=publish_root)


class IncrementalCandidateTrainer:
    """The production trainer: each candidate is one warm-started
    ``incremental_update`` on the delta batch (on ``batch``'s device, where
    ``device`` says), trained at EXACTLY the proposed configuration
    (``optimization_config``), published never (``publish=False`` — only
    the experiment winner moves LATEST, through the normal gate)."""

    def __init__(
        self,
        publish_root: str,
        batch,
        index_maps: Dict,
        entity_indexes: Dict,
        task,
        coordinate_configs: Sequence,
        update_sequence: Sequence[str],
        valid_batch=None,
        evaluation_suite=None,
        num_iterations: int = 1,
        locked_coordinates: Sequence[str] = (),
        device="cuda",
    ):
        self.publish_root = publish_root
        self.batch = batch
        self.index_maps = index_maps
        self.entity_indexes = entity_indexes
        self.task = task
        self.coordinate_configs = list(coordinate_configs)
        self.update_sequence = list(update_sequence)
        self.valid_batch = valid_batch
        self.evaluation_suite = evaluation_suite
        self.num_iterations = int(num_iterations)
        self.locked_coordinates = list(locked_coordinates)
        self.device = torch.device(device)

    def train(self, config: GameOptimizationConfig, generation: str, extra_manifest: dict) -> str:
        from photon_tpu_torch.train.incremental import incremental_update

        result = incremental_update(
            self.publish_root,
            self.batch,
            self.index_maps,
            self.entity_indexes,
            self.task,
            self.coordinate_configs,
            self.update_sequence,
            valid_batch=self.valid_batch,
            evaluation_suite=self.evaluation_suite,
            generation=generation,
            num_iterations=self.num_iterations,
            locked_coordinates=self.locked_coordinates,
            publish=False,
            extra_manifest=extra_manifest,
            optimization_config=config,
            device=self.device,
        )
        return result.model_dir

    def load(self, model_dir: str):
        return _load_candidate(self.publish_root, model_dir, self.index_maps, self.entity_indexes)


def _trainer_worker(conn, factory: Callable[[], IncrementalCandidateTrainer]) -> None:
    """The spawned trainer's loop: build the trainer (it reads the delta
    onto its device), then answer ``("train", config, generation, extra)``
    with ``("trained", model_dir)`` or ``("error", text)`` until
    ``("stop",)`` or the parent's end of the pipe closes."""
    try:
        trainer = factory()
    except Exception:  # noqa: BLE001 — reported to the parent, then exit
        conn.send(("error", traceback.format_exc()))
        return
    conn.send(("ready", str(trainer.device)))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] != "train":
            return
        _, config, generation, extra = msg
        try:
            conn.send(("trained", trainer.train(config, generation, extra)))
        except Exception:  # noqa: BLE001 — the candidate fails, the worker stays
            conn.send(("error", traceback.format_exc()))


# How long the spawned trainer may take to build its trainer, to fit one
# candidate, and to stop when asked.
TRAINER_START_TIMEOUT_S, TRAINER_TRAIN_TIMEOUT_S, TRAINER_STOP_TIMEOUT_S = 900.0, 3600.0, 30.0


class SpawnedCandidateTrainer:
    """:class:`IncrementalCandidateTrainer`'s fits in ONE spawned process for
    the whole run (spawned, never forked: the parent holds CUDA). ``factory``
    is a picklable callable that builds the in-process trainer in the
    child; ``load`` reads the candidate here against the publish root's
    index maps and entity indexes, which the child's updates keep current.
    A child that cannot start, or dies, fails the call that needed it."""

    def __init__(self, publish_root: str, factory: Callable[[], IncrementalCandidateTrainer]):
        self.publish_root = publish_root
        self._factory = factory
        self._proc = None
        self._conn = None
        self._ready = False
        self.device: Optional[str] = None

    def start(self) -> None:
        """Spawn the child (it builds its trainer while the caller goes on);
        the first ``train`` waits for it."""
        if self._proc is not None:
            return
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        self._proc = ctx.Process(target=_trainer_worker, args=(child, self._factory), name="experiment-trainer")
        self._proc.start()
        child.close()
        self._conn = parent

    def _reply(self, timeout_s: float, what: str):
        deadline = time.monotonic() + timeout_s
        while not self._conn.poll(0.2):
            if not self._proc.is_alive():
                raise RuntimeError(f"experiment trainer process exited {self._proc.exitcode} during {what}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"experiment trainer process: no answer to {what} in {timeout_s:.0f} s")
        msg = self._conn.recv()
        if msg[0] == "error":
            raise RuntimeError(f"experiment trainer process failed during {what}:\n{msg[1]}")
        return msg

    def train(self, config: GameOptimizationConfig, generation: str, extra_manifest: dict) -> str:
        self.start()
        if not self._ready:
            self.device = self._reply(TRAINER_START_TIMEOUT_S, "its start")[1]
            self._ready = True
        self._conn.send(("train", config, generation, extra_manifest))
        return self._reply(TRAINER_TRAIN_TIMEOUT_S, f"training {generation}")[1]

    def load(self, model_dir: str):
        from photon_tpu_torch.data.index_map import EntityIndex, IndexMap

        root = self.publish_root
        index_maps = {n[len("index-map-"):-len(".json")]: IndexMap.load(os.path.join(root, n))
                      for n in os.listdir(root) if n.startswith("index-map-") and n.endswith(".json")}
        entity_indexes = {n[len("entity-index-"):-len(".json")]: EntityIndex.load(os.path.join(root, n))
                          for n in os.listdir(root) if n.startswith("entity-index-") and n.endswith(".json")}
        return _load_candidate(root, model_dir, index_maps, entity_indexes)

    def close(self) -> None:
        if self._proc is None:
            return
        try:
            self._conn.send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(TRAINER_STOP_TIMEOUT_S)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(5.0)
        self._conn.close()
        self._proc = None


def experiment_summary(publish_root: str) -> dict:
    """Offline rollup of every experiment recorded in a publish root's
    generation manifests (the ``obs_tool experiments`` surface): per
    experiment — rounds, candidates with params/observations/status, poison
    reasons, and the winner when one promoted. Reads only the manifests +
    poison list; works with no server running."""
    from photon_tpu_torch.io.model_io import load_poison_list

    poison = load_poison_list(publish_root)
    experiments: Dict[str, dict] = {}
    for rec in experiment_generations(publish_root):
        exp_id = str(rec.get("id"))
        exp = experiments.setdefault(exp_id, dict(id=exp_id, rounds=0, candidates=[], winner=None, poisoned=[]))
        gen = str(rec["generation"])
        entry = dict(
            generation=gen,
            round=int(rec.get("round", 0)),
            params=rec.get("params"),
            observation=rec.get("observation"),
            observationSource=rec.get("observationSource"),
            status=rec.get("status"),
            gate=(rec.get("gate") or {}).get("status"),
        )
        if gen in poison:
            entry["poisonReason"] = poison[gen]
            exp["poisoned"].append(gen)
        exp["candidates"].append(entry)
        exp["rounds"] = max(exp["rounds"], entry["round"] + 1)
        if rec.get("winner"):
            exp["winner"] = gen
    for exp in experiments.values():
        observed = [c for c in exp["candidates"] if c["observation"] is not None and c["status"] != "poisoned"]
        exp["best"] = min(observed, key=lambda c: c["observation"]) if observed else None
    return dict(publish_root=publish_root, experiments=sorted(experiments.values(), key=lambda e: e["id"]))
