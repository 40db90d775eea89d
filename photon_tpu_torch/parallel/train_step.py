"""GLMix training steps (port of photon_tpu/parallel/train_step.py).

``glmix_train_step``: one coordinate-descent pass on one device. The fixed
effect trains by margin-space L-BFGS against the random-effect scores (its
gradient pass in csrc/fused_value_grad.cu when the objective fuses); the
random effects then train over the entity block by the batched damped
Newton solve (every Newton system from csrc/newton_system.cu on the card)
or, with ``re_solver="lbfgs"``, by margin-space L-BFGS, one lane an entity.
Both solves go through the solve cache (algorithm/solve_cache.py: captured
CUDA graphs on the card), as the reference's step is one jitted program.
The l2-override sweep hook is not ported.

The sharded steps are the same pass over the ranks of a mesh
(parallel/mesh.py), SPMD: each rank holds its rows of the fixed-effect
batch (parallel/distributed.py::shard_batch), whose sums reduce over the
data axes (K1 and K2 on each rank's rows, then one all-reduce), and solves
its part of the entities. The reference's XLA-inserted exchanges become
collectives at the same places: the fixed-effect margins that the entity
blocks read by ``sample_index`` are gathered (exactly: an all-reduce of
disjoint rows), and so are the new coefficients, which every rank then
holds whole (the reference's replicated table and flat-batch score
gather).
- ``glmix_sharded_train_step``: the reference's block rows sharded over
  the data axes; each rank solves a contiguous part of the block.
- ``game_entity_sharded_train_step``: per-shard blocks (stacked by
  ``stack_shard_blocks``) with a (S, E_s, d) coefficient table; rank r
  solves the shards s with ``(s·dp)//S == r`` (parallel/entity_shard.py's
  device map).

Unlike the reference, every coefficient write-back drops shape-bucket
padding rows (entity_idx -1). The reference's unsharded steps write
``re_coefs.at[entity_idx]`` and a -1 wraps to the last entity, so a padded
block overwrites entity E-1's new coefficients with its old ones (its
entity-sharded step drops them, ``mode="drop"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.random_effect import EntityBlock
from photon_tpu_torch.ops.fused_newton import resolve_re_kernel
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import OptimizerConfig
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.optim.margin_lbfgs import MarginLBFGS
from photon_tpu_torch.optim.problem import GLMTerms
from photon_tpu_torch.types import OptimizerType

Tensor = torch.Tensor

RE_SOLVERS = ("newton", "lbfgs")


def full_precision_matmuls() -> None:
    """Pin f32 matrix products and convolutions to full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check(fixed_objective: GLMObjective, re_objective: GLMObjective, re_solver: str) -> None:
    if fixed_objective.l1_weight > 0.0 or re_objective.l1_weight > 0.0:
        raise ValueError("glmix_train_step solves smooth objectives; L1/elastic-net needs OWL-QN")
    if re_solver not in RE_SOLVERS:
        raise ValueError(f"unknown re_solver {re_solver!r}")


def _fe_solve(cache: SolveCache, fixed_objective: GLMObjective, fe_config: OptimizerConfig):
    fe_spec = OptimizerSpec(OptimizerType.LBFGS, fe_config.max_iter, fe_config.tol, fe_config.memory,
                            track_history=fe_config.track_history)
    if fe_spec.config() != fe_config:
        raise ValueError(f"glmix_train_step: fe_config {fe_config} is not an L-BFGS spec's ({fe_spec.config()})")
    return cache.fe_solver(fixed_objective, fe_spec)


def _re_solve(cache: SolveCache, re_objective: GLMObjective, re_config: OptimizerConfig, re_solver: str,
              re_kernel: str):
    """``solve(block, offsets, w_init) -> (w_new, X passes)`` of every
    entity of a block (entities whose train_mask is off keep w_init)."""
    if re_solver == "newton":
        re_spec = OptimizerSpec(OptimizerType.NEWTON, re_config.max_iter, re_config.tol, re_config.memory,
                                track_history=re_config.track_history)

        def newton(block: EntityBlock, offs: Tensor, w_init: Tensor):
            kernel = resolve_re_kernel(re_kernel, block.features.device)
            solve = cache.block_solver(re_objective, re_spec, re_config, has_mask=False, re_kernel=kernel)
            w_new, _iterations, _reasons, passes = solve(block, offs, w_init)
            return w_new, passes

        return newton

    # Margin-space L-BFGS, one lane an entity (the reference's vmapped
    # minimize_lbfgs_margin), as a captured program of the cache.
    name = ("glmix_re_lbfgs", SolveCache._objective_key(re_objective), float(re_objective.l2_weight),
            SolveCache._config_key(re_config))

    def make(t):
        blk = EntityBlock(t["entity_idx"], t["features"], t["label"], t["weight"], t["entity_idx"], t["train_mask"])
        w_start = torch.empty_like(t["w0"])
        prog = MarginLBFGS(GLMTerms.of_block(re_objective, blk, t["offsets"]), re_objective.l2_weight,
                           re_objective.intercept_index, w_start, re_config)

        def post():
            res = prog.result()
            return torch.where(t["train_mask"][:, None], res.w, t["w0"]), res.evals

        return prog, lambda: w_start.copy_(t["w0"]), post

    solve = cache.lane_solver(name, make, fixed_effect=False, pins=(re_objective, re_config))

    def lbfgs(block: EntityBlock, offs: Tensor, w_init: Tensor):
        return solve(dict(features=block.features, label=block.label, weight=block.weight, offsets=offs,
                          w0=w_init, train_mask=block.train_mask, entity_idx=block.entity_idx))

    return lbfgs


def _write_rows(table: Tensor, eidx: Tensor, rows: Tensor) -> Tensor:
    """A copy of ``table`` with rows ``eidx`` set to ``rows``; padding rows
    (entity_idx -1) are dropped."""
    out = table.clone()
    real = eidx >= 0
    out[eidx[real].long()] = rows[real].to(out.dtype)
    return out


def glmix_train_step(
    fixed_objective: GLMObjective,
    re_objective: GLMObjective,
    fe_config: OptimizerConfig,
    re_config: OptimizerConfig,
    re_solver: str = "newton",
    re_kernel: str = "auto",
    solve_cache: Optional[SolveCache] = None,
):
    """Build ``step(w_fixed, re_coefs, fe_batch, re_block, re_features_flat,
    re_entity_ids) → (w_fixed', re_coefs', scores, fe_evals,
    re_sample_visits)``.

    ``fe_evals`` counts fixed-effect X passes and ``re_sample_visits`` is
    Σ_e passes_e × n_e, the reference's throughput accounting.
    ``re_solver``: "newton" (batched damped Newton) or "lbfgs" (margin-space
    L-BFGS, one lane an entity). ``re_kernel`` routes the Newton system
    (ops.fused_newton.RE_KERNELS); "auto" takes the CUDA kernel for a block
    on the card. Smooth objectives only. Sets f32 matmuls to full precision
    (no TF32). The solves go through ``solve_cache`` (default: the shared
    one); a step has no end of its own, so the caller releases the cache
    (``SolveCache.release``) when its training loop is done.
    """
    _check(fixed_objective, re_objective, re_solver)
    full_precision_matmuls()
    cache = solve_cache if solve_cache is not None else default_cache()
    fe_solve = _fe_solve(cache, fixed_objective, fe_config)
    re_solve = _re_solve(cache, re_objective, re_config, re_solver, re_kernel)

    def step(w_fixed: Tensor, re_coefs: Tensor, fe_batch: LabeledBatch, re_block: EntityBlock,
             re_features_flat: Tensor, re_entity_ids: Tensor):
        def re_scores_of(coefs: Tensor) -> Tensor:
            valid = re_entity_ids >= 0
            w = coefs[torch.clamp(re_entity_ids, min=0).long()]
            return torch.where(valid, torch.sum(re_features_flat * w, dim=-1), 0.0)

        # --- fixed effect against the random-effect residuals ---
        fe_res = fe_solve(w_fixed, fe_batch.add_scores_to_offsets(re_scores_of(re_coefs)))
        w_fixed_new = fe_res.w

        # --- fixed scores as offsets for the per-entity solves ---
        fe_scores = fe_batch.margins(w_fixed_new)
        offs = re_block.gather_offsets(fe_scores)
        eidx = re_block.entity_idx.long()
        w_init = re_coefs[torch.clamp(eidx, min=0)]
        w_new, passes = re_solve(re_block, offs, w_init)
        re_coefs_new = _write_rows(re_coefs, eidx, w_new)
        re_sample_visits = torch.sum(passes * torch.sum(re_block.weight > 0, dim=1))

        total_scores = fe_scores + re_scores_of(re_coefs_new)
        return w_fixed_new, re_coefs_new, total_scores, fe_res.evals, re_sample_visits

    return step


# ---------------------------------------------------------------------------
# Sharded steps (SPMD over the ranks of a mesh)
# ---------------------------------------------------------------------------


def _entity_range(E: int, mesh) -> Tuple[int, int]:
    """This data rank's contiguous part of E entity rows."""
    from photon_tpu_torch.parallel.mesh import dp_axes

    dp, i = mesh.size(*dp_axes(mesh)), mesh.index(*dp_axes(mesh))
    per = -(-E // dp)
    return min(i * per, E), min((i + 1) * per, E)


def _gather_disjoint(full_shape, lo: int, part: Tensor, mesh) -> Tensor:
    """The whole of a tensor whose rows [lo, lo + len(part)) this rank
    computed and its peers the others: exact (an all-reduce of disjoint
    rows, the zeros of the others added)."""
    from photon_tpu_torch.parallel.mesh import dp_axes

    buf = torch.zeros(full_shape, dtype=part.dtype, device=part.device)
    buf[lo:lo + part.shape[0]] = part + 0
    return mesh.all_reduce(buf, dp_axes(mesh))


def _place_batch(fe_batch: LabeledBatch, mesh, device):
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.parallel.distributed import shard_batch

    feats = fe_batch.features
    feats = (SparseFeatures(feats.indices.to(device), feats.values.to(device), feats.dim)
             if isinstance(feats, SparseFeatures) else feats.to(device))
    whole = LabeledBatch(fe_batch.label.to(device), feats, fe_batch.offset.to(device), fe_batch.weight.to(device))
    return shard_batch(whole, mesh)


def glmix_sharded_train_step(
    mesh,
    fixed_objective: GLMObjective,
    re_objective: GLMObjective,
    fe_config: OptimizerConfig,
    re_config: OptimizerConfig,
    re_solver: str = "newton",
    re_kernel: str = "auto",
    solve_cache: Optional[SolveCache] = None,
):
    """``glmix_train_step`` over the ranks of ``mesh`` (module docstring),
    and ``place``, which takes the whole inputs (on every rank) to this
    rank's: ``place(w_fixed, re_coefs, fe_batch, re_block, re_features_flat,
    re_entity_ids)``. ``step(*placed)`` returns (w_fixed', re_coefs' (whole,
    on every rank), this rank's rows of the total scores (rows padded as
    its batch), fe_evals, re_sample_visits (the whole job's)). The fixed
    effect keeps its kernels: K1 on each rank's rows, then one all-reduce
    (a solve runs captured under NCCL, eagerly under gloo)."""
    _check(fixed_objective, re_objective, re_solver)
    full_precision_matmuls()
    cache = solve_cache if solve_cache is not None else default_cache()
    fe_solve = _fe_solve(cache, fixed_objective, fe_config)
    re_solve = _re_solve(cache, re_objective, re_config, re_solver, re_kernel)
    from photon_tpu_torch.parallel.distributed import local_rows, replicate
    from photon_tpu_torch.parallel.mesh import dp_axes

    device = mesh.device

    def place(w_fixed, re_coefs, fe_batch: LabeledBatch, re_block: EntityBlock, re_features_flat, re_entity_ids):
        fe = _place_batch(fe_batch, mesh, device)
        lo, hi = _entity_range(re_block.num_entities, mesh)
        rb = EntityBlock(*(getattr(re_block, f.name)[lo:hi].to(device) if getattr(re_block, f.name) is not None
                           and f.name != "col_map" else getattr(re_block, f.name)
                           for f in dataclasses.fields(EntityBlock)))
        return (replicate(torch.as_tensor(w_fixed).to(device)), replicate(torch.as_tensor(re_coefs).to(device)),
                fe, (rb, lo, re_block.num_entities),
                local_rows(torch.as_tensor(re_features_flat).to(device), fe.rows),
                local_rows(torch.as_tensor(re_entity_ids).to(device), fe.rows, -1))

    def step(w_fixed: Tensor, re_coefs: Tensor, fe_batch: LabeledBatch, re_part, re_features: Tensor,
             re_entity_ids: Tensor):
        re_block, lo, E_b = re_part
        rows = fe_batch.rows

        def re_scores_of(coefs: Tensor) -> Tensor:
            valid = re_entity_ids >= 0
            w = coefs[torch.clamp(re_entity_ids, min=0).long()]
            return torch.where(valid, torch.sum(re_features * w, dim=-1), 0.0)

        fe_res = fe_solve(w_fixed, fe_batch.add_scores_to_offsets(re_scores_of(re_coefs)))
        w_fixed_new = fe_res.w
        fe_scores = fe_batch.margins(w_fixed_new)
        # The block's samples live on any rank: gather the margins.
        offs = re_block.gather_offsets(rows.gather(fe_scores))
        eidx = re_block.entity_idx.long()
        w_init = re_coefs[torch.clamp(eidx, min=0)]
        if re_block.num_entities:
            w_new, passes = re_solve(re_block, offs, w_init)
            visits = torch.sum(passes * torch.sum(re_block.weight > 0, dim=1))
        else:
            w_new, visits = w_init, torch.zeros((), dtype=torch.long, device=device)
        block_eidx = _gather_disjoint((E_b,), lo, eidx, mesh)
        w_block = _gather_disjoint((E_b,) + tuple(w_new.shape[1:]), lo, w_new, mesh)
        re_coefs_new = _write_rows(re_coefs, block_eidx, w_block)
        visits = mesh.all_reduce(visits.to(torch.long).reshape(1), dp_axes(mesh))[0]
        total_scores = fe_scores + re_scores_of(re_coefs_new)
        return w_fixed_new, re_coefs_new, total_scores, fe_res.evals, visits

    return step, place


def stack_shard_blocks(shard_blocks: Sequence[EntityBlock], pad_entities: Optional[int] = None) -> EntityBlock:
    """One EntityBlock per shard stacked into a (S, ...)-leading block for
    :func:`game_entity_sharded_train_step`. Every shard must share
    (n_max, d); entity counts are padded to ``pad_entities`` (default: the
    most of any shard) with -1 / zero rows, as shape bucketing pads."""
    E_pad = pad_entities or max(int(b.entity_idx.shape[0]) for b in shard_blocks)
    n_max, d = int(shard_blocks[0].features.shape[1]), int(shard_blocks[0].features.shape[2])
    F = torch.nn.functional

    def pad(b: EntityBlock) -> EntityBlock:
        if any(sb.col_map is not None for sb in shard_blocks):
            raise ValueError("stack_shard_blocks: projected blocks unsupported")
        if tuple(b.features.shape[1:]) != (n_max, d):
            raise ValueError(f"stack_shard_blocks: shard geometry mismatch {tuple(b.features.shape[1:])} vs "
                             f"{(n_max, d)}")
        k = E_pad - int(b.entity_idx.shape[0])
        return EntityBlock(
            entity_idx=F.pad(b.entity_idx, (0, k), value=-1), features=F.pad(b.features, (0, 0, 0, 0, 0, k)),
            label=F.pad(b.label, (0, 0, 0, k)), weight=F.pad(b.weight, (0, 0, 0, k)),
            sample_index=F.pad(b.sample_index, (0, 0, 0, k), value=-1), train_mask=F.pad(b.train_mask, (0, k)))

    padded = [pad(b) for b in shard_blocks]
    return EntityBlock(*(torch.stack([getattr(b, name) for b in padded])
                         for name in ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")))


def game_entity_sharded_train_step(
    mesh,
    fixed_objective: GLMObjective,
    re_objective: GLMObjective,
    fe_config: OptimizerConfig,
    re_config: OptimizerConfig,
    re_solver: str = "newton",
    re_kernel: str = "auto",
    solve_cache: Optional[SolveCache] = None,
):
    """The entity-sharded GAME pass over the ranks of ``mesh`` (module
    docstring): rank r solves the shards s with (s·dp)//S == r on its
    device, each with the drop-mode write-back. ``place(w_fixed, re_coefs
    (S, E_s, d), fe_batch, re_block (stack_shard_blocks), re_features_flat,
    re_shard_ids, re_local_ids)`` takes the whole inputs (on every rank) to
    this rank's; ``step(*placed)`` returns (w_fixed', re_coefs' (S, E_s, d),
    whole on every rank: the one all-gather of the coefficient slabs), this
    rank's rows of the total scores, fe_evals, re_sample_visits). Uniform
    geometry across shards; projected blocks are refused."""
    _check(fixed_objective, re_objective, re_solver)
    full_precision_matmuls()
    cache = solve_cache if solve_cache is not None else default_cache()
    fe_solve = _fe_solve(cache, fixed_objective, fe_config)
    re_solve = _re_solve(cache, re_objective, re_config, re_solver, re_kernel)
    from photon_tpu_torch.parallel.distributed import local_rows, replicate
    from photon_tpu_torch.parallel.mesh import dp_axes, owned_shards

    device = mesh.device

    def place(w_fixed, re_coefs, fe_batch: LabeledBatch, re_block: EntityBlock, re_features_flat, re_shard_ids,
              re_local_ids):
        fe = _place_batch(fe_batch, mesh, device)
        owned = owned_shards(int(re_block.entity_idx.shape[0]), mesh)
        sl = slice(owned[0], owned[-1] + 1) if owned else slice(0, 0)
        rb = EntityBlock(*(getattr(re_block, name)[sl].to(device)
                           for name in ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")))
        return (replicate(torch.as_tensor(w_fixed).to(device)), replicate(torch.as_tensor(re_coefs).to(device)),
                fe, (rb, owned), local_rows(torch.as_tensor(re_features_flat).to(device), fe.rows),
                local_rows(torch.as_tensor(re_shard_ids).to(device), fe.rows, -1),
                local_rows(torch.as_tensor(re_local_ids).to(device), fe.rows, -1))

    def step(w_fixed: Tensor, re_coefs: Tensor, fe_batch: LabeledBatch, re_part, re_features: Tensor,
             re_shard_ids: Tensor, re_local_ids: Tensor):
        re_block, owned = re_part
        S, E_s = re_coefs.shape[0], re_coefs.shape[1]
        rows = fe_batch.rows

        def re_scores_of(coefs: Tensor) -> Tensor:
            valid = re_shard_ids >= 0
            idx = torch.clamp(re_shard_ids, min=0).long() * E_s + torch.clamp(re_local_ids, min=0).long()
            w = coefs.reshape(S * E_s, -1)[idx]
            return torch.where(valid, torch.sum(re_features * w, dim=-1), 0.0)

        fe_res = fe_solve(w_fixed, fe_batch.add_scores_to_offsets(re_scores_of(re_coefs)))
        w_fixed_new = fe_res.w
        fe_scores = fe_batch.margins(w_fixed_new)
        # The shards' samples live on any rank: gather the margins.
        fe_all = rows.gather(fe_scores)
        slabs, visits = [], torch.zeros((), dtype=torch.long, device=device)
        for j, s in enumerate(owned):
            blk = EntityBlock(*(getattr(re_block, name)[j] for name in
                                ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")))
            eidx = blk.entity_idx.long()
            w_init = re_coefs[s][torch.clamp(eidx, min=0)]
            w_new, passes = re_solve(blk, blk.gather_offsets(fe_all), w_init)
            slabs.append(_write_rows(re_coefs[s], eidx, w_new))
            visits = visits + torch.sum(passes * torch.sum(blk.weight > 0, dim=1))
        lo = owned[0] if owned else 0
        part = torch.stack(slabs) if slabs else re_coefs[0:0]
        re_coefs_new = _gather_disjoint(tuple(re_coefs.shape), lo, part, mesh)
        visits = mesh.all_reduce(visits.reshape(1), dp_axes(mesh))[0]
        total_scores = fe_scores + re_scores_of(re_coefs_new)
        return w_fixed_new, re_coefs_new, total_scores, fe_res.evals, visits

    return step, place
