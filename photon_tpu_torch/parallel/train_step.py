"""One GLMix coordinate-descent pass (port of
photon_tpu/parallel/train_step.py::glmix_train_step).

The fixed effect trains by margin-space L-BFGS against the random-effect
scores (its gradient pass in csrc/fused_value_grad.cu when the objective
fuses); the random effects then train by the batched damped Newton solve
over the entity block, with every Newton system from csrc/newton_system.cu
on the card. Both solves go through the solve cache
(algorithm/solve_cache.py: captured CUDA graphs on the card), as the
reference's step is one jitted program. The sharded steps and the
l2-override sweep hook are not ported yet.

Unlike the reference, the coefficient write-back drops shape-bucket padding
rows (entity_idx -1). The reference writes ``re_coefs.at[entity_idx]`` and
a -1 wraps to the last entity, so a padded block overwrites entity E-1's
new coefficients with its old ones.
"""

from __future__ import annotations

import torch

from typing import Optional

from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.random_effect import EntityBlock
from photon_tpu_torch.ops.fused_newton import resolve_re_kernel
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import OptimizerConfig
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.types import OptimizerType

Tensor = torch.Tensor


def full_precision_matmuls() -> None:
    """Pin f32 matrix products and convolutions to full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def glmix_train_step(
    fixed_objective: GLMObjective,
    re_objective: GLMObjective,
    fe_config: OptimizerConfig,
    re_config: OptimizerConfig,
    re_kernel: str = "auto",
    solve_cache: Optional[SolveCache] = None,
):
    """Build ``step(w_fixed, re_coefs, fe_batch, re_block, re_features_flat,
    re_entity_ids) → (w_fixed', re_coefs', scores, fe_evals,
    re_sample_visits)``.

    ``fe_evals`` counts fixed-effect X passes and ``re_sample_visits`` is
    Σ_e passes_e × n_e, the reference's throughput accounting.
    ``re_kernel`` routes the Newton system (ops.fused_newton.RE_KERNELS);
    "auto" takes the CUDA kernel for a block on the card. Smooth objectives
    only. The random effects always use the Newton solver (the reference's
    ``re_solver="lbfgs"`` is not ported yet). Sets f32 matmuls to full
    precision (no TF32). The solves go through ``solve_cache`` (default:
    the shared one); a step has no end of its own, so the caller releases
    the cache (``SolveCache.release``) when its training loop is done.
    """
    if fixed_objective.l1_weight > 0.0 or re_objective.l1_weight > 0.0:
        raise ValueError(
            "glmix_train_step solves smooth objectives; L1/elastic-net needs OWL-QN"
        )
    full_precision_matmuls()
    cache = solve_cache if solve_cache is not None else default_cache()
    fe_spec = OptimizerSpec(OptimizerType.LBFGS, fe_config.max_iter, fe_config.tol, fe_config.memory,
                            track_history=fe_config.track_history)
    if fe_spec.config() != fe_config:
        raise ValueError(f"glmix_train_step: fe_config {fe_config} is not an L-BFGS spec's ({fe_spec.config()})")
    fe_solve = cache.fe_solver(fixed_objective, fe_spec)
    re_spec = OptimizerSpec(OptimizerType.NEWTON, re_config.max_iter, re_config.tol, re_config.memory,
                            track_history=re_config.track_history)

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
        kernel = resolve_re_kernel(re_kernel, re_block.features.device)
        re_solve = cache.block_solver(re_objective, re_spec, re_config, has_mask=False, re_kernel=kernel)
        w_new, _iterations, _reasons, passes = re_solve(re_block, offs, w_init)
        real = eidx >= 0  # padding rows carry no entity: drop them
        re_coefs_new = re_coefs.clone()
        re_coefs_new[eidx[real]] = w_new[real]
        re_sample_visits = torch.sum(passes * torch.sum(re_block.weight > 0, dim=1))

        total_scores = fe_scores + re_scores_of(re_coefs_new)
        return w_fixed_new, re_coefs_new, total_scores, fe_res.evals, re_sample_visits

    return step
