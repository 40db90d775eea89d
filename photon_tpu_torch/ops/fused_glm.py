"""Fused GLM value+gradient and Hessian-vector kernels (port of
photon_tpu/ops/pallas_glm.py).

``fused_value_grad`` returns Σ wt·loss(X·w + off, y), Xᵀ·(wt·loss'(z, y))
and optionally the margins z, from one read of X
(csrc/fused_value_grad.cu). ``fused_hvp`` returns Xᵀ·diag(d2)·X·v from one
read of X (csrc/fused_hvp.cu). Both are pure data terms: L2 and
normalization are folded by the caller (ops/objective.py). Both take the
same two routes by shape: "row" (csrc/row_ring.h, one row kernel with a
per-row operation each) and "tile" (the staged-tile kernels).

X may be f32 or bfloat16. As in the reference, the vector is rounded to X's
dtype before the dot and everything after is f32. On CPU tensors each
wrapper computes its plain version (``*_plain``, same casts); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Tuple

import torch

from photon_tpu_torch.ops import kernels
from photon_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

# Row tiles are staged whole in shared memory: at most _X_TILE_BYTES of X
# per CTA, at least 8 rows. 8 rows of f32 at d = 4096 fill the budget, and
# each thread keeps d / 256 <= 16 gradient columns in registers
# (csrc/glm_common.h kMaxColsPerThread), so d <= 4096.
MAX_FUSED_DIM = 4096
_X_TILE_BYTES = 128 * 1024
_MAX_TILE_ROWS = 64
# CTAs per launch. Tile t goes to CTA t % grid; fixing the grid fixes the
# summation order, so a result does not depend on the card it ran on.
_MAX_GRID = 1024


def _check_width(d: int, fn_name: str) -> None:
    if d > MAX_FUSED_DIM:
        raise ValueError(
            f"{fn_name} supports d <= {MAX_FUSED_DIM} (got d={d}); "
            "use the two-pass path for wider problems"
        )


def _geometry(X: Tensor) -> Tuple[int, int, int]:
    """(tile_rows, grid, vec) for a row-major X on the card."""
    n, d = X.shape
    tile = min(_MAX_TILE_ROWS, (_X_TILE_BYTES // (d * X.element_size())) // 8 * 8)
    grid = min(_MAX_GRID, -(-n // tile))
    vec = int((d * X.element_size()) % 16 == 0 and X.data_ptr() % 16 == 0)
    return tile, grid, vec


# The "row" route of fused_value_grad and fused_hvp (csrc/row_ring.h): warps
# own whole rows, each lane a row's 16-byte chunks, so a row must be a whole
# number of chunks and start on a 16-byte boundary; a lane holds at most 8
# chunks (d <= 1024). The tile is _ROW_WARPS warps times a few rows, about
# _ROW_TILE_BYTES of X, at most 32 rows a warp. A slot is about
# _ROW_SLOT_BYTES of consecutive tiles; each slot writes one partial sum.
ROW_MAX_DIM = 1024
_ROW_WARPS = 8
_ROW_TILE_BYTES = 16 * 1024
_ROW_SLOT_BYTES = 256 * 1024
# Tiles in flight per CTA: the producer warp keeps this many bulk copies
# ahead of the consumer warps (csrc/glm_common.h bulk_copy_g2s).
RING_STAGES = 4
# Partials summed per group in the first level of the reduction tree
# (csrc/glm_common.h kTreeGroup).
_TREE_GROUP = 64


def value_grad_route(d: int, elem_size: int, data_ptr: int) -> str:
    """"row" where a row is whole 16-byte chunks on a 16-byte boundary and
    d <= ROW_MAX_DIM, else "tile" (PR 1's kernel, any d <= MAX_FUSED_DIM).
    Both are CUDA kernels; the choice is by shape, not a fallback."""
    row_bytes = d * elem_size
    if d <= ROW_MAX_DIM and row_bytes % 16 == 0 and data_ptr % 16 == 0:
        return "row"
    return "tile"


# fused_hvp takes the row route on the same shapes as fused_value_grad.
hvp_route = value_grad_route


def row_tile_rows(d: int, elem_size: int) -> int:
    """Rows in one tile of the row route: a multiple of _ROW_WARPS."""
    rows = _ROW_TILE_BYTES // (d * elem_size) // _ROW_WARPS * _ROW_WARPS
    return min(max(rows, _ROW_WARPS), 32 * _ROW_WARPS)


@dataclass(frozen=True)
class RowPlan:
    """One launch of the row route. Tiles and slots follow from the shape
    alone: slot s holds rows [s * slot_rows, (s + 1) * slot_rows), its
    partial is summed in a fixed order whichever CTA computes it, and the
    partials go through a fixed tree, so the result is bitwise the same on
    any card. Only ``grid`` (resident CTAs, from the card) varies; CTA c
    walks slots c, c + grid, ..."""

    tile_rows: int
    tiles_per_slot: int
    slots: int
    stages: int
    grid: int
    ctas_per_sm: int

    @property
    def slot_rows(self) -> int:
        return self.tile_rows * self.tiles_per_slot

    def cta_slots(self, cta: int) -> range:
        return range(cta, self.slots, self.grid)

    def scratch_rows(self) -> int:
        """Rows of f32 scratch: the slots' partials, then the tree's group sums."""
        return self.slots + -(-self.slots // _TREE_GROUP)


def row_plan(n: int, d: int, elem_size: int, sm_count: int, ctas_per_sm: int) -> RowPlan:
    tile = row_tile_rows(d, elem_size)
    tiles_per_slot = max(1, _ROW_SLOT_BYTES // (tile * d * elem_size))
    tiles = -(-n // tile)
    slots = -(-tiles // tiles_per_slot)
    return RowPlan(tile, tiles_per_slot, slots, RING_STAGES,
                   min(slots, sm_count * ctas_per_sm), ctas_per_sm)


# Resident CTAs per SM of a row kernel, by (kernel, device, bf16, d, loss id).
_ROW_OCCUPANCY: Dict[tuple, int] = {}


def _row_plan_on_card(name: str, X: Tensor, loss_id: int) -> RowPlan:
    """Row plan of kernel ``name`` ("fused_value_grad", whose row kernel
    depends on the loss, or "fused_hvp", loss_id -1) for a CUDA X."""
    n, d = X.shape
    bf16, es = int(X.dtype == torch.bfloat16), X.element_size()
    key = (name, X.device.index, bf16, d, loss_id)
    if key not in _ROW_OCCUPANCY:
        extra = () if loss_id < 0 else (loss_id,)
        with torch.cuda.device(X.device):
            ctas = kernels.query_int(name, f"pt_{name}_occupancy", bf16, d, row_tile_rows(d, es),
                                     RING_STAGES, *extra)
        if ctas < 1:
            raise RuntimeError(f"{name}: the row kernel does not fit an SM at d={d}")
        _ROW_OCCUPANCY[key] = ctas
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    return row_plan(n, d, es, sms, _ROW_OCCUPANCY[key])


def _plan(name: str, X: Tensor, loss_id: int) -> dict:
    n, d = X.shape
    route = value_grad_route(d, X.element_size(), X.data_ptr())
    if route == "row":
        return dict(route=route, **asdict(_row_plan_on_card(name, X, loss_id)))
    tile, grid, _ = _geometry(X)
    return dict(route=route, tile_rows=tile, grid=grid)


def value_grad_plan(X: Tensor, loss: PointwiseLoss) -> dict:
    """The route and launch geometry ``fused_value_grad`` uses for a CUDA X."""
    return _plan("fused_value_grad", X, loss.kernel_id)


def hvp_plan(X: Tensor) -> dict:
    """The route and launch geometry ``fused_hvp`` uses for a CUDA X."""
    return _plan("fused_hvp", X, -1)


def _launch_geometry(name: str, X: Tensor, loss_id: int) -> Tuple[int, tuple, int]:
    """(scratch rows, (route, tile, grid, tiles_per_slot, stages), vec) of a
    launch; vec matters to the tile route only."""
    if value_grad_route(X.shape[1], X.element_size(), X.data_ptr()) == "row":
        plan = _row_plan_on_card(name, X, loss_id)
        return plan.scratch_rows(), (1, plan.tile_rows, plan.grid, plan.tiles_per_slot, plan.stages), 1
    tile, grid, vec = _geometry(X)
    return grid, (0, tile, grid, 0, 0), vec


def _check_cuda_inputs(name: str, X: Tensor, *vecs: Tensor) -> None:
    kernels.require_cuda(name, X, *vecs)
    if X.dim() != 2 or X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: X must be a 2-D f32 or bf16 tensor, got {X.dtype} {tuple(X.shape)}")
    if X.shape[0] == 0:
        raise ValueError(f"{name}: X has no rows")
    for v in vecs:
        if v.dtype != torch.float32 or v.dim() != 1:
            raise ValueError(f"{name}: vectors must be 1-D f32, got {v.dtype} {tuple(v.shape)}")


def _acc_dtype(X: Tensor) -> torch.dtype:
    return torch.promote_types(X.dtype, torch.float32)


def fused_value_grad_plain(loss: PointwiseLoss, w, X, label, offset, weight,
                           return_margins: bool = False):
    """Plain PyTorch version of ``fused_value_grad``, same casts."""
    acc = _acc_dtype(X)
    Xa = X.to(acc)
    z = Xa @ w.to(X.dtype).to(acc) + offset.to(acc)
    y, wt = label.to(acc), weight.to(acc)
    value = torch.sum(wt * loss.value(z, y))
    grad = Xa.T @ (wt * loss.dz(z, y))
    return (value, grad, z) if return_margins else (value, grad)


def fused_value_grad(loss: PointwiseLoss, w: Tensor, X: Tensor, label: Tensor,
                     offset: Tensor, weight: Tensor, return_margins: bool = False):
    """(value, grad[, z]) of the weighted data loss in one pass over X."""
    n, d = X.shape
    _check_width(d, "fused_value_grad")
    if X.device.type == "cpu":
        return fused_value_grad_plain(loss, w, X, label, offset, weight, return_margins)
    _check_cuda_inputs("fused_value_grad", X, w, label, offset, weight)
    if w.shape[0] != d or not (label.shape[0] == offset.shape[0] == weight.shape[0] == n):
        raise ValueError("fused_value_grad: shapes of w/label/offset/weight do not match X")
    # Route by shape (value_grad_route): both routes are CUDA kernels.
    scratch, geometry, vec = _launch_geometry("fused_value_grad", X, loss.kernel_id)
    parts = torch.empty((scratch, d + 1), dtype=torch.float32, device=X.device)
    out = torch.empty(d + 1, dtype=torch.float32, device=X.device)
    z = torch.empty(n, dtype=torch.float32, device=X.device) if return_margins else None
    kernels.launch(
        "fused_value_grad", kernels.ptr(X), int(X.dtype == torch.bfloat16), kernels.ptr(w),
        kernels.ptr(label), kernels.ptr(offset), kernels.ptr(weight),
        None if z is None else kernels.ptr(z), kernels.ptr(parts), kernels.ptr(out),
        n, d, *geometry, loss.kernel_id, vec,
    )
    value, grad = out[d], out[:d]
    return (value, grad, z) if return_margins else (value, grad)


def fused_hvp_plain(v: Tensor, X: Tensor, d2: Tensor) -> Tensor:
    """Plain PyTorch version of ``fused_hvp``, same casts."""
    acc = _acc_dtype(X)
    Xa = X.to(acc)
    u = Xa @ v.to(X.dtype).to(acc)
    return Xa.T @ (d2.to(acc) * u)


def fused_hvp(v: Tensor, X: Tensor, d2: Tensor) -> Tensor:
    """Xᵀ·diag(d2)·X·v in one pass over X."""
    n, d = X.shape
    _check_width(d, "fused_hvp")
    if X.device.type == "cpu":
        return fused_hvp_plain(v, X, d2)
    _check_cuda_inputs("fused_hvp", X, v, d2)
    if v.shape[0] != d or d2.shape[0] != n:
        raise ValueError("fused_hvp: shapes of v/d2 do not match X")
    # Route by shape (hvp_route, the same as value_grad_route): both routes
    # are CUDA kernels.
    scratch, geometry, vec = _launch_geometry("fused_hvp", X, -1)
    parts = torch.empty((scratch, d), dtype=torch.float32, device=X.device)
    out = torch.empty(d, dtype=torch.float32, device=X.device)
    kernels.launch(
        "fused_hvp", kernels.ptr(X), int(X.dtype == torch.bfloat16), kernels.ptr(v),
        kernels.ptr(d2), kernels.ptr(parts), kernels.ptr(out), n, d, *geometry, vec,
    )
    return out
