"""Fused GLM value+gradient and Hessian-vector kernels (port of
photon_tpu/ops/pallas_glm.py).

``fused_value_grad`` returns Σ wt·loss(X·w + off, y), Xᵀ·(wt·loss'(z, y))
and optionally the margins z, from one read of X
(csrc/fused_value_grad.cu). ``fused_hvp`` returns Xᵀ·diag(d2)·X·v from one
read of X (csrc/fused_hvp.cu). Both are pure data terms: L2 and
normalization are folded by the caller (ops/objective.py).

X may be f32 or bfloat16. As in the reference, the vector is rounded to X's
dtype before the dot and everything after is f32. On CPU tensors each
wrapper computes its plain version (``*_plain``, same casts); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

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
    tile, grid, vec = _geometry(X)
    parts = torch.empty((grid, d + 1), dtype=torch.float32, device=X.device)
    out = torch.empty(d + 1, dtype=torch.float32, device=X.device)
    z = torch.empty(n, dtype=torch.float32, device=X.device) if return_margins else None
    kernels.launch(
        "fused_value_grad", kernels.ptr(X), int(X.dtype == torch.bfloat16), kernels.ptr(w),
        kernels.ptr(label), kernels.ptr(offset), kernels.ptr(weight),
        None if z is None else kernels.ptr(z), kernels.ptr(parts), kernels.ptr(out),
        n, d, tile, grid, loss.kernel_id, vec,
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
    tile, grid, vec = _geometry(X)
    parts = torch.empty((grid, d), dtype=torch.float32, device=X.device)
    out = torch.empty(d, dtype=torch.float32, device=X.device)
    kernels.launch(
        "fused_hvp", kernels.ptr(X), int(X.dtype == torch.bfloat16), kernels.ptr(v),
        kernels.ptr(d2), kernels.ptr(parts), kernels.ptr(out), n, d, tile, grid, vec,
    )
    return out
