"""Batched per-entity Newton-system kernel (port of
photon_tpu/ops/pallas_newton.py).

``newton_system(X, d2, dz)`` returns, for every entity e of a block,
H_e = X_eᵀ·diag(d2_e)·X_e and g_e = X_eᵀ·dz_e from one read of the entity's
(n_max, d) slab (csrc/newton_system.cu, one CTA per entity). X is f32, or a
bfloat16 copy under ``re_kernel="cuda_bf16x"``; d2, dz and every sum are
f32. On CPU tensors the wrapper computes the plain batched einsum; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from photon_tpu_torch.ops import kernels

Tensor = torch.Tensor

# d*d Hessian entries over 256 threads, at most 16 per thread
# (csrc/newton_system.cu kMaxDim). The random-effect solver is meant for
# d of a few dozen (photon_tpu/optim/newton.py:9).
NEWTON_MAX_DIM = 64

# Routing values for the random-effect Newton system:
#   torch      — plain batched einsum/matmul (two reads of X per iteration)
#   cuda       — the fused kernel over the f32 slab
#   cuda_bf16x — the fused kernel over a bf16 copy of the slab, f32 sums
#   auto       — cuda for CUDA tensors, torch for CPU tensors
RE_KERNELS = ("auto", "torch", "cuda", "cuda_bf16x")


def resolve_re_kernel(re_kernel: str, device) -> str:
    """Concrete kernel for a routing value and the device of the block."""
    if re_kernel not in RE_KERNELS:
        raise ValueError(f"re_kernel must be one of {RE_KERNELS}, got {re_kernel!r}")
    is_cuda = torch.device(device).type == "cuda"
    if re_kernel == "auto":
        return "cuda" if is_cuda else "torch"
    if re_kernel.startswith("cuda") and not is_cuda:
        raise ValueError(f"re_kernel={re_kernel!r} needs CUDA tensors, got device {device}")
    return re_kernel


def newton_system_plain(X: Tensor, d2: Tensor, dz: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain batched version of ``newton_system``."""
    acc = torch.promote_types(X.dtype, torch.float32)
    Xa = X.to(acc)
    H = torch.einsum("bnd,bn,bne->bde", Xa, d2.to(acc), Xa)
    g = torch.einsum("bnd,bn->bd", Xa, dz.to(acc))
    return H, g


def newton_system(X: Tensor, d2: Tensor, dz: Tensor) -> Tuple[Tensor, Tensor]:
    """(H (E, d, d), g (E, d)) for X (E, n_max, d), d2 and dz (E, n_max)."""
    E, n_max, d = X.shape
    if d > NEWTON_MAX_DIM:
        raise ValueError(f"newton_system supports d <= {NEWTON_MAX_DIM} (got d={d})")
    if X.device.type == "cpu":
        return newton_system_plain(X, d2, dz)
    kernels.require_cuda("newton_system", X, d2, dz)
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"newton_system: X must be f32 or bf16, got {X.dtype}")
    for v in (d2, dz):
        if v.dtype != torch.float32 or tuple(v.shape) != (E, n_max):
            raise ValueError(f"newton_system: d2/dz must be f32 {(E, n_max)}, got {v.dtype} {tuple(v.shape)}")
    H = torch.empty((E, d, d), dtype=torch.float32, device=X.device)
    g = torch.empty((E, d), dtype=torch.float32, device=X.device)
    if E == 0 or n_max == 0:
        return H.zero_(), g.zero_()
    kernels.launch(
        "newton_system", kernels.ptr(X), int(X.dtype == torch.bfloat16), kernels.ptr(d2),
        kernels.ptr(dz), kernels.ptr(H), kernels.ptr(g), E, n_max, d,
    )
    return H, g
