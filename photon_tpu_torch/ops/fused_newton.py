"""Batched per-entity Newton-system kernel (port of
photon_tpu/ops/pallas_newton.py).

``newton_system(X, d2, dz)`` returns, for every entity e of a block,
H_e = X_eᵀ·diag(d2_e)·X_e and g_e = X_eᵀ·dz_e from one read of the entity's
(n_max, d) slab (csrc/newton_system.cu). X is f32, or a bfloat16 copy under
``re_kernel="cuda_bf16x"``; d2, dz and every sum are f32. On CPU tensors the
wrapper computes the plain batched einsum; on CUDA tensors it launches the
kernel or raises.

The kernel's launch plan (``newton_plan``) is computed here from the shape,
plus the card's occupancy for the grid: lanes own 4×4 blocks of H on or
above the diagonal, an entity's rows are split over a fixed number of row
groups, an entity is worked by a team of whole warps, and a CTA holds
several teams. Past 256 upper blocks (d > 88) the blocks are cut into
panels and a team works one (entity, panel) at a time, reading the slab once
per panel, so every width is taken. Everything but the grid follows from
the shape, so the sums are bitwise the same on any card.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Tuple

import torch

from photon_tpu_torch.ops import kernels

Tensor = torch.Tensor

# Lanes own 4×4 blocks of H (csrc/newton_system.cu kBlk).
_BLOCK = 4
# A team (one unit at a time) is 1 to _CTA_WARPS whole warps; a CTA holds
# _CTA_WARPS // team_warps teams. Up to 32 × _CTA_WARPS upper blocks (d <= 88)
# a unit is a whole entity and the team is the fewest warps whose lanes are
# at least _MIN_LANE_USE busy (blocks × row groups of 32 × warps), else the
# best use within _CTA_WARPS. Wider, the blocks are cut into the fewest
# panels of at most 32 × _CTA_WARPS blocks, and the team is the fewest warps
# that hold a panel.
_CTA_WARPS = 8
_MIN_LANE_USE = 0.9
# "bulk" route ring: about _STAGE_BYTES of X per stage (_WIDE_STAGE_BYTES
# when H is cut into panels), between _MIN_CHUNK_ROWS and _MAX_CHUNK_ROWS
# rows, NEWTON_STAGES stages per team. Chosen on the H100: at E=4096,
# n_max=768, d=16, 1 KiB stages spend more on three bulk copies and a
# barrier round per chunk than on the rows, and a third 4 KiB stage halves
# the resident CTAs (PERF.md, section 6); at E=1024, n_max=768, d=96 and
# 128 the panels' 16-row chunks leave the team waiting on its copies, and
# 32 KiB stages (2 of them, 3 CTAs an SM) were the fastest of 4-32 KiB with
# 2-4 stages.
_STAGE_BYTES, _WIDE_STAGE_BYTES = 4096, 32768
_MIN_CHUNK_ROWS, _MAX_CHUNK_ROWS = 16, 512
_MAX_STAGE_BYTES = 32768
NEWTON_STAGES = 2

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


def upper_blocks(d: int) -> Tuple[int, int]:
    """(blocks a side, blocks on or above the diagonal) of a d×d H."""
    nb = -(-d // _BLOCK)
    return nb, nb * (nb + 1) // 2


def panel_shape(d: int) -> Tuple[int, int]:
    """(panels, blocks a panel) for width d."""
    _, blocks = upper_blocks(d)
    panels = -(-blocks // (32 * _CTA_WARPS))
    return panels, -(-blocks // panels)


def team_shape(d: int) -> Tuple[int, int]:
    """(warps a team, row groups) for width d: lanes = panel blocks × row
    groups."""
    panels, blocks = panel_shape(d)
    if panels > 1:
        return -(-blocks // 32), 1
    best = None
    for warps in range(-(-blocks // 32), _CTA_WARPS + 1):
        groups = 32 * warps // blocks
        use = blocks * groups / (32 * warps)
        if use >= _MIN_LANE_USE:
            return warps, groups
        if best is None or use > best[0]:
            best = (use, warps, groups)
    return best[1], best[2]


def newton_route(n_max: int, d: int, elem_size: int, *data_ptrs: int) -> str:
    """"bulk" where every chunk of X, d2 and dz is a 16-byte-aligned span of
    whole 16-byte units (n_max a multiple of 4, a row a multiple of 4 bytes,
    arrays on a 16-byte boundary), else "direct" (element loads, any shape).
    Both are the same CUDA kernel; the choice is by shape, not a fallback."""
    if n_max % 4 == 0 and (d * elem_size) % 4 == 0 and all(p % 16 == 0 for p in data_ptrs):
        return "bulk"
    return "direct"


def chunk_rows(n_max: int, d: int, elem_size: int) -> int:
    """Rows in one ring stage of the bulk route: a multiple of 4, at least
    _MIN_CHUNK_ROWS unless a row is so wide that a stage would pass
    _MAX_STAGE_BYTES."""
    row = d * elem_size
    lo = min(_MIN_CHUNK_ROWS, max(4, _MAX_STAGE_BYTES // row // 4 * 4))
    stage = _STAGE_BYTES if panel_shape(d)[0] == 1 else _WIDE_STAGE_BYTES
    rows = stage // row // 4 * 4
    return min(n_max, max(lo, min(_MAX_CHUNK_ROWS, rows)))


@dataclass(frozen=True)
class NewtonPlan:
    """One launch of the Newton-system kernel. A unit of work is (entity,
    panel): unit u is panel u % panels of entity u // panels. Lane t of a
    team owns upper block panel * panel_blocks + t % panel_blocks and row
    group t // panel_blocks (rows i with i % row_groups equal to it); a CTA
    holds teams_per_cta teams and walks unit groups cta, cta + grid, ...,
    team j taking unit group * teams_per_cta + j. Only ``grid`` and
    ``ctas_per_sm`` depend on the card."""

    route: str
    entities: int
    block_side: int
    blocks: int
    panels: int
    panel_blocks: int
    team_warps: int
    row_groups: int
    teams_per_cta: int
    chunk_rows: int
    stages: int
    grid: int
    ctas_per_sm: int

    @property
    def threads(self) -> int:
        return self.teams_per_cta * self.team_warps * 32

    @property
    def lanes_per_unit(self) -> int:
        return self.panel_blocks * self.row_groups

    @property
    def units(self) -> int:
        return self.entities * self.panels

    @property
    def unit_groups(self) -> int:
        return -(-self.units // self.teams_per_cta)

    def cta_units(self, cta: int) -> list:
        t = self.teams_per_cta
        return [q * t + j for q in range(cta, self.unit_groups, self.grid) for j in range(t)
                if q * t + j < self.units]

    def unit_blocks(self, unit: int) -> range:
        """The upper blocks a unit computes."""
        p = unit % self.panels
        return range(p * self.panel_blocks, min(self.blocks, (p + 1) * self.panel_blocks))

    def group_rows(self, group: int, n_max: int) -> range:
        return range(group, n_max, self.row_groups)

    def layout(self) -> tuple:
        """Everything that decides the sums: the same on every card."""
        return (self.route, self.block_side, self.blocks, self.panels, self.panel_blocks,
                self.team_warps, self.row_groups, self.teams_per_cta, self.chunk_rows, self.stages)


def newton_plan(E: int, n_max: int, d: int, elem_size: int, route: str, sm_count: int,
                ctas_per_sm: int) -> NewtonPlan:
    nb, blocks = upper_blocks(d)
    panels, panel_blocks = panel_shape(d)
    warps, groups = team_shape(d)
    teams = max(1, _CTA_WARPS // warps)
    bulk = route == "bulk"
    return NewtonPlan(route, E, nb, blocks, panels, panel_blocks, warps, groups, teams,
                      chunk_rows(n_max, d, elem_size) if bulk else 0, NEWTON_STAGES if bulk else 0,
                      min(-(-E * panels // teams), sm_count * ctas_per_sm), ctas_per_sm)


# Resident CTAs per SM of the kernel, by (device, bf16, layout).
_OCCUPANCY: Dict[tuple, int] = {}


def _plan_on_card(X: Tensor, d2: Tensor, dz: Tensor) -> NewtonPlan:
    E, n_max, d = X.shape
    bf16, es = int(X.dtype == torch.bfloat16), X.element_size()
    route = newton_route(n_max, d, es, X.data_ptr(), d2.data_ptr(), dz.data_ptr())
    shape = newton_plan(E, n_max, d, es, route, 1, 1)
    key = (X.device.index, bf16, n_max, d, shape.layout())
    if key not in _OCCUPANCY:
        with torch.cuda.device(X.device):
            ctas = kernels.query_int(
                "newton_system", "pt_newton_system_occupancy", bf16, n_max, d,
                int(route == "bulk"), shape.panels, shape.team_warps, shape.row_groups,
                shape.teams_per_cta, shape.chunk_rows, shape.stages,
            )
        if ctas < 1:
            raise RuntimeError(f"newton_system: the kernel does not fit an SM at d={d}")
        _OCCUPANCY[key] = ctas
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    return newton_plan(E, n_max, d, es, route, sms, _OCCUPANCY[key])


def system_plan(X: Tensor, d2: Tensor, dz: Tensor) -> dict:
    """The launch plan ``newton_system`` uses for CUDA tensors."""
    return asdict(_plan_on_card(X, d2, dz))


def newton_system_plain(X: Tensor, d2: Tensor, dz: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain batched version of ``newton_system``."""
    acc = torch.promote_types(X.dtype, torch.float32)
    Xa = X.to(acc)
    H = torch.einsum("bnd,bn,bne->bde", Xa, d2.to(acc), Xa)
    g = torch.einsum("bnd,bn->bd", Xa, dz.to(acc))
    return H, g


# Launches of the kernel by width d, counted where ``kernels.LAUNCHES`` is.
LAUNCHES_BY_WIDTH: Dict[int, int] = {}
kernels.register_counts(LAUNCHES_BY_WIDTH)


def newton_system(X: Tensor, d2: Tensor, dz: Tensor) -> Tuple[Tensor, Tensor]:
    """(H (E, d, d), g (E, d)) for X (E, n_max, d), d2 and dz (E, n_max),
    at any width d."""
    E, n_max, d = X.shape
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
    p = _plan_on_card(X, d2, dz)
    kernels.launch(
        "newton_system", kernels.ptr(X), int(X.dtype == torch.bfloat16), kernels.ptr(d2),
        kernels.ptr(dz), kernels.ptr(H), kernels.ptr(g), E, n_max, d, int(p.route == "bulk"),
        p.panels, p.team_warps, p.row_groups, p.teams_per_cta, p.chunk_rows, p.stages, p.grid,
    )
    LAUNCHES_BY_WIDTH[d] = LAUNCHES_BY_WIDTH.get(d, 0) + 1
    return H, g
