"""The device mesh over torch.distributed ranks (port of
photon_tpu/parallel/mesh.py).

The reference's mesh is a ``jax.sharding.Mesh`` whose axes name its
parallelism styles: ``data`` (samples; gradient reductions), ``feature``
(the coefficient vector of a very wide coordinate) and, on a multi-slice
pod, an outer ``slice`` axis; the entity axis aliases the data axis. Here a
mesh is a grid of the job's ranks, (data, feature) or (slice, data,
feature), rank r at the r-th cell in row-major order, with one process group
for each line of each axis: the ranks that differ only along that axis. A
rank knows its own coordinates and the groups it belongs to; a reduction
over an axis is an ``all_reduce`` over that axis's group.

``dp_axes`` are the data-parallel axes: (slice, data) on a multi-slice mesh,
(data,) otherwise. A reduction over them runs inside each slice first (the
data group), then across slices (the slice group), as the reference's
hierarchical psum does (ICI, then DCN).

Without an initialized process group a mesh is one rank (world 1) and its
reductions do nothing. A mesh's device is the one given, else the device
this rank joined on (utils/virtual_devices.py::init_rank), else the current
CUDA device; the CPU only when asked for or when no card is visible.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
ENTITY_AXIS = "data"  # entities shard over the same axis as samples
FEATURE_AXIS = "feature"
SLICE_AXIS = "slice"  # multi-slice (DCN) outer data axis

Tensor = torch.Tensor


def default_device() -> torch.device:
    """This rank's device (module docstring)."""
    from photon_tpu_torch.utils.virtual_devices import joined_device

    dev = joined_device()
    if dev is not None:
        return dev
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of ranks with named axes; see the module docstring.

    ``shape`` maps each axis to its size, ``coords`` each axis to this
    rank's index along it, ``groups`` each axis to the process group of this
    rank's line along it (None when there is no process group: then every
    reduction is a no-op). ``device`` is this rank's device (default:
    ``default_device()``)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], device=None):
        self.axis_names = tuple(axis_names)
        self.rank, self.world = _world()
        if int(np.prod(sizes)) != self.world:
            raise ValueError(f"mesh {dict(zip(axis_names, sizes))} needs {int(np.prod(sizes))} ranks, the job has "
                             f"{self.world}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.grid = np.arange(self.world).reshape(tuple(sizes))
        here = np.argwhere(self.grid == self.rank)[0]
        self.coords: Dict[str, int] = {a: int(i) for a, i in zip(self.axis_names, here)}
        grouped = dist.is_available() and dist.is_initialized()
        self.backend = dist.get_backend() if grouped else None
        self.device = torch.device(device) if device is not None else default_device()
        self.groups: Dict[str, Optional[object]] = {}
        # Every rank creates every group, in one order (torch.distributed's rule).
        for k, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.grid, k, -1).reshape(-1, self.grid.shape[k])
            mine = None
            for line in lines:
                ranks = [int(r) for r in line]
                # A line of one rank gets a group too: its reductions go
                # through the backend (NCCL's capture path at world 1).
                g = dist.new_group(ranks) if grouped else None
                if self.rank in ranks:
                    mine = g
            self.groups[axis] = mine

    def size(self, *axes: str) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, *axes: str) -> int:
        """This rank's index along ``axes`` taken together (row-major)."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def all_reduce(self, t: Tensor, axes: Sequence[str]) -> Tensor:
        """Sum ``t`` in place over ``axes``: the innermost axis first (inside
        a slice, then across slices). Returns ``t``."""
        for axis in reversed(tuple(axes)):
            g = self.groups.get(axis)
            if g is not None:
                dist.all_reduce(t, group=g)
        return t

    def all_gather(self, t: Tensor, axis: str) -> list:
        """This rank's ``t`` and its peers' along ``axis`` (equal shapes), in
        axis order."""
        g = self.groups.get(axis)
        if g is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(out, t.contiguous(), group=g)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.backend}, {self.device})"


def make_mesh(n_data: Optional[int] = None, n_feature: int = 1, device=None) -> Mesh:
    """A (data, feature) mesh over the job's ranks."""
    _rank, world = _world()
    if n_data is None:
        n_data = world // n_feature
    return Mesh((DATA_AXIS, FEATURE_AXIS), (n_data, n_feature), device)


def make_multislice_mesh(n_slices: int, n_feature: int = 1, device=None) -> Mesh:
    """A (slice, data, feature) mesh: ``n_slices`` slices of world / n_slices
    ranks, each slice a block of consecutive ranks."""
    _rank, world = _world()
    if world % n_slices:
        raise ValueError(f"{world} ranks do not split into {n_slices} slices")
    per_slice = world // n_slices
    if per_slice % n_feature:
        raise ValueError(f"a slice of {per_slice} ranks does not split over {n_feature} feature shards")
    return Mesh((SLICE_AXIS, DATA_AXIS, FEATURE_AXIS), (n_slices, per_slice // n_feature, n_feature), device)


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes: ('slice', 'data') on a multi-slice mesh,
    ('data',) otherwise."""
    if SLICE_AXIS in mesh.axis_names:
        return (SLICE_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def owned_shards(n_shards: int, mesh: Optional[Mesh]) -> list:
    """The shards s of ``n_shards`` that this rank owns along the data axes:
    those with (s·dp)//S == its data index, the rule of
    ``EntityShardPlan.device_of`` (parallel/entity_shard.py), for entity
    and row shards alike. All of them without a mesh."""
    if mesh is None:
        return list(range(n_shards))
    dp, i = mesh.size(*dp_axes(mesh)), mesh.index(*dp_axes(mesh))
    return [s for s in range(n_shards) if (s * dp) // n_shards == i]
