"""Device mesh construction (the port of ``demodel_tpu/parallel/mesh.py``).

Axes: ``dp`` data, ``sp`` sequence/context, ``ep`` expert, ``pp``
pipeline, ``tp`` tensor. ``dp`` and ``tp`` always exist (size 1 when
unused); the optional axes appear only when requested. The leftover
device factor lands in ``tp`` unless ``tp`` was pinned, in which case it
lands in ``dp``: ``make_mesh(8)`` → ``{'dp': 1, 'tp': 8}``;
``make_mesh(8, tp=1, pp=4)`` → ``{'dp': 2, 'pp': 4, 'tp': 1}``.

A :class:`Mesh` is a numpy array of torch devices with axis names. Where
the JAX package drives every device from one controller, the port runs
one process per rank (``torchrun``, or any launcher that starts the
default ``torch.distributed`` process group): while that group is up,
:func:`make_mesh` spans its world, position ``r`` of the array (row-major
over the axes, ``tp`` fastest, as ``jax.devices()`` fills the reference's
array) is rank ``r``, and each rank drives its own device — ``cuda:
LOCAL_RANK``, or the CPU for a gloo group asked for with ``device="cpu"``.
Every named axis gets a sub-group over the ranks that differ only in
that axis (:meth:`Mesh.group`), and the mesh a group of all its ranks
(:attr:`Mesh.world_group`), each created with the mesh's ``timeout``;
:attr:`Mesh.coords` is this rank's coordinate on each axis. With no
process group, the mesh is one process's devices (the CUDA devices
present, or the CPU); placement and the models take such a mesh only
when it has one device (:func:`one_device`).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from demodel_tpu_torch.device import resolve

#: how long a collective on a mesh's groups may wait for its peers
#: before it raises (a rank that never reaches it would hang the rest),
#: unless ``make_mesh(timeout=)`` says otherwise
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
#: the key of the group over every rank in :attr:`Mesh.groups`
_ALL = "*"


@dataclass(frozen=True)
class Mesh:
    devices: np.ndarray            # of torch.device, one dim per axis
    axis_names: tuple[str, ...]
    #: this process's position in ``devices.flat`` when the mesh spans a
    #: ``torch.distributed`` world (its rank there); None when one
    #: process drives every device of the mesh
    rank: int | None = None
    #: axis name → the sub-group of this rank along that axis (and
    #: ``"*"`` → the group of every rank)
    groups: dict = field(default_factory=dict, compare=False, repr=False)
    #: how long a collective on these groups waits for its peers
    timeout: datetime.timedelta = field(default=GROUP_TIMEOUT,
                                        compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        """The device this process drives: its rank's, or the first."""
        return self.devices.flat[self.rank or 0]

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (all 0 off a world)."""
        idx = np.unravel_index(self.rank or 0, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def group(self, axis: str):
        """The sub-group of this rank's peers along ``axis``."""
        if not self.distributed:
            raise ValueError("a mesh outside a torch.distributed world has "
                             "no process groups")
        return self.groups[axis]

    @property
    def world_group(self):
        """The group of every rank of the mesh (made with its timeout)."""
        return self.group(_ALL)


def axis_sizes(n: int, *, dp: int | None = None, sp: int | None = None,
               ep: int | None = None, pp: int | None = None,
               tp: int | None = None) -> dict[str, int]:
    """Axis name → size for ``n`` devices, in mesh order."""
    fixed = 1
    for v in (dp, sp, ep, pp, tp):
        if v is not None:
            if v <= 0:
                raise ValueError("mesh axis sizes must be positive")
            fixed *= v
    if n % fixed != 0:
        raise ValueError(f"{n} devices not divisible by requested axes "
                         f"(product {fixed})")
    rest = n // fixed
    if tp is None:
        tp = rest
        rest = 1
    if dp is None:
        dp = rest
        rest = 1
    if rest != 1:
        raise ValueError(f"axis sizes {fixed * rest} != device count {n}")
    sizes = {"dp": dp}
    for name, size in (("sp", sp), ("ep", ep), ("pp", pp)):
        if size is not None:
            sizes[name] = size
    sizes["tp"] = tp
    return sizes


def _world_device(device) -> torch.device:
    """This rank's device: the CPU when asked for, else
    ``cuda:LOCAL_RANK`` (made current, as NCCL wants)."""
    dev = resolve(device)
    if dev.type == "cpu":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise ValueError(f"LOCAL_RANK {local} but only "
                         f"{torch.cuda.device_count()} CUDA devices")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def _axis_groups(shape: tuple[int, ...], names: tuple[str, ...],
                 rank: int, timeout: datetime.timedelta) -> dict:
    """One sub-group per axis holding ``rank``, then the group of every
    rank. Every rank creates every group in the same order, as
    ``new_group`` requires."""
    import torch.distributed as dist

    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    groups = {}
    for ax, name in enumerate(names):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line], timeout=timeout)
            if rank in line:
                groups[name] = g
    groups[_ALL] = dist.new_group(list(range(ranks.size)), timeout=timeout)
    return groups


def make_mesh(n_devices: int | None = None, *, dp: int | None = None,
              sp: int | None = None, ep: int | None = None,
              pp: int | None = None, tp: int | None = None,
              device: str | torch.device | None = None,
              timeout: datetime.timedelta = GROUP_TIMEOUT) -> Mesh:
    """The mesh of ``n_devices`` (all by default) with the given axis
    sizes (:func:`axis_sizes`). Over a process group, its groups give up
    on a peer after ``timeout``; every rank must pass the same value."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices not in (None, world):
            raise ValueError(f"requested {n_devices} devices, the "
                             f"process group has {world} ranks")
        sizes = axis_sizes(world, dp=dp, sp=sp, ep=ep, pp=pp, tp=tp)
        mine = _world_device(device)
        names = [None] * world
        dist.all_gather_object(names, str(mine))
        arr = np.empty(world, dtype=object)
        arr[:] = [torch.device(n) for n in names]
        shape = tuple(sizes.values())
        return Mesh(arr.reshape(shape), tuple(sizes), rank,
                    _axis_groups(shape, tuple(sizes), rank, timeout),
                    timeout)
    dev = resolve(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    sizes = axis_sizes(len(devices), dp=dp, sp=sp, ep=ep, pp=pp, tp=tp)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes.values())), tuple(sizes))


def local_device(mesh: Mesh, what: str) -> torch.device:
    """The device this process places ``what`` on: its rank's on a
    world-spanning mesh, the only one of a one-device mesh. One process
    driving several devices raises: the port runs a process per rank."""
    if mesh.distributed or mesh.size == 1:
        return mesh.device
    raise NotImplementedError(
        f"{what} over {mesh.size} devices of one process (mesh "
        f"{mesh.shape}): the port runs one process per rank — start a "
        "torch.distributed process group (torchrun) and make_mesh() spans "
        "it (ROADMAP A7)")


def one_device(mesh: Mesh, what: str) -> torch.device:
    """The device of a one-device ``mesh``; ``what`` over more devices
    raises (the families of ROADMAP A7's part two)."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"{what} over {mesh.size} devices (mesh {mesh.shape}) is not "
            "ported yet (ROADMAP A7); pass a one-device mesh, e.g. "
            "make_mesh(1)")
    return mesh.device


def shard_index(mesh: Mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """This rank's index into a tensor of ``shape`` placed by ``spec`` (a
    partition spec: per leading dim None, an axis name, or a tuple of
    axis names whose coordinates combine row-major), as jax's
    ``addressable_devices_indices_map`` gives it. A dim whose size the
    axes do not divide raises."""
    coords = mesh.coords
    idx = []
    for d, size in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        axes = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        n, i = 1, 0
        for a in axes:
            n *= mesh.axis_size(a)
            i = i * mesh.axis_size(a) + coords.get(a, 0)
        if n == 1:
            idx.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"dim {d} of {shape} not divisible by "
                             f"{axes} ({n})")
        step = size // n
        idx.append(slice(i * step, (i + 1) * step))
    return tuple(idx)
