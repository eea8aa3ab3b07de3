"""Device mesh construction (the port of ``demodel_tpu/parallel/mesh.py``).

Axes: ``dp`` data, ``sp`` sequence/context, ``ep`` expert, ``pp``
pipeline, ``tp`` tensor. ``dp`` and ``tp`` always exist (size 1 when
unused); the optional axes appear only when requested. The leftover
device factor lands in ``tp`` unless ``tp`` was pinned, in which case it
lands in ``dp``: ``make_mesh(8)`` → ``{'dp': 1, 'tp': 8}``;
``make_mesh(8, tp=1, pp=4)`` → ``{'dp': 2, 'pp': 4, 'tp': 1}``.

A :class:`Mesh` is a numpy array of torch devices with axis names, over
the CUDA devices present (``device=None``) or the CPU (``device="cpu"``,
one device). Placement over more than one device is ROADMAP A7.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from demodel_tpu_torch.device import resolve


@dataclass(frozen=True)
class Mesh:
    devices: np.ndarray            # of torch.device, one dim per axis
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


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


def make_mesh(n_devices: int | None = None, *, dp: int | None = None,
              sp: int | None = None, ep: int | None = None,
              pp: int | None = None, tp: int | None = None,
              device: str | torch.device | None = None) -> Mesh:
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


def one_device(mesh: Mesh, what: str) -> torch.device:
    """The device of a one-device ``mesh``; ``what`` over more devices
    raises (ROADMAP A7)."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"{what} over {mesh.size} devices (mesh {mesh.shape}) is not "
            "ported yet (ROADMAP A7); pass a one-device mesh, e.g. "
            "make_mesh(1)")
    return mesh.devices.flat[0]
