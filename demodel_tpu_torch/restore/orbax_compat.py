"""Placements ↔ checkpoint files on disk: the twin of
``demodel_tpu/restore/orbax_compat.py`` for PyTorch.

The reference writes Orbax checkpoints for the JAX tools that insist on
files; the port writes ``torch.distributed.checkpoint`` (DCP) directories
through ``FileSystemWriter`` and reads them back through
``FileSystemReader``, for the PyTorch tools that do. The files are DCP,
not Orbax: the two packages' files do not read across. Over the network,
:mod:`demodel_tpu_torch.restore.orbax_http` serves DCP consumers instead.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed.checkpoint as dcp

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.sink.hbm import Placement
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("restore.orbax")


def _nest(flat: dict) -> dict:
    """``'a.b.c'`` keys → a nested dict (what DCP flattens back to the
    same dotted names)."""
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, name))
        else:
            flat[name] = v
    return flat


def save_placement(placement: Placement, path: Path | str) -> None:
    """Write a placement as a DCP checkpoint directory at ``path``."""
    path = Path(path).absolute()
    dcp.save(_nest(placement.arrays),
             storage_writer=dcp.FileSystemWriter(path), no_dist=True)
    log.info("saved %d tensors to DCP checkpoint %s",
             len(placement.arrays), path)


def load_placement(path: Path | str, device=None) -> Placement:
    """Load a DCP checkpoint directory written by :func:`save_placement`
    onto ``device`` (default ``cuda``)."""
    path = Path(path).absolute()
    dev = resolve(device)
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    flat = {name: torch.empty(m.size, dtype=m.properties.dtype, device=dev)
            for name, m in meta.items()}
    tree = _nest(flat)
    dcp.load(tree, storage_reader=reader, no_dist=True)
    out = Placement(arrays=_flatten(tree), mesh_desc="dcp")
    log.info("loaded %d tensors from DCP checkpoint %s", len(out.arrays),
             path)
    return out
