"""GPipe-style pipeline of stages (the port of
``demodel_tpu/parallel/pipeline.py``) on one device.

Stages are one STACKED params tree (leading axis = stage), the form a
``pp`` mesh axis shards; :func:`pipeline_apply` runs every microbatch
through all stages in order. Microbatches are independent given the
stage weights, so on one device the schedule is sequential composition,
differentiable by autograd and equal to running the stages one after
another. Sharding the stage axis over ``pp`` GPUs is ROADMAP A7.
"""

from __future__ import annotations

from typing import Callable

import torch

from demodel_tpu_torch.parallel.mesh import Mesh, one_device
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.tree import leaves, tree_map


def stack_stages(stages: list) -> dict:
    """List of per-stage trees (identical structure) → one stacked tree
    with a leading stage axis."""
    if not stages:
        raise ValueError("no stages")
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *stages)


def unstack_stages(stacked, n: int) -> list:
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] → [n_micro, B/n_micro, ...] (validated split)."""
    if x.shape[0] % n_micro != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def pipeline_apply(stage_fn: Callable, stages, xmb: torch.Tensor,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """Run microbatched input [M, b, ...] through all stages in order.

    ``stage_fn(stage_params, activation) -> activation``; ``stages`` is
    the stacked tree. Returns [M, b, ...]. ``mesh`` must be one device:
    more raise (ROADMAP A7). Under the export tier of
    :mod:`~demodel_tpu_torch.utils.trace` (``DEMODEL_TRACE`` or
    ``trace.enable()``), the call runs under a ``compute.gpipe`` span that
    synchronises the device so it times the compute, not the launches;
    the default observe tier skips it, so default callers keep
    asynchronous launches."""
    if mesh is not None:
        one_device(mesh, "pipeline_apply")
    n_stages = leaves(stages)[0].shape[0]
    M = xmb.shape[0]
    per_stage = unstack_stages(stages, n_stages)

    def run() -> torch.Tensor:
        outs = []
        for m in range(M):
            a = xmb[m]
            for stage in per_stage:
                a = stage_fn(stage, a)
            outs.append(a)
        return torch.stack(outs, dim=0)

    if not trace.enabled():
        return run()
    with trace.span("compute.gpipe", stages=int(n_stages),
                    microbatches=int(M)):
        out = run()
        if out.device.type == "cuda":
            # observability-only sync, under opted-in export tracing
            torch.cuda.synchronize(out.device)
        return out


def pipeline_stage_spec(ndim: int) -> tuple:
    """The partition spec of a stacked stage leaf of ``ndim`` dims (stage
    axis over pp, the rest replicated)."""
    return ("pp",) + (None,) * (ndim - 1)


def shard_stages(stages, mesh: Mesh):
    """Place a stacked stage tree on ``mesh``'s device; a mesh of more
    devices (the stage axis over ``pp``) raises (ROADMAP A7)."""
    dev = one_device(mesh, "shard_stages")
    return tree_map(lambda x: x.to(dev), stages)
