"""HBM sink: stream tensors from a blob into device memory (the port of
``demodel_tpu/sink/hbm.py``).

Safetensors and GGUF byte ranges are parsed out of a store (anything with
``pread(key, length, offset)``, ``pread_into(key, out, offset)`` and
``size(key)``) or out of a host buffer (``buffer=``, memory-first
delivery), and each tensor lands on the device with one range read and
one host-to-device copy:

- a tensor split on its leading axis is contiguous in the file, so a
  device's rows are a single range read — no host copy of the whole
  checkpoint;
- quantized GGUF tensors ship only their quantized parts over the link
  and are dequantized on the device (:mod:`demodel_tpu_torch.ops.dequant`),
  shard-wise when the rows align to quant blocks.

One device only: a mesh of more devices raises (ROADMAP A7 brings
placement over several GPUs and the ``ici_complete`` all-gather leg).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from demodel_tpu_torch.formats import gguf as gguf_mod
from demodel_tpu_torch.formats import safetensors as st
from demodel_tpu_torch.ops import dequant
from demodel_tpu_torch.parallel.mesh import Mesh, make_mesh
from demodel_tpu_torch.sink.plan import ShardingPlan
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("sink")
_HOST = torch.device("cpu")


@dataclass
class Placement:
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    mesh_desc: str = ""
    #: background finalizer thread (deferred cache commit + manifest) set
    #: by a pull that defers its cache commit — join via :meth:`finalize`
    finalizer: object = None
    #: ``[(key, error)]`` from the deferred cache commits (set by the
    #: finalizer); ``integrity_errors`` ⊆ ``commit_errors`` are re-hash
    #: mismatches proving the DELIVERED bytes corrupt
    commit_errors: list = field(default_factory=list)
    integrity_errors: list = field(default_factory=list)
    #: exception the finalizer itself died with (e.g. the manifest write
    #: failed) — re-raised by :meth:`finalize`
    finalize_error: object = None
    #: delivery phase wall-clock split (``fetch_secs``/``place_secs``, or
    #: ``fetch_stall_secs`` under prefetch overlap) set by a pipelined
    #: pull — the network-bound vs device-transfer-bound diagnosis
    phase_secs: dict | None = None

    @property
    def total_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def finalize(self, timeout: float | None = None) -> None:
        """Join the deferred persistence work (cache commits, manifest,
        store close). Raises when optimistic verification found delivered
        bytes corrupt — the arrays in this placement must be discarded and
        re-pulled. No-op when delivery was not deferred."""
        if self.finalizer is not None:
            self.finalizer.join(timeout)
            if self.finalizer.is_alive():
                raise TimeoutError(
                    f"delivery finalizer still running after {timeout}s")
        if self.integrity_errors:
            raise IOError("delivered bytes failed digest verification; "
                          f"discard this placement: {self.integrity_errors}")
        if self.finalize_error is not None:
            raise IOError("delivery finalization failed (cache/manifest "
                          "not persisted)") from self.finalize_error


def _slices_contiguous_rows(idx: tuple, shape: tuple[int, ...]) -> tuple[int, int] | None:
    """If ``idx`` selects whole trailing dims and a row range on axis 0,
    return (row_start, row_stop); else None."""
    if not shape:
        return None
    first = idx[0] if idx else slice(None)
    rest = idx[1:] if len(idx) > 1 else ()
    for i, s in enumerate(rest):
        full = s == slice(None) or (
            isinstance(s, slice)
            and (s.start in (0, None))
            and (s.stop in (None, shape[i + 1]))
        )
        if not full:
            return None
    if first == slice(None):
        return 0, shape[0]
    if isinstance(first, slice):
        start = first.start or 0
        stop = first.stop if first.stop is not None else shape[0]
        return start, stop
    return None


def _device_indices(mesh: Mesh, spec: tuple, shape: tuple[int, ...]
                    ) -> dict[torch.device, tuple]:
    """Each device's index into a tensor of ``shape`` placed by ``spec``,
    as jax's ``addressable_devices_indices_map`` gives it. On one device
    that is the whole tensor; more devices raise."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"placement over {mesh.size} devices (mesh {mesh.shape}, spec "
            f"{spec}) is not ported yet (ROADMAP A7); pass a one-device "
            "mesh, e.g. make_mesh(1)")
    return {mesh.devices.flat[0]: (slice(None),) * len(shape)}


def _read_into_from(read_at):
    """A ``read_into(offset, out)`` over a ``read_at(offset, length)``."""
    def read_into(offset: int, out: np.ndarray) -> int:
        raw = np.frombuffer(read_at(offset, out.nbytes), np.uint8)
        out[:raw.size] = raw
        return raw.size
    return read_into


def place_tensor(
    read_at,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    start: int,
    mesh: Mesh,
    spec: tuple = (),
    cast_to: torch.dtype | None = None,
    read_into=None,
    ici_complete: bool = False,
) -> torch.Tensor:
    """Place one tensor reading only its device's byte range.

    ``read_at(offset, length)`` serves file-absolute ranges; ``start`` is
    the tensor's first data byte. The range lands in a host buffer —
    through ``read_into(offset, out)`` straight into it when given — and
    goes to the device in one copy, then casts there to ``cast_to``.

    ``ici_complete`` is accepted and ignored: the all-gather that
    completes replicas across chips has no meaning on one GPU (ROADMAP
    A7 brings it)."""
    del ici_complete
    itemsize = dtype.itemsize
    if read_into is None:
        read_into = _read_into_from(read_at)
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize if shape else itemsize

    def read_range(offset: int, nbytes: int, out_shape) -> torch.Tensor:
        host = torch.empty(nbytes, dtype=torch.uint8)
        got = read_into(offset, host.numpy())
        if got != nbytes:
            raise IOError(f"short read: {got} != {nbytes}")
        return host.view(dtype).reshape(out_shape)

    (device, idx), = _device_indices(mesh, spec, shape).items()
    rows = _slices_contiguous_rows(idx, shape)
    if rows is not None:
        r0, r1 = rows
        arr = read_range(start + r0 * row_bytes, (r1 - r0) * row_bytes,
                         (r1 - r0,) + shape[1:])
    else:  # a 0-d tensor
        total = int(np.prod(shape, dtype=np.int64)) * itemsize
        arr = read_range(start, total, shape)[idx]
    arr = arr.to(device)
    if cast_to is not None and arr.dtype != cast_to:
        arr = arr.to(cast_to)
    return arr


# ------------------------------------------------------------- safetensors


def _default_plan(mesh: Mesh | None, plan: ShardingPlan | None
                  ) -> tuple[Mesh, ShardingPlan]:
    if mesh is None:
        mesh = make_mesh()
    return mesh, plan if plan is not None else ShardingPlan(mesh)


def deliver_safetensors(
    store,
    key: str,
    mesh: Mesh | None = None,
    plan: ShardingPlan | None = None,
    cast_to: torch.dtype | None = None,
    buffer=None,
    ici_complete: bool | None = None,
    skip: set | None = None,
) -> Placement:
    """Land every tensor of a stored safetensors blob on the device.

    With ``buffer`` (a bytes-like landing buffer of the whole file),
    tensor ranges are views of host memory — no store read on the
    delivery path. ``skip`` names tensors already placed: their ranges
    are neither read nor transferred. The mesh defaults to the CUDA
    device; ``ici_complete`` is accepted and ignored (ROADMAP A7)."""
    del ici_complete
    mesh, plan = _default_plan(mesh, plan)
    if buffer is not None:
        mv = memoryview(buffer).cast("B")
        read_at = lambda off, ln: mv[off:off + ln]  # noqa: E731 — zero-copy
        read_into = None
        index = st.read_index_from(read_at, total_size=len(mv))
    else:
        read_at = lambda off, ln: store.pread(key, ln, off)  # noqa: E731
        read_into = lambda off, out: store.pread_into(key, out, off)  # noqa: E731
        index = st.read_index_from(read_at, total_size=store.size(key))
    out = Placement(mesh_desc=f"{mesh.shape}")
    for name, spec in index.tensors.items():
        if skip and name in skip:
            continue
        dtype = st.torch_dtype(spec.dtype)
        out.arrays[name] = place_tensor(
            read_at, spec.shape, dtype, spec.start, mesh,
            plan.sharding_for(name, spec.shape, dtype.itemsize), cast_to,
            read_into=read_into,
        )
    return out


# -------------------------------------------------------------------- gguf


def _split(t: gguf_mod.GGUFTensor, raw):
    """The host's share of one GGUF tensor's delivery: split its blocks
    into parts (:func:`decode_raw` gives strided views) and make each a
    dense host tensor, since the kernels read dense rows. Timed into
    ``stage_duration_seconds{span="sink.split"}``."""
    with trace.span("sink.split"):
        decoded = gguf_mod.decode_raw(t, raw)
        if isinstance(decoded, tuple):
            return tuple(dequant.to_device(p, _HOST) for p in decoded)
        return dequant.to_device(decoded, _HOST)


def _dequant_shard(t: gguf_mod.GGUFTensor, raw, shape, out_dtype, device):
    decoded = _split(
        gguf_mod.GGUFTensor(t.name, t.ggml_type, shape, 0, len(raw)), raw
    )
    if t.ggml_type in (gguf_mod.GGML_F32, gguf_mod.GGML_F16):
        return dequant.to_device(decoded, device).to(out_dtype)
    parts = [dequant.to_device(p, device) for p in decoded]
    flat = dequant._FNS[t.ggml_type](*parts, out_dtype)
    return flat.reshape(shape)


def deliver_gguf(
    store,
    key: str,
    mesh: Mesh | None = None,
    plan: ShardingPlan | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
    buffer=None,
) -> Placement:
    """Land a GGUF blob's tensors on the device as ``out_dtype``
    (dequantized there, shard-wise when the rows align to quant blocks,
    else through :func:`~demodel_tpu_torch.ops.dequant.dequant_gguf_tensor`
    on the whole tensor). The mesh defaults to the CUDA device."""
    mesh, plan = _default_plan(mesh, plan)
    if buffer is not None:
        mv = memoryview(buffer).cast("B")
        read_at = lambda off, ln: mv[off:off + ln]  # noqa: E731 — zero-copy
    else:
        read_at = lambda off, ln: store.pread(key, ln, off)  # noqa: E731
    index = gguf_mod.read_index_from(read_at)
    out = Placement(mesh_desc=f"{mesh.shape}")
    for name, t in index.tensors.items():
        spec = plan.sharding_for(name, t.shape, 2)
        row_elems = int(np.prod(t.shape[1:], dtype=np.int64)) if len(t.shape) > 1 else 1
        blk_elems, bpb = gguf_mod._BLOCK_GEOM[t.ggml_type]
        (device, idx), = _device_indices(mesh, spec, t.shape).items()
        rows = _slices_contiguous_rows(idx, t.shape)
        # shard-wise dequant needs each row range to start/end on a quant
        # block boundary (32 elems for Q*_0, 256 for K-quants)
        if rows is not None and row_elems % blk_elems == 0:
            r0, r1 = rows
            row_bytes = row_elems // blk_elems * bpb
            raw = read_at(t.start + r0 * row_bytes, (r1 - r0) * row_bytes)
            # one device: its shard is the whole tensor
            out.arrays[name] = _dequant_shard(
                t, raw, (r1 - r0,) + t.shape[1:], out_dtype, device)
            continue
        # fallback: whole-tensor dequant
        raw = read_at(t.start, t.nbytes)
        out.arrays[name] = dequant.dequant_gguf_tensor(
            t, _split(t, raw), out_dtype, device)
    return out


# ------------------------------------------------------------------ report


def is_weight_file(name: str, media_type: str = "") -> bool:
    """Artifacts the HBM sink delivers (shared with the streaming sink)."""
    return (
        name.endswith(".safetensors")
        or name.endswith(".gguf")
        or media_type == "application/vnd.ollama.image.model"
    )


def deliver_file(store, name: str, key: str, mesh: Mesh,
                 plan: ShardingPlan, cast_to: torch.dtype | None = None,
                 buffer=None, ici_complete: bool | None = None) -> Placement:
    """Deliver one weight file (dispatch by format). ``buffer``
    short-circuits the store read (memory-first delivery)."""
    if name.endswith(".safetensors"):
        return deliver_safetensors(store, key, mesh, plan, cast_to,
                                   buffer=buffer, ici_complete=ici_complete)
    return deliver_gguf(store, key, mesh, plan, buffer=buffer)


def merge_placement(dst: Placement, placed: Placement) -> None:
    """Merge one file's tensors into the running placement, rejecting
    duplicate tensor names across shards."""
    overlap = set(dst.arrays) & set(placed.arrays)
    if overlap:
        raise ValueError(f"duplicate tensors across shards: {sorted(overlap)[:3]}")
    dst.arrays.update(placed.arrays)


def deliver_report_to_hbm(store, report, mesh: Mesh | None = None,
                          plan: ShardingPlan | None = None) -> Placement:
    """Deliver every weight artifact of a pull report (an object with
    ``files``, or a dict) onto the device."""
    mesh, plan = _default_plan(mesh, plan)
    files = report.files if hasattr(report, "files") else report["files"]
    out = Placement(mesh_desc=f"{mesh.shape}")
    for f in files:
        name = f.name if hasattr(f, "name") else f["name"]
        key = f.key if hasattr(f, "key") else f["key"]
        media = f.media_type if hasattr(f, "media_type") else f.get("media_type", "")
        if not is_weight_file(name, media):
            continue
        merge_placement(out, deliver_file(store, name, key, mesh, plan))
    log.info("delivered %d tensors (%.1f MB) onto mesh %s",
             len(out.arrays), out.total_bytes / 1e6, out.mesh_desc)
    return out
