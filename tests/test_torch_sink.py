"""Port parity of the placement plane: ``demodel_tpu_torch.sink`` against
``demodel_tpu.sink`` on the same stored blobs.

Both packages read from the reference's own ``Store`` (the port takes
any object with ``pread`` / ``pread_into`` / ``size``) or from one host
buffer, and their placements must be byte-identical, tensor by tensor:
f32 GGUF dequant (Q8_0 + Q4_K + Q6_K + F32, a row count that is not
block-aligned, which takes the whole-tensor fallback), bf16 output, and
safetensors of several dtypes. The port places on the CPU here
(``make_mesh(device="cpu")``); the reference on a one-device mesh.
Also held: the range-read-only rule, the plan and mesh arithmetic
against the reference for 1, 5, 6 and 8 devices, and the port's format
copies against the originals.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu_torch.formats import gguf as tg
from demodel_tpu_torch.formats import safetensors as tst
from demodel_tpu_torch.parallel import mesh as tmesh
from demodel_tpu_torch.sink import (ShardingPlan, deliver_gguf,
                                    deliver_safetensors, hbm)

jg = importlib.import_module("demodel_tpu.formats.gguf")
jst = importlib.import_module("demodel_tpu.formats.safetensors")
jhbm = importlib.import_module("demodel_tpu.sink.hbm")
jplan = importlib.import_module("demodel_tpu.sink.plan")
jmesh = importlib.import_module("demodel_tpu.parallel.mesh")
Store = importlib.import_module("demodel_tpu.store").Store

torch.set_num_threads(1)


@pytest.fixture()
def store(tmp_path):
    s = Store(tmp_path / "store")
    yield s
    s.close()


def _cpu_mesh():
    return tmesh.make_mesh(device="cpu")


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(port, ref) -> None:
    assert set(port.arrays) == set(ref.arrays)
    for name, arr in ref.arrays.items():
        got = port.arrays[name]
        assert tuple(got.shape) == arr.shape, name
        assert got.device.type == "cpu", name
        assert _bytes(got) == np.asarray(arr).tobytes(), name


def _mixed_gguf():
    rng = np.random.default_rng(3)
    tensors = {
        "tok": rng.standard_normal((8, 256)).astype(np.float32),
        "wq": rng.standard_normal((4, 512)).astype(np.float32),
        "w6": rng.standard_normal((2, 768)).astype(np.float32),
        "norm": rng.standard_normal((64,)).astype(np.float32),
        "odd": rng.standard_normal((4, 48)).astype(np.float32),  # 48 % 32
        "flat": rng.standard_normal((96,)).astype(np.float32),
    }
    types = {"tok": jg.GGML_Q4_K, "wq": jg.GGML_Q8_0, "w6": jg.GGML_Q6_K,
             "odd": jg.GGML_Q8_0, "flat": jg.GGML_Q4_0}
    return jg.serialize(tensors, types, {"general.architecture": "llama"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gguf_placement_byte_identical(store, dtype):
    blob = _mixed_gguf()
    store.put("torchgguf0000001", blob, {})
    ref = jhbm.deliver_gguf(store, "torchgguf0000001",
                            mesh=jmesh.make_mesh(1),
                            out_dtype=getattr(jnp, dtype))
    port = deliver_gguf(store, "torchgguf0000001", mesh=_cpu_mesh(),
                        out_dtype=getattr(torch, dtype))
    _same(port, ref)
    assert port.total_bytes == sum(int(a.nbytes) for a in ref.arrays.values())
    # the same blob from a host buffer, with no store at all
    _same(deliver_gguf(None, "unused", mesh=_cpu_mesh(),
                       out_dtype=getattr(torch, dtype), buffer=blob), ref)


def test_gguf_whole_tensor_fallback_matches_reference_decode(store):
    """Rows of 48 Q8_0 values do not align to 32-value blocks: the tensor
    is dequantized whole and must equal the normative decode."""
    blob = _mixed_gguf()
    index = tg.parse(blob)
    t = index.tensors["odd"]
    assert t.shape == (4, 48)
    want = tg.REF_DEQUANT[t.ggml_type](
        *tg.decode_raw(t, blob[t.start:t.start + t.nbytes])).reshape(4, 48)
    port = deliver_gguf(None, "k", mesh=_cpu_mesh(), out_dtype=torch.float32,
                        buffer=blob)
    np.testing.assert_array_equal(port.arrays["odd"].numpy(), want)


def test_gguf_split_span_times_every_tensor():
    """The host's split of blocks into dense parts is timed inside the
    delivery, once per tensor, on the shard-wise route and the
    whole-tensor fallback alike."""
    from demodel_tpu_torch.utils.metrics import HUB, labeled

    name = labeled("stage_duration_seconds", span="sink.split")

    def seen():
        h = HUB.histograms().get(name)
        return (h["count"], h["sum"]) if h else (0, 0.0)

    blob = _mixed_gguf()
    n0, s0 = seen()
    deliver_gguf(None, "k", mesh=_cpu_mesh(), out_dtype=torch.float32,
                 buffer=blob)
    n1, s1 = seen()
    assert n1 - n0 == len(tg.parse(blob).tensors)
    assert s1 > s0


def _safetensors_blob():
    import ml_dtypes

    rng = np.random.default_rng(4)
    return {
        "w": rng.standard_normal((32, 16)).astype(np.float32),
        "b": rng.standard_normal((16,)).astype(np.float16),
        "x": rng.standard_normal((8, 8)).astype(ml_dtypes.bfloat16),
        "i": rng.integers(-5, 5, (3, 4)).astype(np.int32),
        "m": rng.integers(0, 2, (5,)).astype(np.bool_),
        "step": np.float32(17.0).reshape(()),
    }


def test_safetensors_placement_byte_identical(store):
    tensors = _safetensors_blob()
    blob = jst.serialize(tensors)
    store.put("torchst000000001", blob, {})
    ref = jhbm.deliver_safetensors(store, "torchst000000001",
                                   mesh=jmesh.make_mesh(1))
    port = deliver_safetensors(store, "torchst000000001", mesh=_cpu_mesh())
    _same(port, ref)
    assert port.arrays["x"].dtype == torch.bfloat16
    assert port.arrays["step"].shape == () and float(port.arrays["step"]) == 17
    _same(deliver_safetensors(None, "unused", mesh=_cpu_mesh(),
                              buffer=bytearray(blob)), ref)


def test_safetensors_keeps_64_bit_dtypes():
    """64-bit tensors land as stored. (The JAX package narrows them to 32
    bits when jax runs without x64, so no byte parity there.)"""
    i64 = np.arange(-3, 9, dtype=np.int64).reshape(3, 4) * (1 << 40)
    f64 = np.linspace(0, 1, 5)
    placed = deliver_safetensors(None, "unused", mesh=_cpu_mesh(),
                                 buffer=jst.serialize({"i": i64, "f": f64}))
    assert placed.arrays["i"].dtype == torch.int64
    np.testing.assert_array_equal(placed.arrays["i"].numpy(), i64)
    np.testing.assert_array_equal(placed.arrays["f"].numpy(), f64)


def test_safetensors_cast_and_skip(store):
    tensors = {k: v for k, v in _safetensors_blob().items()
               if k in ("w", "b", "x")}
    store.put("torchstcast00001", jst.serialize(tensors), {})
    ref = jhbm.deliver_safetensors(store, "torchstcast00001",
                                   mesh=jmesh.make_mesh(1),
                                   cast_to=np.float32, skip={"b"})
    port = deliver_safetensors(store, "torchstcast00001", mesh=_cpu_mesh(),
                               cast_to=torch.float32, skip={"b"})
    assert set(port.arrays) == {"w", "x"}
    _same(port, ref)


def test_placement_is_range_read_only(store, monkeypatch):
    """Delivery never reads the whole blob: one range per tensor (the
    reference's spy, tests/test_sink.py). On one device a tensor's range
    is the whole tensor; no read may span two tensors."""
    rng = np.random.default_rng(1)
    tensors = {"w": rng.standard_normal((64, 32)).astype(np.float32),
               "v": rng.standard_normal((32, 32)).astype(np.float32)}
    st_blob = jst.serialize(tensors)
    gg_blob = jg.serialize(tensors, {"w": jg.GGML_Q8_0, "v": jg.GGML_Q8_0})
    store.put("rangeonlyst00001", st_blob, {})
    store.put("rangeonlygg00001", gg_blob, {})

    reads = []
    orig_pread, orig_into = Store.pread, Store.pread_into

    def spy_pread(self, key, length, offset):
        reads.append(length)
        return orig_pread(self, key, length, offset)

    def spy_into(self, key, out, offset=0):
        reads.append(memoryview(out).nbytes)
        return orig_into(self, key, out, offset)

    monkeypatch.setattr(Store, "pread", spy_pread)
    monkeypatch.setattr(Store, "pread_into", spy_into)
    placed = deliver_safetensors(store, "rangeonlyst00001", mesh=_cpu_mesh())
    np.testing.assert_array_equal(placed.arrays["w"].numpy(), tensors["w"])
    assert max(reads) == tensors["w"].nbytes < len(st_blob)
    reads.clear()
    placed = deliver_gguf(store, "rangeonlygg00001", mesh=_cpu_mesh(),
                          out_dtype=torch.float32)
    assert placed.arrays["w"].shape == (64, 32)
    biggest = tg.tensor_nbytes(tg.GGML_Q8_0, 64 * 32)
    assert max(reads) == biggest < len(gg_blob)


@pytest.mark.parametrize("n", [1, 5, 6, 8])
def test_mesh_and_plan_match_reference(n):
    kwargs = [{}, {"tp": 1}, {"dp": 1}, {"tp": 1, "pp": n}, {"sp": n},
              {"ep": n, "tp": 1}]
    shapes = [(128, 64), (100, 64), (64,), (), (16, 8, 32), (n * 8, 4),
              (40, 2)]
    for kw in kwargs:
        ref = jmesh.make_mesh(n, **kw)
        sizes = tmesh.axis_sizes(n, **kw)
        assert sizes == dict(ref.shape), kw
        assert tuple(sizes) == ref.axis_names
        devices = np.empty(n, dtype=object)
        devices[:] = [torch.device("cpu")] * n
        mesh = tmesh.Mesh(devices.reshape(tuple(sizes.values())),
                          tuple(sizes))
        assert mesh.shape == dict(ref.shape) and mesh.size == n
        for min_bytes in (None, 0):
            rplan = jplan.ShardingPlan(ref, min_bytes)
            tplan = ShardingPlan(mesh, min_bytes)
            for shape in shapes:
                for itemsize in (1, 4):
                    want = tuple(rplan.sharding_for("t", shape,
                                                    itemsize).spec)
                    assert tplan.sharding_for("t", shape, itemsize) == want
        if n > 1:  # placement over several GPUs is ROADMAP A7
            with pytest.raises(NotImplementedError, match="A7"):
                deliver_gguf(None, "k", mesh=mesh, buffer=_mixed_gguf())
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.axis_sizes(n, tp=n + 1)


def test_cpu_mesh_has_one_device():
    mesh = _cpu_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.devices.flat[0] == torch.device("cpu")
    with pytest.raises(ValueError, match="requested 2 devices"):
        tmesh.make_mesh(2, device="cpu")


def test_format_copies_match_originals():
    rng = np.random.default_rng(9)
    tensors = {"q8": rng.standard_normal((2, 64)).astype(np.float32),
               "q4": rng.standard_normal((64,)).astype(np.float32),
               "k2": rng.standard_normal((256,)).astype(np.float32),
               "k3": rng.standard_normal((1, 256)).astype(np.float32),
               "k4": rng.standard_normal((2, 256)).astype(np.float32),
               "k5": rng.standard_normal((256,)).astype(np.float32),
               "k6": rng.standard_normal((256,)).astype(np.float32),
               "f16": rng.standard_normal((3, 3)).astype(np.float32),
               "f32": rng.standard_normal((5,)).astype(np.float32),
               "s": np.float32(2.0).reshape(())}
    types = {"q8": 8, "q4": 2, "k2": 10, "k3": 11, "k4": 12, "k5": 13,
             "k6": 14, "f16": 1}
    meta = {"general.name": "t", "n": 3, "x": 0.5, "flag": True}
    for align in (32, 64):
        blob = jg.serialize(tensors, types, meta, alignment=align)
        assert tg.serialize(tensors, types, meta, alignment=align) == blob
        ri, pi = jg.parse(blob), tg.parse(blob)
        assert (ri.metadata, ri.alignment, ri.data_start) == \
            (pi.metadata, pi.alignment, pi.data_start)
        assert {k: vars(v) for k, v in ri.tensors.items()} == \
            {k: vars(v) for k, v in pi.tensors.items()}
    st_tensors = {k: v for k, v in _safetensors_blob().items() if k != "x"}
    blob = jst.serialize(st_tensors, {"format": "pt"})
    assert tst.serialize(st_tensors, {"format": "pt"}) == blob
    mv = memoryview(blob)
    ri = jst.read_index_from(lambda o, n: mv[o:o + n], len(blob))
    pi = tst.read_index_from(lambda o, n: mv[o:o + n], len(blob))
    assert (ri.metadata, ri.data_start, ri.total_size) == \
        (pi.metadata, pi.data_start, pi.total_size)
    assert {k: vars(v) for k, v in ri.tensors.items()} == \
        {k: vars(v) for k, v in pi.tensors.items()}
    # a bf16 tensor through the port's writer reads back in the original
    x = _safetensors_blob()["x"]
    port_blob = tst.serialize({"x": torch.from_numpy(x.view(np.uint16))
                               .view(torch.bfloat16)})
    assert port_blob == jst.serialize({"x": x})


def test_helpers_match_reference():
    for idx, shape in [((slice(None), slice(None)), (4, 8)),
                       ((slice(2, 4), slice(None)), (4, 8)),
                       ((slice(None), slice(0, 4)), (4, 8)),
                       ((slice(1, None),), (4,)), ((), ())]:
        assert hbm._slices_contiguous_rows(idx, shape) == \
            jhbm._slices_contiguous_rows(idx, shape)
    for name, media in [("a.gguf", ""), ("m.safetensors", ""),
                        ("blob", "application/vnd.ollama.image.model"),
                        ("config.json", "")]:
        assert hbm.is_weight_file(name, media) == \
            jhbm.is_weight_file(name, media)


def test_report_delivery_matches_reference(store):
    """A pull report's weight files (GGUF and safetensors) merge into one
    placement; other files are skipped; a name in two files raises."""
    store.put("reportgguf000001", _mixed_gguf(), {})
    tensors = {k: v for k, v in _safetensors_blob().items() if k != "x"}
    store.put("reportst00000001", jst.serialize(tensors), {})
    store.put("reportcfg0000001", b"{}", {})
    report = {"files": [
        {"name": "model.gguf", "key": "reportgguf000001"},
        {"name": "model.safetensors", "key": "reportst00000001"},
        {"name": "config.json", "key": "reportcfg0000001"}]}
    ref = jhbm.deliver_report_to_hbm(store, report, mesh=jmesh.make_mesh(1))
    port = hbm.deliver_report_to_hbm(store, report, mesh=_cpu_mesh())
    _same(port, ref)
    dup = {"files": report["files"][:1] * 2}
    with pytest.raises(ValueError, match="duplicate tensors"):
        hbm.deliver_report_to_hbm(store, dup, mesh=_cpu_mesh())
