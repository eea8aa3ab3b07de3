"""Port parity: ``demodel_tpu_torch.ops.dequant`` against the JAX
package's Pallas dequant kernels (interpret mode on the CPU, pinned with
``DEMODEL_FORCE_PALLAS=1`` as tests/test_dequant.py runs them) and against
the normative numpy decoders (``REF_DEQUANT``) of both packages.

Random packed blocks (every bit pattern of a payload is a valid block)
with sane f16 scale fields come from a seeded numpy generator and go to
every side. Tolerance: f32, ``atol = rtol = 1e-4``, the reference's own.
On CPU tensors the port's wrappers run the kernels' plain versions, so
these tests hold the function the CUDA kernels must compute; the kernels
themselves are held against those plain versions on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu_torch.formats import gguf as tg
from demodel_tpu_torch.ops import dequant as tdq

jg = importlib.import_module("demodel_tpu.formats.gguf")
jdq = importlib.import_module("demodel_tpu.ops.dequant")

torch.set_num_threads(1)

ATOL = RTOL = 1e-4

_FORMATS = {"q8_0": tg.GGML_Q8_0, "q4_0": tg.GGML_Q4_0,
            "q2_k": tg.GGML_Q2_K, "q3_k": tg.GGML_Q3_K,
            "q4_k": tg.GGML_Q4_K, "q5_k": tg.GGML_Q5_K,
            "q6_k": tg.GGML_Q6_K}
#: bytes of each block that are quant payload (randomized), the rest
#: being the encoder's f16 scale fields (d, dmin), kept
_PAYLOAD = {tg.GGML_Q8_0: slice(2, None), tg.GGML_Q4_0: slice(2, None),
            tg.GGML_Q2_K: slice(0, 80), tg.GGML_Q3_K: slice(0, 108),
            tg.GGML_Q4_K: slice(4, None), tg.GGML_Q5_K: slice(4, None),
            tg.GGML_Q6_K: slice(0, 208)}
# (format, block count): Q8_0/Q4_0 up to 64 blocks, K-quants up to 8;
# 1, 3 and 7 are odd counts
CASES = ([(f, n) for f in ("q8_0", "q4_0") for n in (1, 7, 64)]
         + [(f, n) for f in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k")
            for n in (3, 8)])


def _block_elems(ggml_type: int) -> int:
    return tg._BLOCK_GEOM[ggml_type][0]


def _random_blocks(ggml_type: int, nblocks: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    bpb = tg._BLOCK_GEOM[ggml_type][1]
    x = rng.standard_normal(nblocks * _block_elems(ggml_type))
    out = np.frombuffer(tg.encode(x.astype(np.float32), ggml_type),
                        np.uint8).reshape(nblocks, bpb).copy()
    sl = _PAYLOAD[ggml_type]
    out[:, sl] = rng.integers(0, 256, out[:, sl].shape, dtype=np.uint8)
    return out.tobytes()


def _decoded(ggml_type: int, nblocks: int, seed: int):
    raw = _random_blocks(ggml_type, nblocks, seed)
    t = tg.GGUFTensor("t", ggml_type, (nblocks * _block_elems(ggml_type),),
                      0, len(raw))
    return tg.decode_raw(t, raw)


def _port(ggml_type: int, parts, out_dtype=torch.float32) -> np.ndarray:
    tparts = [tdq.to_device(p, "cpu") for p in parts]
    return tdq._FNS[ggml_type](*tparts, out_dtype).float().numpy()


@pytest.mark.parametrize("fmt,nblocks", CASES,
                         ids=[f"{f}-{n}" for f, n in CASES])
def test_port_matches_pallas_kernel_and_reference(fmt, nblocks,
                                                  monkeypatch):
    monkeypatch.setenv("DEMODEL_FORCE_PALLAS", "1")
    ggml_type = _FORMATS[fmt]
    parts = _decoded(ggml_type, nblocks, seed=nblocks)
    got = _port(ggml_type, parts)
    assert got.shape == (nblocks * _block_elems(ggml_type),)
    pallas = np.asarray(jdq._FNS[ggml_type](
        *[jnp.asarray(p) for p in parts], jnp.float32))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, tg.REF_DEQUANT[ggml_type](*parts),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, jg.REF_DEQUANT[ggml_type](*parts),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fmt", list(_FORMATS))
def test_zero_blocks_and_default_dtype(fmt):
    ggml_type = _FORMATS[fmt]
    empty = [tdq.to_device(p, "cpu") for p in _decoded(ggml_type, 0, seed=0)]
    out = tdq._FNS[ggml_type](*empty, torch.float32)
    assert out.shape == (0,) and out.dtype == torch.float32
    one = [tdq.to_device(p, "cpu") for p in _decoded(ggml_type, 1, seed=5)]
    out = tdq._FNS[ggml_type](*one)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tdq._FNS[ggml_type](*one, torch.float32)
                       .to(torch.bfloat16))


def test_scale_unpacking_matches_reference():
    """The plain versions' 6-bit scale unpacking against the numpy
    reference, over every byte value in every position."""
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 256, (512, 12), dtype=np.uint8)
    packed[:256, 0] = np.arange(256)  # every value in the shuffled bytes
    packed[256:, 8] = np.arange(256)
    sc = tdq._q3_k_scales(torch.from_numpy(packed))
    np.testing.assert_array_equal(sc.numpy(), tg.unpack_q3k_scales(packed))
    s4, m4 = tdq._k4_scales(torch.from_numpy(packed))
    ref_s, ref_m = tg.unpack_k4_scales(packed)
    np.testing.assert_array_equal(s4.numpy(), ref_s)
    np.testing.assert_array_equal(m4.numpy(), ref_m)


def test_dequant_gguf_tensor_end_to_end():
    """encode → GGUF container → decode_raw → dequant_gguf_tensor, every
    format plus F32/F16, against the reference decode of the same bytes
    and the JAX package's whole-tensor dequant."""
    rng = np.random.default_rng(11)
    shapes = {"q8_0": (3, 64), "q4_0": (2, 96), "q2_k": (2, 256),
              "q3_k": (1, 512), "q4_k": (3, 256), "q5_k": (2, 256),
              "q6_k": (1, 768), "f32": (5, 7), "f16": (4,)}
    types = {**_FORMATS, "f32": tg.GGML_F32, "f16": tg.GGML_F16}
    tensors = {n: rng.standard_normal(s).astype(np.float32)
               for n, s in shapes.items()}
    blob = tg.serialize(tensors, {n: types[n] for n in tensors})
    index = tg.parse(blob)
    for name, t in index.tensors.items():
        decoded = tg.decode_raw(t, blob[t.start:t.start + t.nbytes])
        got = tdq.dequant_gguf_tensor(t, decoded, torch.float32,
                                      device="cpu")
        assert got.shape == t.shape and got.dtype == torch.float32
        if t.ggml_type in tg.REF_DEQUANT:
            want = tg.REF_DEQUANT[t.ggml_type](*decoded).reshape(t.shape)
        else:
            want = np.asarray(decoded, np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        jt = jg.GGUFTensor(t.name, t.ggml_type, t.shape, t.start, t.nbytes)
        ref = jdq.dequant_gguf_tensor(
            jt, jg.decode_raw(jt, blob[t.start:t.start + t.nbytes]),
            jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)
