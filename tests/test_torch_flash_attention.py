"""Port parity: ``demodel_tpu_torch.ops.flash_attention`` against the JAX
package's reference attention and its Pallas kernel (interpret mode on
the CPU, as tests/test_flash_attention.py runs it).

Inputs come from a seeded numpy generator and go to both packages.
Tolerances are the reference's own: 2e-5 in f32, 2e-2 in bf16. On CPU
tensors the port's ``flash_attention`` runs the kernel's plain version,
so these tests hold the function the CUDA kernel must compute; the
kernel itself is held against that plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu_torch.ops import flash_attention as tfa
from demodel_tpu_torch.ops import flash_default as tfd
from demodel_tpu_torch.ops.ring_attention import dense_attention

jfa = importlib.import_module("demodel_tpu.ops.flash_attention")
jring = importlib.import_module("demodel_tpu.ops.ring_attention")
#: jit the JAX references: eager dispatch compiles every op per shape
_jref = jax.jit(jfa.reference_attention_lse, static_argnums=(3,))
_jdense = jax.jit(jring.dense_attention, static_argnums=(3,))

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 2e-2

# name, B, Sq, Sk, H, G, D, causal, kv_len, causal_offset
CASES = [
    ("causal_square", 2, 40, 40, 4, 4, 16, True, None, None),
    ("noncausal_tails", 2, 24, 70, 4, 4, 16, False, None, None),
    ("gqa_ratio_4", 1, 33, 33, 8, 2, 16, True, None, None),
    ("gqa_ratio_8", 1, 20, 20, 8, 1, 32, True, None, None),
    ("decode_window", 1, 5, 72, 4, 4, 16, True, None, None),
    ("per_batch_kv_len", 3, 4, 48, 4, 2, 16, True, [17, 48, 30], None),
    ("kv_len_zero_row", 2, 6, 20, 4, 4, 16, True, [0, 13], None),
    ("per_batch_offset", 2, 12, 16, 4, 4, 16, True, None, [-8, 3]),
    ("sq_gt_kv_len", 1, 12, 16, 2, 2, 16, True, 4, None),
    ("noncausal_kv_len", 2, 9, 30, 4, 2, 16, False, [11, 30], None),
]
IDS = [c[0] for c in CASES]


def _inputs(B, Sq, Sk, H, G, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, G, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, G, D)).astype(np.float32)
    return q, k, v


def _arg(x, lib):
    if x is None:
        return None
    a = np.asarray(x, np.int32)
    return jnp.asarray(a) if lib == "jax" else torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_reference_lse_matches_jax(case):
    _, B, Sq, Sk, H, G, D, causal, kv_len, off = case
    q, k, v = _inputs(B, Sq, Sk, H, G, D, seed=1)
    want, want_lse = _jref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
        _arg(kv_len, "jax"), _arg(off, "jax"))
    got, got_lse = tfa.reference_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_len=_arg(kv_len, "torch"),
        causal_offset=_arg(off, "torch"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_matches_jax_kernel(case):
    """The port's flash_attention (plain version on CPU) against the
    Pallas kernel in interpret mode — output and LSE, fully-masked rows
    (zeros, NEG_INF) included."""
    _, B, Sq, Sk, H, G, D, causal, kv_len, off = case
    q, k, v = _inputs(B, Sq, Sk, H, G, D, seed=2)
    want, want_lse = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=_arg(kv_len, "jax"), causal=causal,
        causal_offset=_arg(off, "jax"), block_q=32, block_k=32,
        return_lse=True)
    before = tfa.launches
    got, got_lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=_arg(kv_len, "torch"), causal=causal,
        causal_offset=_arg(off, "torch"), return_lse=True)
    assert tfa.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == torch.float32 and got_lse.shape == (B, Sq, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, [9, 30])],
                         ids=["causal", "noncausal_kv_len"])
def test_flash_bf16_matches_jax_kernel(causal, kv_len):
    """bf16 in, fp32 accumulate, bf16 out — against the interpreted
    kernel on the same bf16 inputs."""
    q, k, v = _inputs(2, 24, 30, 4, 2, 32, seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, kv_len=_arg(kv_len, "jax"),
                               causal=causal, block_q=16, block_k=16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, kv_len=_arg(kv_len, "torch"),
                              causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("G", [4, 2, 1], ids=["mha", "gqa2", "gqa4"])
def test_dense_attention_matches_jax(G):
    q, k, v = _inputs(2, 19, 19, 4, G, 16, seed=4)
    want = _jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    got = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_flash_mixed_dtypes_promote_like_jax():
    """bf16 queries over an fp32 cache: the JAX kernel reads every tile
    in fp32 and returns q's dtype; the port promotes the same way."""
    q, k, v = _inputs(1, 8, 20, 4, 4, 16, seed=5)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = tfa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                              kv_len=13)
    want = jfa.flash_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                               jnp.asarray(v), kv_len=13, block_q=8,
                               block_k=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_rejects_bad_head_ratio():
    q, k, v = _inputs(1, 4, 4, 6, 4, 16)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))


# ------------------------------------------------------------ launch plan
#
# The host-side choices of a launch, from the tensors' metadata alone:
# no build and no card (the kernels are held against the plain version on
# the card by chip_smoke.py).

MAIN_PATH_LENS = (17, 64, 96, 128, 512)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("S", MAIN_PATH_LENS)
def test_plan_main_path_bf16_goes_to_tensor_cores(S):
    """Llama-2-7B prefill (B=1, H=G=32, D=128, kv_len=S as an int): the
    tensor-core kernel, one block per 64 rows of one head, windows by
    value, no copies."""
    q = _bf16(1, S, 32, 128)
    plan = tfa.launch_plan(q, q, q, kv_len=S)
    assert plan.kernel == "wgmma_bf16"
    assert plan.grid == (-(-S // 64), 32, 1)
    assert plan.threads == 160
    assert plan.smem_bytes == 64 * 128 * 2 * 5 + 1024   # Q + 2-stage K/V
    assert (plan.windows, plan.kv_len, plan.causal_offset) == ("scalar", S,
                                                               0)
    assert plan.copy == (False, False, False)


@pytest.mark.parametrize("S", MAIN_PATH_LENS + (2048,))
def test_plan_main_path_f16_goes_to_tensor_cores(S):
    """A pulled F16 Llama-2 checkpoint's prefill: the f16 instantiation of
    the tensor-core kernel, the bf16 one's grid, block and shared memory,
    one launch with no copies."""
    q = torch.zeros(1, S, 32, 128, dtype=torch.float16)
    plan = tfa.launch_plan(q, q, q, kv_len=S)
    assert (plan.kernel, plan.code) == ("wgmma_f16", 2)
    assert plan.grid == (-(-S // 64), 32, 1)
    assert plan.threads == 160
    assert plan.smem_bytes == 64 * 128 * 2 * 5 + 1024
    assert plan.windows == "scalar" and plan.copy == (False, False, False)


@pytest.mark.parametrize("D", [64, 128])
def test_plan_f32_goes_to_cuda_cores(D):
    """float32 goes to its own kernel (3xTF32 on the tensor cores since
    the CUDA-core one was replaced): 64 rows a block of 128 threads, the
    Q tile and the 2-stage K/V ring of 32 keys, Q and K in rows of D + 16
    floats, V in rows of D + 4, at the head dim itself (a multiple of
    16)."""
    q = torch.zeros(2, 70, 8, D)
    k = torch.zeros(2, 90, 2, D)
    plan = tfa.launch_plan(q, k, k)
    assert plan.kernel == "tf32x3_f32" and plan.threads == 128
    assert plan.grid == (2, 8, 2)
    assert plan.smem_bytes == 4 * ((D + 16) * (64 + 64) + (D + 4) * 64)
    assert tfa.padded_head_dim(plan.kernel, D) == D
    # defaults: kv_len = Sk, causal_offset = kv_len - Sq
    assert (plan.windows, plan.kv_len, plan.causal_offset) == ("scalar", 90,
                                                               20)


@pytest.mark.parametrize("kv_len,offset,windows", [
    (40, None, "scalar"),
    (np.int32(40), 3, "scalar"),
    (None, -5, "scalar"),
    (torch.tensor([40, 20], dtype=torch.int32), None, "vector"),
    (40, torch.tensor([0, 3], dtype=torch.int32), "vector"),
    ([40, 20], None, "vector"),
], ids=["int", "numpy_int", "offset_only", "kv_tensor", "offset_tensor",
        "kv_list"])
def test_plan_windows_by_value_only_for_ints(kv_len, offset, windows):
    q, k = _bf16(2, 24, 4, 64), _bf16(2, 48, 4, 64)
    plan = tfa.launch_plan(q, k, k, kv_len, offset)
    assert plan.windows == windows
    if windows == "scalar":
        kvb, offb = tfa._windows(kv_len, offset, 2, 24, 48, q.device)
        assert (plan.kv_len, plan.causal_offset) == (int(kvb[0]),
                                                     int(offb[0]))


def test_plan_copies_only_what_tma_cannot_read():
    """bf16 k/v views: a head slice of a wider buffer is read in place; a
    row stride that is not a multiple of 16 bytes, or a base off 16-byte
    alignment, is copied contiguous first."""
    q = _bf16(2, 32, 8, 128)
    wide = _bf16(2, 40, 4, 128)[:, :, 2:]          # strides 16-byte multiples
    padded = _bf16(2, 40, 2, 132)[..., :128]       # 264-byte rows
    shifted = _bf16(2 * 40 * 2 * 128 + 1)[1:].view(2, 40, 2, 128)
    assert tfa.launch_plan(q, wide, wide).copy == (False, False, False)
    assert tfa.launch_plan(q, padded, wide).copy == (False, True, False)
    assert tfa.launch_plan(q, wide, shifted).copy == (False, False, True)
    assert tfa.launch_plan(q, padded, wide).maps == ("4d",) * 3
    # the float32 kernel reads any strides with a unit last one
    fq = torch.zeros(2, 32, 8, 128)
    fpadded = torch.zeros(2, 40, 2, 132)[..., :128]
    ftransposed = torch.zeros(2, 40, 128, 2).transpose(2, 3)
    assert tfa.launch_plan(fq, fpadded, fpadded).copy == (False, False,
                                                          False)
    assert tfa.launch_plan(fq, fpadded, ftransposed).copy == (False, False,
                                                              True)


@pytest.mark.parametrize("q,k,err", [
    # every bf16 head dim up to 256 goes to the tensor cores
    (_bf16(1, 8, 4, 32), _bf16(1, 8, 4, 32), "wgmma_bf16"),    # D=32
    # float16 has its tensor-core kernel: planned, not refused
    (torch.zeros(1, 8, 4, 64, dtype=torch.float16),
     torch.zeros(1, 8, 4, 64, dtype=torch.float16), "wgmma_f16"),
    (torch.zeros(1, 8, 4, 64, dtype=torch.float64),
     torch.zeros(1, 8, 4, 64, dtype=torch.float64), TypeError),
    (_bf16(1, 8, 4, 64), torch.zeros(1, 8, 4, 64), TypeError),  # mixed
    (_bf16(1, 8, 4, 64), torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16,
                                     device="meta"), ValueError),
    (_bf16(1, 8, 4, 264), _bf16(1, 8, 4, 264), ValueError),     # D > 256
], ids=["head_dim_32", "float16", "float64", "mixed_dtypes", "two_devices",
        "head_dim_264"])
def test_plan_rejects_what_no_kernel_takes(q, k, err):
    if isinstance(err, str):
        assert tfa.launch_plan(q, k, k).kernel == err
        return
    with pytest.raises(err):
        tfa.launch_plan(q, k, k)


#: head dims other than 64 and 128 (100: OpenLLaMA-3B's), with the
#: padded head dim of the f32 (3xTF32) and the bf16/f16 (``wgmma``)
#: instantiation that takes each
ODD_HEAD_DIMS = {8: (16, 64), 32: (32, 64), 80: (80, 128), 96: (96, 128),
                 100: (112, 128), 256: (256, 256)}


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32")],
                         ids=["f32"])
@pytest.mark.parametrize("D", sorted(ODD_HEAD_DIMS))
def test_plan_every_head_dim_goes_to_cuda_cores(D, dtype, suffix):
    """Every float32 head dim: the float32 kernel (3xTF32 on the tensor
    cores), 64 rows a block, shared memory for the padded head dim
    (205,824 bytes at 256, above the 48 KB default), read in place
    through strides."""
    q = torch.zeros(1, 512, 32, D, dtype=dtype)
    k = torch.zeros(1, 512, 8, D, dtype=dtype)
    plan = tfa.launch_plan(q, k, k, kv_len=512)
    dp = ODD_HEAD_DIMS[D][0]
    assert plan.kernel == f"tf32x3_{suffix}"
    assert plan.code == tfa.KERNELS[plan.kernel][0]
    assert (plan.grid, plan.threads) == ((8, 32, 1), 128)
    assert tfa.padded_head_dim(plan.kernel, D) == dp
    ld_qk = dp + 16 if dp % 32 == 0 else dp
    assert plan.smem_bytes == 4 * (ld_qk * (64 + 64) + (dp + 4) * 64)
    assert plan.copy == (False, False, False)
    assert plan.maps == ("strides",) * 3
    assert plan.kernel in tfa.launches_by_kernel
    if D == 256:
        assert plan.smem_bytes == 205824


@pytest.mark.parametrize("dtype,suffix", [
    (torch.bfloat16, "bf16"), (torch.float16, "f16")], ids=["bf16", "f16"])
@pytest.mark.parametrize("D", sorted(ODD_HEAD_DIMS))
def test_plan_every_head_dim_goes_to_tensor_cores(D, dtype, suffix):
    """Every bf16 or f16 head dim: the tensor-core kernel at the head dim
    padded to 64, 128 or 256, 64 rows a block, shared memory for the Q
    tile and the 2-stage K/V ring at that width (164,864 bytes at 256:
    one block an SM), q/k/v read in place through the 4-D map where the
    head stride is a multiple of 16 bytes."""
    q = torch.zeros(1, 512, 32, D, dtype=dtype)
    k = torch.zeros(1, 512, 8, D, dtype=dtype)
    plan = tfa.launch_plan(q, k, k, kv_len=512)
    dp = ODD_HEAD_DIMS[D][1]
    assert plan.kernel == f"wgmma_{suffix}"
    assert plan.code == tfa.KERNELS[plan.kernel][0]
    assert (plan.grid, plan.threads) == ((8, 32, 1), 160)
    assert tfa.padded_head_dim(plan.kernel, D) == dp
    assert plan.smem_bytes == 64 * dp * 2 * 5 + 1024
    if D % 8:
        # D=100 with 4 q heads a kv head: q and k padded for the 4-D map
        assert plan.copy == (True, True, False)
        assert plan.maps == ("4d", "4d", "rows")
    else:
        assert plan.copy == (False, False, False)
        assert plan.maps == ("4d",) * 3
    assert plan.kernel in tfa.launches_by_kernel
    if D == 256:
        assert plan.smem_bytes == 164864


def test_plan_d100_reads_q_and_the_kv_cache_in_place():
    """OpenLLaMA-3B's shapes (H=G=32, D=100: a 200-byte head stride that
    no 4-D map takes): q and k/v as views of a 2048-row KV cache, or as
    a head slice of a wider buffer, go through the row map with no copy;
    D=80 (160-byte heads) through the 4-D map."""
    f16 = torch.float16
    q = torch.zeros(1, 512, 32, 100, dtype=f16)
    cache = torch.zeros(1, 2048, 32, 100, dtype=f16)
    plan = tfa.launch_plan(q, cache[:, :1024], cache[:, :1024], kv_len=900)
    assert (plan.kernel, plan.windows) == ("wgmma_f16", "scalar")
    assert (plan.kv_len, plan.causal_offset) == (900, 388)
    assert plan.copy == (False, False, False)
    assert plan.maps == ("rows", "rows", "rows")
    wide = torch.zeros(1, 512, 64, 100, dtype=f16)[:, :, 32:]  # 6400 B in
    assert tfa.tma_map(wide) == "rows"
    assert tfa.launch_plan(q, wide, wide).maps == ("rows",) * 3
    q80 = torch.zeros(1, 512, 32, 80, dtype=f16)
    assert tfa.launch_plan(q80, q80, q80).maps == ("4d",) * 3


@pytest.mark.parametrize("view,want", [
    ("contiguous", "rows"),
    ("column_slice_8", "4d"),      # 104-wide rows: a 208-byte head stride
    ("column_slice_2", None),      # 102-wide rows: heads not packed
    ("one_head_rows", None),       # 200-byte rows
    ("shifted_base", None),        # base 2 bytes off 16-byte alignment
    ("odd_head_dim", None),        # D=255: a shift of up to 7 passes 256
])
def test_plan_pads_what_no_map_takes(view, want):
    """The padding rule: a bf16 tensor that no TMA map reads in place is
    copied once into a contiguous zero buffer whose head dim is padded to
    a multiple of 8, which the 4-D map reads; the values and the plan's
    kernel are unchanged."""
    def rnd(*shape):
        g = torch.Generator().manual_seed(0)
        return torch.randn(*shape, generator=g).to(torch.bfloat16)

    t = {"contiguous": lambda: rnd(2, 16, 4, 100),
         "column_slice_8": lambda: rnd(2, 16, 4, 104)[..., :100],
         "column_slice_2": lambda: rnd(2, 16, 4, 102)[..., :100],
         "one_head_rows": lambda: rnd(2, 16, 1, 100),
         "shifted_base": lambda: rnd(2 * 16 * 4 * 100 + 1)[1:].view(
             2, 16, 4, 100),
         "odd_head_dim": lambda: rnd(2, 16, 8, 255)}[view]()
    assert tfa.tma_map(t) == want
    plan = tfa.launch_plan(t, t, t)
    assert plan.kernel == "wgmma_bf16"
    assert plan.copy == (want is None,) * 3
    assert plan.maps == (want or "4d",) * 3
    padded = tfa._pad8(t)
    D, D8 = t.shape[3], -(-t.shape[3] // 8) * 8
    assert padded.shape == t.shape and torch.equal(padded, t)
    assert padded.stride()[2:] == (D8, 1)
    assert tfa.tma_map(padded) == "4d"
    tail = padded.as_strided((*t.shape[:3], D8 - D),
                             (*padded.stride()[:3], 1), D)
    assert not tail.any()


@pytest.mark.parametrize("G,maps,copy", [
    (32, ("rows", "rows", "rows"), (False, False, False)),
    (8, ("4d", "4d", "rows"), (True, True, False)),
], ids=["one_kv_head_per_q_head", "gqa"])
def test_plan_row_map_takes_q_and_k_only_together(G, maps, copy):
    """Through the row map a head sits (head·D) % 8 columns into its tile
    (4 for odd heads at D=100), and Q·Kᵀ needs q's and k's heads at one
    shift: so q and k take the row map together and only with one kv
    head per q head; with GQA the plan pads copies of q and k for the
    4-D map, and v still takes the row map."""
    q = torch.zeros(1, 64, 32, 100, dtype=torch.float16)
    kv = torch.zeros(1, 64, G, 100, dtype=torch.float16)
    plan = tfa.launch_plan(q, kv, kv)
    assert (plan.maps, plan.copy) == (maps, copy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", sorted(ODD_HEAD_DIMS))
def test_flash_matches_jax_kernel_at_every_head_dim(D, dtype):
    """The function the kernels compute at head dims other than 64 and 128
    (the f32 3xTF32 kernel, the bf16 ``wgmma`` kernel, each at the padded
    head dim), against the Pallas kernel in interpret mode: GQA, causal,
    a per-batch kv_len; f32 at 2e-5, bf16 at 2e-2 (the reference's
    tolerances)."""
    q, k, v = _inputs(2, 20, 24, 4, 2, D, seed=D)
    kv_len = [24, 13]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want, want_lse = jfa.flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), kv_len=_arg(kv_len, "jax"),
        causal=True, block_q=8, block_k=8, return_lse=True)
    tdt = getattr(torch, dtype)
    got, got_lse = tfa.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        kv_len=_arg(kv_len, "torch"), causal=True, return_lse=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=tol, atol=tol)


def test_plan_rejects_windows_outside_int32():
    q = _bf16(1, 8, 4, 64)
    with pytest.raises(ValueError, match="int32"):
        tfa.launch_plan(q, q, q, kv_len=2 ** 31)


@pytest.mark.parametrize("causal", [True, False])
def test_int_and_vector_windows_give_identical_plain_results(causal):
    """The by-value form (what the main path passes) and the tensor form
    of the same windows compute the same function."""
    q, k, v = _inputs(3, 10, 40, 4, 2, 64, seed=6)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    by_value = tfa.flash_attention(tq, tk, tv, kv_len=33, causal=causal,
                                   causal_offset=20, return_lse=True)
    as_tensor = tfa.flash_attention(
        tq, tk, tv, kv_len=torch.full((3,), 33, dtype=torch.int32),
        causal=causal, causal_offset=torch.tensor([20, 20, 20]),
        return_lse=True)
    for a, b in zip(by_value, as_tensor):
        assert torch.equal(a, b)


def test_launch_args_match_the_c_struct():
    """The packed launch arguments follow csrc's ``LaunchArgs`` field by
    field: int64 each, then the double ``scale``, no padding."""
    import re

    (src,) = tfa.SOURCES
    body = re.search(r"struct LaunchArgs \{(.*?)\};", src.read_text(),
                     re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = re.match(r"(long long|double)\s+(.*)", decl,
                                    re.S).groups()
            fields += [(ctype, n.strip()) for n in names.split(",")]
    assert [n for _, n in fields] == list(tfa.ARG_FIELDS)
    assert [c for c, _ in fields] == ["long long"] * (len(fields) - 1) + [
        "double"]
    assert tfa._ARGS.size == 8 * len(fields)


# ------------------------------------------------------------- routing
#
# The rule a model asks before the call (ops/flash_default.py): unset,
# every attention on CUDA tensors goes to the kernel, whatever its dtype
# and head dim, and what no kernel takes raises in launch_plan; CPU
# tensors take the einsum path. DEMODEL_FLASH_ATTN is the caller's
# explicit choice.


@pytest.mark.parametrize("device,want", [("cuda", True), ("cpu", False)])
def test_routing_default_is_the_device(monkeypatch, device, want):
    monkeypatch.delenv("DEMODEL_FLASH_ATTN", raising=False)
    assert tfd.use_flash_attention(device) is want


@pytest.mark.parametrize("dtype,D,err", [
    (torch.float16, 8, "wgmma_f16"),      # LlamaConfig.tiny() in f16
    (torch.float32, 32, "tf32x3_f32"),
    (torch.bfloat16, 96, "wgmma_bf16"),
    (torch.float16, 100, "wgmma_f16"),    # OpenLLaMA-3B
    (torch.float64, 128, TypeError),
    (torch.bfloat16, 320, ValueError),
], ids=["f16_d8", "f32_d32", "bf16_d96", "f16_d100", "f64_d128",
        "bf16_d320"])
def test_cuda_shape_without_kernel_raises_not_einsum(monkeypatch, dtype, D,
                                                     err):
    """Unset, every CUDA shape routes to the kernel: each bf16 or f16 head
    dim up to 256 is planned on the ``wgmma`` kernel and each float32
    one on the 3xTF32 kernel, and what no kernel takes (float64, a
    head dim past 256) raises in the plan. Nothing on the card drops to
    einsum unless the caller says ``DEMODEL_FLASH_ATTN=0``."""
    monkeypatch.delenv("DEMODEL_FLASH_ATTN", raising=False)
    assert tfd.use_flash_attention("cuda")
    q = torch.empty(1, 4, 8, D, dtype=dtype, device="meta")
    if isinstance(err, str):
        assert tfa.launch_plan(q, q[:, :, :2], q[:, :, :2]).kernel == err
    else:
        with pytest.raises(err):
            tfa.launch_plan(q, q[:, :, :2], q[:, :, :2])
    monkeypatch.setenv("DEMODEL_FLASH_ATTN", "0")
    assert not tfd.use_flash_attention("cuda")
    monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    assert tfd.use_flash_attention("cpu")


@pytest.mark.parametrize("env,want_calls", [(None, 2), ("0", 0)],
                         ids=["default", "explicit_einsum"])
def test_llama_asks_the_rule_per_layer(monkeypatch, env, want_calls):
    """The model asks the rule with its tensors' device at every layer:
    as if they were on CUDA, the tiny config's head dim of 8 reaches the
    kernel wrapper (on the card, the f32 3xTF32 kernel);
    ``DEMODEL_FLASH_ATTN=0`` keeps it on einsum."""
    from demodel_tpu_torch.models import common as tcommon
    from demodel_tpu_torch.models import llama as tl

    if env is None:
        monkeypatch.delenv("DEMODEL_FLASH_ATTN", raising=False)
    else:
        monkeypatch.setenv("DEMODEL_FLASH_ATTN", env)
    asked, called = [], []

    def rule(device):
        asked.append(torch.device(device).type)
        return tfd.use_flash_attention("cuda")

    def kernel(*a, **kw):
        called.append(1)
        return tfa.flash_attention(*a, **kw)

    monkeypatch.setattr(tcommon, "_p", rule)
    monkeypatch.setattr(tl, "flash_attention", kernel)
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tl.step_prefill(params, torch.zeros(1, 5, dtype=torch.long), cfg)
    assert asked == ["cpu"] * cfg.num_hidden_layers
    assert len(called) == want_calls


def _tiny_plan(dtype: str):
    """The launch plan of ``LlamaConfig.tiny()``'s prefill q/k/v (9
    tokens) in ``dtype``, and the config."""
    import dataclasses

    from demodel_tpu_torch.models import llama as tl

    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=dtype)
    T = 9
    q = torch.zeros(1, T, tcfg.num_attention_heads, tcfg.head_dim,
                    dtype=tcfg.torch_dtype)
    k = torch.zeros(1, T, tcfg.num_key_value_heads, tcfg.head_dim,
                    dtype=tcfg.torch_dtype)
    return tfa.launch_plan(q, k, k, kv_len=T), tcfg


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "wgmma_bf16"),
                                          ("float16", "wgmma_f16")])
def test_tiny_config_plans_on_its_dtype_kernel(dtype, kernel):
    """``LlamaConfig.tiny()`` (head dim 8) in bf16 and f16: its prefill's
    q/k/v plan onto the tensor-core kernel of the model's type, at
    padded head dim 64."""
    plan, tcfg = _tiny_plan(dtype)
    assert plan.kernel == kernel
    assert tfa.padded_head_dim(plan.kernel, tcfg.head_dim) == 64


@pytest.mark.parametrize("dtype,kernel", [("float32", "tf32x3_f32")])
def test_tiny_config_goes_through_the_cuda_core_kernel(monkeypatch, dtype,
                                                       kernel):
    """``LlamaConfig.tiny()`` (head dim 8) in f32: its prefill's q/k/v
    plan onto the float32 (3xTF32) kernel, and its fp32 logits through the
    kernel's plain version stay within 2e-4 of the JAX package's."""
    from demodel_tpu.models import llama as jl
    from demodel_tpu_torch.models import convert
    from demodel_tpu_torch.models import llama as tl

    plan, tcfg = _tiny_plan(dtype)
    assert plan.kernel == kernel
    T = 9
    monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    jcfg = jl.LlamaConfig.tiny()
    jparams = jax.jit(jl.init_params, static_argnums=(1,))(
        jax.random.key(4), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (1, T))
    want = jax.jit(jl.forward, static_argnums=(2,))(jparams,
                                                    jnp.asarray(tok), jcfg)
    got = tl.forward(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
