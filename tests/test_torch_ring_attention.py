"""The port's ring attention against the JAX package's
``ops/ring_attention.py`` (``tests/test_ring_attention.py``'s cases).

Four gloo ranks run ``ring_attention_sharded`` on an ``sp`` mesh of 2 or
4 (K/V rotating by ``batch_isend_irecv``), both bodies: the einsum ring
and the flash ring (K1 once a step, its plain version on CPU tensors);
causal and not, GQA, a sequence that does not divide the ring (T=27),
and the gradients of q, k and v at sp=2 and sp=4 through the rotation's
backward. The reference runs here on the first four virtual CPU devices
at the same axis sizes (its flash ring through the Pallas kernel in
interpret mode), atol 1e-4 as in its own tests. Each rank's body also
runs over the in-process rotation, which must equal the gloo ring bit
for bit; in this process, the in-process schedule makes n² K1 calls with
the windows of each rank's ring steps.
"""

from __future__ import annotations

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from demodel_tpu_torch.ops import flash_attention as tfa
from demodel_tpu_torch.ops import ring_attention as tra
from demodel_tpu_torch.parallel import mesh as tmesh
from demodel_tpu_torch.utils import trace as ttrace
from demodel_tpu_torch.utils.metrics import HUB, labeled

from .torch_mesh_rig import Ranks

jra = importlib.import_module("demodel_tpu.ops.ring_attention")
jmesh = importlib.import_module("demodel_tpu.parallel.mesh")

torch.set_num_threads(1)
WORLD = 4
ATOL = 1e-4  # tests/test_ring_attention.py


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(WORLD, tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


def _qkv(seed, B=2, T=32, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((B, T, h, D)).astype(np.float32)
            for n, h in (("q", H), ("k", Hkv), ("v", Hkv))}


def _reference(x, n, causal, flash, monkeypatch, grad=False):
    monkeypatch.setenv("DEMODEL_FLASH_RING", "1" if flash else "0")
    mesh = jmesh.make_mesh(WORLD, sp=n, tp=1)
    q, k, v = (jax.numpy.asarray(x[c]) for c in "qkv")

    def run(q_, k_, v_):
        return jra.ring_attention_sharded(q_, k_, v_, mesh, causal=causal)

    # jitted: eager shard_map dispatch compiles every op on its own
    out = np.asarray(jax.jit(run)(q, k, v))
    if not grad:
        return out, None
    grads = jax.jit(jax.grad(lambda *a: (run(*a) ** 2).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return out, [np.asarray(g) for g in grads]


def _check(ranks, x, n, causal, flash, monkeypatch, grad=False):
    want, wgrads = _reference(x, n, causal, flash, monkeypatch, grad)
    out = ranks.run("ring", {"axes": {"sp": n, "tp": 1}, "flash": flash,
                             "causal": causal, "grad": grad}, x)
    for got, _ in out:
        assert got["out"].shape == want.shape
        np.testing.assert_allclose(got["out"], want, atol=ATOL)
        assert np.array_equal(got["body_ring"], got["body_local"])
        if grad:
            for name, w in zip(("dq", "dk", "dv"), wgrads):
                np.testing.assert_allclose(got[name], w, atol=ATOL,
                                           err_msg=name)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_the_reference(ranks, n, causal, flash, monkeypatch):
    _check(ranks, _qkv(10 * n + causal), n, causal, flash, monkeypatch)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_ring_pads_a_sequence_the_ring_does_not_divide(ranks, causal, flash,
                                                      monkeypatch):
    """T=27 over 4 ranks: the last shard is mostly padding, masked by the
    global kv_len."""
    _check(ranks, _qkv(33, T=27, Hkv=4), 4, causal, flash, monkeypatch)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_gradients_match_the_reference(ranks, n, flash, monkeypatch):
    """dq, dk and dv of a sum of squares: k and v's gradients come back
    round the ring through the rotation's backward."""
    _check(ranks, _qkv(35 + n, T=16, H=2, Hkv=2, D=8), n, True, flash,
           monkeypatch, grad=True)


@pytest.mark.parametrize("T", [32, 27, 9])
def test_in_process_schedule_makes_each_ranks_launches(T, monkeypatch):
    """Each rank's body over :func:`local_rotation`: n² K1 calls, rank
    ``my``'s step ``s`` with ``causal_offset = my·Tq − src·Tk`` and its
    block's share of the global kv_len (0 for the last block at T=9,
    which is all padding); the output equals the reference ring's."""
    n, x = 4, _qkv(7, T=T)
    calls = []
    inner = tfa.flash_attention

    def counting(q, k, v, **kw):
        calls.append((kw["causal_offset"], kw["kv_len"]))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention", counting)
    pad = (-T) % n
    blocks = [torch.chunk(torch.nn.functional.pad(
        torch.from_numpy(x[c]), (0, 0, 0, 0, 0, pad)), n, dim=1)
        for c in "qkv"]
    outs = [tra.ring_attention(
        blocks[0][my], blocks[1][my], blocks[2][my],
        tra.local_rotation(list(blocks[1]), list(blocks[2]), my), my, n,
        kv_len=T if pad else None, use_flash=True) for my in range(n)]
    tl = (T + pad) // n
    assert calls == [((my - (my - s) % n) * tl,
                      min(max(T - (my - s) % n * tl, 0), tl))
                     for my in range(n) for s in range(n)]
    got = torch.cat(outs, dim=1)[:, :T].numpy()
    want, _ = _reference(x, n, True, True, monkeypatch)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ring_span_only_under_export_tracing(monkeypatch, tmp_path):
    """``compute.ring-attention`` (which synchronises the device) runs
    only under the export tier, as the reference's; on a one-device mesh
    the ring is one step of dense attention."""
    key = labeled("stage_duration_seconds", span="compute.ring-attention")
    mesh = tmesh.make_mesh(device="cpu", sp=1)
    x = {c: torch.from_numpy(a) for c, a in _qkv(5, T=8).items()}

    def count():
        h = HUB.histograms().get(key)
        return h["count"] if h else 0

    monkeypatch.delenv("DEMODEL_TRACE", raising=False)
    ttrace.reset()
    try:
        before = count()
        out = tra.ring_attention_sharded(x["q"], x["k"], x["v"], mesh)
        want = tra.dense_attention(x["q"], x["k"], x["v"])
        torch.testing.assert_close(out, want, atol=ATOL, rtol=0)
        assert count() == before
        sink = tmp_path / "trace.jsonl"
        monkeypatch.setenv("DEMODEL_TRACE", str(sink))
        ttrace.reset()
        tra.ring_attention_sharded(x["q"], x["k"], x["v"], mesh)
        assert count() == before + 1 and ttrace.mode() == "export"
        assert [json.loads(line)["name"] for line in
                sink.read_text().splitlines()] == ["compute.ring-attention"]
    finally:
        monkeypatch.delenv("DEMODEL_TRACE", raising=False)
        ttrace.reset()


def test_the_device_picks_the_ring_body(monkeypatch):
    """No environment option, ``DEMODEL_FLASH_ATTN`` included: on CPU
    tensors the einsum ring runs unless ``use_flash=True`` asks for K1
    (its plain version here), which then runs once a step."""
    calls = []
    inner = tfa.flash_attention

    def counting(q, k, v, **kw):
        calls.append(kw["causal_offset"])
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention", counting)
    monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    x = {c: torch.from_numpy(a) for c, a in _qkv(6, T=8).items()}
    mesh = tmesh.make_mesh(device="cpu", sp=1)
    want = tra.dense_attention(x["q"], x["k"], x["v"])
    for flash, launches in ((None, 0), (False, 0), (True, 1)):
        calls.clear()
        out = tra.ring_attention_sharded(x["q"], x["k"], x["v"], mesh,
                                         use_flash=flash)
        torch.testing.assert_close(out, want, atol=ATOL, rtol=0)
        assert len(calls) == launches, flash
