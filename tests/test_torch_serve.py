"""Port parity: ``demodel_tpu_torch.serve`` — the paged KV pool, the
continuous-batching engine against the JAX package's ``llama.generate``,
and the ``/generate`` HTTP contract — on the CPU with the tiny config.

The engine runs the port's step functions on weights carried across
from the JAX package; its greedy tokens, under staggered joins into a
running batch, must equal the JAX sequential decoder's exactly.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from demodel_tpu.models import llama as jl
from demodel_tpu_torch import serve
from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.serve import (BlockLease, GenEngine, KVBlockPool,
                                     PoolExhausted, QueueOverflow, http)
from demodel_tpu_torch.utils.metrics import HUB, labeled

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jax.jit(jl.init_params, static_argnums=(1,))(
        jax.random.key(2), jcfg)
    tcfg = tl.LlamaConfig.tiny()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


def _pool(cfg, **kw):
    kw.setdefault("block_tokens", 16)
    kw.setdefault("budget_mb", 1)
    return KVBlockPool(cfg.num_hidden_layers, cfg.num_key_value_heads,
                       cfg.head_dim, **kw)


def _prompt(cfg, n, seed=0):
    rng = random.Random(seed)
    return [rng.randrange(cfg.vocab_size) for _ in range(n)]


def _engine(tiny, **kw):
    kw.setdefault("device", "cpu")
    return GenEngine(tiny[2], tiny[3], **kw)


STAGGERED = [9, 5, 12, 9]
MAX_NEW = 6


@pytest.fixture(scope="module")
def staggered_refs(tiny):
    prompts = [_prompt(tiny[3], n, seed=i) for i, n in enumerate(STAGGERED)]
    return prompts, [_jax_ref(tiny, p, MAX_NEW) for p in prompts]


def _jax_ref(tiny, prompt, n):
    jparams, jcfg = tiny[0], tiny[1]
    return [int(t) for t in np.asarray(jl.generate(jparams, jcfg, prompt,
                                                   n))[0]]


# ---------------------------------------------------------------- KV pool


class TestKVBlockPool:
    @pytest.mark.parametrize("tokens,blocks", [(0, 1), (1, 1), (16, 1),
                                               (17, 2), (64, 4)])
    def test_blocks_for_rounds_up(self, tiny, tokens, blocks):
        assert _pool(tiny[3]).blocks_for(tokens) == blocks

    def test_alloc_free_exact_under_churn(self, tiny):
        pool = _pool(tiny[3])
        rng = random.Random(7)
        live: list[BlockLease] = []
        for _ in range(300):
            if live and (rng.random() < 0.5 or pool.free_blocks < 4):
                live.pop(rng.randrange(len(live))).free()
            else:
                live.append(pool.alloc(rng.randint(1, 3)))
        for lease in live:
            lease.free()
        assert pool.in_use_blocks == 0
        assert pool.budget.describe()["in_use_bytes"] == 0

    def test_alloc_is_all_or_nothing(self, tiny):
        pool = _pool(tiny[3])
        free = pool.free_blocks
        with pytest.raises(PoolExhausted):
            pool.alloc(free + 1)
        assert pool.free_blocks == free

    def test_double_free_is_idempotent(self, tiny):
        pool = _pool(tiny[3])
        lease = pool.alloc(2)
        lease.free()
        lease.free()
        assert pool.in_use_blocks == 0

    @pytest.mark.parametrize("as_tensor", [False, True],
                             ids=["numpy", "torch"])
    def test_write_gather_roundtrip(self, tiny, as_tensor):
        """Paged writes read back exactly through the dense gather, at
        ragged widths and across block boundaries — from numpy or from
        the engine's tensors."""
        cfg = tiny[3]
        L, Hkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                      cfg.head_dim)
        pool = _pool(cfg, block_tokens=4)
        rng = np.random.default_rng(3)
        t_a, t_b = 6, 3
        lease_a = pool.alloc(pool.blocks_for(t_a + 2))
        lease_b = pool.alloc(pool.blocks_for(t_b + 2))
        ka = rng.normal(size=(L, 1, t_a, Hkv, hd)).astype(np.float32)
        kb = rng.normal(size=(L, 1, t_b, Hkv, hd)).astype(np.float32)
        wrap = torch.from_numpy if as_tensor else np.asarray
        pool.write_prompt(lease_a, [(wrap(ka[i]), wrap(ka[i] + 1))
                                    for i in range(L)])
        pool.write_prompt(lease_b, [(wrap(kb[i]), wrap(kb[i] + 1))
                                    for i in range(L)])
        tok = rng.normal(size=(L, Hkv, hd)).astype(np.float32)
        pool.write_token(lease_a, t_a, tok, tok - 1)
        k, v = pool.gather([lease_a, lease_b], width=t_a + 1)
        np.testing.assert_array_equal(k[:, 0, :t_a], ka[:, 0])
        np.testing.assert_array_equal(k[:, 0, t_a], tok)
        np.testing.assert_array_equal(v[:, 0, t_a], tok - 1)
        np.testing.assert_array_equal(k[:, 1, :t_b], kb[:, 0])
        np.testing.assert_array_equal(v[:, 1, :t_b], kb[:, 0] + 1)
        lease_a.free()
        lease_b.free()


# ----------------------------------------------------------- scheduler


class TestGenEngine:
    @pytest.mark.parametrize("max_batch", [3, 1])
    def test_matches_jax_generate_staggered(self, tiny, staggered_refs,
                                            max_batch):
        """Continuous batching with staggered admission produces the
        JAX sequential decoder's greedy tokens."""
        prompts, refs = staggered_refs
        max_new = MAX_NEW
        engine = _engine(tiny, max_batch=max_batch, queue_limit=16,
                         max_new_tokens=max_new, kv_mb=4).start()
        try:
            reqs = []
            for i, p in enumerate(prompts):  # staggered: join mid-decode
                if i == 2:
                    reqs[0].result(timeout=120)
                reqs.append(engine.submit(p, max_new))
            outs = [r.result(timeout=120) for r in reqs]
        finally:
            engine.stop()
        assert outs == refs
        assert engine.pool.describe()["in_use_blocks"] == 0

    def test_queue_overflow_raises_with_retry_after(self, tiny):
        engine = _engine(tiny, max_batch=1, queue_limit=2,
                         max_new_tokens=4, kv_mb=4)  # not started
        try:
            for _ in range(2):
                engine.submit(_prompt(tiny[3], 4), 2)
            with pytest.raises(QueueOverflow) as exc:
                engine.submit(_prompt(tiny[3], 4), 2)
            assert exc.value.retry_after >= 1
        finally:
            engine.stop()

    def test_submit_validates_before_reserving(self, tiny):
        engine = _engine(tiny, max_batch=1, queue_limit=2,
                         max_new_tokens=4, kv_mb=4)
        try:
            with pytest.raises(ValueError):
                engine.submit([], 2)
            with pytest.raises(ValueError):
                engine.submit([tiny[3].vocab_size], 2)
            assert engine.admission.describe()["outstanding"] == 0
        finally:
            engine.stop()

    def test_stop_settles_pending_requests(self, tiny):
        engine = _engine(tiny, max_batch=1, queue_limit=8,
                         max_new_tokens=4, kv_mb=4)  # never started
        req = engine.submit(_prompt(tiny[3], 4), 2)
        engine.stop()
        with pytest.raises(RuntimeError, match="shutdown"):
            req.result(timeout=10)
        assert engine.admission.describe()["outstanding"] == 0
        with pytest.raises(RuntimeError, match="stopped"):
            engine.submit(_prompt(tiny[3], 4), 2)

    def test_submit_rejects_request_larger_than_pool(self, tiny):
        """A worst-case reservation beyond the whole pool is a 400 at
        submit, never a wedged FIFO head."""
        pool = _pool(tiny[3], block_tokens=2048, budget_mb=1)
        capacity = pool.num_blocks * pool.block_tokens
        engine = _engine(tiny, pool=pool, max_batch=2, queue_limit=8,
                         max_new_tokens=capacity + 64)
        try:
            with pytest.raises(ValueError, match="KV blocks"):
                engine.submit(_prompt(tiny[3], 8), capacity + 8)
            assert engine.admission.describe()["outstanding"] == 0
        finally:
            engine.stop()

    def test_unsupported_device_rejected(self, tiny):
        with pytest.raises(ValueError, match="unsupported device"):
            GenEngine(tiny[2], tiny[3], device="meta")


# --------------------------------------------------------- HTTP surface


def _post(url, doc, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers, resp.read()


@pytest.fixture()
def gen_server():
    server = http.start()
    yield server.url
    server.stop()
    engine = serve.current()
    serve.install(None)
    if engine is not None:
        engine.stop()


class TestGenerateHTTP:
    def test_disabled_without_engine(self, gen_server):
        serve.install(None)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{gen_server}/generate", {"prompt": [1, 2, 3]})
        assert exc.value.code == 503
        assert b"serving disabled" in exc.value.read()

    def test_sync_roundtrip_matches_jax(self, gen_server, tiny,
                                        staggered_refs):
        prompt, ref = staggered_refs[0][0], staggered_refs[1][0]
        serve.boot(tiny[2], tiny[3], device="cpu", max_batch=2,
                   queue_limit=8, max_new_tokens=8, kv_mb=4)
        before = HUB.get(labeled("gen_http_total", code="200"))
        status, _, body = _post(f"{gen_server}/generate",
                                {"prompt": prompt, "max_new_tokens": MAX_NEW})
        doc = json.loads(body)
        assert status == 200 and doc["tokens"] == ref
        assert doc["prompt_tokens"] == len(prompt)
        assert HUB.get(labeled("gen_http_total", code="200")) == before + 1

    def test_streaming_ndjson(self, gen_server, tiny, staggered_refs):
        prompt, ref = staggered_refs[0][1], staggered_refs[1][1]
        serve.boot(tiny[2], tiny[3], device="cpu", max_batch=2,
                   queue_limit=8, max_new_tokens=8, kv_mb=4)
        status, headers, body = _post(
            f"{gen_server}/generate",
            {"prompt": prompt, "max_new_tokens": MAX_NEW, "stream": True})
        assert status == 200
        assert "x-ndjson" in headers.get("Content-Type", "")
        lines = [json.loads(ln) for ln in body.decode().splitlines()
                 if ln.strip()]
        assert [ln["token"] for ln in lines if "token" in ln] == ref
        assert lines[-1]["done"] is True and lines[-1]["tokens"] == ref

    @pytest.mark.parametrize("body,code", [
        ({"prompt": []}, 400),
        ({"prompt": "1 2 3"}, 400),
        ({"max_new_tokens": 3}, 400),
    ], ids=["empty_prompt", "string_prompt", "no_prompt"])
    def test_bad_body_answers_400(self, gen_server, tiny, body, code):
        serve.install(_engine(tiny, max_batch=1, queue_limit=1,
                              max_new_tokens=4, kv_mb=4))
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{gen_server}/generate", body)
        assert exc.value.code == code

    @pytest.mark.parametrize("length,code", [(9 << 20, 413), (0, 411)],
                             ids=["oversized_413", "empty_411"])
    def test_length_limits(self, gen_server, tiny, length, code):
        """Answered from the header alone, and counted."""
        serve.install(_engine(tiny, max_batch=1, queue_limit=1,
                              max_new_tokens=4, kv_mb=4))
        label = labeled("gen_http_total", code=str(code))
        before = HUB.get(label)
        host, port = gen_server.rsplit("/", 1)[1].split(":")
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: %d\r\n\r\n" % length)
            status = s.recv(4096).split(b"\r\n", 1)[0]
        assert str(code).encode() in status
        assert HUB.get(label) == before + 1

    def test_overflow_503_sets_retry_after(self, gen_server, tiny):
        engine = _engine(tiny, max_batch=1, queue_limit=1,
                         max_new_tokens=4, kv_mb=4)  # not started: the
        serve.install(engine)  # waiting room fills deterministically
        parked = threading.Thread(
            target=lambda: _post(f"{gen_server}/generate",
                                 {"prompt": _prompt(tiny[3], 4),
                                  "max_new_tokens": 2}),
            daemon=True)
        parked.start()
        for _ in range(200):
            if engine.describe()["waiting"] >= 1:
                break
            threading.Event().wait(0.02)
        assert engine.describe()["waiting"] == 1
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{gen_server}/generate",
                  {"prompt": _prompt(tiny[3], 4), "max_new_tokens": 2})
        assert exc.value.code == 503
        assert int(exc.value.headers["Retry-After"]) >= 1
        assert json.loads(exc.value.read())["retry_after"] >= 1
        engine.start()  # drain the parked request before teardown
        parked.join(timeout=120)
        assert not parked.is_alive()

    def test_metrics_scrape(self, gen_server, tiny):
        serve.boot(tiny[2], tiny[3], device="cpu", max_batch=1,
                   queue_limit=4, max_new_tokens=2, kv_mb=4)
        _post(f"{gen_server}/generate",
              {"prompt": _prompt(tiny[3], 3), "max_new_tokens": 2})
        with urllib.request.urlopen(f"{gen_server}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
        for family in ('demodel_gen_http_total{code="200"}',
                       "# TYPE demodel_gen_tokens_total counter",
                       "demodel_gen_kv_blocks_in_use",
                       'demodel_stage_duration_seconds_count'
                       '{span="serve.prefill"}'):
            assert family in text
