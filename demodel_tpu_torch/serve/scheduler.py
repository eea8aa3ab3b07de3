"""Continuous-batching scheduler: admit → prefill → interleaved decode
(``demodel_tpu/serve/scheduler.py`` with torch step functions).

One engine thread advances all running sequences one token per decode
step; new sequences join the running batch between steps, and a
finished, evicted or failed sequence frees its blocks immediately.
Admission reserves the worst case (prompt + ``max_new_tokens``) up
front, so a running sequence never hits an out-of-blocks wall.

A full waiting queue answers :class:`QueueOverflow`, which the HTTP
surface maps to 503 + ``Retry-After``; every admitted request carries an
:class:`AdmissionTicket` that settles exactly once.

Decode batches keep the JAX plane's power-of-two batch/width buckets
(pad rows decode with ``length 0`` and are dropped on the host), so the
port decodes the same shapes and hence the same tokens. Prefill runs
``llama.step_prefill``, whose attention is the fused kernel on CUDA.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Iterator

import numpy as np
import torch

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models import llama
from demodel_tpu_torch.serve.kvcache import KVBlockPool, PoolExhausted, host
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import (gen_max_batch, gen_max_new_tokens,
                                         gen_queue_limit, gen_retry_after_s)
from demodel_tpu_torch.utils.logging import get_logger
from demodel_tpu_torch.utils.metrics import HUB, labeled

log = get_logger("serve.scheduler")

#: pre-register the generation families at import (house idiom)
HUB.inc(labeled("gen_tokens_total", stage="prefill"), 0)
HUB.inc(labeled("gen_tokens_total", stage="decode"), 0)
HUB.inc("gen_requests_total", 0)
HUB.inc("gen_rejected_total", 0)
HUB.inc("gen_evicted_total", 0)
HUB.set_gauge("gen_queue_depth", 0)
HUB.set_gauge("gen_running", 0)

_END = object()  # stream sentinel: the request is finished


class QueueOverflow(Exception):
    """Waiting queue is full — the HTTP surface answers 503 with
    ``Retry-After: retry_after``."""

    def __init__(self, depth: int, limit: int, retry_after: int):
        super().__init__(
            f"generation queue full ({depth}/{limit} waiting)")
        self.retry_after = retry_after


class Request:
    """One generation request, observable from any thread: a stream of
    generated token ids plus a done event. Tokens in, tokens out."""

    def __init__(self, rid: int, prompt: list[int], max_new_tokens: int):
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tokens: list[int] = []
        self.error: str | None = None
        self.ticket: "AdmissionTicket | None" = None
        self.submitted_s = time.time()
        self.started_s: float | None = None
        self.finished_s: float | None = None
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self._stream: queue_mod.Queue = queue_mod.Queue()

    # -- engine side ----------------------------------------------------
    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        self._stream.put(tok)

    def _close(self) -> None:
        self.finished_s = time.time()
        self._stream.put(_END)
        self.done.set()

    # -- consumer side --------------------------------------------------
    def cancel(self) -> None:
        """Ask the engine to evict this sequence at the next step
        boundary (its blocks free immediately there)."""
        self.cancelled.set()

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until finished; the generated token ids (raises on a
        failed/evicted request)."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.error is not None:
            raise RuntimeError(self.error)
        return list(self.tokens)

    def iter_tokens(self, timeout: float = 60.0) -> Iterator[int]:
        """Stream token ids as they are generated; raises on error."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is _END:
                if self.error is not None:
                    raise RuntimeError(self.error)
                return
            yield item


class AdmissionTicket:
    """One admitted request's slot in the engine's accounting — must
    reach :meth:`finish` exactly once (completion, eviction, or error)."""

    __slots__ = ("_queue", "request", "_done")

    def __init__(self, queue: "AdmissionQueue", request: Request):
        self._queue = queue
        self.request = request
        self._done = False

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self._queue._settle()


class AdmissionQueue:
    """Bounded waiting room with the proxy's overflow contract."""

    def __init__(self, limit: int, retry_after: int):
        self.limit = int(limit)
        self.retry_after = int(retry_after)
        self._outstanding = 0
        self._settled = 0
        self._lock = threading.Lock()

    def admit(self, request: Request, waiting: int) -> AdmissionTicket:
        """Issue a ticket, or answer the overflow contract when
        ``waiting`` (the scheduler's pending depth) is at the limit."""
        with self._lock:
            if waiting >= self.limit:
                HUB.inc("gen_rejected_total")
                raise QueueOverflow(waiting, self.limit, self.retry_after)
            self._outstanding += 1
        return AdmissionTicket(self, request)

    def _settle(self) -> None:
        with self._lock:
            self._outstanding -= 1
            self._settled += 1

    def describe(self) -> dict[str, Any]:
        with self._lock:
            return {"limit": self.limit, "retry_after_s": self.retry_after,
                    "outstanding": self._outstanding,
                    "settled": self._settled}


class _Seq:
    """Engine-internal running-sequence state."""

    __slots__ = ("req", "lease", "length", "last_tok", "generated")

    def __init__(self, req: Request, lease, length: int, last_tok: int):
        self.req = req
        self.lease = lease
        self.length = length      # KV positions written so far
        self.last_tok = last_tok  # next token to feed
        self.generated = 1        # last_tok itself came from the prefill


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class GenEngine:
    """The serving loop: one thread, one model, one paged pool.

    ``device`` (default ``cuda``) must be where ``params`` live. All
    cross-thread state (`_pending`, `_running`, `_stop`, token counters)
    is guarded by ``_work``'s lock; the tensors and the pool's leased
    bytes are engine-thread-only.
    """

    def __init__(self, params, cfg, *,
                 device: str | torch.device | None = None,
                 pool: KVBlockPool | None = None,
                 max_batch: int | None = None,
                 queue_limit: int | None = None,
                 max_new_tokens: int | None = None,
                 block_tokens: int | None = None,
                 kv_mb: int | None = None,
                 model: str = "inline"):
        self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.model = model
        self.pool = pool if pool is not None else KVBlockPool(
            cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim,
            block_tokens=block_tokens, budget_mb=kv_mb)
        self.max_batch = int(max_batch or gen_max_batch())
        self.max_new_cap = int(max_new_tokens or gen_max_new_tokens())
        self.admission = AdmissionQueue(
            queue_limit if queue_limit is not None else gen_queue_limit(),
            gen_retry_after_s())
        self._pending: deque[Request] = deque()
        self._running: list[_Seq] = []
        self._stop = False
        self._work = threading.Condition(threading.Lock())
        self._ids = itertools.count(1)
        self._tokens = {"prefill": 0, "decode": 0}
        self.started_s = time.time()
        self._thread = threading.Thread(target=self._run, name="gen-engine",
                                        daemon=True)

    # ------------------------------------------------------ step functions
    @torch.inference_mode()
    def _prefill(self, prompt: list[int]):
        """``prompt`` → (last logits [V] on the host, per-layer KV)."""
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, kv = llama.step_prefill(self.params, tokens, self.cfg)
        return host(logits[0]), kv

    @torch.inference_mode()
    def _decode(self, toks: np.ndarray, k: np.ndarray, v: np.ndarray,
                lens: np.ndarray):
        """One decode step over the gathered batch; returns host (logits
        [Bb, V], new K [L, Bb, Hkv, hd], new V)."""
        dev = self.device
        kt = torch.from_numpy(k).to(dev)
        vt = torch.from_numpy(v).to(dev)
        cache = [(kt[li], vt[li]) for li in range(kt.shape[0])]
        logits, new_kv = llama.step_decode(
            self.params, torch.from_numpy(toks).to(dev), self.cfg, cache,
            torch.from_numpy(lens).to(dev))
        nk = host(torch.stack([lk[:, 0] for lk, _lv in new_kv]))
        nv = host(torch.stack([lv[:, 0] for _lk, lv in new_kv]))
        return host(logits), nk, nv

    # ------------------------------------------------------------ public
    def start(self) -> "GenEngine":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop and settle every in-flight request (error =
        shutdown) — blocks are freed, tickets finished, streams closed."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread.ident is not None:  # tolerate never-started engines
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # still inside a step and still writing into leased
                # blocks — reclaiming them now would hand corruptible
                # memory to a future engine; the thread settles them
                with self._work:
                    n_run, n_pend = len(self._running), len(self._pending)
                log.error("engine thread still running after 30s; "
                          "leaving %d leases and %d pending requests "
                          "unreclaimed", n_run, n_pend)
                return
        with self._work:
            leftovers = list(self._pending) + [s.req for s in self._running]
            seqs = list(self._running)
            self._pending.clear()
            self._running.clear()
        for seq in seqs:
            seq.lease.free()
        for req in leftovers:
            self._finish_req(req, error="engine shutdown")
        HUB.set_gauge("gen_queue_depth", 0)
        HUB.set_gauge("gen_running", 0)

    def submit(self, prompt, max_new_tokens: int | None = None) -> Request:
        """Admit one request (greedy decode). Raises
        :class:`QueueOverflow` when the waiting room is full and
        ``ValueError`` on malformed input — both before any KV is
        reserved."""
        toks = [int(t) for t in prompt]
        if not toks:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.cfg.vocab_size for t in toks):
            raise ValueError("prompt token out of vocab range")
        want = int(max_new_tokens or self.max_new_cap)
        want = max(1, min(want, self.max_new_cap))
        # a worst-case reservation larger than the whole pool can never be
        # admitted and would wedge FIFO admission: reject it here (400)
        need = self.pool.blocks_for(len(toks) + want - 1)
        if need > self.pool.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks (prompt {len(toks)} + "
                f"{want} new tokens) but the pool only has "
                f"{self.pool.num_blocks}; shorten the prompt or lower "
                f"max_new_tokens")
        req = Request(next(self._ids), toks, want)
        rejected: QueueOverflow | None = None
        with trace.span("serve.admit", request=req.id, prompt=len(toks)):
            with self._work:
                if self._stop:
                    raise RuntimeError("engine stopped")
                try:
                    ticket = self.admission.admit(req, len(self._pending))
                except QueueOverflow as exc:
                    trace.event("rejected", retry_after=exc.retry_after)
                    rejected = exc
                else:
                    req.ticket = ticket
                    self._pending.append(req)
                    HUB.inc("gen_requests_total")
                    HUB.set_gauge("gen_queue_depth", len(self._pending))
                    self._work.notify_all()
        if rejected is not None:
            raise rejected
        return req

    def generate(self, prompt, max_new_tokens: int | None = None,
                 timeout: float = 300.0) -> list[int]:
        """Synchronous convenience: submit + wait."""
        return self.submit(prompt, max_new_tokens).result(timeout)

    def describe(self) -> dict[str, Any]:
        with self._work:
            waiting = len(self._pending)
            running = len(self._running)
            tokens = dict(self._tokens)
        return {
            "model": self.model,
            "device": str(self.device),
            "running": running,
            "waiting": waiting,
            "max_batch": self.max_batch,
            "tokens": tokens,
            "uptime_s": round(time.time() - self.started_s, 3),
            "admission": self.admission.describe(),
            "kv": self.pool.describe(),
        }

    # ------------------------------------------------------ engine loop
    def _run(self) -> None:
        while True:
            with self._work:
                while not self._stop and not self._pending \
                        and not self._running:
                    self._work.wait()
                if self._stop:
                    return
            progressed = False
            while self._admit_one():
                progressed = True
            self._evict_cancelled()
            if self._snapshot_running():
                self._decode_step()
            elif not progressed:
                # pending work but nothing admittable and nothing running:
                # sleep instead of busy-spinning (submit/stop notify)
                with self._work:
                    if not self._stop and self._pending \
                            and not self._running:
                        self._work.wait(timeout=0.05)

    def _snapshot_running(self) -> list[_Seq]:
        with self._work:
            return list(self._running)

    def _admit_one(self) -> bool:
        """Move one waiting request into the running batch: reserve its
        worst-case blocks, prefill, emit its first token. False when the
        batch is full, the queue is empty, or blocks are short (FIFO)."""
        with self._work:
            if self._stop or not self._pending \
                    or len(self._running) >= self.max_batch:
                return False
            req = self._pending[0]
            lease = None
            if not req.cancelled.is_set():
                need = self.pool.blocks_for(
                    len(req.prompt) + req.max_new_tokens - 1)
                try:
                    lease = self.pool.alloc(need)
                except PoolExhausted:
                    return False
                cancelled = True
                try:
                    cancelled = req.cancelled.is_set()
                finally:
                    if cancelled:
                        # cancel landed between the head check and the
                        # alloc — free here or the blocks leak
                        lease.free()
                        lease = None
            self._pending.popleft()
            depth = len(self._pending)
        HUB.set_gauge("gen_queue_depth", depth)
        if lease is None:
            HUB.inc("gen_evicted_total")
            self._finish_req(req, error="cancelled before start")
            return True
        self._start_seq(req, lease)
        return True

    def _start_seq(self, req: Request, lease) -> None:
        req.started_s = time.time()
        HUB.observe("gen_queue_wait_seconds",
                    req.started_s - req.submitted_s)
        try:
            with trace.span("serve.prefill", request=req.id,
                            prompt=len(req.prompt)):
                logits, kv = self._prefill(req.prompt)
                self.pool.write_prompt(lease, kv)
                tok0 = int(np.argmax(logits))
        except Exception as exc:  # noqa: BLE001 - engine must survive
            lease.free()
            log.error("prefill failed for request %d: %s", req.id, exc)
            self._finish_req(req, error=f"prefill failed: {exc}")
            return
        seq = _Seq(req, lease, len(req.prompt), tok0)
        with self._work:
            self._running.append(seq)
            running = len(self._running)
            self._tokens["prefill"] += len(req.prompt)
        HUB.set_gauge("gen_running", running)
        HUB.inc(labeled("gen_tokens_total", stage="prefill"),
                len(req.prompt))
        req._emit(tok0)
        HUB.inc(labeled("gen_tokens_total", stage="decode"))
        if seq.generated >= req.max_new_tokens:
            self._retire(seq)

    def _evict_cancelled(self) -> None:
        for seq in self._snapshot_running():
            if seq.req.cancelled.is_set():
                HUB.inc("gen_evicted_total")
                self._retire(seq, error="evicted")

    def _decode_step(self) -> None:
        """Advance every running sequence one token, ragged lengths and
        all — the continuous-batching inner loop."""
        batch = self._snapshot_running()
        if not batch:
            return
        B = len(batch)
        Bb = _pow2(B)
        bs = self.pool.block_tokens
        width = bs * _pow2(-(-max(s.length for s in batch) // bs))
        toks = np.zeros((Bb,), np.int64)
        lens = np.zeros((Bb,), np.int64)
        for i, s in enumerate(batch):
            toks[i] = s.last_tok
            lens[i] = s.length
        k, v = self.pool.gather([s.lease for s in batch], width)
        if Bb > B:  # pad rows ride along with length 0 and are dropped
            pad = ((0, 0), (0, Bb - B)) + ((0, 0),) * (k.ndim - 2)
            k = np.pad(k, pad)
            v = np.pad(v, pad)
        try:
            with trace.span("serve.decode-step", batch=B, width=width):
                out, nk, nv = self._decode(toks, k, v, lens)
        except Exception as exc:  # noqa: BLE001 - engine must survive
            log.error("decode step failed (batch=%d): %s", B, exc)
            for seq in batch:
                self._retire(seq, error=f"decode failed: {exc}")
            return
        for i, seq in enumerate(batch):
            self.pool.write_token(seq.lease, seq.length, nk[:, i], nv[:, i])
            seq.length += 1
            tok = int(np.argmax(out[i]))
            seq.last_tok = tok
            seq.generated += 1
            seq.req._emit(tok)
            if seq.generated >= seq.req.max_new_tokens:
                self._retire(seq)
        with self._work:
            self._tokens["decode"] += B
        HUB.inc(labeled("gen_tokens_total", stage="decode"), B)

    def _retire(self, seq: _Seq, error: str | None = None) -> None:
        """Finished/evicted/failed: blocks free immediately."""
        seq.lease.free()
        with self._work:
            if seq in self._running:
                self._running.remove(seq)
            running = len(self._running)
        HUB.set_gauge("gen_running", running)
        self._finish_req(seq.req, error=error)

    def _finish_req(self, req: Request, error: str | None = None) -> None:
        req.error = error
        if req.ticket is not None:
            req.ticket.finish()
        req._close()
