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

Over a mesh of several ranks (one process each) the engines run in
lockstep: rank 0 schedules and sends each step's plan, every rank runs
the step on its shards (:class:`GenEngine`). The reference's single
controller needs none of this.
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
from demodel_tpu_torch.parallel.mesh import local_device
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
        #: the submitter's span (the server's ``serve.restore``) as a W3C
        #: traceparent: the engine thread files this request's prefill
        #: and decode steps under it, so they join the client's trace
        self.traceparent = trace.traceparent()

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
    """Engine-internal running-sequence state (its lease is in
    ``GenEngine._leases`` under the request's id)."""

    __slots__ = ("req", "length", "last_tok", "generated")

    def __init__(self, req: Request, length: int, last_tok: int):
        self.req = req
        self.length = length      # KV positions written so far
        self.last_tok = last_tok  # next token to feed
        self.generated = 1        # last_tok itself came from the prefill


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ------------------------------------------------------------- lockstep

#: a plan's kind, the first word of its header
_NOOP, _PREFILL, _DECODE, _RETIRE, _STOP = range(5)
#: int64 words in one plan broadcast: the header ``[kind, n]`` and the
#: first n words; a longer plan (a long prompt) takes more broadcasts of
#: the same size
PLAN_WORDS = 1024


class StepFailed(RuntimeError):
    """A step failed on some rank of the mesh (or the ranks could not
    agree on it): no rank may go on, since the ranks may now sit in
    different collectives."""


class _Lockstep:
    """What keeps the ranks of a mesh in step: rank 0's plan for each
    step, one fixed-size int64 broadcast (or more) on the mesh's world
    group, and every rank's verdict on the step, one all-reduce. The
    tensors live on the mesh's device: the card for NCCL, the CPU for
    gloo."""

    def __init__(self, mesh):
        self.group = mesh.world_group
        self.leader = mesh.rank == 0
        self.buf = torch.zeros(PLAN_WORDS, dtype=torch.int64,
                               device=mesh.device)
        self.flag = torch.zeros(1, dtype=torch.int64, device=mesh.device)
        #: when rank 0 last sent a plan (its heartbeat reads it)
        self.sent_s = time.monotonic()

    def share(self, values: list[int]) -> list[int]:
        """Rank 0's ``values`` on every rank."""
        import torch.distributed as dist

        t = torch.tensor(values if self.leader else [0] * len(values),
                         dtype=torch.int64, device=self.buf.device)
        dist.broadcast(t, 0, group=self.group)
        return [int(v) for v in t.tolist()]

    def send(self, kind: int, words) -> None:
        """Rank 0: broadcast one plan."""
        import torch.distributed as dist

        words = np.asarray(words, dtype=np.int64).reshape(-1)
        data = np.concatenate([np.array([kind, words.size], np.int64),
                               words])
        with trace.span("serve.plan", kind=kind, words=int(words.size)):
            for off in range(0, data.size, PLAN_WORDS):
                chunk = torch.from_numpy(data[off:off + PLAN_WORDS])
                self.buf[:chunk.numel()].copy_(chunk)
                dist.broadcast(self.buf, 0, group=self.group)
        self.sent_s = time.monotonic()

    def recv(self) -> tuple[int, np.ndarray]:
        """A follower: the next plan, ``(kind, words)``."""
        import torch.distributed as dist

        dist.broadcast(self.buf, 0, group=self.group)
        first = self.buf.to("cpu", copy=True).numpy()
        kind, n = int(first[0]), int(first[1])
        parts, got = [first[2:2 + n]], min(n, PLAN_WORDS - 2)
        while got < n:
            dist.broadcast(self.buf, 0, group=self.group)
            take = min(n - got, PLAN_WORDS)
            parts.append(self.buf[:take].to("cpu", copy=True).numpy())
            got += take
        return kind, np.concatenate(parts)

    def run(self, fn):
        """Run this rank's part of a step, then take every rank's
        verdict: ``fn``'s result when all succeeded, else
        :class:`StepFailed` on every rank."""
        import torch.distributed as dist

        err: Exception | None = None
        out = None
        try:
            out = fn()
        except Exception as exc:  # noqa: BLE001 - every rank must vote
            err = exc
            log.error("lockstep step failed here: %s", exc)
        try:
            with trace.span("serve.verdict"):
                self.flag.fill_(0 if err is None else 1)
                dist.all_reduce(self.flag, op=dist.ReduceOp.MAX,
                                group=self.group)
                ok = int(self.flag.item()) == 0
        except RuntimeError as exc:  # a broken group
            raise StepFailed(f"the ranks could not agree on a step: "
                             f"{err or exc}") from (err or exc)
        if not ok:
            raise StepFailed(f"step failed: {err}" if err is not None
                             else "step failed on another rank") from err
        return out


class GenEngine:
    """The serving loop: one thread, one model, one paged pool.

    ``device`` (default ``cuda``) must be where ``params`` live. All
    cross-thread state (`_pending`, `_running`, `_stop`, token counters)
    is guarded by ``_work``'s lock; the tensors and the pool's leased
    bytes are engine-thread-only.

    On a ``mesh`` that spans a ``torch.distributed`` world, ``params``
    are this rank's shards (``llama.shard_params``, or a pull's
    placement), the engine runs on this rank's device, and every rank
    builds its engine with the same arguments. Rank 0 leads: it alone
    takes :meth:`submit`, admits, batches, takes the argmax and emits
    tokens. Before each step it sends the step's plan (a prefill: the
    request id, its lease's block ids and its prompt; a decode: the
    width and each row's request id, token and length; a retire: the
    request ids whose leases go back; a stop), and every rank runs the
    same ``llama.step_prefill``/``step_decode(..., mesh=)`` on its own
    shards and KV heads, then votes on it. A step that fails on any rank
    stops every rank's engine: rank 0 settles every request with the
    error and emits nothing from that step on. Rank 0 sends an empty
    plan when idle for a quarter of the mesh's timeout, so a waiting
    follower never times out. On a mesh of one process this is the
    engine without a mesh.
    """

    def __init__(self, params, cfg, mesh=None, *,
                 device: str | torch.device | None = None,
                 pool: KVBlockPool | None = None,
                 max_batch: int | None = None,
                 queue_limit: int | None = None,
                 max_new_tokens: int | None = None,
                 block_tokens: int | None = None,
                 kv_mb: int | None = None,
                 model: str = "inline"):
        if mesh is not None:
            self.device = local_device(mesh, "GenEngine")
            want = resolve(device) if device is not None else self.device
            if want.type != self.device.type or want.index not in (
                    None, self.device.index):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")
        else:
            self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.model = model
        self._lockstep = (_Lockstep(mesh) if mesh is not None
                          and mesh.distributed else None)
        #: rank 0 of the mesh, or the only engine
        self.leader = self._lockstep is None or self._lockstep.leader
        heads = llama.cache_heads(cfg, mesh)
        if pool is None and self.leader:
            pool = KVBlockPool(cfg.num_hidden_layers, heads, cfg.head_dim,
                               block_tokens=block_tokens, budget_mb=kv_mb)
        if self._lockstep is not None:
            # every rank's pool has rank 0's blocks, whatever its heads
            shape = self._lockstep.share(
                [pool.num_blocks, pool.block_tokens] if self.leader
                else [0, 0])
            if pool is None:
                pool = KVBlockPool(cfg.num_hidden_layers, heads,
                                   cfg.head_dim, block_tokens=shape[1],
                                   num_blocks=shape[0])
            elif [pool.num_blocks, pool.block_tokens] != shape:
                raise ValueError(f"pool of {pool.num_blocks} blocks of "
                                 f"{pool.block_tokens} tokens; rank 0's "
                                 f"has {shape[0]} of {shape[1]}")
        self.pool = pool
        self._heartbeat_s = (mesh.timeout.total_seconds() / 4
                             if self._lockstep is not None else None)
        self.max_batch = int(max_batch or gen_max_batch())
        self.max_new_cap = int(max_new_tokens or gen_max_new_tokens())
        self.admission = AdmissionQueue(
            queue_limit if queue_limit is not None else gen_queue_limit(),
            gen_retry_after_s())
        self._pending: deque[Request] = deque()
        self._running: list[_Seq] = []
        #: request id → its lease, on every rank (rank 0's plans name
        #: leases by request id)
        self._leases: dict[int, Any] = {}
        #: request ids retired since the last retire plan
        self._retired: list[int] = []
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
        logits, kv = llama.step_prefill(self.params, tokens, self.cfg,
                                        self.mesh)
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
            torch.from_numpy(lens).to(dev), self.mesh)
        nk = host(torch.stack([lk[:, 0] for lk, _lv in new_kv]))
        nv = host(torch.stack([lv[:, 0] for _lk, lv in new_kv]))
        return host(logits), nk, nv

    def _apply(self, kind: int, words) -> np.ndarray:
        """This rank's part of a prefill or decode plan (the same code on
        every rank): the step's host logits."""
        words = [int(w) for w in words]
        if kind == _PREFILL:
            rid, T, nb = words[:3]
            if self.leader:
                lease = self._leases[rid]
            else:
                lease = self._leases[rid] = self.pool.alloc(
                    nb, blocks=words[3:3 + nb])
            logits, kv = self._prefill(words[3 + nb:3 + nb + T])
            self.pool.write_prompt(lease, kv)
            return logits
        width, B = words[:2]
        rids = words[2:2 + B]
        toks = np.zeros((_pow2(B),), np.int64)
        lens = np.zeros((_pow2(B),), np.int64)
        toks[:B] = words[2 + B:2 + 2 * B]
        lens[:B] = words[2 + 2 * B:2 + 3 * B]
        leases = [self._leases[r] for r in rids]
        k, v = self.pool.gather(leases, width)
        if toks.size > B:  # pad rows ride along with length 0, dropped
            pad = ((0, 0), (0, toks.size - B)) + ((0, 0),) * (k.ndim - 2)
            k = np.pad(k, pad)
            v = np.pad(v, pad)
        out, nk, nv = self._decode(toks, k, v, lens)
        for i, lease in enumerate(leases):
            self.pool.write_token(lease, int(lens[i]), nk[:, i], nv[:, i])
        return out

    def _step(self, kind: int, words: list[int]) -> np.ndarray:
        """Run one prefill or decode step: alone, or on a mesh by sending
        its plan first and taking every rank's verdict after."""
        ls = self._lockstep
        if ls is None:
            return self._apply(kind, words)
        try:
            ls.send(kind, words)
        except RuntimeError as exc:  # a broken group
            raise StepFailed(f"plan broadcast failed: {exc}") from exc
        return ls.run(lambda: self._apply(kind, words))

    def _free(self, rids) -> None:
        """Return the leases of ``rids`` (a retire plan, on every
        rank)."""
        for rid in rids:
            lease = self._leases.pop(int(rid), None)
            if lease is not None:
                lease.free()

    def _flush(self) -> None:
        """Free what was retired since the last step: on a mesh, after a
        retire plan that makes every rank free the same leases."""
        if not self._retired:
            return
        rids, self._retired = self._retired, []
        if self._lockstep is not None:
            try:
                self._lockstep.send(_RETIRE, rids)
            except RuntimeError as exc:  # a broken group
                self._free(rids)
                raise StepFailed(f"retire plan failed: {exc}") from exc
        self._free(rids)

    # ------------------------------------------------------------ public
    def start(self) -> "GenEngine":
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the engine thread to end (a follower's ends when rank
        0 stops the mesh or a step fails); True when it has."""
        if self._thread.ident is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Stop the loop and settle every in-flight request (error =
        shutdown) — blocks are freed, tickets finished, streams closed.
        On a mesh, rank 0's stop stops every rank; a follower's waits
        for that."""
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
        elif self._lockstep is not None and self.leader:
            self._send_stop()
        self._settle_all("engine shutdown")

    def _settle_all(self, error: str) -> None:
        """Free every lease and settle every pending and running request
        with ``error``."""
        with self._work:
            leftovers = list(self._pending) + [s.req for s in self._running]
            self._pending.clear()
            self._running.clear()
        self._retired.clear()
        self._free(list(self._leases))
        for req in leftovers:
            self._finish_req(req, error=error)
        HUB.set_gauge("gen_queue_depth", 0)
        HUB.set_gauge("gen_running", 0)

    def submit(self, prompt, max_new_tokens: int | None = None) -> Request:
        """Admit one request (greedy decode). Raises
        :class:`QueueOverflow` when the waiting room is full and
        ``ValueError`` on malformed input — both before any KV is
        reserved. On a mesh only rank 0 takes requests."""
        if not self.leader:
            raise RuntimeError(
                f"rank {self.mesh.rank} follows rank 0's plans: submit "
                "to rank 0's engine")
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
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)  # a rank's card, for NCCL
        if not self.leader:
            self._follow()
            return
        try:
            self._lead()
        except StepFailed as exc:
            log.error("engine stopped: %s", exc)
            with self._work:
                self._stop = True
            self._settle_all(f"mesh step failed: {exc}")

    def _lead(self) -> None:
        ls = self._lockstep
        while True:
            with self._work:
                while not self._stop and not self._pending \
                        and not self._running:
                    if not self._work.wait(self._heartbeat_s):
                        break  # idle for a heartbeat
                if self._stop:
                    break
            if ls is not None and \
                    time.monotonic() - ls.sent_s >= self._heartbeat_s:
                self._beat()
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
        if ls is not None:
            self._send_stop()

    def _beat(self) -> None:
        try:
            self._lockstep.send(_NOOP, [])
        except RuntimeError as exc:  # a broken group
            raise StepFailed(f"heartbeat failed: {exc}") from exc

    def _send_stop(self) -> None:
        try:
            self._lockstep.send(_STOP, [])
        except RuntimeError as exc:  # the followers time out
            log.error("stop plan not sent: %s", exc)

    def _follow(self) -> None:
        """A follower's loop: run rank 0's plans until its stop, or until
        a step fails on some rank; then free every lease."""
        ls = self._lockstep
        try:
            while True:
                kind, words = ls.recv()
                if kind == _STOP:
                    return
                if kind == _RETIRE:
                    self._free(words)
                elif kind in (_PREFILL, _DECODE):
                    ls.run(lambda: self._apply(kind, words))
        except Exception as exc:  # noqa: BLE001 - StepFailed, a broken group
            log.error("follower rank %d stopped: %s", self.mesh.rank, exc)
        finally:
            self._free(list(self._leases))

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
        self._leases[req.id] = lease
        words = [req.id, len(req.prompt), len(lease.blocks), *lease.blocks,
                 *req.prompt]
        try:
            with trace.span("serve.prefill", remote_parent=req.traceparent,
                            request=req.id, prompt=len(req.prompt)):
                logits = self._step(_PREFILL, words)
                tok0 = int(np.argmax(logits))
        except StepFailed as exc:
            self._finish_req(req, error=f"mesh step failed: {exc}")
            raise
        except Exception as exc:  # noqa: BLE001 - engine must survive
            self._free([req.id])
            log.error("prefill failed for request %d: %s", req.id, exc)
            self._finish_req(req, error=f"prefill failed: {exc}")
            return
        seq = _Seq(req, len(req.prompt), tok0)
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
        self._flush()

    def _evict_cancelled(self) -> None:
        for seq in self._snapshot_running():
            if seq.req.cancelled.is_set():
                HUB.inc("gen_evicted_total")
                self._retire(seq, error="evicted")
        self._flush()

    def _decode_step(self) -> None:
        """Advance every running sequence one token, ragged lengths and
        all — the continuous-batching inner loop."""
        batch = self._snapshot_running()
        if not batch:
            return
        B = len(batch)
        bs = self.pool.block_tokens
        width = bs * _pow2(-(-max(s.length for s in batch) // bs))
        words = [width, B, *(s.req.id for s in batch),
                 *(s.last_tok for s in batch), *(s.length for s in batch)]
        try:
            # one step serves the whole batch: it is filed under the
            # trace of the oldest running request
            with trace.span("serve.decode-step",
                            remote_parent=batch[0].req.traceparent,
                            batch=B, width=width):
                out = self._step(_DECODE, words)
        except StepFailed:
            raise
        except Exception as exc:  # noqa: BLE001 - engine must survive
            log.error("decode step failed (batch=%d): %s", B, exc)
            for seq in batch:
                self._retire(seq, error=f"decode failed: {exc}")
            self._flush()
            return
        for i, seq in enumerate(batch):
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
        self._flush()

    def _retire(self, seq: _Seq, error: str | None = None) -> None:
        """Finished/evicted/failed: its blocks free at the next
        :meth:`_flush`, which follows at the end of the step."""
        self._retired.append(seq.req.id)
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
