"""Paged KV cache: fixed-size blocks in one preallocated host pool
(``demodel_tpu/serve/kvcache.py``, kept as it is).

The pool preallocates ``num_blocks`` blocks of ``block_tokens`` KV slots
(all layers of one token position share a block index — a block is
``[L, block_tokens, Hkv, hd]`` ×2 for K and V), sequences lease whole
blocks through a :class:`~demodel_tpu_torch.tier.TierBudget`, and a
finished sequence's blocks return to the free list immediately.

The pool is host numpy, float32 by default, on purpose: it is the memory
ledger (alloc/free exactness, budget-bounded admission). The engine
passes no dtype, so a bf16 model's KV is written into and gathered from
an fp32 pool — and every decode step moves the gathered KV to the card.
A device-resident pool is later work.

On a mesh of several ranks every rank keeps its own pool of the KV heads
its attention reads (``llama.cache_heads``), with rank 0's block count
(``num_blocks=``), and leases the very blocks rank 0 leased
(``alloc(blocks=)``), so the block ids in rank 0's step plans address
every rank's pool alike.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from demodel_tpu_torch.tier import TierBudget
from demodel_tpu_torch.utils.env import gen_block_tokens, gen_kv_mb
from demodel_tpu_torch.utils.logging import get_logger
from demodel_tpu_torch.utils.metrics import HUB

log = get_logger("serve.kvcache")

#: pre-register the generation KV families so a scrape types them
HUB.set_gauge("gen_kv_blocks_in_use", 0)
HUB.inc("gen_kv_blocks_alloc_total", 0)
HUB.inc("gen_kv_blocks_freed_total", 0)


def host(x) -> np.ndarray:
    """A tensor (any device; bf16 widened to fp32, which numpy lacks) or
    an array, as host numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class PoolExhausted(Exception):
    """alloc() asked for more blocks than the pool has free — the
    admission signal: the scheduler keeps the sequence waiting, it never
    overcommits."""


class BlockLease:
    """One sequence's blocks. Must reach :meth:`free` exactly once;
    idempotent so cleanup paths can race shutdown."""

    __slots__ = ("_pool", "blocks", "_freed")

    def __init__(self, pool: "KVBlockPool", blocks: list[int]):
        self._pool = pool
        self.blocks = blocks
        self._freed = False

    def free(self) -> None:
        if self._freed:
            return
        self._freed = True
        self._pool._reclaim(self.blocks)


class KVBlockPool:
    """Preallocated block pool for one model's generation KV.

    ``layers``/``kv_heads``/``head_dim`` fix the block geometry; the byte
    budget (``DEMODEL_GEN_KV_MB`` unless overridden) fixes the block
    count, unless ``num_blocks`` gives it (a rank mirroring rank 0's
    pool; the budget is then what those blocks take). Block state sits
    behind one lock; leased bytes are written lock-free because only the
    engine thread touches them.
    """

    def __init__(self, layers: int, kv_heads: int, head_dim: int, *,
                 block_tokens: int | None = None,
                 budget_mb: int | None = None,
                 dtype: str = "float32",
                 num_blocks: int | None = None):
        self.block_tokens = int(block_tokens or gen_block_tokens())
        budget_bytes = int(budget_mb if budget_mb is not None
                           else gen_kv_mb()) << 20
        dt = np.dtype(dtype)
        self.block_bytes = (2 * layers * self.block_tokens * kv_heads
                            * head_dim * dt.itemsize)
        if num_blocks is None:
            self.num_blocks = max(1, budget_bytes // self.block_bytes)
        else:
            self.num_blocks = int(num_blocks)
            budget_bytes = self.num_blocks * self.block_bytes
        shape = (layers, self.num_blocks, self.block_tokens, kv_heads,
                 head_dim)
        self.k = np.zeros(shape, dt)
        self.v = np.zeros(shape, dt)
        self.budget = TierBudget("gen-kv", budget_bytes)
        self._free_list = list(range(self.num_blocks - 1, -1, -1))
        self._lock = threading.Lock()
        log.info("kv pool: %d blocks x %d tokens (%d KiB/block, %d MiB)",
                 self.num_blocks, self.block_tokens,
                 self.block_bytes >> 10, budget_bytes >> 20)

    # ------------------------------------------------------------ sizing
    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV positions (≥1)."""
        return max(1, -(-int(tokens) // self.block_tokens))

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free_list)

    @property
    def in_use_blocks(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free_list)

    # ------------------------------------------------------- alloc/free
    def alloc(self, n: int, blocks: list[int] | None = None) -> BlockLease:
        """Lease ``n`` blocks or raise :class:`PoolExhausted` — never a
        partial grant. ``blocks`` names the ``n`` blocks to lease (a rank
        mirroring rank 0's lease); one that is not free raises."""
        with self._lock:
            if n > len(self._free_list):
                raise PoolExhausted(
                    f"need {n} blocks, {len(self._free_list)} free "
                    f"of {self.num_blocks}")
            if blocks is None:
                blocks = [self._free_list.pop() for _ in range(n)]
            else:
                blocks = [int(b) for b in blocks]
                taken = set(blocks)
                if len(blocks) != n or len(taken) != n \
                        or not taken.issubset(self._free_list):
                    raise PoolExhausted(
                        f"blocks {blocks} are not {n} free blocks")
                self._free_list = [b for b in self._free_list
                                   if b not in taken]
            in_use = self.num_blocks - len(self._free_list)
        self.budget.charge(n * self.block_bytes)
        HUB.inc("gen_kv_blocks_alloc_total", n)
        HUB.set_gauge("gen_kv_blocks_in_use", in_use)
        return BlockLease(self, blocks)

    def _reclaim(self, blocks: list[int]) -> None:
        with self._lock:
            self._free_list.extend(blocks)
            in_use = self.num_blocks - len(self._free_list)
        self.budget.release(len(blocks) * self.block_bytes)
        HUB.inc("gen_kv_blocks_freed_total", len(blocks))
        HUB.set_gauge("gen_kv_blocks_in_use", in_use)

    # ---------------------------------------------------------- data IO
    def write_prompt(self, lease: BlockLease, kv) -> None:
        """Page a prefill's KV out into the lease: ``kv`` is the
        per-layer ``(k, v)`` list from ``step_prefill``, each
        [1, T, Hkv, hd] (tensors on any device, or arrays)."""
        if isinstance(kv[0][0], torch.Tensor):  # one copy off the card
            k = host(torch.stack([lk[0] for lk, _lv in kv]))
            v = host(torch.stack([lv[0] for _lk, lv in kv]))
        else:
            k = np.stack([host(lk[0]) for lk, _lv in kv])
            v = np.stack([host(lv[0]) for _lk, lv in kv])
        T = k.shape[1]
        bs = self.block_tokens
        for j in range(0, T, bs):
            blk = lease.blocks[j // bs]
            n = min(bs, T - j)
            self.k[:, blk, :n] = k[:, j:j + n]
            self.v[:, blk, :n] = v[:, j:j + n]

    def write_token(self, lease: BlockLease, pos: int, k, v) -> None:
        """Write one decoded position: ``k``/``v`` are [L, Hkv, hd]."""
        blk = lease.blocks[pos // self.block_tokens]
        off = pos % self.block_tokens
        self.k[:, blk, off] = k
        self.v[:, blk, off] = v

    def gather(self, leases: list[BlockLease], width: int):
        """Dense [L, B, width, Hkv, hd] K and V views of ``leases``. Rows
        past a sequence's filled length are stale pool bytes; the model
        masks them by length."""
        bs = self.block_tokens
        nb = -(-int(width) // bs)
        ids = np.zeros((len(leases), nb), np.int64)
        for i, lease in enumerate(leases):
            got = lease.blocks[:nb]
            ids[i, :len(got)] = got
        L = self.k.shape[0]
        k = self.k[:, ids].reshape(L, len(leases), nb * bs,
                                   *self.k.shape[3:])[:, :, :width]
        v = self.v[:, ids].reshape(L, len(leases), nb * bs,
                                   *self.v.shape[3:])[:, :, :width]
        return k, v

    # ------------------------------------------------------------ intro
    def describe(self) -> dict[str, Any]:
        with self._lock:
            free = len(self._free_list)
        return {
            "block_tokens": self.block_tokens,
            "block_bytes": self.block_bytes,
            "num_blocks": self.num_blocks,
            "free_blocks": free,
            "in_use_blocks": self.num_blocks - free,
            "budget": self.budget.describe(),
        }
