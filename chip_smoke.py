#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``demodel_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line:

1. device — the card, its power limit, and TF32 switched off for both
   matmul and cuDNN; which compilers the machine has and whether
   ``requests``, ``cryptography`` and ``jax`` are installed (recorded,
   not used); the OpenSSL version of the libcrypto the port's ``pki``
   loads;
2. build — nvcc builds the flash-attention and dequant kernels (csrc/)
   for sm_90a and g++ the store library (native/), one compiler per
   library, started together; the library must hold exactly the flash
   instantiations ``wgmma_{bf16,f16}_d{64,128,256}`` (any D up to the
   padded one), the same with ``_exact`` (D equal to it, no run-time
   guard) and ``tf32x3_f32_d{16,32,...,256}`` (f32 by three TF32
   products, at every multiple of 16), each with 0 spill bytes in its
   ptxas line (registers, spills and ptxas's injected
   ``warpgroup.arrive`` count printed per instantiation), and
   ``cuobjdump -sass`` must count tensor-core
   instructions in each: HGMMA in the ``wgmma`` ones,
   HMMA.1688.F32.TF32 in the ``tf32x3`` ones;
3. kernel — the flash kernels against their plain PyTorch version on the
   card at every main-path prompt length (17, 64, 96, 128, 512), at
   2048, and in every masking case (GQA, ragged decode, a kv_len-0 row,
   Sq > kv_len, non-causal, no keys at all, D=64, strided and misaligned
   k/v views, f32, return_lse), f16 at 17, 512 and 2048, f32 at D=128
   (S=512 and 2048, and the strided views), head dims 8, 32, 80, 96 and
   256 (S=512, H=32, G=8), GPT-2's and BERT's D=64 at H=G=12 (S=512,
   causal and bidirectional, f32 and bf16) and the tiny config's prefill
   shape in f32, bf16 and f16, OpenLLaMA-3B's D=100 at H=G=32 in bf16,
   f16 and f32 at S=512 and 2048, from a view of its KV cache, and with
   GQA (the padded
   copy), odd head dims (D=99 through the row map in bf16 and f16, by
   4-byte copies in f32; D=33 from views padded to 40) in bf16 and f16,
   each with the call time
   (CUDA events), the device time per call (torch.profiler, or the call
   time where every trace lost the work) of the kernel and of SDPA, the
   plain version's time and the roofline bound; then a ``floors`` line
   that sets the first redesign's targets beside what was measured, and a
   ``head_dim_floors`` line with the bf16/f16 device time over SDPA's at
   D 80, 96, 100 and 256 (target 2x, reported), and an ``f32_floors``
   line with the f32 device time over SDPA's at every f32 head dim
   (target 1x, reported) beside SDPA's kernels;
3b. grads — grads through K1 on the card in bf16 and f32, with and
   without the LSE: one launch a forward (and under ``inference_mode``),
   dq, dk, dv finite and within the dtype's limit of autograd through
   ``reference_attention_lse`` on the same tensors;
4. dequant — each GGUF dequant kernel (csrc/dequant.cu: Q8_0, Q4_0 and
   the five K-quants) against its plain PyTorch version on the card at
   the ffn_gate shape 11008×4096 in bf16 and f32, and at 1, 3, 257 and 0
   blocks; kernel and plain times beside the bytes bound;
5. slice — a Llama-2-7B-width model (32 layers, bf16, seeded random
   weights) served by the continuous-batching engine: prefill logits
   kernel vs plain path, five requests (staggered joins, HTTP sync and
   NDJSON stream among them) whose first tokens must equal the argmax of
   their kernel-path prefill logits, kernel launches counted over the
   run (all on the tensor-core kernel), the KV pool back to zero
   blocks;
6. parity — full width, 2 layers, fp32: engine tokens equal the port's
   sequential ``generate``;
7. gguf — cold boot of Llama-2-7B-width GGUF files (seeded random valid
   blocks in a host buffer) through ``deliver_gguf`` on the default CUDA
   mesh: a 32-layer Q4_K_M file, then Q4_0, Q8_0, Q2_K, Q3_K and Q5_K
   at 2 layers; launches per format counted over each delivery, every
   value finite, layer 0, the last layer, token_embd and output held
   against the plain version, one tensor against ``REF_DEQUANT``;
8. ollama — an Ollama registry (registry-v2 on stdlib ``http.server``,
   127.0.0.1) serves the gguf phase's 32-layer Q4_K_M file (4.08 GB)
   and its 2-layer Q4_0 and Q8_0 files as three models, each with a
   config blob, a license and a params layer; ``delivery.pull_to_hbm(
   source="ollama")`` pulls each into a store in a temporary directory
   and streams the GGUF layer through the sink onto the card, dequantized
   by K2–K4: the stored blob's sha256 is its digest, every placed tensor
   equals ``deliver_gguf`` of the same bytes from the host buffer, one
   tensor per ggml type is held against its plain dequant, and the
   dequant launches per format are those the file needs; then the
   sharded phase's gguf leg: that store behind the port's
   ``ProxyServer`` and ``pull_manifest_to_hbm(source="ollama")`` of the
   Q4_0 and Q8_0 models onto the card with no store on this side (K3 and
   K4e, then K2), every tensor equal to ``deliver_gguf`` of the stored
   blob, launches per format those the file needs;
9. pull — a cold pull from a HuggingFace-style registry served by this
   script (stdlib ``http.server`` on 127.0.0.1: the Hub API, resolve
   with its 302 to a CDN path, Range) of an F16 Llama-2-7B-width
   checkpoint cut to 8 layers (3.76 GB of seeded random weights in two
   safetensors shards) through ``serve.load_model`` into a store in a
   temporary directory: every placed tensor equal to its source on the
   card, three requests (prompts of 17, 128 and 512 tokens) over HTTP
   with all K1 launches on the f16 tensor-core kernel, first tokens the
   argmax of their kernel-path prefill logits, logits against the plain
   path, the manifest record in the store;
10. peer — the pull phase's store served by the port's ``ProxyServer``
   (``no_mitm``, ``/peer/*`` from the native library) on 127.0.0.1, and
   ``serve.load_model(peers=[it])`` into a fresh store with the same Hub
   as endpoint: no CDN or blob request reaches the Hub, every file comes
   from the peer, every placed tensor equals the pull phase's, the
   17-token prompt's tokens equal the pull phase's, K1 launches all on
   ``wgmma_f16``; then the gossip thread and the proxy stop;
10b. sharded — the pull phase's store behind the port's ``ProxyServer``
   again; ``sink.remote.pull_manifest_to_hbm`` places the checkpoint off
   it onto the card with no store on this side (the prefetch pipeline,
   the tuner, native window fetches): every placed tensor equals the pull
   phase's, network bytes equal weight bytes equal the checkpoint's, no
   window fell back to the Python transport; ``materialize_aux_files``
   writes ``config.json``, the model is built from it and the placement
   (``load_llama_params``, ``serve.boot``) and the 17-token prompt's
   tokens equal the pull phase's, K1 launches all on ``wgmma_f16``; then
   two ``SwarmScheduler`` hosts, each behind its own ``RestoreServer``,
   place it at once: both placements equal, origin chunk bytes exactly
   the checkpoint's (1×), peer chunk bytes the same (the other copy), no
   chunk re-fetched;
10c. mitm — the MITM front door: the pull phase's Hub and a registry-v2
   holding the ollama phase's Q4_0 file, both over TLS (a CA and a
   127.0.0.1 leaf from the port's ``pki``), behind the port's
   ``ProxyServer`` intercepting both with its own CA (RSA, the default)
   and a store of its own. A ``huggingface-cli``-shaped client (urllib,
   trusting only the port's CA) fetches every file through it, following
   the 302 to the CDN: sha256 equal to the source, one leaf minted, every
   object committed whole, then a warm pass (``config.json`` and a 64 MiB
   Range of each shard) with no Hub request. ``synthesize_manifest``
   turns the cache into the model's record (synth keys, sizes, sha256),
   served on ``/peer``; the sharded leg places it off the proxy onto the
   card (the sharded phase's gates: tensors, bytes, no fallback, tokens,
   K1 on ``wgmma_f16``); an ``ollama pull``-shaped client fetches the Q4_0
   model, its record is synthesized and ``pull_manifest_to_hbm`` places
   it through K3 and K4e, equal to ``deliver_gguf`` of the buffer; and
   ``python -m demodel_tpu_torch.cli manifest`` prints the same record;
10d. restore — the restore node: ``python -m demodel_tpu_torch.cli
   serve`` in a child process over the pull phase's store (node A; its
   ports read from its stderr line) and a ``RestoreServer`` in this
   process over a fresh store (node B). A's manifest resolves from the
   pull record (all 75 tensors, its native plane as ``data_endpoint``);
   ``restore.client.restore`` from A places every tensor on the card,
   equal to the pull phase's, the tensors' bytes fetched and A's
   ``demodel_proxy_bytes_cache`` grown by as many; the model built from
   it answers the pull phase's tokens over B's ``/generate`` (K1 on
   ``wgmma_f16``) while A's answers 503; ``save_state_dict`` to B pushes
   all 75 tensors, again none (0 bytes), and ``dcp.save`` through
   ``HTTPStorageWriter`` under a second name sends 0 bytes; a restore
   from B (its Python server) is equal; ``dcp.load`` through
   ``HTTPStorageReader`` from A is equal; ``orbax_compat`` writes layers
   0-1 as DCP files and reads them back onto the card, equal; SIGINT
   stops A with exit 0 within 30 s; seconds and GB/s of each step;
10e. obs — on node B, started with a telemetry archive
   (``DEMODEL_TELEMETRY_ARCHIVE``) and the export tier
   (``trace.enable`` with a JSONL sink), the restored model booted on the
   card: a streamed 512-token request (64 new tokens) carrying a W3C
   ``traceparent``; while it decodes ``/debug/statusz`` shows the running
   sequence, KV blocks in use and a ``serve.*`` span in flight, and
   ``/debug/profile?seconds=1`` has stacks rooted at
   ``serve.decode-step`` with wall and on-CPU samples; after it the
   JSONL holds the server's root span under the client's trace and span
   ids with the prefill and all 63 decode steps below it,
   ``dump_chrome`` one ``X`` event a span, ``/debug/telemetry`` the
   prefill and ``/debug/telemetry/history`` its windows; the pull
   phase's 17-token request in turns under ``DEMODEL_OBS=0``, the
   default tier and export, its tokens equal to the pull phase's each
   time, K1 on ``wgmma_f16``; node B stops and a second
   ``RestoreServer`` (another process) starts over the same archive,
   whose history then reads one series from both pids; a flight-recorder
   dump is complete JSON; the seconds of each request and of one statusz
   scrape are printed with the card; the phase takes 30 s or less;
11. tiny — ``LlamaConfig.tiny()`` (head dim 8) in f32, bf16 and f16:
   served through K1 by default (f32 on ``tf32x3_f32``, bf16 and f16 on
   ``wgmma_*`` at padded head dim 64), engine tokens equal to
   ``generate``; under the caller's explicit ``DEMODEL_FLASH_ATTN=0``
   served on the einsum path with no K1 launch; sampled ``generate``
   (temperature 1) equal under equal seeded CUDA generators, temperature
   0 equal to greedy;
12. openllama — OpenLLaMA-3B's widths (its ``config.json``: hidden 3200,
   32 heads of 100, 26 layers, intermediate 8640; seeded random
   weights) on the card, in f16 (6.85 GB) and then in f32 (13.7 GB, as
   an F32 checkpoint is built in its stored dtype): prefill logits of
   the kernel path against the plain path at 17, 128, 512 and 2048
   tokens (f32 within 1e-3), K1's share of the 512- and 2048-token
   prefills' device time, then ``serve.boot`` and prompts of 17, 128 and
   512 tokens over HTTP with first tokens the argmax of their kernel-path
   logits and all 78 K1 launches of a leg on ``wgmma_f16`` or
   ``tf32x3_f32``;
13. families — GPT-2 and BERT at their published widths
   (``openai-community/gpt2``, ``google-bert/bert-base-uncased``; F32
   checkpoints of seeded weights under HF names) pulled cold from the
   in-script Hub through the port's store and built by
   ``model_from_pull`` on the card: every placed tensor equal to its
   source; GPT-2 ``forward`` (B=2, T=1024, causal) and BERT ``encode``
   (B=4, T=512, bidirectional) through K1 at head dim 64, 12 launches a
   forward, in f32 (``tf32x3_f32``) and cast to bf16 (``wgmma_bf16``),
   each against the plain path (f32 within 2e-4 of the largest value,
   bf16 within 2e-2 relative L2); BERT with a right-padded mask on the
   einsum path, no K1 launch, equal to the plain path; each forward's
   seconds, K1's share of its device time, and the route of GPT-2's
   strided q/k/v views (any copy before K1 timed);
14. train — Llama's momentum-SGD ``make_train_step`` through K1 (one
   launch a layer a step, the backward the recompute rule) at
   OpenLLaMA-3B's widths: bf16 at all 26 layers, B=1, T=512, 3 steps
   from seeded params (loss finite; step 1's loss within 2e-2 and
   momentum within 5e-2 relative L2 of the plain path's; no attention
   score tensor saved for the backward; seconds a step, tokens/s, peak
   memory), f32 at 4 layers, one step (loss and momentum within 1e-4 of
   the plain path's); one MoE step (``MoEConfig.tiny()``) on the card
   equal to the same code on the CPU within 1e-5; a GPipe forward and
   gradient (4 stages of 16) equal to sequential execution within 1e-5;
15. mesh — multi-device as far as one card shows it. NCCL at world size
   1 (``init_process_group`` on a ``FileStore`` in a temporary
   directory): ``make_mesh()`` spans the group on ``cuda:0``;
   ``replicate``, ``allgather_axis``, ``psum_across``, ``redistribute``
   and ``fingerprint`` on CUDA tensors equal their inputs; a
   Llama-2-7B-width 2-layer bf16 model on ``make_mesh(1, sp=1)`` gives
   the one-device prefill logits bit for bit and its greedy tokens;
   ``deliver_safetensors`` with ``ici_complete`` equals it without, byte
   for byte, on a 7B-width 2-layer file, and a 2-layer Q4_K_M
   ``deliver_gguf`` on the group's mesh equals it with no group; the
   group is destroyed. Then the ring's per-rank schedule for 4 ranks in
   this process (each rank's body over the in-process rotation: the K1
   launches and windows of a real ring, not a multi-GPU run) at
   Llama-2-7B's attention widths (H=G=32 and GQA H=32/G=8, D=128, B=1)
   at T=4096, 4093 (padded) and 9 (a block of padding), causal and
   bidirectional, in bf16, f16 and f32: within 2e-2, 2e-3 and 1e-4 of
   the plain dense attention, n² K1 launches a call; the ring's device
   time beside K1 over the whole sequence (reported); and the ring's dq,
   dk, dv at n=2, T=1024 in bf16 and f32 within the dtype's limit of
   autograd through the plain dense attention.

Then the card line from nvidia-smi, a JSON line with the kernels, and
last ``{"ok": true, "device": {...}}``. Any failed phase raises (exit
code 1, no last line); without a CUDA device the script exits 2.
Imports neither jax nor ``demodel_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

#: kernel vs plain version, max abs error on outputs of O(1)-scaled inputs:
#: bf16 output rounding (8-bit mantissa) and summation order; f32 summation
#: order only
BF16_TOL = 2e-2
F32_TOL = 1e-4
#: the same for f16, its own: the kernel rounding P to f16 reads at most
#: 2^-9 (one f16 ulp at |o| in [2, 4)) on these seeded inputs, while the
#: same kernel rounding P to bf16 reads 0.0022 to 0.0039, so 2e-3 tells
#: the two apart
F16_TOL = 2e-3
TOL = {"bfloat16": BF16_TOL, "float16": F16_TOL, "float32": F32_TOL}
#: 7B prefill logits, kernel path vs plain path (dense einsum attention in
#: bf16), relative L2 error: bf16 scores in the plain path round to 8 bits
#: before the softmax and the difference compounds over 32 layers
LOGITS_REL_TOL = 5e-2
#: peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16/f16 tensor
#: cores; for exact f32 work the faster of the CUDA cores (67 TFLOP/s) and
#: three TF32 products a pair on the tensor cores (495 / 3 = 165 TFLOP/s,
#: the split K1's f32 kernel runs); HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": max(67e12, 495e12 / 3)}
PEAK_BYTES = 3.35e12
NEG_INF = -1e30

PROMPT_LENS = (17, 128, 64, 96)   # served together, staggered
LONG_PROMPT = 512                 # served alone afterwards
MAX_NEW = 16
#: K1 targets of the tensor-core redesign, reported (not gated) beside
#: the measurement: device ms at S=512 (a quarter of the CUDA-core
#: kernel's 0.228 ms per call), device ms at S=2048 (15% of the
#: operations bound), call time at S=17 over SDPA's
K1_FLOORS = {"prefill_s512_device_ms": 0.057,
             "prefill_s2048_device_ms": 0.231,
             "prefill_s17_call_over_sdpa": 2.0}


def _say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 1-2


def phase_device() -> str:
    import importlib.util
    import shutil

    import torch

    from demodel_tpu_torch import pki

    if os.environ.get("DEMODEL_FLASH_ATTN", "").strip().lower() in (
            "0", "false", "no", "off"):
        raise SystemExit("chip_smoke: DEMODEL_FLASH_ATTN=0 turns the kernel "
                         "off; unset it")
    smi = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say("device", card=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
         which={t: shutil.which(t) for t in ("g++", "c++", "make", "nvcc")},
         installed={m: importlib.util.find_spec(m) is not None
                    for m in ("requests", "cryptography", "jax")},
         openssl=pki.openssl_version())
    return smi


#: the flash instantiations the library must hold: the ``wgmma`` kernel
#: in bf16 and f16 at each padded head dim, for any D up to it and for D
#: equal to it (``_exact``), the 3xTF32 ``mma.sync`` one in f32
FLASH_INSTANTIATIONS = sorted(
    [f"wgmma_{t}_d{dp}{x}" for t in ("bf16", "f16") for dp in (64, 128, 256)
     for x in ("", "_exact")]
    + [f"tf32x3_f32_d{dp}" for dp in range(16, 257, 16)])
#: the tensor-core instruction each kind of instantiation must hold in its
#: SASS: Hopper's warpgroup MMA, and the TF32 m16n8k8 MMA of mma.sync
TC_SASS = {"wgmma": "HGMMA", "tf32x3": "HMMA.1688.F32.TF32"}


def _instantiation(fn: str) -> str | None:
    """``wgmma_bf16_d128`` for the mangled ``flash_fwd_wgmma<bf16, 128,
    false>`` (``_exact`` appended for ``true``), ``tf32x3_f32_d64`` for
    ``flash_fwd_tf32x3<64>``; None for the rest."""
    m = re.search(r"flash_fwd_wgmmaI(6__half|13__nv_bfloat16)"
                  r"Li(\d+)ELb([01])E", fn)
    if m:
        return (f"wgmma_{'f16' if m[1] == '6__half' else 'bf16'}_d{m[2]}"
                f"{'_exact' if m[3] == '1' else ''}")
    m = re.search(r"flash_fwd_tf32x3ILi(\d+)E", fn)
    return f"tf32x3_f32_d{m[1]}" if m else None


def _tensor_core_counts(lib) -> dict[str, dict[str, int]]:
    """Tensor-core instructions (HGMMA and HMMA.1688.F32.TF32) in each
    flash kernel function of the built library, from ``cuobjdump
    -sass``."""
    from pathlib import Path

    from demodel_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc(_build.CUDA_DEFAULT)).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for ln in sass.splitlines():
        s = ln.strip()
        if s.startswith("Function :"):
            fn = _instantiation(s.split(":", 1)[1].strip())
            if fn is not None:
                counts[fn] = dict.fromkeys(TC_SASS.values(), 0)
        elif fn is not None:
            for op in TC_SASS.values():
                if op in s:
                    counts[fn][op] += 1
    return counts


def _ptxas_by_instantiation(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each flash instantiation, from the
    ``-Xptxas=-v`` lines of the build log, and how many times ptxas
    injected a ``warpgroup.arrive`` among its wgmmas (advisory C7519: a
    wait the source did not ask for)."""
    out: dict[str, dict] = {}
    fn = None
    for ln in log.splitlines():
        m = re.search(r"\(C7519\).* in function '(\w+)'", ln)
        if m and _instantiation(m[1]) is not None:
            entry = out.setdefault(_instantiation(m[1]), {})
            entry["arrives_injected"] = entry.get("arrives_injected", 0) + 1
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)", ln)
        if m:
            fn = _instantiation(m[1])
            if fn is not None:
                out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[fn]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


def phase_build() -> None:
    """Build every library at once: one nvcc per kernel source and one
    g++ for the store library, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from demodel_tpu_torch import native
    from demodel_tpu_torch.ops import dequant as dq
    from demodel_tpu_torch.ops import flash_attention as fa

    builders = {"flash_attention": fa.build_library,
                "dequant": dq.build_library, "store": native.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futs = {k: pool.submit(b) for k, b in builders.items()}
        libs = {k: f.result() for k, f in futs.items()}
    fa._library()
    dq._library()
    native.lib()
    secs = time.perf_counter() - t0
    flash_ptxas = _ptxas_by_instantiation(
        libs["flash_attention"].with_suffix(".log").read_text())
    dequant_ptxas = [ln.strip() for ln in libs["dequant"].with_suffix(".log")
                     .read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
    tc = _tensor_core_counts(libs["flash_attention"])
    _say("build", seconds=round(secs, 3),
         libraries={k: lib.name for k, lib in libs.items()},
         ptxas={"flash_attention": flash_ptxas, "dequant": dequant_ptxas},
         tensor_core=tc)
    missing = [k for k, n in tc.items()
               if n[TC_SASS[k.split("_")[0]]] == 0]
    if sorted(tc) != FLASH_INSTANTIATIONS or missing:
        raise AssertionError(f"flash instantiations {sorted(tc)} (want "
                             f"{FLASH_INSTANTIATIONS}), or ones without "
                             f"their tensor-core instructions: {missing}")
    spills = {k: v for k, v in flash_ptxas.items()
              if v.get("spill_bytes", 1) != 0}
    if sorted(flash_ptxas) != FLASH_INSTANTIATIONS or spills:
        raise AssertionError(f"flash instantiations spill or lack a ptxas "
                             f"line: {flash_ptxas}")


# --------------------------------------------------------------- phase 3


def _case(name, B, Sq, Sk, H, G, D, dtype, causal=True, kv_len=None,
          offset=None, lse=False, view=None, seed=0):
    """One K1 case. ``kv_len`` / ``offset``: an int goes by value, a list
    as a per-batch tensor. ``view="strided"``: k is a column slice of
    padded rows (a stride TMA cannot take, so the wrapper copies it) and
    v a head slice of a wider buffer (read in place through its
    strides). ``view="cache"``: k and v are the first Sk rows of a
    2048-row KV cache (read in place). ``view="padded"``: q, k and v are
    the first D columns of buffers whose head dim is padded to a
    multiple of 8 (read in place through the 4-D map)."""
    return dict(name=name, B=B, Sq=Sq, Sk=Sk, H=H, G=G, D=D, dtype=dtype,
                causal=causal, kv_len=kv_len, offset=offset, lse=lse,
                view=view, seed=seed)


CASES = [
    _case("prefill_s17", 1, 17, 17, 32, 32, 128, "bfloat16"),
    _case("prefill_s64", 1, 64, 64, 32, 32, 128, "bfloat16"),
    _case("prefill_s96", 1, 96, 96, 32, 32, 128, "bfloat16"),
    _case("prefill_s128", 1, 128, 128, 32, 32, 128, "bfloat16"),
    _case("prefill_s512", 1, 512, 512, 32, 32, 128, "bfloat16", lse=True),
    _case("prefill_s2048", 1, 2048, 2048, 32, 32, 128, "bfloat16"),
    _case("gqa_h32_g8", 1, 256, 256, 32, 8, 128, "bfloat16"),
    _case("gqa_d64", 2, 200, 200, 16, 4, 64, "bfloat16", lse=True),
    _case("strided_kv", 2, 130, 150, 32, 8, 128, "bfloat16", kv_len=140,
          lse=True, view="strided"),
    _case("ragged_decode", 4, 1, 256, 32, 32, 128, "bfloat16",
          kv_len=[1, 100, 256, 37], offset=[0, 99, 255, 36]),
    _case("kv_len_zero_row", 2, 16, 64, 32, 32, 128, "bfloat16",
          kv_len=[0, 50], lse=True),
    _case("sq_gt_kv_len", 1, 48, 64, 32, 32, 128, "bfloat16", kv_len=20,
          lse=True),
    _case("non_causal", 2, 100, 100, 32, 32, 128, "bfloat16", causal=False),
    _case("no_keys", 1, 16, 0, 32, 32, 128, "bfloat16", lse=True),
    _case("f32_prefill", 1, 200, 200, 32, 32, 128, "float32", lse=True),
    _case("f32_d64_gqa_lse", 2, 70, 90, 8, 2, 64, "float32", causal=False,
          lse=True),
    # an F32 Llama-2-7B checkpoint's prefill, and the strided views (k a
    # column slice of padded rows, v a head slice) read in place in f32
    *(_case(f"f32_d128_s{S}", 1, S, S, 32, 32, 128, "float32")
      for S in (512, 2048)),
    _case("strided_kv_float32", 2, 130, 150, 32, 8, 128, "float32",
          kv_len=140, lse=True, view="strided"),
    # a pulled F16 Llama-2 checkpoint's prefill
    _case("f16_prefill_s17", 1, 17, 17, 32, 32, 128, "float16"),
    _case("f16_prefill_s512", 1, 512, 512, 32, 32, 128, "float16", lse=True),
    _case("f16_prefill_s2048", 1, 2048, 2048, 32, 32, 128, "float16"),
    # other head dims, each kernel at its padded head dim: wgmma in bf16
    # and f16, 3xTF32 in f32 (B=1, S=512, H=32, G=8, causal)
    *(_case(f"d{D}_{dt}", 1, 512, 512, 32, 8, D, dt)
      for D in (8, 32, 80, 96, 256)
      for dt in ("float32", "bfloat16", "float16")),
    # OpenLLaMA-3B's prefill (H=G=32, D=100: in bf16/f16 a head stride
    # TMA cannot map, so q, k and v go through the row map; in f32 a
    # 400-byte one, read in place by 16-byte copies), and k/v read from
    # its KV cache with kv_len < Sk
    *(_case(f"openllama_s{S}_{dt}", 1, S, S, 32, 32, 100, dt)
      for S in (512, 2048) for dt in ("bfloat16", "float16", "float32")),
    _case("openllama_kv_cache_float16", 1, 512, 1024, 32, 32, 100,
          "float16", kv_len=900, lse=True, view="cache"),
    # D=100 with GQA: q and k heads at different shifts, so the plan pads
    # copies of q and k for the 4-D map (v through the row map)
    _case("d100_gqa_float16", 1, 512, 512, 32, 8, 100, "float16"),
    # odd head dims, stored one column at a time: D=99 with packed heads
    # (row map, the heads at every shift 0..7; in f32 4-byte copies), D=33
    # read from views padded to 40 columns (4-D map)
    *(_case(f"d99_{dt}", 1, 512, 512, 32, 32, 99, dt)
      for dt in ("bfloat16", "float16", "float32")),
    *(_case(f"d33_padded_{dt}", 1, 512, 512, 32, 8, 33, dt, view="padded")
      for dt in ("bfloat16", "float16")),
    # GPT-2's and BERT's attention (12 heads of 64, no GQA) at S=512:
    # causal and bidirectional, in f32 and bf16
    *(_case(f"d64_h12_{name}_{dt}", 1, 512, 512, 12, 12, 64, dt,
            causal=causal)
      for name, causal in (("causal", True), ("bidir", False))
      for dt in ("float32", "bfloat16")),
    # LlamaConfig.tiny()'s prefill in the tiny phase (12 tokens, 8 heads
    # over 2, head dim 8)
    *(_case(f"tiny_prefill_{dt}", 1, 12, 12, 8, 2, 8, dt)
      for dt in ("float32", "bfloat16", "float16")),
]
#: the K1 kernel each dtype takes at every head dim
K1_BY_DTYPE = {"float32": "tf32x3_f32", "bfloat16": "wgmma_bf16",
               "float16": "wgmma_f16"}
#: the S=512 cases the redesign of bf16/f16 at other head dims aims at
#: (device time at most HEAD_DIM_TARGET times SDPA's), reported
HEAD_DIM_CASES = [f"{c}_{dt}" for c in ("d80", "d96", "openllama_s512",
                                        "d256")
                  for dt in ("bfloat16", "float16")]
HEAD_DIM_TARGET = 2.0
#: the f32 cases the 3xTF32 kernel aims at (device time at most SDPA's,
#: F32_TARGET), reported
F32_CASES = ("d8_float32", "d32_float32", "d80_float32", "d96_float32",
             "openllama_s512_float32", "f32_d128_s512", "d256_float32",
             "openllama_s2048_float32", "f32_d128_s2048")
F32_TARGET = 1.0
#: device-time attribution: K1's own kernels, and everything else
K1_KERNELS = ("flash_fwd_wgmma", "flash_fwd_tf32x3")


def _window(x):
    import torch

    if isinstance(x, list):
        return torch.tensor(x, dtype=torch.int32, device="cuda")
    return x


def _per_call_device_ms(fn, groups, counts_ok=None, iters: int = 20):
    """Device ms per call of ``fn`` by group, over ``iters`` calls after
    a warm-up, the device activities per call by name, and where the
    times come from. From torch.profiler (:func:`_device_ms`;
    ``counts_ok`` sees the counts of all ``iters`` calls). Where every
    trace lost launched work, the first group's time is the call's time
    on CUDA events instead (which includes launch gaps, so it is never
    less than the device time), the other groups' is None, and the
    activities are None."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    got = _device_ms(run, groups, counts_ok)
    if got is None:
        first = next(iter(groups))
        return ({k: _time_ms(fn, iters) if k == first else None
                 for k in groups}, None, "cuda_events")
    ms, counts = got
    return ({k: v / iters for k, v in ms.items()},
            {k: v / iters for k, v in counts.items()}, "profiler")


def _kernel_case(c) -> dict:
    import torch
    import torch.nn.functional as F

    from demodel_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, c["dtype"])
    gen = torch.Generator("cuda").manual_seed(c["seed"])
    B, Sq, Sk, H, G, D = (c[k] for k in ("B", "Sq", "Sk", "H", "G", "D"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q = rnd(B, Sq, H, D)
    if c["view"] == "padded":
        w = -(-D // 8) * 8
        q = rnd(B, Sq, H, w)[..., :D]
        k, v = rnd(B, Sk, G, w)[..., :D], rnd(B, Sk, G, w)[..., :D]
    elif c["view"] == "strided":
        k = rnd(B, Sk, G, D + 4)[..., :D]      # 2(D+4)-byte rows
        v = rnd(B, Sk, 2 * G, D)[:, :, G:]      # every other head block
    elif c["view"] == "cache":
        k, v = rnd(B, 2048, G, D)[:, :Sk], rnd(B, 2048, G, D)[:, :Sk]
    else:
        k, v = rnd(B, Sk, G, D), rnd(B, Sk, G, D)
    kv, off = _window(c["kv_len"]), _window(c["offset"])
    scale = D ** -0.5
    plan = fa.launch_plan(q, k, v, kv, off)
    if plan.kernel != K1_BY_DTYPE[c["dtype"]]:
        raise AssertionError(f"kernel case {c['name']}: planned on "
                             f"{plan.kernel}")

    def kernel(lse=True):
        return fa.flash_attention(q, k, v, kv_len=kv, causal=c["causal"],
                                  causal_offset=off, return_lse=lse)

    kvb, offb = fa._windows(kv, off, B, Sq, Sk, q.device)

    def plain():
        return fa._flash_plain(q, k, v, kvb, offb, c["causal"], scale)

    before = dict(fa.launches_by_kernel)
    got, got_lse = kernel()
    want, want_lse = plain()
    torch.cuda.synchronize()
    if fa.launches_by_kernel[plan.kernel] != before[plan.kernel] + 1:
        raise AssertionError(f"kernel case {c['name']}: no launch of "
                             f"{plan.kernel}")
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[c["dtype"]]
    seen = want_lse > NEG_INF / 2
    lse_err = ((got_lse - want_lse)[seen].abs().max().item()
               if seen.any() else 0.0)
    masked_ok = bool((got_lse[~seen] == NEG_INF).all()
                     and (got.float().permute(0, 2, 1, 3)[
                         (~seen).permute(0, 2, 1)] == 0).all())
    if not (err <= tol and lse_err <= tol and masked_ok
            and torch.isfinite(got.float()).all()):
        raise AssertionError(f"kernel case {c['name']}: max_abs_err {err} "
                             f"lse_err {lse_err} masked_ok {masked_ok} "
                             f"(tol {tol})")

    def call():
        return kernel(c["lse"])

    ms = _time_ms(call)
    # one K1 launch a call, so the trace of 20 calls holds 20 of them
    dev, _, dev_by = _per_call_device_ms(call, {
        "k1": lambda n: any(s in n for s in K1_KERNELS),
        "other": lambda n: not any(s in n for s in K1_KERNELS)},
        counts_ok={"k1": lambda c: sum(c.values()) == 20})
    plain_ms = _time_ms(plain)
    lib_ms = lib_dev_ms = lib_kernels = lib_dev_by = None
    if c["kv_len"] is None and c["offset"] is None and (
            not c["causal"] or Sq == Sk):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = {"enable_gqa": True} if G != H else {}

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=c["causal"], **gqa)

        lib_ms = _time_ms(sdpa)
        lib_dev, lib_kernels, lib_dev_by = _per_call_device_ms(
            sdpa, {"all": lambda n: True}, counts_ok={"all": _every_call(20)})
        lib_dev_ms = lib_dev["all"]
    # work this run's data needs: 4·D flops per visible (query, key) pair
    # per head; bytes of q, k, v read once and o (+ lse) written once
    # (the mask broadcasts over queries when not causal)
    pairs = int(fa._mask(kvb, offb, Sq, Sk, c["causal"])
                .expand(B, 1, Sq, Sk).sum().item()) * H
    flops = 4 * D * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    if c["lse"]:
        nbytes += got_lse.numel() * 4
    t_ops = flops / PEAK_FLOPS[c["dtype"]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"case": c["name"], "shape": [B, Sq, Sk, H, G, D],
            "dtype": c["dtype"], "causal": c["causal"],
            "kernel": plan.kernel, "windows": plan.windows,
            "copies": list(plan.copy), "maps": list(plan.maps),
            "max_abs_err": err,
            "lse_err": lse_err, "tol": tol, "ms": ms,
            "device_ms": dev["k1"], "other_device_ms": dev["other"],
            "device_ms_by": dev_by,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "library_kernels": lib_kernels,
            "library_device_ms_by": lib_dev_by,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def _over_sdpa(rows: dict[str, dict], names) -> dict[str, float | None]:
    """Each case's K1 device time over SDPA's, both from the profiler in
    this run, else None (not measured)."""
    return {n: (rows[n]["device_ms"] / rows[n]["library_device_ms"]
                if rows[n]["device_ms_by"] == rows[n]["library_device_ms_by"]
                == "profiler" else None) for n in names}


def phase_kernel() -> dict[str, dict]:
    """Every case; returns the rows by case name."""
    rows = {c["name"]: _kernel_case(c) for c in CASES}
    for r in rows.values():
        _say("kernel", **r)
    s17, s512, s2048 = (rows[f"prefill_s{n}"] for n in (17, 512, 2048))
    measured = {
        "prefill_s512_device_ms": s512["device_ms"],
        "prefill_s2048_device_ms": s2048["device_ms"],
        "prefill_s17_call_over_sdpa": s17["ms"] / s17["library_ms"]}
    _say("floors", targets=K1_FLOORS, measured=measured,
         met={k: measured[k] <= v for k, v in K1_FLOORS.items()},
         s2048_ops_bound_share=s2048["bound_ms"] / s2048["device_ms"],
         # both from the profiler, else not measured
         k1_over_sdpa_device={
             n: (r["device_ms"] / r["library_device_ms"]
                 if r["device_ms_by"] == r["library_device_ms_by"]
                 == "profiler" else None)
             for n in (17, 64, 96, 128, 512, 2048)
             for r in [rows[f"prefill_s{n}"]]},
         k1_over_sdpa_call={n: rows[f"prefill_s{n}"]["ms"]
                            / rows[f"prefill_s{n}"]["library_ms"]
                            for n in (17, 64, 96, 128, 512, 2048)})
    # bf16/f16 at head dims other than 64 and 128 (S=512): device time
    # over SDPA's in this run
    ratio = _over_sdpa(rows, HEAD_DIM_CASES)
    _say("head_dim_floors", target_over_sdpa_device=HEAD_DIM_TARGET,
         over_sdpa_device=ratio,
         met={n: r is not None and r <= HEAD_DIM_TARGET
              for n, r in ratio.items()},
         device_ms={n: rows[n]["device_ms"] for n in HEAD_DIM_CASES},
         library_device_ms={n: rows[n]["library_device_ms"]
                            for n in HEAD_DIM_CASES},
         bound_ms={n: rows[n]["bound_ms"] for n in HEAD_DIM_CASES})
    # f32 on the 3xTF32 kernel: device time over SDPA's
    f32 = _over_sdpa(rows, F32_CASES)
    _say("f32_floors", target_over_sdpa_device=F32_TARGET,
         over_sdpa_device=f32,
         met={n: r is not None and r <= F32_TARGET for n, r in f32.items()},
         device_ms={n: rows[n]["device_ms"] for n in F32_CASES},
         library_device_ms={n: rows[n]["library_device_ms"]
                            for n in F32_CASES},
         library_kernels={n: rows[n]["library_kernels"] for n in F32_CASES},
         bound_ms={n: rows[n]["bound_ms"] for n in F32_CASES},
         max_abs_err={n: rows[n]["max_abs_err"] for n in F32_CASES})
    return rows


def phase_grads() -> None:
    """Grads through K1 on the card: bf16 and f32, with and without the
    LSE, a loss linear in the outputs. q, k and v are CUDA tensors that
    require grad; the forward is one launch of the planned kernel (and
    under ``inference_mode`` one launch and no graph), the backward the
    JAX package's rule (a recompute of ``reference_attention_lse``).
    dq, dk and dv must be there, finite, and within the dtype's limit of
    autograd through ``reference_attention_lse`` on the same tensors."""
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa

    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for lse in (False, True):
            gen = torch.Generator("cuda").manual_seed(21)
            B, S, H, G, D = 2, 256, 8, 2, 128

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda")

            base = [rnd(B, S, H, D), rnd(B, S, G, D), rnd(B, S, G, D)]
            w, w_lse = rnd(B, S, H, D), rnd(B, S, H)
            kernel = K1_BY_DTYPE[dtype]
            grads = {}
            for path in ("k1", "reference"):
                qkv = [t.detach().to(dt, copy=True).requires_grad_()
                       for t in base]
                before = fa.launches_by_kernel[kernel]
                if path == "k1":
                    res = fa.flash_attention(*qkv, causal=True,
                                             return_lse=lse)
                    launched = fa.launches_by_kernel[kernel] - before
                    if launched != 1:
                        raise AssertionError(f"grads {dtype}: {launched} "
                                             f"launches of {kernel}")
                else:
                    res = fa.reference_attention_lse(*qkv, causal=True)
                    res = res if lse else res[0]
                out, l_ = res if lse else (res, None)
                loss = (out.float() * w).sum()
                if lse:
                    loss = loss + (l_ * w_lse).sum()
                loss.backward()
                grads[path] = [t.grad for t in qkv]
            torch.cuda.synchronize()
            if any(g is None or not torch.isfinite(g.float()).all()
                   for g in grads["k1"]):
                raise AssertionError(f"grads {dtype} lse={lse}: missing or "
                                     "not finite")
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(grads["k1"], grads["reference"]))
            before = fa.launches_by_kernel[kernel]
            with torch.inference_mode():
                out = fa.flash_attention(*(t.to(dt) for t in base))
            launched = fa.launches_by_kernel[kernel] - before
            if err > TOL[dtype] or launched != 1 or out.requires_grad:
                raise AssertionError(f"grads {dtype} lse={lse}: max abs err "
                                     f"{err} (tol {TOL[dtype]}), inference "
                                     f"launches {launched}")
            rows.append({"dtype": dtype, "return_lse": lse,
                         "shape": [B, S, S, H, G, D], "kernel": kernel,
                         "max_abs_err": err, "tol": TOL[dtype],
                         "inference_launches": launched})
    _say("grads", cases=rows)


# --------------------------------------------------------------- phase 4


def _post(url: str, doc: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def _prompt(gen, n: int, vocab: int) -> list[int]:
    import torch

    return torch.randint(0, vocab, (n,), generator=gen).tolist()


def phase_slice() -> int:
    import numpy as np
    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.serve import http
    from demodel_tpu_torch.utils.metrics import HUB, labeled

    cfg = llama.LlamaConfig(dtype="bfloat16")
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                               "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pgen = torch.Generator().manual_seed(1)
    prompts = [_prompt(pgen, n, cfg.vocab_size)
               for n in (*PROMPT_LENS, LONG_PROMPT)]

    # prefill logits, kernel path vs plain path (not counted: comparison)
    first, rel_errs = [], []
    with torch.inference_mode():
        for p in prompts:
            toks = torch.tensor([p], device="cuda")
            got = llama.step_prefill(params, toks, cfg)[0][0].float()
            os.environ["DEMODEL_FLASH_ATTN"] = "0"
            try:
                want = llama.step_prefill(params, toks, cfg)[0][0].float()
            finally:
                del os.environ["DEMODEL_FLASH_ATTN"]
            rel_errs.append(((got - want).norm() / want.norm()).item())
            first.append(int(np.argmax(got.cpu().numpy())))
    if max(rel_errs) > LOGITS_REL_TOL or not all(map(np.isfinite, rel_errs)):
        raise AssertionError(f"prefill logits kernel vs plain: rel errors "
                             f"{rel_errs} > {LOGITS_REL_TOL}")

    fa.launches = 0  # count the main path's launches only
    for name in fa.launches_by_kernel:
        fa.launches_by_kernel[name] = 0
    decode_before = HUB.histograms().get(
        labeled("stage_duration_seconds", span="serve.decode-step"),
        {"sum": 0.0})["sum"]
    engine = serve.boot(params, cfg, device="cuda", kv_mb=1024,
                        max_new_tokens=MAX_NEW, max_batch=8, queue_limit=16)
    server = http.start()
    url = f"{server.url}/generate"
    results: dict[int, list[int]] = {}
    errors: list[BaseException] = []
    t_serve = time.perf_counter()
    try:
        def via_http(i: int, stream: bool) -> None:
            try:
                status, ctype, body = _post(url, {
                    "prompt": prompts[i], "max_new_tokens": MAX_NEW,
                    "stream": stream})
                assert status == 200
                if stream:
                    assert "x-ndjson" in ctype
                    lines = [json.loads(ln) for ln in
                             body.decode().splitlines() if ln.strip()]
                    toks = [ln["token"] for ln in lines if "token" in ln]
                    assert lines[-1]["done"] and lines[-1]["tokens"] == toks
                else:
                    toks = json.loads(body)["tokens"]
                results[i] = toks
            except BaseException as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        # request 0 starts alone; the rest join its running batch
        r0 = engine.submit(prompts[0], MAX_NEW)
        it = r0.iter_tokens(timeout=600)
        next(it)
        threads = [threading.Thread(target=via_http, args=(1, False)),
                   threading.Thread(target=via_http, args=(2, True))]
        for t in threads:
            t.start()
        next(it)
        r3 = engine.submit(prompts[3], MAX_NEW)
        results[0] = r0.result(timeout=600)
        results[3] = r3.result(timeout=600)
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        # the 512-token prompt alone, over HTTP
        via_http(4, False)
        if errors:
            raise errors[0]
        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=60) as resp:
            scrape = resp.read().decode()
        assert 'demodel_gen_http_total{code="200"}' in scrape
    finally:
        engine.stop()
        server.stop()
        serve.install(None)
    serve_s = time.perf_counter() - t_serve
    launches = fa.launches
    by_kernel = dict(fa.launches_by_kernel)
    decode_s = HUB.histograms()[labeled(
        "stage_duration_seconds", span="serve.decode-step")]["sum"] \
        - decode_before
    decode_tokens = engine.describe()["tokens"]["decode"]
    for i, p in enumerate(prompts):
        toks = results[i]
        if len(toks) != MAX_NEW or toks[0] != first[i]:
            raise AssertionError(
                f"request {i} (prompt {len(p)}): {len(toks)} tokens, first "
                f"{toks[:1]} vs kernel-path prefill argmax {first[i]}")
    if launches != cfg.num_hidden_layers * len(prompts):
        raise AssertionError(f"flash kernel launches {launches}, expected "
                             f"{cfg.num_hidden_layers} per prefill")
    if by_kernel["wgmma_bf16"] != launches:
        raise AssertionError(f"bf16 prefill launches by kernel {by_kernel}: "
                             "not all on the tensor-core kernel")
    in_use = engine.pool.describe()["in_use_blocks"]
    if in_use != 0:
        raise AssertionError(f"KV pool still holds {in_use} blocks")
    _say("slice", model="Llama-2-7B widths, 32 layers, bf16, seeded",
         init_s=round(init_s, 3), requests=len(prompts),
         prompt_lens=[len(p) for p in prompts],
         logits_rel_err=rel_errs, logits_tol=LOGITS_REL_TOL,
         flash_launches=launches, flash_launches_by_kernel=by_kernel,
         serve_s=round(serve_s, 3),
         decode_tokens=decode_tokens, decode_step_s=round(decode_s, 3),
         decode_tok_s=round(decode_tokens / decode_s, 3),
         kv_in_use_blocks=in_use)
    del params
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 5


def phase_parity() -> None:
    import torch

    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.serve import GenEngine

    cfg = llama.LlamaConfig(num_hidden_layers=2)  # full width, fp32
    params = llama.init_params(torch.Generator("cuda").manual_seed(2), cfg,
                               "cuda")
    pgen = torch.Generator().manual_seed(3)
    prompts = [_prompt(pgen, n, cfg.vocab_size) for n in (9, 40, 23, 70)]
    refs = [llama.generate(params, cfg, p, MAX_NEW)[0].tolist()
            for p in prompts]
    engine = GenEngine(params, cfg, device="cuda", max_batch=3,
                       queue_limit=16, max_new_tokens=MAX_NEW,
                       kv_mb=512).start()
    try:
        reqs = []
        for i, p in enumerate(prompts):  # staggered: join mid-decode
            if i == 2:
                reqs[0].result(timeout=600)
            reqs.append(engine.submit(p, MAX_NEW))
        outs = [r.result(timeout=600) for r in reqs]
    finally:
        engine.stop()
    if outs != refs:
        raise AssertionError(f"engine tokens {outs} != generate {refs}")
    _say("parity", model="Llama-2-7B widths, 2 layers, fp32",
         requests=len(prompts), tokens_equal=True)


# ------------------------------------------------------- dequant, gguf

#: the Llama-2-7B ffn_gate shape, where each dequant kernel is timed
GATE_SHAPE = (11008, 4096)
#: block counts held besides it: one block, an odd few, one past 256
SMALL_BLOCKS = (1, 3, 257, 0)
#: K-quant kernel vs plain version, max abs error relative to max|ref|:
#: f32 summation-free math leaves only the scale products' rounding (the
#: kernel is built without FMA contraction, so it is exact in practice);
#: bf16 output is one bf16 ulp. Q8_0 and Q4_0 must match bit for bit.
KQ_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
DEQUANT_FORMATS = ("q8_0", "q4_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k")
#: where each kernel's TPU counterpart is launched
DEQUANT_REPLACES = {"q8_0": "demodel_tpu/ops/dequant.py:95",
                    "q4_0": "demodel_tpu/ops/dequant.py:140",
                    "k_quant": "demodel_tpu/ops/dequant.py:338"}
#: f16 scale fields of each block: (byte offset, magnitude). They are set
#: to values in [mag/2, mag) so every output stays O(1); every other bit
#: pattern of a block is valid (tests/test_dequant.py relies on the same)
SCALE_FIELDS = {
    "q8_0": ((0, 1 / 127),),
    "q4_0": ((0, 1 / 8),),
    "q2_k": ((80, 1 / 45), (82, 1 / 15)),
    "q3_k": ((108, 1 / 128),),
    "q4_k": ((0, 1 / 945), (2, 1 / 63)),
    "q5_k": ((0, 1 / 1953), (2, 1 / 63)),
    "q6_k": ((208, 1 / 4096),),
}
#: Llama-2-7B widths of the GGUF files
VOCAB, HIDDEN, INTER = 32000, 4096, 11008


def _ggml_type(fmt: str) -> int:
    from demodel_tpu_torch.formats import gguf

    return getattr(gguf, f"GGML_{fmt.upper()}")


def _random_blocks(out, fmt: str, rng) -> None:
    """Fill ``out`` ((nb, bytes per block) uint8, contiguous) with random
    valid blocks of ``fmt``."""
    import numpy as np

    flat = out.reshape(-1)
    n8 = flat.size // 8 * 8
    flat[:n8].view(np.uint64)[:] = rng.bit_generator.random_raw(n8 // 8)
    flat[n8:] = rng.integers(0, 256, flat.size - n8, dtype=np.uint8)
    nb = out.shape[0]
    for off, mag in SCALE_FIELDS[fmt]:
        d = (rng.uniform(0.5, 1.0, nb) * mag).astype(np.float16)
        out[:, off:off + 2] = d.view(np.uint8).reshape(nb, 2)


def _parts(fmt: str, nb: int, rng):
    """Seeded random valid blocks of ``fmt``, split into parts on the
    card, with their packed size in bytes."""
    import numpy as np

    from demodel_tpu_torch.formats import gguf
    from demodel_tpu_torch.ops import dequant as dq

    t = _ggml_type(fmt)
    blk, bpb = gguf._BLOCK_GEOM[t]
    raw = np.empty((nb, bpb), np.uint8)
    _random_blocks(raw, fmt, rng)
    spec = gguf.GGUFTensor("t", t, (nb * blk,), 0, raw.nbytes)
    return [dq.to_device(p, "cuda")
            for p in gguf.decode_raw(spec, raw.reshape(-1))], raw.nbytes


def _plain(fmt: str):
    from demodel_tpu_torch.ops import dequant as dq

    return getattr(dq, f"_{fmt}_math")


def _held(fmt: str, got, want, dtype: str) -> float:
    """Max abs error of kernel output ``got`` against the plain version's
    ``want``; raises past the limit."""
    import torch

    err = (got.float() - want.float().reshape(got.shape)).abs().max().item() \
        if got.numel() else 0.0
    if fmt in ("q8_0", "q4_0"):
        ok = torch.equal(got, want.reshape(got.shape))
    else:
        scale = want.float().abs().max().item() if want.numel() else 0.0
        ok = err <= KQ_TOL[dtype] * scale
    if not (ok and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"dequant {fmt} {dtype}: kernel vs plain max "
                             f"abs err {err} over {got.numel()} values")
    return err


def _dequant_case(fmt: str, seed: int) -> dict:
    import numpy as np
    import torch

    from demodel_tpu_torch.ops import dequant as dq

    fn = dq._FNS[_ggml_type(fmt)]
    plain = _plain(fmt)
    rng = np.random.default_rng(seed)
    per_block = 32 if fmt in ("q8_0", "q4_0") else 256
    nb = GATE_SHAPE[0] * GATE_SHAPE[1] // per_block
    parts, qbytes = _parts(fmt, nb, rng)
    errs = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        errs[dtype] = _held(fmt, fn(*parts, dt), plain(*parts, dt), dtype)
    for n in SMALL_BLOCKS:
        small, _ = _parts(fmt, n, rng)
        before = dq.launches[fmt]
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            got = fn(*small, dt)
            if got.shape != (n * per_block,):
                raise AssertionError(f"dequant {fmt}: {n} blocks gave "
                                     f"{tuple(got.shape)}")
            _held(fmt, got, plain(*small, dt) if n else got, dtype)
        if n == 0 and dq.launches[fmt] != before:
            raise AssertionError(f"dequant {fmt}: launched for 0 blocks")
    torch.cuda.synchronize()
    ms = _time_ms(lambda: fn(*parts, torch.bfloat16))
    plain_ms = _time_ms(lambda: plain(*parts, torch.bfloat16))
    nbytes = qbytes + nb * per_block * 2  # quantized in + bf16 out
    return {"format": fmt, "shape": list(GATE_SHAPE), "dtype": "bfloat16",
            "max_abs_err": errs["bfloat16"], "max_abs_err_f32":
            errs["float32"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None, "quantized_bytes": qbytes}


def phase_dequant() -> dict[str, dict]:
    rows = {fmt: _dequant_case(fmt, seed=10 + i)
            for i, fmt in enumerate(DEQUANT_FORMATS)}
    for r in rows.values():
        _say("dequant", **r)
    return rows


def _llama_tensors(n_layers: int) -> list[tuple[str, tuple[int, ...], int]]:
    """(name, numpy shape, layer or -1) of a Llama-2-7B GGUF, llama.cpp's
    names in llama.cpp's order."""
    out = [("token_embd.weight", (VOCAB, HIDDEN), -1)]
    for i in range(n_layers):
        out += [(f"blk.{i}.attn_norm.weight", (HIDDEN,), i),
                (f"blk.{i}.attn_q.weight", (HIDDEN, HIDDEN), i),
                (f"blk.{i}.attn_k.weight", (HIDDEN, HIDDEN), i),
                (f"blk.{i}.attn_v.weight", (HIDDEN, HIDDEN), i),
                (f"blk.{i}.attn_output.weight", (HIDDEN, HIDDEN), i),
                (f"blk.{i}.ffn_norm.weight", (HIDDEN,), i),
                (f"blk.{i}.ffn_gate.weight", (INTER, HIDDEN), i),
                (f"blk.{i}.ffn_up.weight", (INTER, HIDDEN), i),
                (f"blk.{i}.ffn_down.weight", (HIDDEN, INTER), i)]
    return out + [("output_norm.weight", (HIDDEN,), -1),
                  ("output.weight", (VOCAB, HIDDEN), -1)]


def _file_format(kind: str, name: str, shape, layer: int,
                 n_layers: int) -> str:
    """The format of one tensor: norms are f32; Q4_K_M follows
    llama.cpp's ``use_more_bits`` rule (attn_v and ffn_down in Q6_K for
    the first and last eighth of the layers and every third between);
    the single-format files keep ``output`` in Q6_K (Q8_0 in the Q8_0
    file)."""
    if len(shape) == 1:
        return "f32"
    if name == "output.weight":
        return "q8_0" if kind == "q8_0" else "q6_k"
    if kind != "q4_k_m":
        return kind
    more_bits = (layer < n_layers // 8 or layer >= 7 * n_layers // 8
                 or (layer - n_layers // 8) % 3 == 2)
    if more_bits and (".attn_v." in name or ".ffn_down." in name):
        return "q6_k"
    return "q4_k"


def _build_gguf(kind: str, n_layers: int, seed: int):
    """A Llama-2-7B-width GGUF of seeded random valid blocks in a host
    buffer: (buffer, [(name, shape, format)], quantized data bytes)."""
    import numpy as np

    from demodel_tpu_torch.formats import gguf

    rng = np.random.default_rng(seed)
    specs = [(name, shape, _file_format(kind, name, shape, layer, n_layers))
             for name, shape, layer in _llama_tensors(n_layers)]
    entries = [(n, s, _ggml_type(f)) for n, s, f in specs]
    header, offsets = gguf.write_header(
        entries, {"general.architecture": "llama",
                  "llama.block_count": n_layers})
    sizes = [gguf.tensor_nbytes(t, int(np.prod(s))) for _, s, t in entries]
    data_len = offsets[-1] + sizes[-1] + (-sizes[-1]) % gguf.DEFAULT_ALIGNMENT
    buf = bytearray(len(header) + data_len)
    buf[:len(header)] = header
    arr = np.frombuffer(buf, np.uint8)
    for (_, shape, fmt), (_, _, t), off, size in zip(specs, entries,
                                                     offsets, sizes):
        body = arr[len(header) + off:len(header) + off + size]
        if fmt == "f32":
            body.view(np.float32)[:] = 1.0 + 0.1 * rng.standard_normal(
                int(np.prod(shape)), dtype=np.float32)
        else:
            _random_blocks(body.reshape(-1, gguf._BLOCK_GEOM[t][1]), fmt,
                           rng)
    return buf, specs, data_len


def _device_ms(run, groups, counts_ok=None, tries: int = 5):
    """:func:`demodel_tpu_torch.probes.device_time.device_ms`, printing a
    ``trace_lost`` line where every trace lost launched work."""
    from demodel_tpu_torch.probes import device_time

    got = device_time.device_ms(run, groups, counts_ok, tries)
    if got is None:
        _say("trace_lost", groups=list(groups), tries=tries)
    return got


def _every_call(iters: int):
    from demodel_tpu_torch.probes import device_time

    return device_time.every_call(iters)


#: the dequant kernels' names, for their device-time sum
DEQUANT_KERNELS = ("q8_0_kernel", "q4_0_kernel", "k_quant_kernel")


def _split_s() -> float:
    """Seconds the sink has spent so far splitting blocks into dense
    host parts (its ``sink.split`` span)."""
    from demodel_tpu_torch.utils.metrics import HUB, labeled

    h = HUB.histograms().get(labeled("stage_duration_seconds",
                                     span="sink.split"))
    return h["sum"] if h else 0.0


def _gguf_file(kind: str, n_layers: int, seed: int) -> dict:
    import numpy as np
    import torch

    from demodel_tpu_torch.formats import gguf
    from demodel_tpu_torch.ops import dequant as dq
    from demodel_tpu_torch.sink import deliver_gguf

    t0 = time.perf_counter()
    buf, specs, data_len = _build_gguf(kind, n_layers, seed)
    build_s = time.perf_counter() - t0
    if kind in OLLAMA_KINDS:  # the ollama phase serves the same bytes
        _GGUF_BUILT[kind] = (buf, specs)
    index = gguf.parse(buf)
    want_launches = {f: 0 for f in DEQUANT_FORMATS}
    for _, _, fmt in specs:
        if fmt != "f32":
            want_launches[fmt] += 1
    want_values = sum(int(np.prod(s)) for _, s, _ in specs)

    for fmt in dq.launches:
        dq.launches[fmt] = 0
    torch.cuda.synchronize()
    split0 = _split_s()
    t0 = time.perf_counter()
    placed = deliver_gguf(None, f"llama-7b-{kind}", out_dtype=torch.bfloat16,
                          buffer=buf)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    split_s = _split_s() - split0
    launches = dict(dq.launches)

    if launches != want_launches:
        raise AssertionError(f"{kind}: launches {launches}, expected "
                             f"{want_launches}")
    values = sum(a.numel() for a in placed.arrays.values())
    if (values != want_values or placed.total_bytes != 2 * want_values
            or set(placed.arrays) != {n for n, _, _ in specs}):
        raise AssertionError(f"{kind}: placed {values} values in "
                             f"{placed.total_bytes} bytes, expected "
                             f"{want_values}")
    for name, shape, _ in specs:
        a = placed.arrays[name]
        if (tuple(a.shape) != shape or a.dtype != torch.bfloat16
                or a.device.type != "cuda"
                or not bool(torch.isfinite(a).all())):
            raise AssertionError(f"{kind}: {name} placed as {a.dtype} "
                                 f"{tuple(a.shape)} on {a.device}, or "
                                 "not finite")

    # layer 0, the last layer, token_embd and output against the plain
    # version on the card, from the same parts
    held, errs = 0, []
    for name, shape, fmt in specs:
        if not (name.startswith(("blk.0.", f"blk.{n_layers - 1}."))
                or name in ("token_embd.weight", "output.weight")):
            continue
        t = index.tensors[name]
        decoded = gguf.decode_raw(t, memoryview(buf)[t.start:t.start
                                                     + t.nbytes])
        if fmt == "f32":
            want = dq.to_device(decoded, "cuda").to(torch.bfloat16)
            ok = torch.equal(placed.arrays[name], want)
            if not ok:
                raise AssertionError(f"{kind}: {name} f32 → bf16 differs")
        else:
            parts = [dq.to_device(p, "cuda") for p in decoded]
            want = _plain(fmt)(*parts, torch.bfloat16)
            errs.append(_held(fmt, placed.arrays[name], want, "bfloat16"))
        held += 1

    # one tensor against the normative numpy decoder on the host
    name = "blk.0.attn_q.weight"
    t = index.tensors[name]
    ref = gguf.REF_DEQUANT[t.ggml_type](*gguf.decode_raw(
        t, memoryview(buf)[t.start:t.start + t.nbytes])).reshape(t.shape)
    got = placed.arrays[name].float().cpu().numpy()
    ref_err = float(np.abs(got - ref).max())
    if not ref_err <= KQ_TOL["bfloat16"] * float(np.abs(ref).max()):
        raise AssertionError(f"{kind}: {name} vs REF_DEQUANT max abs err "
                             f"{ref_err}")
    del placed, got
    torch.cuda.empty_cache()

    # summed kernel and copy times, from a second delivery under the
    # profiler
    traced = _device_ms(lambda: deliver_gguf(
        None, f"llama-7b-{kind}", out_dtype=torch.bfloat16, buffer=buf),
        {"kernel_ms_sum": lambda k: any(n in k for n in DEQUANT_KERNELS),
         "h2d_ms_sum": lambda k: "HtoD" in k},
        counts_ok={"kernel_ms_sum": lambda c: sum(c.values()) > 0,
                   "h2d_ms_sum": lambda c: sum(c.values()) > 0})
    # not measured where every trace lost the delivery's work
    dev_ms, events = traced or ({"kernel_ms_sum": None,
                                 "h2d_ms_sum": None}, None)
    torch.cuda.empty_cache()
    return {"file": kind, "layers": n_layers, "tensors": len(specs),
            "gguf_bytes": len(buf), "quantized_data_bytes": data_len,
            "build_s": round(build_s, 3), "deliver_s": wall_s,
            "quantized_GBps": data_len / wall_s / 1e9,
            **dev_ms, "host_split_s": split_s,
            "launches": {k: v for k, v in launches.items() if v},
            # beside the launches, so a trace that lost some shows it
            "kernels_in_trace": events and sum(
                v for k, v in events.items()
                if any(n in k for n in DEQUANT_KERNELS)),
            "values": values, "bf16_bytes": 2 * values,
            "held_vs_plain": held, "max_abs_err_vs_plain": max(errs),
            "ref_dequant_tensor": name, "ref_dequant_err": ref_err}


#: the cold-boot files: the 32-layer Q4_K_M (llama.cpp's and Ollama's
#: default), then each other format at 2 layers, full width
GGUF_FILES = (("q4_k_m", 32), ("q4_0", 2), ("q8_0", 2), ("q2_k", 2),
              ("q3_k", 2), ("q5_k", 2))
#: the gguf phase's files the ollama phase serves, by Ollama model name
OLLAMA_KINDS = {"q4_k_m": "llama:7b-q4_K_M", "q4_0": "llama:7b-q4_0-2l",
                "q8_0": "llama:7b-q8_0-2l"}
#: the one of them the mitm phase's Ollama leg pulls through the proxy
MITM_GGUF_KIND = "q4_0"
#: (buffer, specs) of those files, as the gguf phase built them
_GGUF_BUILT: dict[str, tuple] = {}


def phase_gguf() -> dict[str, int]:
    """Cold-boot each GGUF file through ``deliver_gguf`` on the default
    (CUDA) mesh; returns the launches per format over the phase."""
    total = {f: 0 for f in DEQUANT_FORMATS}
    for i, (kind, n_layers) in enumerate(GGUF_FILES):
        row = _gguf_file(kind, n_layers, seed=100 + i)
        for fmt, n in row["launches"].items():
            total[fmt] += n
        _say("gguf", **row)
    return total


# --------------------------------------------------------------- ollama

OLLAMA_MODEL_MEDIA = "application/vnd.ollama.image.model"


def _ollama_handler(models: dict[str, dict], blobs: dict[str, object]):
    """A registry-v2 over ``models`` ({"repo:tag": manifest}) and
    ``blobs`` ({digest: bytes-like}): manifests, blobs with HEAD and
    Range. ``Registry.counts`` counts blob GETs by digest."""
    counts: dict[str, int] = {}
    lock = threading.Lock()

    class Registry(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        request_counts = counts

        def log_message(self, *a):
            pass

        def _send(self, status, body=b"", ctype="application/json",
                  extra=None):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Docker-Distribution-Api-Version",
                             "registry/2.0")
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def do_HEAD(self):
            self.do_GET()

        def do_GET(self):
            if self.path in ("/v2/", "/v2"):  # the ping; no token needed
                return self._send(200, b"{}")
            m = re.match(r"^/v2/(.+?)/manifests/([^/]+)$", self.path)
            if m:
                doc = models.get(f"{m[1]}:{m[2]}")
                if doc is None:
                    return self._send(404, b'{"errors":[{"code":'
                                      b'"MANIFEST_UNKNOWN"}]}')
                return self._send(200, json.dumps(doc).encode(),
                                  "application/vnd.docker.distribution."
                                  "manifest.v2+json")
            m = re.match(r"^/v2/(.+?)/blobs/(sha256:[0-9a-f]{64})$",
                         self.path)
            if m:
                body = blobs.get(m[2])
                if body is None:
                    return self._send(404, b'{"errors":[{"code":'
                                      b'"BLOB_UNKNOWN"}]}')
                if self.command == "GET":
                    with lock:
                        counts[m[2]] = counts.get(m[2], 0) + 1
                body = memoryview(body).cast("B")
                rng = self.headers.get("Range", "")
                if rng.startswith("bytes="):
                    a, _, b = rng[6:].partition("-")
                    start, end = int(a), int(b) if b else len(body) - 1
                    part = body[start:end + 1]
                    return self._send(206, part, "application/octet-stream", {
                        "Content-Range": f"bytes {start}-"
                        f"{start + len(part) - 1}/{len(body)}",
                        "Accept-Ranges": "bytes"})
                return self._send(200, body, "application/octet-stream",
                                  {"Accept-Ranges": "bytes"})
            self._send(404, b"{}")

    return Registry


def _ollama_manifest(model_blob, side: dict[str, bytes]) -> tuple[dict, str]:
    """A registry-v2 manifest (schemaVersion 2, Ollama media types) over
    a GGUF model layer and the side blobs; returns it with the model
    layer's digest."""
    import hashlib

    def desc(media, body, digest=None):
        digest = digest or "sha256:" + hashlib.sha256(body).hexdigest()
        return {"mediaType": media, "digest": digest, "size": len(body)}

    model = desc(OLLAMA_MODEL_MEDIA, model_blob)
    return {
        "schemaVersion": 2,
        "mediaType": "application/vnd.docker.distribution.manifest.v2+json",
        "config": desc("application/vnd.docker.container.image.v1+json",
                       side["config"]),
        "layers": [model,
                   desc("application/vnd.ollama.image.license",
                        side["license"]),
                   desc("application/vnd.ollama.image.params",
                        side["params"])],
    }, model["digest"]


def _ollama_pull(cfg, url: str, kind: str, name: str) -> dict:
    """One Ollama pull onto the card, held against ``deliver_gguf`` of the
    gguf phase's buffer of ``kind``; its row."""
    import hashlib

    import torch

    from demodel_tpu_torch import delivery
    from demodel_tpu_torch.formats import gguf
    from demodel_tpu_torch.ops import dequant as dq
    from demodel_tpu_torch.sink import deliver_gguf

    buf, specs = _GGUF_BUILT[kind]
    want_launches = {f: 0 for f in DEQUANT_FORMATS}
    for _, _, fmt in specs:
        if fmt != "f32":
            want_launches[fmt] += 1
    deliver0, split0 = _span_s("sink-deliver"), _split_s()
    for fmt in dq.launches:
        dq.launches[fmt] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, placed = delivery.pull_to_hbm(name, cfg, source="ollama",
                                          endpoint=url)
    wall_s = time.perf_counter() - t0
    launches = dict(dq.launches)
    deliver_s = _span_s("sink-deliver") - deliver0
    split_s = _split_s() - split0
    if launches != want_launches:
        raise AssertionError(f"ollama {name}: dequant launches {launches}, "
                             f"expected {want_launches}")
    layer = next(f for f in report["files"]
                 if f["media_type"] == OLLAMA_MODEL_MEDIA)
    store = delivery.open_store(cfg)
    try:
        sha = hashlib.sha256()
        for chunk in store.stream(layer["key"], 64 << 20):
            sha.update(chunk)
        stored = {f["name"]: store.meta(f["key"]).get("sha256")
                  for f in report["files"][1:]}
    finally:
        store.close()
    if ("sha256:" + sha.hexdigest() != layer["name"]
            or any("sha256:" + v != k for k, v in stored.items())):
        raise AssertionError(f"ollama {name}: stored blob sha256 "
                             f"{sha.hexdigest()} vs digest {layer['name']}")
    if set(placed.arrays) != {n for n, _, _ in specs}:
        raise AssertionError(f"ollama {name}: placed {len(placed.arrays)} "
                             f"tensors, expected {len(specs)}")

    # every tensor against deliver_gguf of the host buffer (not counted)
    ref = deliver_gguf(None, name, out_dtype=torch.bfloat16, buffer=buf)
    unequal = [n for n, a in placed.arrays.items()
               if not (a.dtype == torch.bfloat16 and a.device.type == "cuda"
                       and torch.equal(a, ref.arrays[n]))]
    del ref
    if unequal:
        raise AssertionError(f"ollama {name}: placed tensors differ from "
                             f"deliver_gguf of the buffer: {unequal[:5]}")
    # one tensor per ggml type against its plain dequant
    index = gguf.parse(buf)
    held = {}
    for tname, _, fmt in specs:
        if fmt in held:
            continue
        t = index.tensors[tname]
        decoded = gguf.decode_raw(t, memoryview(buf)[t.start:t.start
                                                     + t.nbytes])
        if fmt == "f32":
            want = dq.to_device(decoded, "cuda").to(torch.bfloat16)
            if not torch.equal(placed.arrays[tname], want):
                raise AssertionError(f"ollama {name}: {tname} f32 differs")
            held[fmt] = [tname, 0.0]
        else:
            parts = [dq.to_device(x, "cuda") for x in decoded]
            held[fmt] = [tname, _held(fmt, placed.arrays[tname],
                                      _plain(fmt)(*parts, torch.bfloat16),
                                      "bfloat16")]
    n_tensors = len(placed.arrays)
    del placed
    torch.cuda.empty_cache()
    return {"model": name, "file": kind, "blob_bytes": layer["size"],
            "pull_s": report["secs"], "pull_and_place_s":
            report["tpu_sink"]["secs"], "wall_s": wall_s,
            "pull_GBps": layer["size"] / report["secs"] / 1e9,
            "sink_deliver_s": deliver_s, "host_split_s": split_s,
            "tensors_equal": n_tensors,
            "launches": {k: v for k, v in launches.items() if v},
            "held_vs_plain": held, "files": len(report["files"])}


#: the Ollama models the sharded phase's gguf leg places off a peer
SHARDED_GGUF_KINDS = ("q4_0", "q8_0")


def _sharded_gguf(cfg) -> dict[str, int]:
    """The sharded phase's gguf leg: the ollama phase's store behind the
    port's ``ProxyServer``, and ``pull_manifest_to_hbm(source="ollama")``
    of its 2-layer Q4_0 and Q8_0 models onto the card (the per-file path
    into ``deliver_gguf``: K3 and K4e, then K2). Gates: the dequant
    launches per format are those the file needs, and every placed
    tensor equals ``deliver_gguf`` of the stored blob (not counted).
    Returns the launches."""
    import torch

    from demodel_tpu_torch.config import ProxyConfig
    from demodel_tpu_torch.delivery import open_store
    from demodel_tpu_torch.ops import dequant as dq
    from demodel_tpu_torch.parallel.peer import PeerGossip
    from demodel_tpu_torch.proxy import ProxyServer
    from demodel_tpu_torch.sink import deliver_gguf, pull_manifest_to_hbm
    from demodel_tpu_torch.utils.metrics import HUB

    total = {f: 0 for f in DEQUANT_FORMATS}
    peer_cfg = ProxyConfig(host="127.0.0.1", port=0, no_mitm=True,
                           cache_dir=cfg.cache_dir, data_dir=cfg.data_dir)
    proxy = ProxyServer(peer_cfg, verbose=False,
                        session_threads=8).start()
    try:
        for kind in SHARDED_GGUF_KINDS:
            name = OLLAMA_KINDS[kind]
            want = {f: 0 for f in DEQUANT_FORMATS}
            for _, _, fmt in _GGUF_BUILT[kind][1]:
                if fmt != "f32":
                    want[fmt] += 1
            fallback0 = HUB.get("peer_window_fallback_total")
            torch.cuda.synchronize()
            for fmt in dq.launches:
                dq.launches[fmt] = 0
            t0 = time.perf_counter()
            report, placed = pull_manifest_to_hbm(name, [proxy.url],
                                                  source="ollama")
            wall_s = time.perf_counter() - t0
            launches = dict(dq.launches)
            if launches != want:
                raise AssertionError(f"sharded gguf {name}: dequant "
                                     f"launches {launches}, expected {want}")
            layer = next(f for f in report["files"]
                         if f["media_type"] == OLLAMA_MODEL_MEDIA)
            store = open_store(cfg)
            try:
                ref = deliver_gguf(store, layer["key"],
                                   out_dtype=torch.bfloat16)
            finally:
                store.close()
            unequal = sorted(set(placed.arrays) ^ set(ref.arrays)) or [
                n for n, a in placed.arrays.items()
                if not (a.dtype == torch.bfloat16 and a.device.type == "cuda"
                        and torch.equal(a, ref.arrays[n]))]
            fallbacks = HUB.get("peer_window_fallback_total") - fallback0
            if unequal or report["pipelined"] or fallbacks:
                raise AssertionError(
                    f"sharded gguf {name}: tensors differ from deliver_gguf "
                    f"of the stored blob {unequal[:5]}, pipelined "
                    f"{report['pipelined']}, fallbacks {fallbacks}")
            for fmt, n in launches.items():
                total[fmt] += n
            _say("sharded_gguf", model=name, file=kind,
                 weight_bytes=report["weight_bytes"],
                 network_bytes=report["network_bytes"], pull_s=wall_s,
                 pull_GBps=report["weight_bytes"] / wall_s / 1e9,
                 tensors_equal=len(placed.arrays),
                 launches={k: v for k, v in launches.items() if v},
                 window_fallbacks=fallbacks)
            del placed, ref
            torch.cuda.empty_cache()
    finally:
        PeerGossip.reset_shared()
        proxy.stop()
    return total


#: the side blobs of every Ollama model the script serves
OLLAMA_SIDE = {"config": json.dumps({"model_format": "gguf",
                                     "model_family": "llama",
                                     "file_type": "seeded"}).encode(),
               "license": b"LLAMA 2 COMMUNITY LICENSE (test)",
               "params": json.dumps({"stop": ["</s>"]}).encode()}


def _ollama_models(kinds) -> tuple[dict, dict]:
    """The registry's manifests ({"library/repo:tag": manifest}) and
    blobs ({digest: bytes-like}) of the gguf phase's files ``kinds``."""
    models, blobs = {}, {}
    for kind in kinds:
        buf = _GGUF_BUILT[kind][0]
        manifest, digest = _ollama_manifest(buf, OLLAMA_SIDE)
        repo, _, tag = OLLAMA_KINDS[kind].partition(":")
        models[f"library/{repo}:{tag}"] = manifest
        blobs[digest] = buf
        blobs.update({d["digest"]: OLLAMA_SIDE[k] for k, d in zip(
            ("config", "license", "params"),
            (manifest["config"], *manifest["layers"][1:]))})
    return models, blobs


def phase_ollama() -> dict[str, int]:
    """Ollama pulls of the gguf phase's Q4_K_M, Q4_0 and Q8_0 files
    through an in-script registry-v2 onto the card; returns the dequant
    launches per format over the three pulls. Every buffer but the
    mitm phase's is dropped at the end."""
    import shutil
    import tempfile

    from demodel_tpu_torch.config import ProxyConfig

    t0 = time.perf_counter()
    models, blobs = _ollama_models(OLLAMA_KINDS)
    digest_s = time.perf_counter() - t0
    reg = ThreadingHTTPServer(("127.0.0.1", 0), _ollama_handler(models,
                                                                blobs))
    threading.Thread(target=reg.serve_forever, daemon=True).start()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ollama-")
    cfg = ProxyConfig(cache_dir=os.path.join(tmp, "cache"),
                      data_dir=os.path.join(tmp, "data"))
    total = {f: 0 for f in DEQUANT_FORMATS}
    try:
        for kind, name in OLLAMA_KINDS.items():
            row = _ollama_pull(cfg, f"http://127.0.0.1:{reg.server_port}",
                               kind, name)
            for fmt, n in row["launches"].items():
                total[fmt] += n
            _say("ollama", **row, digest_s=round(digest_s, 3))
        for fmt, n in _sharded_gguf(cfg).items():
            total[fmt] += n
    finally:
        reg.shutdown()
        reg.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    for kind in set(_GGUF_BUILT) - {MITM_GGUF_KIND}:
        del _GGUF_BUILT[kind]
    return total


# ----------------------------------------------------------------- pull

#: the checkpoint the pull phase serves: Llama-2-7B's published widths
#: and its stored dtype, cut from 32 to 8 layers
PULL_MODEL = "meta-llama/Llama-2-7b-hf"
PULL_LAYERS = 8
PULL_PROMPTS = (17, 128, 512)
PULL_NEW = 8
PULL_COMMIT = "c0ffee" * 6 + "c0ff"


def _llama_hf_shapes(n_layers: int) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of a ``transformers`` Llama-2-7B state dict
    (``nn.Linear`` weights ``[out, in]``), in checkpoint order."""
    out = [("model.embed_tokens.weight", (VOCAB, HIDDEN))]
    for i in range(n_layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (HIDDEN,)),
                (p + "self_attn.q_proj.weight", (HIDDEN, HIDDEN)),
                (p + "self_attn.k_proj.weight", (HIDDEN, HIDDEN)),
                (p + "self_attn.v_proj.weight", (HIDDEN, HIDDEN)),
                (p + "self_attn.o_proj.weight", (HIDDEN, HIDDEN)),
                (p + "post_attention_layernorm.weight", (HIDDEN,)),
                (p + "mlp.gate_proj.weight", (INTER, HIDDEN)),
                (p + "mlp.up_proj.weight", (INTER, HIDDEN)),
                (p + "mlp.down_proj.weight", (HIDDEN, INTER))]
    return out + [("model.norm.weight", (HIDDEN,)),
                  ("lm_head.weight", (VOCAB, HIDDEN))]


def _hf_checkpoint(n_layers: int, seed: int):
    """A Llama-2-7B-width F16 checkpoint of seeded random weights: the
    source tensors on the card, and the repo's files (config.json, two
    safetensors shards, their index) as bytes in host memory."""
    import torch

    from demodel_tpu_torch.formats import safetensors as st

    gen = torch.Generator("cuda").manual_seed(seed)
    src = {}
    for name, shape in _llama_hf_shapes(n_layers):
        if len(shape) == 1:
            t = torch.ones(shape, device="cuda")
        else:
            std = 0.02 if "embed" in name else shape[1] ** -0.5
            t = torch.randn(shape, generator=gen, device="cuda") * std
        src[name] = t.to(torch.float16)
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": VOCAB, "hidden_size": HIDDEN,
              "intermediate_size": INTER, "num_hidden_layers": n_layers,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
              "rope_theta": 10000.0, "tie_word_embeddings": False,
              "torch_dtype": "float16"}
    names = list(src)
    half = names.index(f"model.layers.{n_layers // 2}.input_layernorm.weight")
    files = {"config.json": json.dumps(config).encode()}
    weight_map = {}
    for k, part in enumerate((names[:half], names[half:])):
        fname = f"model-{k + 1:05d}-of-00002.safetensors"
        files[fname] = st.serialize({n: src[n].cpu() for n in part})
        weight_map.update({n: fname for n in part})
    files["model.safetensors.index.json"] = json.dumps(
        {"metadata": {"total_size": sum(t.numel() * 2 for t in src.values())},
         "weight_map": weight_map}).encode()
    return src, files


def _hf_handler(repos: dict[str, dict[str, bytes]]):
    """A HuggingFace Hub over ``repos`` ({repo: {file: bytes}}): the API
    route, ``/resolve`` with a 302 to a ``/cdn`` path for LFS files
    (``X-Linked-Etag``, ``X-Linked-Size``, ``X-Repo-Commit``), small
    files directly, and Range on the CDN. ``Hub.counts`` counts requests:
    ``api``, ``head``, and the GETs that serve or lead to file bytes,
    ``resolve`` and ``cdn``."""
    import hashlib

    digests = {r: {f: hashlib.sha256(b).hexdigest() for f, b in fs.items()}
               for r, fs in repos.items()}
    by_digest = {r: {sha: f for f, sha in m.items()}
                 for r, m in digests.items()}
    counts = {"api": 0, "head": 0, "resolve": 0, "cdn": 0}
    lock = threading.Lock()

    class Hub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _count(self, what: str) -> None:
            with lock:
                counts["head" if self.command == "HEAD" else what] += 1

        def _send(self, status, body=b"", ctype="application/json",
                  extra=None):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def do_HEAD(self):
            self.do_GET()

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            m = re.match(r"^/api/models/(.+?)/revision/([^/]+)$", path)
            if m:
                self._count("api")
                if m[1] not in repos:
                    return self._send(404, b'{"error":"RepoNotFound"}')
                return self._send(200, json.dumps({
                    "sha": PULL_COMMIT, "id": m[1], "siblings": [
                        {"rfilename": f} for f in sorted(repos[m[1]])]
                }).encode())
            m = re.match(r"^/(.+?)/resolve/([^/]+)/(.+)$", path)
            if m:
                self._count("resolve")
                repo, fname = m[1], m[3]
                body = repos.get(repo, {}).get(fname)
                if body is None:
                    return self._send(404, b'{"error":"EntryNotFound"}')
                sha = digests[repo][fname]
                if fname.endswith(".safetensors"):
                    host = self.headers.get("Host", "127.0.0.1")
                    scheme = "https" if isinstance(self.connection,
                                                   ssl.SSLSocket) else "http"
                    return self._send(302, extra={
                        "Location": f"{scheme}://{host}/cdn/{repo}/{sha}",
                        "X-Linked-Etag": f'"{sha}"',
                        "X-Linked-Size": str(len(body)),
                        "X-Repo-Commit": PULL_COMMIT,
                        "Accept-Ranges": "bytes"})
                return self._send(200, body, "application/octet-stream", {
                    "ETag": f'"{sha}"', "X-Repo-Commit": PULL_COMMIT,
                    "Accept-Ranges": "bytes"})
            m = re.match(r"^/cdn/(.+?)/([0-9a-f]{64})$", path)
            if m:
                self._count("cdn")
                fname = by_digest.get(m[1], {}).get(m[2])
                if fname is None:
                    return self._send(404)
                body = memoryview(repos[m[1]][fname])
                rng = self.headers.get("Range", "")
                if rng.startswith("bytes="):
                    a, _, b = rng[6:].partition("-")
                    start, end = int(a), int(b) if b else len(body) - 1
                    part = body[start:end + 1]
                    return self._send(206, part, "application/octet-stream", {
                        "ETag": f'"{m[2]}"', "Content-Range":
                        f"bytes {start}-{start + len(part) - 1}/{len(body)}"})
                return self._send(200, body, "application/octet-stream", {
                    "ETag": f'"{m[2]}"', "Accept-Ranges": "bytes"})
            self._send(404, b'{"error":"not found"}')

    Hub.counts = counts
    Hub.digests = digests
    return Hub


def _span_s(name: str) -> float:
    from demodel_tpu_torch.utils.metrics import HUB, labeled

    h = HUB.histograms().get(labeled("stage_duration_seconds", span=name))
    return h["sum"] if h else 0.0


def _reset_k1() -> None:
    from demodel_tpu_torch.ops import flash_attention as fa

    fa.launches = 0
    for name in fa.launches_by_kernel:
        fa.launches_by_kernel[name] = 0


def _generate_http(url: str, prompt: list[int], n: int) -> list[int]:
    status, _, body = _post(url, {"prompt": prompt, "max_new_tokens": n})
    if status != 200:
        raise AssertionError(f"/generate answered {status}")
    return json.loads(body)["tokens"]


class _HubRig:
    """The pull and peer phases' world: the 8-layer F16 checkpoint (its
    sources on the card), the in-script Hub serving it, and a temporary
    directory; :meth:`close` stops the Hub and removes the directory."""

    def __init__(self):
        import tempfile

        t0 = time.perf_counter()
        self.src, self.files = _hf_checkpoint(PULL_LAYERS, seed=7)
        self.build_s = time.perf_counter() - t0
        self.nbytes = sum(len(b) for b in self.files.values())
        handler = _hf_handler({PULL_MODEL: self.files})
        self.counts = handler.counts
        self.hub = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=self.hub.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.hub.server_port}"
        self.tmp = tempfile.mkdtemp(prefix="chip-smoke-pull-")

    def config(self, name: str):
        from demodel_tpu_torch.config import ProxyConfig

        return ProxyConfig(host="127.0.0.1", port=0, no_mitm=True,
                           cache_dir=os.path.join(self.tmp, name),
                           data_dir=os.path.join(self.tmp, "data"))

    def close(self) -> None:
        import shutil

        self.hub.shutdown()
        self.hub.server_close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _placed_by_source_name(params: dict) -> dict:
    """The served model's tensors under their checkpoint names
    (``transformers`` layout: projections ``[out, in]``)."""
    placed = {"model.embed_tokens.weight": params["embed"],
              "model.norm.weight": params["final_norm"],
              "lm_head.weight": params["lm_head"].T}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        placed[p + "input_layernorm.weight"] = layer["attn_norm"]
        placed[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
        for k in ("q", "k", "v", "o"):
            placed[p + f"self_attn.{k}_proj.weight"] = layer[f"{k}_proj"].T
        for k in ("gate", "up", "down"):
            placed[p + f"mlp.{k}_proj.weight"] = layer[f"{k}_proj"].T
    return placed


def _unequal(placed: dict, want: dict) -> list[str]:
    import torch

    if sorted(placed) != sorted(want):
        return sorted(set(placed) ^ set(want))
    return [n for n, t in want.items()
            if not (placed[n].dtype == torch.float16
                    and placed[n].device.type == "cuda"
                    and torch.equal(placed[n], t))]


def _load_and_serve(rig: _HubRig, cfg, prompts, **load_kw):
    """``serve.load_model`` of the rig's checkpoint into ``cfg``'s store
    and one HTTP request per prompt; (load seconds, tokens, K1 launches
    by kernel, the model's params, its config). The K1 counts cover the
    load and the requests only."""
    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.serve import http

    engine = server = None
    try:
        torch.cuda.synchronize()
        _reset_k1()  # count the main path's launches only
        t0 = time.perf_counter()
        engine = serve.load_model(
            PULL_MODEL, cfg, endpoint=rig.url, device="cuda", kv_mb=1024,
            max_new_tokens=PULL_NEW, max_batch=4, queue_limit=8, **load_kw)
        load_s = time.perf_counter() - t0
        server = http.start()
        tokens = [_generate_http(f"{server.url}/generate", p, PULL_NEW)
                  for p in prompts]
        by_kernel = dict(fa.launches_by_kernel)
        if sum(by_kernel.values()) != fa.launches:
            raise AssertionError(f"K1 launches {fa.launches} vs by kernel "
                                 f"{by_kernel}")
        return load_s, tokens, by_kernel, engine.params, engine.cfg
    finally:
        if engine is not None:
            engine.stop()
        if server is not None:
            server.stop()
        serve.install(None)


def _manifest_record(cfg) -> dict:
    from demodel_tpu_torch import delivery

    store = delivery.open_store(cfg)
    try:
        mkey = delivery.manifest_key("hf", PULL_MODEL)
        record = json.loads(store.get(mkey)) if store.has(mkey) else {}
        record["stored_bytes"] = sum(store.size(f["key"])
                                     for f in record.get("files", []))
        record["key"] = mkey
        return record
    finally:
        store.close()


def phase_pull(rig: _HubRig) -> tuple[int, dict]:
    """Cold pull → placement → build → serve of the 8-layer F16
    checkpoint. Returns the K1 launches of the main path (all on
    ``wgmma_f16``) and what the peer phase holds its own pull against."""
    import numpy as np
    import torch

    from demodel_tpu_torch.models import llama

    cfg = rig.config("cache")
    pgen = torch.Generator().manual_seed(8)
    prompts = [_prompt(pgen, n, VOCAB) for n in PULL_PROMPTS]
    spans = ("registry-fetch", "sink-deliver", "serve.load-model")
    before = {k: _span_s(k) for k in spans}
    load_s, tokens, by_kernel, params, mcfg = _load_and_serve(rig, cfg,
                                                              prompts)
    placed = _placed_by_source_name(params)
    launches = sum(by_kernel.values())
    span_s = {k: _span_s(k) - before[k] for k in spans}

    # every placed tensor against its source, on the card
    unequal = _unequal(placed, rig.src)
    if unequal:
        raise AssertionError(f"pull: placed tensors differ from their "
                             f"sources: {unequal[:5]}")
    if mcfg.dtype != "float16" or mcfg.num_hidden_layers != PULL_LAYERS:
        raise AssertionError(f"pull: built {mcfg}")
    want = PULL_LAYERS * len(prompts)
    if launches != want or by_kernel["wgmma_f16"] != want:
        raise AssertionError(f"pull: K1 launches {by_kernel}, expected "
                             f"{want} on wgmma_f16")

    # prefill logits, kernel path vs plain path (comparison only)
    rel_errs, first = [], []
    with torch.inference_mode():
        for p in prompts:
            toks = torch.tensor([p], device="cuda")
            got = llama.step_prefill(params, toks, mcfg)[0][0].float()
            os.environ["DEMODEL_FLASH_ATTN"] = "0"
            try:
                ref = llama.step_prefill(params, toks, mcfg)[0][0].float()
            finally:
                del os.environ["DEMODEL_FLASH_ATTN"]
            rel_errs.append(((got - ref).norm() / ref.norm()).item())
            first.append(int(torch.argmax(got).item()))
    if max(rel_errs) > LOGITS_REL_TOL or not all(map(np.isfinite,
                                                     rel_errs)):
        raise AssertionError(f"pull: prefill logits kernel vs plain rel "
                             f"errors {rel_errs} > {LOGITS_REL_TOL}")
    for p, toks, f in zip(prompts, tokens, first):
        if len(toks) != PULL_NEW or toks[0] != f:
            raise AssertionError(f"pull: prompt {len(p)}: tokens {toks}, "
                                 f"kernel-path prefill argmax {f}")

    record = _manifest_record(cfg)
    if sorted(f["name"] for f in record.get("files", [])) != \
            sorted(rig.files) or record["stored_bytes"] != rig.nbytes:
        raise AssertionError(f"pull: manifest record {record['key']} lists "
                             f"{record.get('files')}")
    load = span_s["serve.load-model"]
    # the registry pull's and the delivery's wall seconds, as the pull
    # recorded them in its manifest; the spans' sums (fetches overlap, so
    # registry-fetch can exceed the wall) and shares of serve.load-model
    pull_s, sink_s = record["secs"], record["tpu_sink"]["secs"]
    _say("pull", model=f"{PULL_MODEL} widths, {PULL_LAYERS} layers, f16, "
         "seeded", checkpoint_build_s=round(rig.build_s, 3),
         pulled_bytes=rig.nbytes, pull_s=pull_s, pull_and_place_s=sink_s,
         load_model_s=load_s, span_sum_s=span_s,
         span_share={k: v / load for k, v in span_s.items()},
         pull_GBps=rig.nbytes / pull_s / 1e9,
         load_GBps=rig.nbytes / load / 1e9, tensors_equal=len(rig.src),
         k1_launches=launches, k1_launches_by_kernel=by_kernel,
         prompt_lens=list(PULL_PROMPTS), tokens=tokens,
         logits_rel_err=rel_errs, logits_tol=LOGITS_REL_TOL,
         manifest_key=record["key"], hub_requests=dict(rig.counts))
    return launches, {"cfg": cfg, "placed": placed, "prompt": prompts[0],
                      "tokens": tokens[0]}


def phase_peer(rig: _HubRig, pulled: dict) -> int:
    """``serve.load_model`` from a peer: the pull phase's store served by
    the port's ``ProxyServer`` on 127.0.0.1, a fresh store, the same Hub
    as endpoint. Returns the K1 launches (all on ``wgmma_f16``)."""
    from demodel_tpu_torch.parallel.peer import PeerGossip
    from demodel_tpu_torch.proxy import ProxyServer
    from demodel_tpu_torch.utils.metrics import HUB

    proxy = ProxyServer(pulled["cfg"], verbose=False,
                        session_threads=8).start()
    try:
        cfg = rig.config("peer-cache")
        hub_before = dict(rig.counts)
        peer_files0 = HUB.get("pull_files_from_peer_total")
        deliver0 = _span_s("sink-deliver")
        load_s, tokens, by_kernel, params, _ = _load_and_serve(
            rig, cfg, [pulled["prompt"]], peers=[proxy.url])
        deliver_s = _span_s("sink-deliver") - deliver0
        hub = {k: rig.counts[k] - hub_before[k] for k in rig.counts}
        served = proxy.metrics()
    finally:
        PeerGossip.reset_shared()
        proxy.stop()
    launches = sum(by_kernel.values())
    placed = _placed_by_source_name(params)
    record = _manifest_record(cfg)
    files = record.get("files", [])
    if hub["resolve"] or hub["cdn"]:
        raise AssertionError(f"peer: the Hub served file requests {hub}")
    if sorted(f["name"] for f in files) != sorted(rig.files) or not all(
            f["from_peer"] for f in files) or \
            record["stored_bytes"] != rig.nbytes:
        raise AssertionError(f"peer: files not all from the peer, or not "
                             f"all stored: {files}")
    if HUB.get("pull_files_from_peer_total") - peer_files0 != len(files):
        raise AssertionError("peer: pull_files_from_peer_total is not the "
                             "file count")
    unequal = _unequal(placed, pulled["placed"])
    if unequal:
        raise AssertionError(f"peer: placed tensors differ from the pull "
                             f"phase's: {unequal[:5]}")
    if tokens[0] != pulled["tokens"]:
        raise AssertionError(f"peer: tokens {tokens[0]} vs the pull phase's "
                             f"{pulled['tokens']}")
    if launches != PULL_LAYERS or by_kernel["wgmma_f16"] != launches:
        raise AssertionError(f"peer: K1 launches {by_kernel}, expected "
                             f"{PULL_LAYERS} on wgmma_f16")
    _say("peer", model=f"{PULL_MODEL} widths, {PULL_LAYERS} layers, f16",
         peer_bytes=rig.nbytes, pull_s=record["secs"],
         pull_GBps=rig.nbytes / record["secs"] / 1e9,
         pull_and_place_s=record["tpu_sink"]["secs"], load_model_s=load_s,
         sink_deliver_s=deliver_s, files_from_peer=len(files),
         hub_requests=hub, peer_serve_bytes=served.get("serve_bytes_total"),
         tensors_equal=len(placed), tokens=tokens[0],
         k1_launches_by_kernel=by_kernel)
    return launches


#: the swarm leg's hosts (one process, one card, a chunk board and a
#: swarm serve surface each)
SWARM_HOSTS = ("hA", "hB")


def _weight_bytes(rig: _HubRig) -> int:
    return sum(len(b) for n, b in rig.files.items()
               if n.endswith(".safetensors"))


def _sharded_leg(rig: _HubRig, pulled: dict, url: str) -> tuple[int, dict]:
    """``pull_manifest_to_hbm`` of the pull phase's checkpoint off the
    peer at ``url`` onto the card (no store on this side), then the model
    built from the placement and ``config.json`` alone and served; its
    K1 launches and its row."""
    import dataclasses
    import tempfile

    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.models.hf_loader import load_llama_params
    from demodel_tpu_torch.models.llama import LlamaConfig
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.serve import http
    from demodel_tpu_torch.sink.remote import (fetch_manifest,
                                               materialize_aux_files,
                                               pull_manifest_to_hbm)
    from demodel_tpu_torch.utils.metrics import HUB

    weight = _weight_bytes(rig)
    fallback0 = HUB.get("peer_window_fallback_total")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, placed = pull_manifest_to_hbm(PULL_MODEL, [url], source="hf")
    wall_s = time.perf_counter() - t0
    fallbacks = HUB.get("peer_window_fallback_total") - fallback0
    knobs = {k: HUB.get_gauge(f"tuner_{k}")
             for k in ("streams", "window_bytes", "prefetch_depth")}
    decisions = {k.split('"')[1]: v for k, v in HUB.snapshot().items()
                 if k.startswith("tuner_decisions_total{")}
    unequal = _unequal(placed.arrays, pulled["placed"])
    if unequal:
        raise AssertionError(f"sharded: placed tensors differ from the pull "
                             f"phase's: {unequal[:5]}")
    if not (report["network_bytes"] == report["weight_bytes"] == weight):
        raise AssertionError(f"sharded: network_bytes "
                             f"{report['network_bytes']}, weight_bytes "
                             f"{report['weight_bytes']}, checkpoint {weight}")
    if not report["pipelined"] or fallbacks:
        raise AssertionError(f"sharded: pipelined {report['pipelined']}, "
                             f"native window fallbacks {fallbacks}")

    # build from config.json and the placement only, then serve
    engine = server = None
    with tempfile.TemporaryDirectory(prefix="chip-smoke-aux-") as aux:
        peer, manifest = fetch_manifest([url], PULL_MODEL)
        written = materialize_aux_files(manifest, peer, aux)
        config = json.loads((Path(aux) / "config.json").read_text())
    mcfg = dataclasses.replace(LlamaConfig.from_hf(config), dtype="float16")
    if mcfg.num_hidden_layers != PULL_LAYERS:
        raise AssertionError(f"sharded: config.json gives {mcfg}")
    try:
        torch.cuda.synchronize()
        _reset_k1()  # the served request's launches only
        t1 = time.perf_counter()
        params = load_llama_params(placed.arrays, mcfg, device="cuda")
        engine = serve.boot(params, mcfg, device="cuda", kv_mb=1024,
                            max_new_tokens=PULL_NEW, max_batch=4,
                            queue_limit=8, model=PULL_MODEL)
        server = http.start()
        tokens = _generate_http(f"{server.url}/generate", pulled["prompt"],
                                PULL_NEW)
        serve_s = time.perf_counter() - t1
        by_kernel = dict(fa.launches_by_kernel)
    finally:
        if engine is not None:
            engine.stop()
        if server is not None:
            server.stop()
        serve.install(None)
    launches = sum(by_kernel.values())
    if tokens != pulled["tokens"]:
        raise AssertionError(f"sharded: tokens {tokens} vs the pull "
                             f"phase's {pulled['tokens']}")
    if launches != PULL_LAYERS or by_kernel["wgmma_f16"] != launches:
        raise AssertionError(f"sharded: K1 launches {by_kernel}, expected "
                             f"{PULL_LAYERS} on wgmma_f16")
    row = {"weight_bytes": weight, "network_bytes": report["network_bytes"],
           "pull_s": wall_s, "pull_GBps": weight / wall_s / 1e9,
           "report_secs": report["secs"], "block_secs": report["block_secs"],
           "phase_secs": report["phase_secs"], "tuner_knobs": knobs,
           "tuner_decisions": decisions, "window_fallbacks": fallbacks,
           "aux_files": sorted(p.name for p in written),
           "tensors_equal": len(placed.arrays), "build_and_serve_s": serve_s,
           "tokens": tokens, "k1_launches_by_kernel": by_kernel}
    del placed, params, engine
    torch.cuda.empty_cache()
    return launches, row


def _swarm_leg(rig: _HubRig, pulled: dict, url: str) -> dict:
    """Two swarm hosts in this process, each with its chunk board behind
    its own ``RestoreServer``, placing the checkpoint at once off the one
    origin peer at ``url``; its row."""
    import torch

    from demodel_tpu_torch.restore.server import (RestoreRegistry,
                                                  RestoreServer)
    from demodel_tpu_torch.sink.remote import (SwarmScheduler,
                                               pull_manifest_to_hbm)
    from demodel_tpu_torch.store import Store
    from demodel_tpu_torch.utils.metrics import HUB

    names = ("swarm_origin_bytes_total", "swarm_peer_bytes_total",
             "swarm_chunks_refetched_total", "swarm_chunks_reaped_total",
             "swarm_bytes_served_total")
    before = {k: HUB.get(k) for k in names}
    # a swarm host serves its board; its registry is empty
    servers = {h: RestoreServer(RestoreRegistry(Store(
        Path(rig.tmp) / f"swarm-{h}")), host="127.0.0.1").start()
        for h in SWARM_HOSTS}
    parts = {h: f"http://127.0.0.1:{s.port}" for h, s in servers.items()}
    scheds = [SwarmScheduler("chip-smoke", h, parts) for h in SWARM_HOSTS]
    results: dict = {}
    errors: list = []

    def run(s):
        try:
            results[s.self_id] = pull_manifest_to_hbm(
                PULL_MODEL, [url], source="hf", swarm=s)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(s,)) for s in scheds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        if errors or len(results) != len(scheds):
            raise AssertionError(f"swarm: {errors or 'a host did not end'}")
        stats = {s.self_id: s.stats() for s in scheds}
    finally:
        for s in scheds:
            s.close()
        for srv in servers.values():
            srv.stop()
            srv.registry.store.close()
    weight = _weight_bytes(rig)
    delta = {k: HUB.get(k) - before[k] for k in names}
    for host, (report, placed) in results.items():
        unequal = _unequal(placed.arrays, pulled["placed"])
        if unequal or report["weight_bytes"] != weight:
            raise AssertionError(f"swarm {host}: tensors differ from the "
                                 f"pull phase's {unequal[:5]}, weight bytes "
                                 f"{report['weight_bytes']}")
    if (delta["swarm_origin_bytes_total"] != weight
            or delta["swarm_peer_bytes_total"] != weight
            or delta["swarm_chunks_refetched_total"]):
        raise AssertionError(f"swarm: {delta} against {weight} weight bytes "
                             "(want origin 1x, peer 1x, no re-fetch)")
    row = {"hosts": len(scheds), "weight_bytes": weight, "wall_s": wall_s,
           "aggregate_GBps": len(scheds) * weight / wall_s / 1e9,
           "chunk_bytes": scheds[0].chunk_bytes,
           "chunks": stats[SWARM_HOSTS[0]]["chunks_total"], **delta,
           "owned_chunks": {h: st["owned_chunks"] for h, st in stats.items()},
           "network_bytes": {h: r["network_bytes"]
                             for h, (r, _) in results.items()},
           "phase_secs": {h: r["phase_secs"]
                          for h, (r, _) in results.items()},
           "tensors_equal": {h: len(p.arrays)
                             for h, (_, p) in results.items()}}
    del results
    torch.cuda.empty_cache()
    return row


def phase_sharded(rig: _HubRig, pulled: dict) -> int:
    """The sharded pull off a warm peer: the pull phase's store behind
    the port's ``ProxyServer``, then (1) ``pull_manifest_to_hbm`` onto the
    card with no store on this side, built from ``config.json`` and
    served, and (2) the same pull by two swarm hosts at once. Returns the
    K1 launches (all on ``wgmma_f16``)."""
    from demodel_tpu_torch.parallel.peer import PeerGossip
    from demodel_tpu_torch.proxy import ProxyServer

    proxy = ProxyServer(pulled["cfg"], verbose=False,
                        session_threads=8).start()
    try:
        launches, row = _sharded_leg(rig, pulled, proxy.url)
        _say("sharded", model=f"{PULL_MODEL} widths, {PULL_LAYERS} layers, "
             "f16", **row)
        _say("swarm", model=f"{PULL_MODEL} widths, {PULL_LAYERS} layers, "
             "f16", **_swarm_leg(rig, pulled, proxy.url))
    finally:
        PeerGossip.reset_shared()
        proxy.stop()
    return launches


# ----------------------------------------------------------------- mitm

#: where the mitm phase's TLS servers listen, the host its leaf is for
MITM_HOST = "127.0.0.1"
#: the warm pass's Range on each shard
MITM_RANGE = 64 << 20
#: how long the store may take to commit what the client fetched
MITM_COMMIT_S = 300.0
#: the native plane's kernel-TLS switch for the mitm phase's proxy: on
#: the H100 host's emulated kernel (release "4.4.0") the plane's kTLS
#: test passes, and every client handshake with kTLS asked for then
#: fails ("unknown ssl error"; "data between ccs and finished" at TLS
#: 1.2), while with it off all succeed
#: (``python -m demodel_tpu_torch.probes.mitm_ktls``)
MITM_KTLS = "0"


def _client(proxy_url: str, ca_file):
    """A foreign client's opener: through the proxy, trusting ``ca_file``
    (the proxy's CA) and nothing else."""
    from demodel_tpu_torch.probes.mitm_ktls import ViaProxy

    return urllib.request.build_opener(
        ViaProxy(proxy_url), urllib.request.HTTPSHandler(
            context=ssl.create_default_context(cafile=str(ca_file))))


def _get_hashed(opener, req, chunk: int = 16 << 20) -> tuple[int, str]:
    """(bytes, sha256) of the body of ``req``, hashed as it streams."""
    import hashlib

    sha, n = hashlib.sha256(), 0
    with opener.open(req, timeout=600) as r:
        while part := r.read(chunk):
            sha.update(part)
            n += len(part)
    return n, sha.hexdigest()


def _hf_download(opener, base: str, model: str, names, nbytes: int = 0
                 ) -> dict[str, tuple[int, str]]:
    """What ``huggingface-cli download`` does: each file on its own
    thread (up to 8, ``snapshot_download``'s default), GET
    ``resolve/main/{name}`` following the Hub's 302 to the CDN, with
    ``Range: bytes=0-{nbytes - 1}`` where ``nbytes``; name → (bytes,
    sha256)."""
    from concurrent.futures import ThreadPoolExecutor

    def get(name):
        req = urllib.request.Request(f"{base}/{model}/resolve/main/{name}")
        if nbytes:
            req.add_header("Range", f"bytes=0-{nbytes - 1}")
        return _get_hashed(opener, req)

    names = list(names)
    with ThreadPoolExecutor(min(8, len(names))) as pool:
        return dict(zip(names, pool.map(get, names)))


def _v2_pull(opener, base: str, name_tag: str) -> dict:
    """What ``ollama pull`` does against a registry-v2: the ping, a
    bearer token where the registry challenges for one, the manifest,
    then the config and every layer by digest, each held to its digest
    and size. Returns the manifest."""
    name, _, tag = name_tag.partition(":")
    name = name if "/" in name else f"library/{name}"
    headers = {}
    try:
        opener.open(f"{base}/v2/", timeout=60).close()
    except urllib.error.HTTPError as e:
        if e.code != 401:
            raise
        chal = dict(re.findall(r'(\w+)="([^"]*)"',
                               e.headers.get("WWW-Authenticate", "")))
        query = urllib.parse.urlencode(
            {k: chal[k] for k in ("service", "scope") if k in chal})
        with opener.open(f"{chal['realm']}?{query}", timeout=60) as r:
            headers["Authorization"] = f"Bearer {json.load(r)['token']}"
    req = urllib.request.Request(
        f"{base}/v2/{name}/manifests/{tag or 'latest'}", headers={
            **headers, "Accept":
            "application/vnd.docker.distribution.manifest.v2+json"})
    with opener.open(req, timeout=60) as r:
        manifest = json.load(r)
    for blob in [manifest["config"], *manifest["layers"]]:
        n, sha = _get_hashed(opener, urllib.request.Request(
            f"{base}/v2/{name}/blobs/{blob['digest']}", headers=headers))
        if f"sha256:{sha}" != blob["digest"] or n != blob["size"]:
            raise AssertionError(f"{name_tag}: blob {blob['digest']} came "
                                 f"as {n} bytes hashing to {sha}")
    return manifest


def _serve_tls(handler, ctx: ssl.SSLContext) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((MITM_HOST, 0), handler)
    server.socket = ctx.wrap_socket(server.socket, server_side=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _await_keys(store, keys, deadline_s: float) -> float:
    """Seconds until ``store`` holds every key of ``keys`` (the native
    plane may commit after the client's last byte); raises past
    ``deadline_s``."""
    t0 = time.perf_counter()
    while missing := [k for k in keys if not store.has(k)]:
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"mitm: the store did not commit {missing} "
                                 f"within {deadline_s} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _mitm_ollama(opener, store, proxy_url: str, base: str) -> tuple[dict,
                                                                   dict]:
    """The mitm phase's Ollama leg: ``_v2_pull`` of the gguf phase's
    Q4_0 model through the proxy, the record synthesized from the store,
    then ``pull_manifest_to_hbm(source="ollama")`` off the proxy onto the
    card (K3 and K4e), every tensor equal to ``deliver_gguf`` of the
    buffer. Returns its row and the dequant launches."""
    import torch

    from demodel_tpu_torch import delivery
    from demodel_tpu_torch.ops import dequant as dq
    from demodel_tpu_torch.sink import deliver_gguf, pull_manifest_to_hbm
    from demodel_tpu_torch.store import key_for_uri

    buf, specs = _GGUF_BUILT[MITM_GGUF_KIND]
    name = OLLAMA_KINDS[MITM_GGUF_KIND]
    repo, _, tag = name.partition(":")
    t0 = time.perf_counter()
    manifest = _v2_pull(opener, base, name)
    fetch_s = time.perf_counter() - t0
    v2 = f"{base}/v2/library/{repo}"
    commit_s = _await_keys(store, [key_for_uri(f"{v2}/manifests/{tag}")] + [
        key_for_uri(f"{v2}/blobs/{b['digest']}")
        for b in [manifest["config"], *manifest["layers"]]], MITM_COMMIT_S)
    record = delivery.synthesize_manifest(store, name, source="ollama")
    if sorted(f["name"] for f in record["files"]) != sorted(
            b["digest"].split(":")[1]
            for b in [manifest["config"], *manifest["layers"]]):
        raise AssertionError(f"mitm ollama: record {record}")
    want = {f: 0 for f in DEQUANT_FORMATS}
    for _, _, fmt in specs:
        if fmt != "f32":
            want[fmt] += 1
    torch.cuda.synchronize()
    for fmt in dq.launches:
        dq.launches[fmt] = 0  # the placement's launches only
    t1 = time.perf_counter()
    report, placed = pull_manifest_to_hbm(name, [proxy_url], source="ollama")
    place_s = time.perf_counter() - t1
    launches = dict(dq.launches)
    if launches != want:
        raise AssertionError(f"mitm ollama: dequant launches {launches}, "
                             f"expected {want}")
    ref = deliver_gguf(None, name, out_dtype=torch.bfloat16, buffer=buf)
    unequal = sorted(set(placed.arrays) ^ set(ref.arrays)) or [
        n for n, a in placed.arrays.items()
        if not (a.dtype == torch.bfloat16 and a.device.type == "cuda"
                and torch.equal(a, ref.arrays[n]))]
    if unequal:
        raise AssertionError(f"mitm ollama: tensors differ from "
                             f"deliver_gguf of the buffer: {unequal[:5]}")
    row = {"model": name, "blob_bytes": len(buf), "fetch_s": fetch_s,
           "commit_wait_s": commit_s, "place_s": place_s,
           "network_bytes": report["network_bytes"],
           "tensors_equal": len(placed.arrays),
           "launches": {k: v for k, v in launches.items() if v}}
    del placed, ref
    torch.cuda.empty_cache()
    return row, launches


def phase_mitm(rig: _HubRig, pulled: dict) -> tuple[int, dict[str, int]]:
    """The MITM front door: a foreign client warms a node through the
    port's proxy, and the node places the model on the card.

    The pull phase's checkpoint on a Hub over TLS and the gguf phase's
    Q4_0 model on a registry-v2 over TLS (one CA and leaf from the port's
    pki); the port's ``ProxyServer`` intercepting both with its own CA
    (RSA, the default) and a store in the rig's directory. Gates: a
    ``huggingface-cli``-shaped client through the proxy gets every file
    byte-exact (sha256) over a leaf it verifies against the port's CA
    alone, one leaf is minted for the host, the store commits every
    resolve and CDN object whole, and a second pass (``config.json`` and
    a 64 MiB Range of each shard) sends the Hub nothing; the record
    ``synthesize_manifest`` builds lists every file with its size and
    sha256, the LFS ones under synth keys, and ``/peer`` serves it; the
    sharded leg off the proxy (``_sharded_leg``'s gates: tensors, bytes,
    no fallback, tokens, K1 on ``wgmma_f16``); the Ollama leg
    (``_mitm_ollama``); ``python -m demodel_tpu_torch.cli manifest``
    prints the same record. Returns the K1 and dequant launches."""
    import hashlib

    from demodel_tpu_torch import delivery, pki
    from demodel_tpu_torch.config import ProxyConfig
    from demodel_tpu_torch.parallel.peer import PeerGossip
    from demodel_tpu_torch.probes.mitm_ktls import origin_context
    from demodel_tpu_torch.proxy import ProxyServer
    from demodel_tpu_torch.sink.remote import fetch_manifest
    from demodel_tpu_torch.store import key_for_uri

    root = Path(rig.tmp) / "mitm"
    ctx, upstream_ca = origin_context(root / "upstream-tls", MITM_HOST)
    hub_handler = _hf_handler({PULL_MODEL: rig.files})
    digests = hub_handler.digests[PULL_MODEL]
    servers = [_serve_tls(hub_handler, ctx),
               _serve_tls(_ollama_handler(*_ollama_models(
                   [MITM_GGUF_KIND])), ctx)]
    hub, reg = (f"https://{MITM_HOST}:{s.server_port}" for s in servers)
    cfg = ProxyConfig(host="127.0.0.1", port=0, cache_dir=root / "cache",
                      data_dir=root / "data", mitm_hosts=[
                          u.split("//")[1] for u in (hub, reg)])
    t0 = time.perf_counter()
    pki.read_or_new_ca(cfg.data_dir, use_ecdsa=cfg.use_ecdsa)
    ca_keygen_s = time.perf_counter() - t0
    ktls = os.environ.get("DEMODEL_PROXY_KTLS")
    os.environ["DEMODEL_PROXY_KTLS"] = MITM_KTLS  # read at start()
    try:
        proxy = ProxyServer(cfg, upstream_ca=str(upstream_ca),
                            verbose=False, session_threads=8).start()
    finally:
        if ktls is None:
            del os.environ["DEMODEL_PROXY_KTLS"]
        else:
            os.environ["DEMODEL_PROXY_KTLS"] = ktls
    mints = []
    mint = proxy._minter._mint  # noqa: SLF001 — timed, not changed

    def timed_mint(host):
        t = time.perf_counter()
        out = mint(host)
        mints.append((host, time.perf_counter() - t))
        return out

    proxy._minter._mint = timed_mint  # noqa: SLF001
    store = delivery.open_store(cfg)
    try:
        opener = _client(proxy.url, pki.ca_paths(cfg.data_dir)[0])
        names = sorted(rig.files)
        shards = [n for n in names if n.endswith(".safetensors")]
        t0 = time.perf_counter()
        got = _hf_download(opener, hub, PULL_MODEL, names)
        cold_s = time.perf_counter() - t0
        bad = [n for n in names
               if got[n] != (len(rig.files[n]), digests[n])]
        if bad or [h for h, _ in mints] != [MITM_HOST]:
            raise AssertionError(f"mitm: client bytes differ for {bad}, "
                                 f"mints {mints}")
        commit_s = _await_keys(store, [
            key_for_uri(f"{hub}/{PULL_MODEL}/resolve/main/{n}")
            for n in names] + [
            key_for_uri(f"{hub}/cdn/{PULL_MODEL}/{digests[n]}")
            for n in shards], MITM_COMMIT_S)
        cached = {n: store.size(key_for_uri(
            f"{hub}/cdn/{PULL_MODEL}/{digests[n]}")) for n in shards}
        if cached != {n: len(rig.files[n]) for n in shards}:
            raise AssertionError(f"mitm: shards cached as {cached}")

        before = dict(hub_handler.counts)
        warm = _hf_download(opener, hub, PULL_MODEL, ["config.json"])
        warm.update(_hf_download(opener, hub, PULL_MODEL, shards,
                                 nbytes=MITM_RANGE))
        hub_warm = {k: hub_handler.counts[k] - before[k] for k in before}
        heads = {n: memoryview(rig.files[n])[:MITM_RANGE] for n in shards}
        want = {n: (len(h), hashlib.sha256(h).hexdigest())
                for n, h in heads.items()}
        want["config.json"] = got["config.json"]
        if warm != want or any(hub_warm.values()):
            raise AssertionError(f"mitm: warm pass {warm} vs {want}, Hub "
                                 f"requests {hub_warm}")

        t0 = time.perf_counter()
        record = delivery.synthesize_manifest(store, PULL_MODEL)
        synth_s = time.perf_counter() - t0
        listed = {f["name"]: (f["size"], f["sha256"]) for f in
                  record["files"]}
        if listed != {n: (len(b), digests[n]) for n, b in rig.files.items()
                      } or any(f["key"] != key_for_uri(
                          f"demodel://synth/{PULL_MODEL}/{f['name']}")
                          for f in record["files"]
                          if f["name"] in shards):
            raise AssertionError(f"mitm: synthesized record {record}")
        if fetch_manifest([proxy.url], PULL_MODEL)[1] != record:
            raise AssertionError("mitm: /peer serves another record")

        k1, sharded = _sharded_leg(rig, pulled, proxy.url)
        t0 = time.perf_counter()
        ollama, dq_launches = _mitm_ollama(opener, store, proxy.url, reg)
        ollama_s = time.perf_counter() - t0

        out = subprocess.run(
            [sys.executable, "-m", "demodel_tpu_torch.cli", "manifest",
             PULL_MODEL], cwd=Path(__file__).resolve().parent,
            env={**os.environ, "DEMODEL_CACHE_DIR": str(cfg.cache_dir),
                 "DEMODEL_DATA_DIR": str(cfg.data_dir)},
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0 or json.loads(out.stdout) != record:
            raise AssertionError(f"mitm: cli manifest exit "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        served = proxy.metrics()
    finally:
        store.close()
        PeerGossip.reset_shared()
        proxy.stop()
        for s in servers:
            s.shutdown()
            s.server_close()
        _GGUF_BUILT.clear()
    nbytes = sum(len(b) for b in rig.files.values())
    _say("mitm", model=f"{PULL_MODEL} widths, {PULL_LAYERS} layers, f16",
         openssl=pki.openssl_version(), ktls=MITM_KTLS,
         ca_keygen_s=ca_keygen_s,
         first_leaf_mint_s=mints[0][1], mints=len(mints),
         cold_bytes=nbytes, cold_s=cold_s, cold_GBps=nbytes / cold_s / 1e9,
         commit_wait_s=commit_s, warm_hub_requests=sum(hub_warm.values()),
         synth_s=synth_s, proxy_mitm_connects=served.get("mitm"),
         sharded={k: sharded[k] for k in (
             "pull_s", "pull_GBps", "network_bytes", "phase_secs",
             "window_fallbacks", "tokens", "k1_launches_by_kernel")},
         ollama={**ollama, "leg_s": ollama_s},
         k1_launches=k1, dequant_launches={k: v for k, v in
                                           dq_launches.items() if v})
    return k1, dq_launches


# -------------------------------------------------------------- restore

#: node A's stderr line naming its two ports (``cli.py`` ``_cmd_serve``)
NODE_PORTS = re.compile(r"proxy\+peer on [^:]+:(\d+), restore API "
                        r"\+ /metrics on [^:]+:(\d+)")
#: how long node A may take to start, and to stop on SIGINT
NODE_START_S = 120.0
NODE_STOP_S = 30.0
#: the layers the ``orbax_compat`` twin writes to disk and reads back
DCP_FILE_LAYERS = ("model.layers.0.", "model.layers.1.")


def _node_a(cfg) -> tuple[subprocess.Popen, str, str, list[str]]:
    """``python -m demodel_tpu_torch.cli serve --restore-port 0`` over
    ``cfg``'s store, proxy port 0 on 127.0.0.1, kTLS as the mitm phase
    sets it (C5): the child, its proxy and restore URLs, and its stderr
    lines (drained by a thread)."""
    env = {**os.environ, "DEMODEL_CACHE_DIR": str(cfg.cache_dir),
           "DEMODEL_DATA_DIR": str(cfg.data_dir),
           "DEMODEL_PROXY_HOST": "127.0.0.1", "DEMODEL_PROXY_PORT": "0",
           "DEMODEL_PROXY_KTLS": MITM_KTLS}
    child = subprocess.Popen(
        [sys.executable, "-m", "demodel_tpu_torch.cli", "serve",
         "--restore-port", "0"], cwd=Path(__file__).resolve().parent,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    lines: list[str] = []
    seen = threading.Event()

    def drain():
        for line in child.stderr:
            lines.append(line.rstrip())
            if NODE_PORTS.search(line):
                seen.set()
        seen.set()

    threading.Thread(target=drain, daemon=True).start()
    found = seen.wait(NODE_START_S) and next(
        (m for m in map(NODE_PORTS.search, lines) if m), None)
    if not found:
        child.kill()
        child.wait(timeout=NODE_STOP_S)
        raise AssertionError(f"restore: node A did not start: {lines[-20:]}")
    proxy, api = (f"http://127.0.0.1:{p}" for p in found.groups())
    return child, proxy, api, lines


def _get(url: str, timeout: float = 60.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _scrape(url: str) -> dict[str, float]:
    """The unlabeled samples of a ``/metrics`` page."""
    out = {}
    for line in _get(f"{url}/metrics").decode().splitlines():
        parts = line.split()
        if len(parts) == 2 and not line.startswith("#") and "{" not in line:
            out[parts[0]] = float(parts[1])
    return out


def phase_restore(rig: _HubRig, pulled: dict) -> int:
    """The restore node. Node A is the CLI's ``serve`` in a child process
    over the pull phase's store (nothing registered; the model resolves
    from its pull record); node B is a ``RestoreServer`` in this process
    over a fresh store. Gates: A's manifest lists every tensor with its
    native plane as ``data_endpoint``; ``restore`` from A puts every
    tensor on the card equal to the pull phase's, ``bytes_fetched`` the
    tensors' bytes, A's ``demodel_proxy_bytes_cache`` grown by at least
    that; the model built from it (``load_llama_params``, ``serve.boot``)
    answers the pull phase's tokens over B's ``/generate`` with K1 on
    ``wgmma_f16``, while A's ``/generate`` answers 503; ``save_state_dict``
    to B pushes every tensor, a second save none (0 bytes sent), and
    ``dcp.save`` through ``HTTPStorageWriter`` under another name sends
    0 bytes; ``restore`` from B (its Python server) is equal; ``dcp.load``
    through ``HTTPStorageReader`` from A is equal; the ``orbax_compat``
    twin round-trips layers 0-1 on the card; then the obs phase runs on
    node B (:func:`phase_obs`; its archive and trace sink are set before
    B starts); SIGINT stops A with exit 0. Returns the K1 launches of
    both phases.

    The parent holds no handle on the pull phase's store while A runs
    (every earlier phase closed its own); A reads it and writes only its
    pin markers, which its handles remove when they close."""
    import dataclasses
    import signal
    import tempfile

    import torch
    import torch.distributed.checkpoint as dcp

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.models.hf_loader import load_llama_params
    from demodel_tpu_torch.models.llama import LlamaConfig
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.restore.client import restore
    from demodel_tpu_torch.restore.orbax_compat import (load_placement,
                                                        save_placement)
    from demodel_tpu_torch.restore.orbax_http import (HTTPStorageReader,
                                                      HTTPStorageWriter,
                                                      save_state_dict)
    from demodel_tpu_torch.restore.server import (RestoreRegistry,
                                                  RestoreServer)
    from demodel_tpu_torch.sink.hbm import Placement
    from demodel_tpu_torch.store import Store
    from demodel_tpu_torch.utils.env import restore_workers

    want = pulled["placed"]
    tensor_bytes = sum(t.numel() * t.element_size()
                       for t in rig.src.values())
    row: dict = {"workers": restore_workers(), "tensor_bytes": tensor_bytes}
    t0 = time.perf_counter()
    child, proxy, api, lines = _node_a(pulled["cfg"])
    row["node_start_s"] = time.perf_counter() - t0
    # the obs phase's set-up, after A started (A keeps its own env)
    obs = _obs_setup(rig)
    store_b = Store(Path(rig.tmp) / "restore-b" / "proxy")
    node_b = RestoreServer(RestoreRegistry(store_b), host="127.0.0.1").start()
    b_url = f"http://127.0.0.1:{node_b.port}"
    b_stopped: list[bool] = []

    def stop_b() -> None:
        if not b_stopped:
            b_stopped.append(True)
            node_b.stop()

    engine = params = None
    obs_launches = 0
    try:
        if json.loads(_get(f"{api}/restore/models")) != {"models": []}:
            raise AssertionError("restore: node A starts with models")
        manifest = json.loads(_get(f"{api}/restore/{PULL_MODEL}/manifest"))
        if sorted(manifest["tensors"]) != sorted(rig.src) or \
                manifest.get("data_endpoint") != proxy:
            raise AssertionError(f"restore: manifest lists "
                                 f"{len(manifest['tensors'])} tensors, "
                                 f"data_endpoint "
                                 f"{manifest.get('data_endpoint')}")

        # 2. restore onto the card, bytes off A's native plane
        before = _scrape(api)
        torch.cuda.synchronize()
        res = restore(api, PULL_MODEL)
        torch.cuda.synchronize()
        after = _scrape(api)
        native_bytes = after["demodel_proxy_bytes_cache"] - \
            before["demodel_proxy_bytes_cache"]
        unequal = _unequal(res.arrays, want)
        if unequal or res.bytes_fetched != tensor_bytes:
            raise AssertionError(f"restore: tensors differ {unequal[:5]}, "
                                 f"bytes_fetched {res.bytes_fetched}")
        if native_bytes < tensor_bytes or "demodel_store_objects" not in \
                after:
            raise AssertionError(f"restore: native plane served "
                                 f"{native_bytes} bytes of {tensor_bytes}")
        row.update(restore_s=res.secs, restore_GBps=tensor_bytes / res.secs
                   / 1e9, native_bytes=native_bytes,
                   store_objects=after["demodel_store_objects"],
                   tensors_equal=len(res.arrays))

        # 3. serve the restored model; /generate on A has no engine
        config = json.loads(rig.files["config.json"])
        mcfg = dataclasses.replace(LlamaConfig.from_hf(config),
                                   dtype="float16")
        torch.cuda.synchronize()
        _reset_k1()  # the served request's launches only
        t0 = time.perf_counter()
        params = load_llama_params(res.arrays, mcfg, device="cuda")
        engine = serve.boot(params, mcfg, device="cuda", kv_mb=1024,
                            max_new_tokens=PULL_NEW, max_batch=4,
                            queue_limit=8, model=PULL_MODEL)
        tokens = _generate_http(f"{b_url}/generate", pulled["prompt"],
                                PULL_NEW)
        row["build_and_serve_s"] = time.perf_counter() - t0
        by_kernel = dict(fa.launches_by_kernel)
        engine.stop()
        serve.install(None)
        engine = None
        try:
            _post(f"{api}/generate", {"prompt": pulled["prompt"]})
            a_status = 200
        except urllib.error.HTTPError as e:
            a_status = e.code
        launches = sum(by_kernel.values())
        if tokens != pulled["tokens"] or a_status != 503:
            raise AssertionError(f"restore: tokens {tokens} vs the pull "
                                 f"phase's {pulled['tokens']}; node A's "
                                 f"/generate answered {a_status}")
        if launches != PULL_LAYERS or by_kernel["wgmma_f16"] != launches:
            raise AssertionError(f"restore: K1 launches {by_kernel}, "
                                 f"expected {PULL_LAYERS} on wgmma_f16")
        row.update(tokens=tokens, node_a_generate=a_status,
                   k1_launches_by_kernel=by_kernel)

        # 4. save to B, twice, then through DCP; restore from B
        saves = []
        spans = ("save-serialize", "save-digest", "save-push")
        for _ in range(2):
            span0 = {k: _span_s(k) for k in spans}
            t0 = time.perf_counter()
            saves.append(save_state_dict(b_url, PULL_MODEL, res.arrays))
            saves[-1]["secs"] = time.perf_counter() - t0
            saves[-1]["span_s"] = {k: _span_s(k) - span0[k] for k in spans}
        writer = HTTPStorageWriter(b_url, f"{PULL_MODEL}-dcp")
        t0 = time.perf_counter()
        dcp.save(res.arrays, storage_writer=writer, no_dist=True)
        dcp_save_s = time.perf_counter() - t0
        n = len(rig.src)
        if (saves[0]["pushed"], saves[0]["skipped"]) != (n, 0) or (
                saves[1]["pushed"], saves[1]["skipped"],
                saves[1]["sent_bytes"]) != (0, n, 0) or (
                writer.stats["pushed"], writer.stats["sent_bytes"]) != (0, 0):
            raise AssertionError(f"restore: saves {saves}, dcp.save "
                                 f"{writer.stats}")
        res_b = restore(b_url, PULL_MODEL)
        unequal = _unequal(res_b.arrays, want)
        if unequal:
            raise AssertionError(f"restore: node B's tensors differ "
                                 f"{unequal[:5]}")
        row.update(saves=saves, dcp_save_s=dcp_save_s,
                   dcp_save=writer.stats, restore_b_s=res_b.secs,
                   restore_b_GBps=tensor_bytes / res_b.secs / 1e9)
        del res_b

        # 5. dcp.load through A
        sd = {k: torch.empty_like(t) for k, t in res.arrays.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dcp.load(sd, storage_reader=HTTPStorageReader(api, PULL_MODEL),
                 no_dist=True)
        torch.cuda.synchronize()
        row["dcp_load_s"] = time.perf_counter() - t0
        unequal = _unequal(sd, want)
        if unequal:
            raise AssertionError(f"restore: dcp.load differs {unequal[:5]}")
        del sd

        # 6. the orbax_compat twin: DCP files on disk, back to the card
        part = {k: t for k, t in res.arrays.items()
                if k.startswith(DCP_FILE_LAYERS)}
        with tempfile.TemporaryDirectory(dir=rig.tmp) as d:
            t0 = time.perf_counter()
            save_placement(Placement(arrays=part), Path(d) / "ckpt")
            back = load_placement(Path(d) / "ckpt", device="cuda")
            row["dcp_files_s"] = time.perf_counter() - t0
        unequal = _unequal(back.arrays, {k: want[k] for k in part})
        if unequal:
            raise AssertionError(f"restore: orbax_compat twin differs "
                                 f"{unequal[:5]}")
        row["dcp_files_tensors"] = len(back.arrays)
        del back, part, res

        # 7. the observability plane on node B
        obs_launches = phase_obs(b_url, params, mcfg, pulled, obs, stop_b)
        params = None
    finally:
        if engine is not None:
            engine.stop()
            serve.install(None)
        stop_b()
        store_b.close()
        _obs_teardown()
        # 8. SIGINT stops node A
        t0 = time.perf_counter()
        child.send_signal(signal.SIGINT)
        try:
            rc = child.wait(timeout=NODE_STOP_S)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=NODE_STOP_S)
            rc = None
        row["node_stop_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"restore: node A exited {rc} on SIGINT: "
                             f"{lines[-20:]}")
    torch.cuda.empty_cache()
    _say("restore", model=f"{PULL_MODEL} widths, {PULL_LAYERS} layers, f16",
         **row)
    return launches + obs_launches


#: the obs phase's request: a 512-token prompt, 64 new tokens, streamed
OBS_PROMPT = 512
OBS_NEW = 64
#: the tiers the pull phase's 17-token request is timed under, in turns
OBS_TIERS = ("export", "observe", "off", "off", "observe", "export")
#: the client's W3C trace context on that request
OBS_TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
OBS_PARENT = "00f067aa0ba902b7"
#: how long the phase may take, and its restarted node may take to
#: answer for both incarnations
OBS_BUDGET_S = 30.0
OBS_POLL_S = 20.0


def _obs_setup(rig: _HubRig) -> dict:
    """The obs phase's set-up, before node B starts: a telemetry archive
    (``DEMODEL_TELEMETRY_ARCHIVE``) and the export tier with a JSONL
    sink (``trace.enable``), both in a temporary directory."""
    from demodel_tpu_torch.utils import trace

    root = Path(rig.tmp) / "obs"
    root.mkdir()
    obs = {"dir": root, "archive": root / "archive",
           "jsonl": root / "trace.jsonl"}
    os.environ["DEMODEL_TELEMETRY_ARCHIVE"] = str(obs["archive"])
    trace.enable(str(obs["jsonl"]))
    return obs


def _obs_teardown() -> None:
    """Back to the default tier for the later phases: no sink, no
    archive flusher (the sampling profiler stays, as on any node that
    started a restore server)."""
    from demodel_tpu_torch.utils import trace

    os.environ.pop("DEMODEL_TELEMETRY_ARCHIVE", None)
    os.environ.pop("DEMODEL_TRACE", None)
    os.environ.pop("DEMODEL_OBS", None)
    trace.reset()
    retention = sys.modules.get("demodel_tpu_torch.utils.retention")
    if retention is not None and retention.current() is not None:
        retention.current().stop()


class _Stream:
    """One streamed ``/generate`` (NDJSON over chunked HTTP/1.1) read by
    a thread: :meth:`first` waits for the first token, :meth:`finish`
    for the end and returns the tokens."""

    def __init__(self, url: str, prompt: list[int], n: int,
                 headers: dict[str, str]):
        import http.client

        u = urllib.parse.urlsplit(url)
        self.conn = http.client.HTTPConnection(u.hostname, u.port,
                                               timeout=600)
        self.t0 = time.perf_counter()
        self.conn.request("POST", u.path, json.dumps(
            {"prompt": prompt, "max_new_tokens": n, "stream": True}),
            headers={"Content-Type": "application/json", **headers})
        self.resp = self.conn.getresponse()
        if self.resp.status != 200:
            raise AssertionError(f"obs: streamed /generate answered "
                                 f"{self.resp.status}")
        self.tokens: list[int] = []
        self.end: dict | None = None
        self.secs = 0.0
        self._first = threading.Event()
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        try:
            for line in iter(self.resp.readline, b""):
                if not line.strip():
                    continue
                doc = json.loads(line)
                if "token" in doc:
                    self.tokens.append(doc["token"])
                    self._first.set()
                elif doc.get("done"):
                    self.end = doc
                else:
                    raise AssertionError(f"obs: stream line {doc}")
        except BaseException as exc:  # noqa: BLE001 - raised by finish()
            self._errors.append(exc)
        finally:
            self.secs = time.perf_counter() - self.t0
            self._first.set()

    def first(self) -> None:
        if not self._first.wait(600) or self._errors:
            raise AssertionError(f"obs: no first token: {self._errors}")

    def finish(self) -> list[int]:
        self._thread.join(600)
        self.conn.close()
        if self._errors or self.end is None or \
                self.end["tokens"] != self.tokens:
            raise AssertionError(f"obs: stream ended {self.end}, "
                                 f"{self._errors}")
        return self.tokens


def _jsonl_trace(path: Path, trace_id: str, timeout_s: float = 10.0
                 ) -> list[dict]:
    """The JSONL sink's records of ``trace_id`` once the server's root
    span is among them (it finishes just after its response is
    written); complete lines only."""
    deadline = time.monotonic() + timeout_s
    while True:
        text = path.read_text() if path.exists() else ""
        recs = [json.loads(line) for line in text.split("\n")[:-1]]
        mine = [r for r in recs if r["trace"] == trace_id]
        if any(r["name"] == "serve.restore" for r in mine) or \
                time.monotonic() > deadline:
            return mine
        time.sleep(0.05)


def _set_tier(tier: str, jsonl: Path) -> None:
    """Switch this process's observability tier (``off``, ``observe`` or
    ``export`` with its sink at ``jsonl``); the sampling profiler runs in
    the last two only."""
    from demodel_tpu_torch.utils import profiler, trace

    os.environ.pop("DEMODEL_OBS", None)
    os.environ.pop("DEMODEL_TRACE", None)
    trace.reset()
    if tier == "off":
        os.environ["DEMODEL_OBS"] = "0"
        trace.reset()
        profiler.stop()
    elif tier == "export":
        trace.enable(str(jsonl))
    if tier != "off" and profiler.ensure() is None:
        raise AssertionError(f"obs: no profiler under {tier}")


#: a second restore node over the obs archive, in a process of its own:
#: it imports the port, starts its server over the store at ``argv[1]``
#: when a line arrives on stdin, prints its port, and stops at stdin's end
_SECOND_NODE = """
import sys
from demodel_tpu_torch.restore.server import RestoreRegistry, RestoreServer
from demodel_tpu_torch.store import Store

sys.stdin.readline()
store = Store(sys.argv[1])
node = RestoreServer(RestoreRegistry(store), host="127.0.0.1").start()
print(node.port, flush=True)
sys.stdin.read()
node.stop()
store.close()
"""


def phase_obs(b_url: str, params, mcfg, pulled: dict, obs: dict,
              stop_b) -> int:
    """The observability plane on node B (the port's ``RestoreServer``,
    its archive and the export tier on since it started) with the pull
    phase's model booted on the card. A streamed 512-token request with
    64 new tokens carries a W3C ``traceparent``; while it decodes,
    ``/debug/statusz`` shows it running (KV blocks in use, a ``serve.*``
    span in flight, mode ``export``) and ``/debug/profile?seconds=1``
    has stacks rooted at ``serve.*`` spans, with wall and on-CPU samples.
    After it, the JSONL holds the server's root span under the client's
    trace and span ids with ``serve.prefill`` and every
    ``serve.decode-step`` below it; ``dump_chrome`` writes one ``X``
    event a span; ``/debug/telemetry`` counts the prefill and
    ``/debug/telemetry/history`` returns windows. The pull phase's
    17-token request is then served in turns under ``DEMODEL_OBS=0``,
    the default tier and export, its tokens equal to the pull phase's
    every time; K1 runs on ``wgmma_f16``. Then node B stops, a second
    node (another process, its interpreter started with the phase so
    that its imports are not in the restart's time) starts over the same
    archive, and its history reads one series from both pids; a recorder
    dump is complete JSON. The seconds of the streamed request and of
    each timed one, and one statusz scrape's milliseconds, are reported,
    not gated. Returns the K1 launches (all on ``wgmma_f16``)."""
    import tempfile

    t_phase = time.perf_counter()
    second_store = Path(tempfile.mkdtemp(dir=obs["dir"]))
    second = subprocess.Popen(
        [sys.executable, "-c", _SECOND_NODE, str(second_store)],
        cwd=Path(__file__).resolve().parent, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "DEMODEL_TELEMETRY_ARCHIVE": str(obs["archive"]),
             "DEMODEL_TRACE": ""})
    try:
        return _obs_legs(b_url, params, mcfg, pulled, obs, stop_b, second,
                         t_phase)
    finally:
        if second.poll() is None:
            second.kill()
            second.wait(timeout=NODE_STOP_S)


def _obs_legs(b_url: str, params, mcfg, pulled: dict, obs: dict, stop_b,
              second: subprocess.Popen, t_phase: float) -> int:
    """:func:`phase_obs` once its second node's interpreter is starting."""
    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.utils import profiler, retention, trace
    from demodel_tpu_torch.utils.retention import TelemetryArchive

    prompt = _prompt(torch.Generator().manual_seed(31), OBS_PROMPT, VOCAB)
    row: dict = {"prompt": OBS_PROMPT, "new_tokens": OBS_NEW}
    engine = serve.boot(params, mcfg, device="cuda", kv_mb=1024,
                        max_new_tokens=OBS_NEW, max_batch=4, queue_limit=8,
                        model=PULL_MODEL)
    _reset_k1()
    n_requests = 0
    try:
        if trace.mode() != "export" or retention.current() is None \
                or profiler.current() is None:
            raise AssertionError(f"obs: node B runs mode {trace.mode()}, "
                                 f"archive {retention.current()}, "
                                 f"profiler {profiler.current()}")
        # 1. the streamed request, and two reads while it decodes; a
        # history read first (it flushes), so the telemetry ring and the
        # archive hold a snapshot from before it
        json.loads(_get(f"{b_url}/debug/telemetry/history?family=none"))
        stream = _Stream(f"{b_url}/generate", prompt, OBS_NEW, {
            "traceparent": f"00-{OBS_TRACE}-{OBS_PARENT}-01"})
        n_requests += 1
        stream.first()
        # the capture starts at the first token, so its second covers
        # the decode; the statusz scrape runs beside it
        captured: dict = {}
        capture = threading.Thread(target=lambda: captured.update(json.loads(
            _get(f"{b_url}/debug/profile?seconds=1"))))
        capture.start()
        t0 = time.perf_counter()
        statusz = json.loads(_get(f"{b_url}/debug/statusz"))
        row["statusz_scrape_ms"] = (time.perf_counter() - t0) * 1e3
        tokens_at_scrape = len(stream.tokens)
        stream.finish()
        capture.join(60)
        prof = captured
        row.update(stream_s=stream.secs, tokens_at_scrape=tokens_at_scrape)
        gen = statusz["generation"]
        inflight = [s["name"] for s in _flat(statusz["inflight_spans"])]
        if gen.get("running", 0) < 1 or gen["kv"]["in_use_blocks"] < 1 or \
                not any(n.startswith("serve.") for n in inflight) or \
                statusz["trace"]["mode"] != "export":
            raise AssertionError(f"obs: statusz during decode: generation "
                                 f"{gen}, in flight {inflight}, mode "
                                 f"{statusz['trace']['mode']}")
        row["statusz"] = {"running": gen["running"],
                          "kv_in_use_blocks": gen["kv"]["in_use_blocks"],
                          "inflight": sorted(set(inflight)),
                          "sections": len(statusz)}
        # the capture's own handler thread sleeps under serve.restore: the
        # engine thread's decode steps are what show the join
        stacks = prof["stacks"]
        wall = sum(s["wall"] for s in stacks)
        cpu = sum(s["cpu"] for s in stacks)
        roots: dict[str, list[int]] = {}
        for s in stacks:
            acc = roots.setdefault(s["stack"].split(";", 1)[0], [0, 0])
            acc[0] += s["wall"]
            acc[1] += s["cpu"]
        if roots.get("serve.decode-step", [0])[0] < 1 or \
                not 0 < cpu < wall:
            raise AssertionError(f"obs: profile roots {roots}, wall {wall}, "
                                 f"cpu {cpu}, cpu_mode {prof.get('cpu_mode')}"
                                 f"; {row}")
        row["profile"] = {"samples": prof["samples"], "wall": wall,
                          "cpu": cpu, "cpu_mode": prof["cpu_mode"],
                          "by_root": roots}

        row["at_s"] = {"streamed": time.perf_counter() - t_phase}
        # 2. after the request: the trace, Chrome, telemetry, history
        recs = _jsonl_trace(obs["jsonl"], OBS_TRACE)
        root = [r for r in recs if r["name"] == "serve.restore"]
        if len(root) != 1 or root[0]["parent"] != OBS_PARENT:
            raise AssertionError(f"obs: server root spans {root}")
        below = {}
        for r in recs:
            if r["parent"] == root[0]["span"]:
                below[r["name"]] = below.get(r["name"], 0) + 1
        if below.get("serve.prefill") != 1 or \
                below.get("serve.decode-step") != OBS_NEW - 1:
            raise AssertionError(f"obs: under the root span {below}")
        steps = sorted(r["dur"] for r in recs
                       if r["name"] == "serve.decode-step")
        row.update(trace_under_root=below,
                   decode_step_ms={"median": steps[len(steps) // 2] * 1e3,
                                   "max": steps[-1] * 1e3})
        buffered = trace.buffer().snapshot()
        chrome = obs["dir"] / "trace.chrome.json"
        n_events = trace.dump_chrome(str(chrome), buffered)
        with open(chrome) as f:
            events = json.load(f)["traceEvents"]
        n_x = sum(e["ph"] == "X" for e in events)
        if n_x != len(buffered) or len(events) != n_events:
            raise AssertionError(f"obs: chrome {n_x} X events for "
                                 f"{len(buffered)} spans")
        row["chrome"] = {"spans": len(buffered), "events": n_events}
        tele = json.loads(_get(f"{b_url}/debug/telemetry"))
        key = 'stage_duration_seconds{span="serve.prefill"}'
        counts = {w: v["count"] for w, v in
                  tele["windows"]["hist"].get(key, {}).items()}
        if max(counts.values(), default=0) < 1:
            raise AssertionError(f"obs: /debug/telemetry {key} {counts} "
                                 f"over {tele['windows']['snapshots']} "
                                 f"snapshots")
        history = json.loads(_get(
            f"{b_url}/debug/telemetry/history?family=stage_duration_seconds"
            f"&label=span=serve.prefill"))
        if history["records"] < 1 or key not in history["series"]:
            raise AssertionError(f"obs: history {history['records']} "
                                 f"records, {list(history['series'])}")
        row.update(telemetry_prefill_counts=counts,
                   history_records=history["records"])

        row["at_s"]["checked"] = time.perf_counter() - t_phase
        # 3. the pull phase's request under each tier, in turns
        row["request_s"] = {tier: [] for tier in OBS_TIERS}
        for tier in OBS_TIERS:
            _set_tier(tier, obs["jsonl"])
            t0 = time.perf_counter()
            tokens = _generate_http(f"{b_url}/generate", pulled["prompt"],
                                    PULL_NEW)
            row["request_s"][tier].append(time.perf_counter() - t0)
            n_requests += 1
            if tokens != pulled["tokens"]:
                raise AssertionError(f"obs: tokens {tokens} under {tier} vs "
                                     f"the pull phase's {pulled['tokens']}")
        if trace.mode() != "export":
            raise AssertionError(f"obs: back in mode {trace.mode()}")
        by_kernel = dict(fa.launches_by_kernel)
        launches = sum(by_kernel.values())
        if launches != PULL_LAYERS * n_requests or \
                by_kernel["wgmma_f16"] != launches:
            raise AssertionError(f"obs: K1 launches {by_kernel}, expected "
                                 f"{PULL_LAYERS * n_requests} on wgmma_f16")
        row.update(tokens=tokens, k1_launches_by_kernel=by_kernel)
    finally:
        engine.stop()
        serve.install(None)

    row["at_s"]["requests"] = time.perf_counter() - t_phase
    # 4. restart: node B stops, a second node appends to the same archive
    archive = retention.current()
    archive.flush_once()
    stop_b()
    archive.stop()
    t0 = time.perf_counter()
    second.stdin.write("start\n")
    second.stdin.flush()
    api = f"http://127.0.0.1:{int(second.stdout.readline())}"
    row["restart_start_s"] = time.perf_counter() - t0
    key = 'stage_duration_seconds{span="serve.restore"}'
    deadline = time.monotonic() + OBS_POLL_S
    while True:
        _get(f"{api}/restore/models")
        doc = json.loads(_get(
            f"{api}/debug/telemetry/history?family=stage_duration_seconds"
            f"&label=span=serve.restore"))
        pids = {r.get("pid") for r in
                TelemetryArchive(obs["archive"]).records()
                if key in r.get("hists", {})}
        if {os.getpid(), second.pid} <= pids and \
                doc["incarnations"] >= 2 and key in doc["series"]:
            break
        if time.monotonic() > deadline:
            raise AssertionError(
                f"obs: history after the restart: pids {pids} (this "
                f"{os.getpid()}, node {second.pid}), incarnations "
                f"{doc['incarnations']}, {list(doc['series'])}")
        time.sleep(0.25)
    row.update(restart_s=time.perf_counter() - t0,
               history_incarnations=doc["incarnations"],
               history_points=len(doc["series"][key]),
               segments=doc["segments"])
    second.stdin.close()
    rc = second.wait(timeout=NODE_STOP_S)
    if rc != 0:
        raise AssertionError(f"obs: the second node exited {rc}")

    row["at_s"]["restarted"] = time.perf_counter() - t_phase
    # 5. the flight recorder
    path = trace.dump_recorder("smoke", str(obs["dir"] / "recorder.json"))
    with open(path) as f:
        rec = json.load(f)
    if rec.get("kind") != "demodel-flight-recorder" or not rec["spans"] \
            or "profile" not in rec:
        raise AssertionError(f"obs: recorder dump {sorted(rec)}")
    row["recorder"] = {"spans": len(rec["spans"]),
                       "dropped": rec["dropped"],
                       "profile_stacks": len(rec["profile"]["stacks"])}
    row["phase_s"] = time.perf_counter() - t_phase
    row["card"] = _smi()
    _say("obs", **row)
    if row["phase_s"] > OBS_BUDGET_S:
        raise AssertionError(f"obs: {row['phase_s']:.1f} s over "
                             f"{OBS_BUDGET_S} s")
    return launches


def _flat(trees: list[dict]) -> list[dict]:
    """Span trees (``children`` lists) as one flat list."""
    out = []
    for t in trees:
        out.append(t)
        out.extend(_flat(t.get("children", ())))
    return out


def _smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def phase_tiny() -> dict[str, int]:
    """``LlamaConfig.tiny()`` (head dim 8) on the card in f32, bf16 and
    f16. By default it is served through K1 (f32 on the 3xTF32
    kernel, bf16 and f16 on the tensor-core kernel at padded head dim
    64), engine tokens equal to ``generate``; with the caller's explicit
    ``DEMODEL_FLASH_ATTN=0`` on the einsum path, no K1 launch. Sampled
    ``generate`` (temperature 1) draws equal tokens from equal seeded
    CUDA generators, and temperature 0 equals greedy. Returns the K1
    launches by kernel over the default runs."""
    import dataclasses

    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.ops import flash_attention as fa

    def served(params, cfg, prompt) -> tuple[list[int], list[int], dict]:
        want = llama.generate(params, cfg, prompt, PULL_NEW)[0].tolist()
        _reset_k1()  # the engine's launches only
        engine = serve.boot(params, cfg, device="cuda", kv_mb=16,
                            max_new_tokens=PULL_NEW)
        try:
            got = engine.submit(prompt, PULL_NEW).result(timeout=600)
        finally:
            engine.stop()
            serve.install(None)
        return got, want, dict(fa.launches_by_kernel)

    total = {k: 0 for k in K1_BY_DTYPE.values()}
    rows = {}
    for i, (dtype, kernel) in enumerate(K1_BY_DTYPE.items()):
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=dtype)
        params = llama.init_params(torch.Generator("cuda").manual_seed(9 + i),
                                   cfg, "cuda")
        prompt = _prompt(torch.Generator().manual_seed(10), 12,
                         cfg.vocab_size)
        got, want, by_kernel = served(params, cfg, prompt)
        if got != want or by_kernel[kernel] != cfg.num_hidden_layers or \
                sum(by_kernel.values()) != by_kernel[kernel]:
            raise AssertionError(f"tiny {dtype}: K1 launches {by_kernel}, "
                                 f"tokens {got} vs generate {want}")
        total[kernel] += by_kernel[kernel]
        os.environ["DEMODEL_FLASH_ATTN"] = "0"
        try:
            e_got, e_want, e_by = served(params, cfg, prompt)
        finally:
            del os.environ["DEMODEL_FLASH_ATTN"]
        if sum(e_by.values()) != 0 or e_got != e_want:
            raise AssertionError(f"tiny {dtype} on einsum: K1 launches "
                                 f"{e_by}, tokens {e_got} vs {e_want}")
        # sampled decode: equal seeded generators draw equal tokens, and
        # temperature 0 is greedy whatever the generator
        drawn = [llama.generate(params, cfg, prompt, PULL_NEW,
                                temperature=1.0,
                                generator=torch.Generator("cuda")
                                .manual_seed(14))[0].tolist()
                 for _ in range(2)]
        at_zero = llama.generate(
            params, cfg, prompt, PULL_NEW, temperature=0.0,
            generator=torch.Generator("cuda").manual_seed(14))[0].tolist()
        if drawn[0] != drawn[1] or at_zero != want:
            raise AssertionError(f"tiny {dtype} sampled: draws {drawn}, "
                                 f"temperature 0 {at_zero} vs greedy {want}")
        rows[dtype] = {"kernel_tokens": got, "k1_launches": by_kernel[kernel],
                       "einsum_tokens": e_got, "sampled_tokens": drawn[0]}
    _say("tiny", head_dim=llama.LlamaConfig.tiny().head_dim,
         k1_launches=total, runs=rows)
    return total


#: OpenLLaMA-3B's config.json (openlm-research/open_llama_3b and
#: open_llama_3b_v2 on the HuggingFace Hub): head dim 3200 / 32 = 100
OPENLLAMA_3B = {"model_type": "llama", "hidden_size": 3200,
                "intermediate_size": 8640, "num_attention_heads": 32,
                "num_hidden_layers": 26, "rms_norm_eps": 1e-6,
                "vocab_size": 32000, "torch_dtype": "float16"}
OPENLLAMA_PROMPTS = (17, 128, 512, 2048)   # logits held against plain
OPENLLAMA_SERVED = (17, 128, 512)          # served over HTTP
OPENLLAMA_SHARE = (512, 2048)              # K1's share of device time
#: the f32 leg's prefill logits, kernel path vs plain path (both f32),
#: relative L2: K1's f32 output is within F32_TOL (1e-4) of its plain
#: version on O(1) values, the plain path's einsum attention differs from
#: that by summation order only, and 26 layers of seeded weights with RMS
#: norms between them do not grow a relative error tenfold; tighter than
#: the f16 leg's LOGITS_REL_TOL, not loosened from it
F32_LOGITS_REL_TOL = 1e-3
LOGITS_TOL = {"float16": LOGITS_REL_TOL, "float32": F32_LOGITS_REL_TOL}


def phase_openllama(dtype: str, seed: int) -> int:
    """OpenLLaMA-3B's widths at full depth (26 layers, seeded random
    weights: 6.85 GB in f16, 13.7 GB in f32, the stored dtype a pulled
    checkpoint is built in) on the card: prefill logits of the kernel path
    against the plain path at 17, 128, 512 and 2048 tokens, K1's share of
    the 512- and 2048-token prefills' device time, then ``serve.boot`` and
    three prompts over HTTP ``/generate``, first tokens the argmax of
    their kernel-path logits. Returns the engine's K1 launches, all on the
    dtype's kernel (26 per prompt); the weights are freed before it
    returns."""
    import dataclasses

    import numpy as np
    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.serve import http

    cfg = dataclasses.replace(llama.LlamaConfig.from_hf(OPENLLAMA_3B),
                              dtype=dtype)
    kernel, tol = K1_BY_DTYPE[dtype], LOGITS_TOL[dtype]
    if cfg.head_dim != 100:
        raise AssertionError(f"openllama: head dim {cfg.head_dim}")
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator("cuda").manual_seed(seed),
                               cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in (
        params["embed"], params["final_norm"], params["lm_head"],
        *(w for layer in params["layers"] for w in layer.values())))
    pgen = torch.Generator().manual_seed(12)
    prompts = {n: _prompt(pgen, n, cfg.vocab_size) for n in OPENLLAMA_PROMPTS}

    # prefill logits, kernel path vs plain path (comparison only)
    rel_errs, first, share = {}, {}, {}
    with torch.inference_mode():
        for n, p in prompts.items():
            toks = torch.tensor([p], device="cuda")
            got = llama.step_prefill(params, toks, cfg)[0][0].float()
            os.environ["DEMODEL_FLASH_ATTN"] = "0"
            try:
                ref = llama.step_prefill(params, toks, cfg)[0][0].float()
            finally:
                del os.environ["DEMODEL_FLASH_ATTN"]
            rel_errs[n] = ((got - ref).norm() / ref.norm()).item()
            first[n] = int(torch.argmax(got).item())
            if not torch.isfinite(got).all():
                raise AssertionError(f"openllama {dtype}: {n}-token logits "
                                     "not finite")
            del got, ref
        if max(rel_errs.values()) > tol or not all(
                map(np.isfinite, rel_errs.values())):
            raise AssertionError(f"openllama {dtype}: prefill logits kernel "
                                 f"vs plain rel errors {rel_errs} > {tol}")
        # K1's share of a prefill's device time (26 launches)
        for n in OPENLLAMA_SHARE:
            toks = torch.tensor([prompts[n]], device="cuda")
            got = _device_ms(
                lambda: llama.step_prefill(params, toks, cfg),
                {"k1": lambda k: any(s in k for s in K1_KERNELS),
                 "all": lambda k: True},
                counts_ok={"k1": lambda c: sum(c.values())
                           == cfg.num_hidden_layers})
            share[n] = None if got is None else {
                "k1_device_ms": got[0]["k1"], "device_ms": got[0]["all"],
                "k1_share": got[0]["k1"] / got[0]["all"]}

    _reset_k1()  # count the main path's launches only
    engine = serve.boot(params, cfg, device="cuda", kv_mb=1024,
                        max_new_tokens=PULL_NEW, max_batch=4, queue_limit=8)
    server = http.start()
    tokens, prefill_s = {}, {}
    try:
        for n in OPENLLAMA_SERVED:
            before = _span_s("serve.prefill")
            tokens[n] = _generate_http(f"{server.url}/generate", prompts[n],
                                       PULL_NEW)
            prefill_s[n] = _span_s("serve.prefill") - before
    finally:
        engine.stop()
        server.stop()
        serve.install(None)
    by_kernel = dict(fa.launches_by_kernel)
    launches = fa.launches
    want = cfg.num_hidden_layers * len(OPENLLAMA_SERVED)
    if launches != want or by_kernel[kernel] != want:
        raise AssertionError(f"openllama {dtype}: K1 launches {by_kernel}, "
                             f"expected {want} on {kernel}")
    for n, toks in tokens.items():
        if len(toks) != PULL_NEW or toks[0] != first[n]:
            raise AssertionError(f"openllama {dtype}: prompt {n}: tokens "
                                 f"{toks}, kernel-path prefill argmax "
                                 f"{first[n]}")
    _say("openllama", model=f"OpenLLaMA-3B widths, {cfg.num_hidden_layers} "
         f"layers, {dtype}, seeded",
         head_dim=cfg.head_dim, weight_bytes=weight_bytes,
         init_s=round(init_s, 3), logits_rel_err=rel_errs,
         logits_tol=tol, prefill_device=share,
         prompt_lens=list(OPENLLAMA_SERVED), tokens=tokens,
         serve_prefill_s=prefill_s, k1_launches=launches,
         k1_launches_by_kernel=by_kernel)
    del params, engine
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------- families and train


#: the families phase's checkpoints: openai-community/gpt2's and
#: google-bert/bert-base-uncased's published widths, F32, seeded weights
#: under HF tensor names (GPT-2's Conv1D weights [in, out], BERT's
#: nn.Linear weights [out, in], BERT's pooler stored and not read)
GPT2_MODEL = "openai-community/gpt2"
GPT2_HF = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
           "vocab_size": 50257, "n_positions": 1024, "n_ctx": 1024,
           "n_embd": 768, "n_layer": 12, "n_head": 12,
           "layer_norm_epsilon": 1e-5, "activation_function": "gelu_new",
           "torch_dtype": "float32"}
BERT_MODEL = "google-bert/bert-base-uncased"
BERT_HF = {"architectures": ["BertForMaskedLM"], "model_type": "bert",
           "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
           "num_attention_heads": 12, "intermediate_size": 3072,
           "max_position_embeddings": 512, "type_vocab_size": 2,
           "layer_norm_eps": 1e-12, "hidden_act": "gelu",
           "torch_dtype": "float32"}
#: (B, T) of each family's forward: GPT-2 at its full context, BERT at
#: its full 512 positions; BERT's right-padded rows keep these lengths
GPT2_SHAPE, BERT_SHAPE = (2, 1024), (4, 512)
BERT_LENGTHS = (512, 384, 200, 17)
#: kernel path vs plain path (the caller's DEMODEL_FLASH_ATTN=0) of a
#: whole forward: f32 by the largest absolute error over the largest
#: absolute value; bf16 by relative L2, because the plain path's bf16
#: scores put the largest element several bf16 ulps off wherever the
#: kernel is (CPU emulation of K1's bf16 numerics at these shapes, three
#: seeds: BERT 0.017-0.0205 of the largest value, relative L2 0.008-0.010).
#: Not BF16_TOL, the kernel cases' max-abs bound, though of equal value
FAMILY_BF16_REL_L2_TOL = 2e-2
FAMILY_TOL = {"float32": 2e-4, "bfloat16": FAMILY_BF16_REL_L2_TOL}


def _hf_family_files(kind: str, seed: int):
    """A seeded F32 checkpoint at ``kind``'s published widths ("gpt2" or
    "bert"): the source tensors on the card by HF name, and the repo's
    files (config.json, model.safetensors) as bytes."""
    import torch

    from demodel_tpu_torch.formats import safetensors as st

    gen = torch.Generator("cuda").manual_seed(seed)

    def w(*shape, std=None, mean=0.0):
        return mean + torch.randn(shape, generator=gen, device="cuda") * (
            std if std is not None else shape[0] ** -0.5)

    src = {}
    if kind == "gpt2":
        cfg = GPT2_HF
        D = cfg["n_embd"]
        src["wte.weight"] = w(cfg["vocab_size"], D, std=0.02)
        src["wpe.weight"] = w(cfg["n_positions"], D, std=0.01)
        for i in range(cfg["n_layer"]):
            p = f"h.{i}."
            for name, n_in, n_out in (("attn.c_attn", D, 3 * D),
                                      ("attn.c_proj", D, D),
                                      ("mlp.c_fc", D, 4 * D),
                                      ("mlp.c_proj", 4 * D, D)):
                src[p + name + ".weight"] = w(n_in, n_out)
                src[p + name + ".bias"] = w(n_out, std=0.02)
            for ln in ("ln_1", "ln_2"):
                src[p + ln + ".weight"] = w(D, std=0.05, mean=1.0)
                src[p + ln + ".bias"] = w(D, std=0.02)
        src["ln_f.weight"] = w(D, std=0.05, mean=1.0)
        src["ln_f.bias"] = w(D, std=0.02)
    else:
        cfg = BERT_HF
        D, I = cfg["hidden_size"], cfg["intermediate_size"]
        e = "bert.embeddings."
        src[e + "word_embeddings.weight"] = w(cfg["vocab_size"], D, std=0.02)
        src[e + "position_embeddings.weight"] = w(
            cfg["max_position_embeddings"], D, std=0.02)
        src[e + "token_type_embeddings.weight"] = w(
            cfg["type_vocab_size"], D, std=0.02)
        src[e + "LayerNorm.weight"] = w(D, std=0.05, mean=1.0)
        src[e + "LayerNorm.bias"] = w(D, std=0.02)
        for i in range(cfg["num_hidden_layers"]):
            p = f"bert.encoder.layer.{i}."
            for name, n_in, n_out in (("attention.self.query", D, D),
                                      ("attention.self.key", D, D),
                                      ("attention.self.value", D, D),
                                      ("attention.output.dense", D, D),
                                      ("intermediate.dense", D, I),
                                      ("output.dense", I, D)):
                src[p + name + ".weight"] = w(n_out, n_in, std=n_in ** -0.5)
                src[p + name + ".bias"] = w(n_out, std=0.02)
            for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
                src[p + ln + ".weight"] = w(D, std=0.05, mean=1.0)
                src[p + ln + ".bias"] = w(D, std=0.02)
        src["bert.pooler.dense.weight"] = w(D, D)
        src["bert.pooler.dense.bias"] = w(D, std=0.02)
    files = {"config.json": json.dumps(cfg).encode(),
             "model.safetensors": st.serialize(
                 {n: t.cpu() for n, t in src.items()})}
    return src, files


def _rel(got, want) -> dict[str, float]:
    """Largest absolute error over the largest absolute value, and the
    relative L2 error, of ``got`` against ``want``."""
    g, w = got.float(), want.float()
    return {"max_rel": ((g - w).abs().max() / w.abs().max()).item(),
            "rel_l2": ((g - w).norm() / w.norm()).item()}


def _plain_path(fn):
    """``fn()`` on the plain path: the caller's explicit
    ``DEMODEL_FLASH_ATTN=0`` (comparison only)."""
    os.environ["DEMODEL_FLASH_ATTN"] = "0"
    try:
        return fn()
    finally:
        del os.environ["DEMODEL_FLASH_ATTN"]


def _family_forward(name: str, fn, kernel: str | None, dtype: str) -> dict:
    """One family forward on the card: K1's launches by kernel (counts
    reset just before, read just after; ``kernel`` the one every launch
    must be on, 12 of them, or None for none), its seconds (the first
    call's, and a warm call's), K1's share of its device time, and the
    output held against the plain path."""
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        _reset_k1()
        with _k1_plans() as seen:
            got, first_s = timed()
        by_kernel = dict(fa.launches_by_kernel)
        plan = _qkv_plan(seen) if kernel else None
        del seen
        want = _plain_path(fn)
        secs = timed()[1]  # warm
        n = 12 if kernel else 0
        if sum(by_kernel.values()) != n or (kernel and by_kernel[kernel] != n):
            raise AssertionError(f"families {name}: K1 launches {by_kernel}, "
                                 f"expected {n} on {kernel}")
        err = _rel(got, want)
        tol = FAMILY_TOL[dtype]
        metric = "max_rel" if dtype == "float32" else "rel_l2"
        if not (torch.isfinite(got).all() and err[metric] <= tol) or (
                kernel is None and not torch.equal(got, want)):
            raise AssertionError(f"families {name}: kernel vs plain {err} "
                                 f"({metric} tol {tol})")
        share = None
        if kernel:
            dev = _device_ms(fn, {"k1": lambda k: any(s in k for s in
                                                      K1_KERNELS),
                                  "all": lambda k: True},
                             counts_ok={"k1": lambda c: sum(c.values())
                                        == 12})
            if dev is not None:
                share = {"k1_device_ms": dev[0]["k1"],
                         "device_ms": dev[0]["all"],
                         "k1_share": dev[0]["k1"] / dev[0]["all"]}
    return {"dtype": dtype, "shape": list(got.shape), "first_s": first_s,
            "forward_s": secs,
            "k1_launches_by_kernel": by_kernel, "vs_plain": err,
            "tol": {metric: tol}, "device": share, "qkv_plan": plan}


@contextlib.contextmanager
def _k1_plans():
    """K1's launch plans while the block runs, read from the path that
    runs: ``fa.launch_plan``, which every launch calls, wrapped to record
    each plan, and the q, k and v of the first launch."""
    from demodel_tpu_torch.ops import flash_attention as fa

    orig, seen = fa.launch_plan, []

    def record(q, k, v, *args):
        plan = orig(q, k, v, *args)
        seen.append((plan, None if seen else (q, k, v)))
        return plan

    fa.launch_plan = record
    try:
        yield seen
    finally:
        fa.launch_plan = orig


def _qkv_plan(seen: list) -> dict:
    """The launch plan the forward's K1 launches took (one for all of
    them), and the time of the copy it makes before the kernel, on the
    first launch's q, k and v."""
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa

    plans = {plan for plan, _ in seen}
    if len(plans) != 1:
        raise AssertionError(f"families: {len(plans)} K1 launch plans in "
                             f"one forward: {plans}")
    plan, qkv = seen[0]
    copy = fa._pad8 if plan.kernel.startswith("wgmma") else \
        torch.Tensor.contiguous
    copied = [t for t, c in zip(qkv, plan.copy) if c]
    copy_ms = _time_ms(lambda: [copy(t) for t in copied]) if copied else 0.0
    return {"kernel": plan.kernel, "copies": list(plan.copy),
            "maps": list(plan.maps), "copy_ms": copy_ms}


def phase_families() -> dict[str, int]:
    """GPT-2 and BERT at their published widths pulled cold from the
    in-script Hub (F32 checkpoints of seeded weights) through the port's
    store, built by ``model_from_pull`` on the card, and run through K1
    at head dim 64: GPT-2 ``forward`` (causal, B=2, T=1024) and BERT
    ``encode`` (bidirectional, B=4, T=512) in f32 (``tf32x3_f32``), BERT
    with a right-padded mask (the einsum path, no K1 launch), then the
    same in bf16 (``wgmma_bf16``); every output against the plain path.
    Returns the K1 launches by kernel of the forwards."""
    import dataclasses
    import functools
    import shutil
    import tempfile

    import torch

    from demodel_tpu_torch import delivery
    from demodel_tpu_torch.config import ProxyConfig
    from demodel_tpu_torch.models import auto
    from demodel_tpu_torch.parallel import make_mesh
    from demodel_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    src, repos = {}, {}
    for kind, model, seed in (("gpt2", GPT2_MODEL, 51),
                              ("bert", BERT_MODEL, 52)):
        src[kind], repos[model] = _hf_family_files(kind, seed)
    build_s = time.perf_counter() - t0
    handler = _hf_handler(repos)
    hub = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=hub.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{hub.server_port}"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-families-")
    built, pulls = {}, {}
    try:
        for kind, model in (("gpt2", GPT2_MODEL), ("bert", BERT_MODEL)):
            cfg = ProxyConfig(host="127.0.0.1", port=0, no_mitm=True,
                              cache_dir=os.path.join(tmp, kind),
                              data_dir=os.path.join(tmp, "data"))
            t1 = time.perf_counter()
            report, placed = delivery.pull_to_hbm(model, cfg, endpoint=url,
                                                  mesh=make_mesh())
            store = delivery.open_store(cfg)
            try:
                built[kind] = auto.model_from_pull(store, report,
                                                   placement=placed)
            finally:
                store.close()
            torch.cuda.synchronize()
            unequal = [n for n, t in src[kind].items()
                       if not torch.equal(placed.arrays[n], t)]
            if unequal or sorted(placed.arrays) != sorted(src[kind]):
                raise AssertionError(f"families {kind}: placed tensors "
                                     f"differ: {unequal[:5]}")
            pulls[kind] = {"pull_and_build_s": time.perf_counter() - t1,
                           "bytes": len(repos[model]["model.safetensors"]),
                           "tensors": len(placed.arrays),
                           "dtype": built[kind][2].dtype}
            del placed
    finally:
        hub.shutdown()
        hub.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    del src, repos
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(53)
    g_tok = torch.randint(0, GPT2_HF["vocab_size"], GPT2_SHAPE,
                          generator=gen, device="cuda")
    b_tok = torch.randint(0, BERT_HF["vocab_size"], BERT_SHAPE,
                          generator=gen, device="cuda")
    b_types = torch.randint(0, 2, BERT_SHAPE, generator=gen, device="cuda")
    b_mask = (torch.arange(BERT_SHAPE[1], device="cuda")[None]
              < torch.tensor(BERT_LENGTHS, device="cuda")[:, None]).int()
    total = {k: 0 for k in K1_BY_DTYPE.values()}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        kernel = K1_BY_DTYPE[dtype]
        dt = getattr(torch, dtype)
        models = {}
        for kind, (fn, params, mcfg) in built.items():
            if dtype != mcfg.dtype:  # cast the pulled model
                fn = functools.partial(fn.func, cfg=dataclasses.replace(
                    mcfg, dtype=dtype))
                params = tree_map(lambda t: t.to(dt), params)
            models[kind] = (fn, params)
        (g_fn, gp), (b_fn, bp) = models["gpt2"], models["bert"]
        legs = {
            "gpt2": (lambda: g_fn(gp, g_tok), kernel),
            "bert": (lambda: b_fn(bp, b_tok, token_type_ids=b_types), kernel),
            "bert_masked": (lambda: b_fn(bp, b_tok, attention_mask=b_mask,
                                         token_type_ids=b_types), None)}
        for leg, (fn, k) in legs.items():
            row = _family_forward(f"{leg} {dtype}", fn, k, dtype)
            if k:
                total[k] += row["k1_launches_by_kernel"][k]
            runs[f"{leg}_{dtype}"] = row
        del models, gp, bp, legs
        torch.cuda.empty_cache()
    _say("families", models={GPT2_MODEL: "published widths, 12 layers, "
                             "F32, seeded", BERT_MODEL: "published widths, "
                             "12 layers, F32, seeded"},
         checkpoint_build_s=round(build_s, 3), pulls=pulls,
         bert_lengths=list(BERT_LENGTHS), runs=runs, k1_launches=total)
    del built
    torch.cuda.empty_cache()
    return total


#: the train phase: OpenLLaMA-3B's widths (OPENLLAMA_3B) in bf16 at full
#: depth, B=1 and T=512 tokens a step (513 drawn: inputs and targets),
#: TRAIN_STEPS steps; f32 at TRAIN_F32_LAYERS layers, one step
TRAIN_T = 512
TRAIN_STEPS = 3
TRAIN_F32_LAYERS = 4
#: the f32 step against the plain path: loss and every momentum leaf
#: within 1e-4 of the leaf's largest value
TRAIN_F32_TOL = 1e-4
#: the bf16 step against the plain path: the loss within BF16_TOL
#: (relative), the momentum tree within TRAIN_BF16_TREE_TOL by relative
#: L2, and every momentum leaf within TRAIN_BF16_LEAF_TOL by relative L2.
#: bf16 gradients of the q/k projections carry the softmax backward's
#: cancellation: in CPU emulation at these widths two bf16 steps that
#: differ only in rounding the probabilities (K1 against its plain
#: version) put q_proj/k_proj gradients 2.0-2.6% apart (8 layers), the
#: einsum path 2.5-3.2%, and each 1.8-2.1% (relative L2) from the f32
#: gradient (4 layers); a per-leaf 2e-2 bound sits on that floor. The
#: whole tree's norm is dominated by the leaves of largest gradient, so
#: the per-leaf bound is what holds the q/k leaves, which only the
#: softmax backward reaches: a q/k leaf zeroed or wrong reads about 1,
#: and TRAIN_DQ_CONTROL (dq scaled in the backward) must fail it
TRAIN_BF16_TREE_TOL = 5e-2
TRAIN_BF16_LEAF_TOL = 1e-1
#: the gate's control: one more bf16 step with FlashAttention's dq scaled
#: by this factor, which the same gate must refuse (a q_proj leaf then
#: reads about 1 - factor)
TRAIN_DQ_CONTROL = 0.8
#: MoE on the card against the same port code on the CPU, and the GPipe
#: stages against sequential execution: every leaf within 1e-5 of
#: max(1, its largest value)
TRAIN_SMALL_TOL = 1e-5


def _leaf_errors(got, want) -> dict:
    """Momentum trees compared leaf for leaf: the worst largest-error
    ratio and the worst relative L2 over the leaves, each as [value, the
    leaf's index in ``leaves`` order], and the relative L2 of the whole
    tree."""
    from demodel_tpu_torch.utils.tree import leaves

    max_rel, rel_l2, num, den = [], [], 0.0, 0.0
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        d, w = g.float() - w.float(), w.float()
        num += float((d * d).sum())
        den += float((w * w).sum())
        max_rel.append([float(d.abs().max() / w.abs().max()), i])
        rel_l2.append([float(d.norm() / w.norm()), i])
    return {"worst_max_rel": max(max_rel), "worst_rel_l2": max(rel_l2),
            "tree_rel_l2": (num / den) ** 0.5}


@contextlib.contextmanager
def _dq_scaled(factor: float):
    """FlashAttention's backward with its dq scaled by ``factor`` while
    the block runs: the fault the bf16 gate's control injects."""
    from demodel_tpu_torch.ops import flash_attention as fa

    orig = fa.FlashAttention.backward

    def backward(ctx, g_out, g_lse=None):
        dq, *rest = orig(ctx, g_out, g_lse)
        return (dq * factor, *rest)

    fa.FlashAttention.backward = staticmethod(backward)
    try:
        yield
    finally:
        fa.FlashAttention.backward = staticmethod(orig)


def _bf16_step_ok(loss, loss_plain, err: dict) -> bool:
    """The bf16 train gate: step 1's loss and momentum against the plain
    path's (TRAIN_BF16_TREE_TOL, TRAIN_BF16_LEAF_TOL)."""
    loss_err = abs(loss - loss_plain) / abs(loss_plain)
    return (math.isfinite(loss) and loss_err <= BF16_TOL
            and err["tree_rel_l2"] <= TRAIN_BF16_TREE_TOL
            and err["worst_rel_l2"][0] <= TRAIN_BF16_LEAF_TOL)


def _k1_step(step, params, opt, tokens, n_layers: int, kernel: str):
    """One train step with K1's counts reset just before and read just
    after; ``n_layers`` launches, all on ``kernel``. Returns the step's
    outputs and its seconds."""
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    _reset_k1()
    t0 = time.perf_counter()
    out = step(params, opt, tokens)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_kernel = dict(fa.launches_by_kernel)
    if by_kernel[kernel] != n_layers or sum(by_kernel.values()) != n_layers:
        raise AssertionError(f"train: K1 launches {by_kernel} in a step, "
                             f"expected {n_layers} on {kernel}")
    return out, secs


def _graph_memory(params, tokens, cfg) -> dict:
    """One forward and backward of the Llama loss: the tensors autograd
    saves whose last two dims are (T, T) (the attention score tensors a
    backward would hold for every layer at once), and the device bytes
    the forward's graph holds and the backward's peak, over what was
    allocated before."""
    import torch

    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.utils.tree import leaves, tree_map

    T = tokens.shape[1] - 1
    found = []

    def pack(t):
        if t.dim() >= 2 and tuple(t.shape[-2:]) == (T, T):
            found.append(tuple(t.shape))
        return t

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = llama.loss_fn(req, tokens, cfg)
    torch.cuda.synchronize()
    graph = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(loss, leaves(req))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del loss, req, grads
    return {"saved_score_tensors": len(found), "graph_bytes": graph,
            "backward_peak_bytes": peak}


def _train_llama_bf16(tokens) -> tuple[int, dict]:
    """OpenLLaMA-3B's widths in bf16, 26 layers: TRAIN_STEPS momentum-SGD
    steps through K1 (26 launches each, the backward a recompute), step
    1 against the plain path's. Returns the K1 launches and the row."""
    import dataclasses

    import torch

    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.utils.tree import leaves

    cfg = dataclasses.replace(llama.LlamaConfig.from_hf(OPENLLAMA_3B),
                              dtype="bfloat16")
    L = cfg.num_hidden_layers
    params = llama.init_params(torch.Generator("cuda").manual_seed(61), cfg,
                               "cuda")
    init, step = llama.make_train_step(cfg)
    graph = {"k1": _graph_memory(params, tokens, cfg),
             "plain": _plain_path(lambda: _graph_memory(params, tokens,
                                                        cfg))}
    if graph["k1"]["saved_score_tensors"] != 0:
        raise AssertionError(f"train: autograd saves score tensors through "
                             f"K1: {graph['k1']}")
    opt = init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (p1, m1, loss1), step1_s = _k1_step(step, params, opt, tokens, L,
                                        "wgmma_bf16")
    peak1 = torch.cuda.max_memory_allocated() - base
    m_plain, loss_plain = _plain_path(
        lambda: step(params, opt, tokens)[1:])  # new params dropped
    err = _leaf_errors(m1, m_plain)
    loss_err = abs(loss1.item() - loss_plain.item()) / abs(loss_plain.item())
    if not _bf16_step_ok(loss1.item(), loss_plain.item(), err):
        raise AssertionError(f"train bf16: step 1 vs plain: loss "
                             f"{loss1.item()} vs {loss_plain.item()}, "
                             f"momentum {err}")
    with _dq_scaled(TRAIN_DQ_CONTROL):
        m_ctl, loss_ctl = step(params, opt, tokens)[1:]
    control = _leaf_errors(m_ctl, m_plain)
    control["refused"] = not _bf16_step_ok(loss_ctl.item(),
                                           loss_plain.item(), control)
    del opt, params, m_plain, m_ctl
    if not control["refused"]:
        raise AssertionError(f"train bf16: the gate passed a step with dq "
                             f"scaled by {TRAIN_DQ_CONTROL}: {control}")
    losses, secs = [loss1.item()], [step1_s]
    state = (p1, m1)
    del p1, m1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS - 1):
        (p, m, loss), t = _k1_step(step, *state, tokens, L, "wgmma_bf16")
        state = (p, m)
        del p, m
        if not torch.isfinite(loss):
            raise AssertionError(f"train bf16: loss {loss.item()}")
        losses.append(loss.item())
        secs.append(t)
    peak = torch.cuda.max_memory_allocated()
    tree_bytes = sum(t.numel() * t.element_size()
                     for t in leaves(state[0]))
    del state
    torch.cuda.empty_cache()
    steady = secs[1:]
    return L * TRAIN_STEPS, {
        "layers": L, "tokens_per_step": TRAIN_T, "losses": losses,
        "step_s": secs, "tokens_per_s": TRAIN_T * len(steady) / sum(steady),
        "max_memory_allocated": peak, "params_bytes": tree_bytes,
        "step_peak_over_inputs": {"step1": peak1,
                                  "steps_2_on": peak - base},
        "k1_launches_per_step": {"wgmma_bf16": L},
        "graph": graph, "step1_loss_plain": loss_plain.item(),
        "step1_loss_rel_err": loss_err, "step1_momentum_vs_plain": err,
        "dq_control": {"dq_scale": TRAIN_DQ_CONTROL, **control},
        "tol": {"loss": BF16_TOL, "momentum_tree_rel_l2": TRAIN_BF16_TREE_TOL,
                "momentum_leaf_rel_l2": TRAIN_BF16_LEAF_TOL}}


def _train_llama_f32(tokens) -> tuple[int, dict]:
    """The same widths in f32 at TRAIN_F32_LAYERS layers, one step
    through K1 (``tf32x3_f32``) against the plain path's."""
    import dataclasses

    import torch

    from demodel_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.from_hf(OPENLLAMA_3B),
                              num_hidden_layers=TRAIN_F32_LAYERS)
    L = cfg.num_hidden_layers
    params = llama.init_params(torch.Generator("cuda").manual_seed(62), cfg,
                               "cuda")
    init, step = llama.make_train_step(cfg)
    opt = init(params)
    out, secs = _k1_step(step, params, opt, tokens, L, "tf32x3_f32")
    m1, loss1 = out[1:]
    del out
    m_plain, loss_plain = _plain_path(lambda: step(params, opt, tokens)[1:])
    err = _leaf_errors(m1, m_plain)
    loss_err = abs(loss1.item() - loss_plain.item())
    if not (torch.isfinite(loss1) and loss_err <= TRAIN_F32_TOL
            and err["worst_max_rel"][0] <= TRAIN_F32_TOL):
        raise AssertionError(f"train f32: step vs plain: loss "
                             f"{loss1.item()} vs {loss_plain.item()}, "
                             f"momentum {err}")
    del params, opt, m1, m_plain
    torch.cuda.empty_cache()
    return L, {"layers": L, "loss": loss1.item(),
               "loss_plain": loss_plain.item(), "step_s": secs,
               "momentum_vs_plain": err, "tol": TRAIN_F32_TOL}


def _train_moe() -> dict:
    """One MoE step (``MoEConfig.tiny()``) on the card against the same
    port code on the CPU."""
    import torch

    from demodel_tpu_torch.models import moe
    from demodel_tpu_torch.utils.tree import leaves, tree_map

    cfg = moe.MoEConfig.tiny()
    cpu = moe.init_params(torch.Generator().manual_seed(63), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 13),
                        generator=torch.Generator().manual_seed(64))
    init, step = moe.make_train_step(cfg)
    want = step(cpu, init(cpu), tok)
    card = tree_map(lambda t: t.to("cuda"), cpu)
    got = step(card, init(card), tok.to("cuda"))
    torch.cuda.synchronize()
    worst = max(float((g.cpu() - w).abs().max()
                      / max(1.0, float(w.abs().max())))
                for g, w in zip(leaves(got), leaves(want)))
    if not worst <= TRAIN_SMALL_TOL or got[2].device.type != "cuda":
        raise AssertionError(f"train moe: card vs CPU {worst}")
    return {"loss": got[2].item(), "loss_cpu": want[2].item(),
            "max_err": worst, "tol": TRAIN_SMALL_TOL}


def _train_gpipe() -> dict:
    """``pipeline_apply`` forward and gradient on the card at
    tests/test_pipeline.py's sizes (4 stages of 16, 4 microbatches of
    2) against sequential execution of the same stages."""
    import torch

    from demodel_tpu_torch.parallel import pipeline

    gen = torch.Generator("cuda").manual_seed(65)
    dim, n_stages, n_micro = 16, 4, 4

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def rnd(*shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    stages = [{"w": rnd(dim, dim, scale=dim ** -0.5), "b": rnd(dim, scale=0.1)}
              for _ in range(n_stages)]
    x = rnd(n_micro * 2, dim, scale=1.0)
    stacked = {k: v.detach().requires_grad_() for k, v in
               pipeline.stack_stages(stages).items()}
    out = pipeline.pipeline_apply(stage_fn, stacked,
                                  pipeline.microbatch(x, n_micro))
    (out ** 2).mean().backward()
    seq = [{k: v.detach().requires_grad_() for k, v in s.items()}
           for s in stages]
    a = x
    for s in seq:
        a = stage_fn(s, a)
    (a ** 2).mean().backward()
    torch.cuda.synchronize()
    errs = [float((out - a.reshape(out.shape)).detach().abs().max())]
    for k in ("w", "b"):
        want = torch.stack([s[k].grad for s in seq])
        errs.append(float((stacked[k].grad - want).abs().max()))
    if max(errs) > TRAIN_SMALL_TOL:
        raise AssertionError(f"train gpipe: vs sequential {errs}")
    return {"stages": n_stages, "microbatches": n_micro, "dim": dim,
            "max_err": max(errs), "tol": TRAIN_SMALL_TOL}


def phase_train() -> dict[str, int]:
    """The training side on the card: Llama's momentum-SGD step through
    K1 (its forward once a layer, the backward the recompute rule) at
    OpenLLaMA-3B's widths in bf16 (26 layers, 3 steps) and f32 (4
    layers, 1 step), each step 1 against the plain path; one MoE step
    against the same code on the CPU; a GPipe forward and gradient
    against sequential execution. Returns the K1 launches by kernel of
    the K1 steps."""
    import torch

    gen = torch.Generator("cuda").manual_seed(60)
    tokens = torch.randint(0, OPENLLAMA_3B["vocab_size"], (1, TRAIN_T + 1),
                           generator=gen, device="cuda")
    t0 = time.perf_counter()
    n_bf16, bf16 = _train_llama_bf16(tokens)
    n_f32, f32 = _train_llama_f32(tokens)
    row = {"llama_bf16": bf16, "llama_f32": f32, "moe": _train_moe(),
           "gpipe": _train_gpipe()}
    _say("train", model="OpenLLaMA-3B widths, seeded; MoEConfig.tiny(); "
         "GPipe 4x16", phase_s=time.perf_counter() - t0, **row)
    return {"wgmma_bf16": n_bf16, "tf32x3_f32": n_f32}


#: the ring schedule: Llama-2-7B's attention (H=G=32, D=128) and GQA at
#: H=32, G=8; B=1, n ranks, a sequence the ring divides, one it pads, and
#: one whose last block is all padding (kv_len 0 there)
RING_N = 4
RING_T = (4096, 4093, 9)
RING_HEADS = ((32, 32), (32, 8))
RING_D = 128
#: the ring's gradients: n=2 at T=1024 (the JAX package's grad tests run
#: at sp=2 and sp=4)
RING_GRAD_N, RING_GRAD_T = 2, 1024
MESH_LAYERS = 2
MESH_NEW = 8
#: the serving leg of the mesh phase: Llama-2-7B's widths, bf16, 4 layers
#: (2.1 GB), served by GenEngine on the NCCL mesh and with no mesh
MESH_SERVE_LAYERS = 4


class _BytesStore:
    """The store surface the sinks read, over blobs in host memory (a
    ``buffer=`` delivery turns ``ici_complete`` off, a store read does
    not)."""

    def __init__(self, blobs: dict[str, bytes]):
        self.blobs = blobs

    def size(self, key: str) -> int:
        return len(self.blobs[key])

    def pread(self, key: str, length: int, offset: int = 0):
        return memoryview(self.blobs[key])[offset:offset + length]

    def pread_into(self, key: str, out, offset: int = 0) -> int:
        mv = memoryview(out).cast("B")
        src = memoryview(self.blobs[key])[offset:offset + mv.nbytes]
        mv[:len(src)] = src
        return len(src)


def _serve_mix(engine, url: str, prompts) -> list[list[int]]:
    """The slice phase's mix through ``engine`` (installed, served at
    ``url``): request 0 alone, 1 and 2 over ``/generate`` joining its
    running batch, 3 joining it too, then the 512-token one alone over
    ``/generate``; each request's tokens."""
    results: dict[int, list[int]] = {}
    errors: list[BaseException] = []

    def via_http(i: int) -> None:
        try:
            results[i] = _generate_http(url, prompts[i], MAX_NEW)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    r0 = engine.submit(prompts[0], MAX_NEW)
    it = r0.iter_tokens(timeout=600)
    next(it)
    threads = [threading.Thread(target=via_http, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    next(it)
    r3 = engine.submit(prompts[3], MAX_NEW)
    results[0] = r0.result(timeout=600)
    results[3] = r3.result(timeout=600)
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    via_http(4)
    if errors:
        raise errors[0]
    return [results[i] for i in range(len(prompts))]


def _hist(name: str, before: dict) -> tuple[float, int]:
    """``stage_duration_seconds{span=name}``'s (sum, count) since
    ``before`` (a ``HUB.histograms()`` snapshot)."""
    from demodel_tpu_torch.utils.metrics import HUB, labeled

    key = labeled("stage_duration_seconds", span=name)
    now = HUB.histograms().get(key, {"sum": 0.0, "count": 0})
    was = before.get(key, {"sum": 0.0, "count": 0})
    return now["sum"] - was["sum"], now["count"] - was["count"]


def _mesh_engines() -> tuple[dict, dict[str, int]]:
    """GenEngine on the NCCL group's mesh of one and with no mesh, over
    one seeded 7B-width bf16 model, in turns (mesh, none, none, mesh):
    each run serves the slice phase's mix (``serve.boot`` and
    ``/generate``). Gates: every run's tokens equal, K1 once a layer a
    prefill on the mesh engine (counts reset just before each run and
    read just after it), every lease back. Reported: each run's decode
    tokens/s, and on the mesh the plan broadcast's and the verdict's mean
    time against a decode step's. Returns the row and every run's K1
    launches."""
    import torch

    from demodel_tpu_torch import serve
    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.parallel.mesh import make_mesh
    from demodel_tpu_torch.serve import http
    from demodel_tpu_torch.utils.metrics import HUB

    cfg = llama.LlamaConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                            intermediate_size=INTER,
                            num_hidden_layers=MESH_SERVE_LAYERS,
                            dtype="bfloat16")
    params = llama.init_params(torch.Generator("cuda").manual_seed(75), cfg,
                               "cuda")
    pgen = torch.Generator().manual_seed(76)
    prompts = [_prompt(pgen, n, VOCAB) for n in (*PROMPT_LENS, LONG_PROMPT)]
    want = cfg.num_hidden_layers * len(prompts)
    mesh = make_mesh(1)
    runs: list[dict] = []
    launches: dict[str, int] = {}
    for leg in ("mesh", "no_mesh", "no_mesh", "mesh"):
        before = HUB.histograms()
        _reset_k1()
        engine = serve.boot(params, cfg, mesh if leg == "mesh" else None,
                            device="cuda", kv_mb=1024,
                            max_new_tokens=MAX_NEW, max_batch=8,
                            queue_limit=16)
        server = http.start()
        t0 = time.perf_counter()
        try:
            tokens = _serve_mix(engine, f"{server.url}/generate", prompts)
        finally:
            engine.stop()
            server.stop()
            serve.install(None)
        serve_s = time.perf_counter() - t0
        k1 = dict(fa.launches_by_kernel)
        for kernel, n in k1.items():
            launches[kernel] = launches.get(kernel, 0) + n
        decode_s, steps = _hist("serve.decode-step", before)
        decoded = engine.describe()["tokens"]["decode"]
        run = {"leg": leg, "serve_s": serve_s, "tokens": tokens, "k1": k1,
               "k1_launches": fa.launches, "decode_steps": steps,
               "decode_tokens": decoded, "decode_step_s": decode_s,
               "decode_tok_s": decoded / decode_s,
               "kv_in_use_blocks": engine.pool.describe()["in_use_blocks"]}
        if leg == "mesh":
            plan_s, plans = _hist("serve.plan", before)
            verdict_s, verdicts = _hist("serve.verdict", before)
            plan_ms, verdict_ms = 1e3 * plan_s / plans, \
                1e3 * verdict_s / verdicts
            step_ms = 1e3 * decode_s / steps
            run.update(plans=plans, plan_ms_mean=plan_ms, verdicts=verdicts,
                       verdict_ms_mean=verdict_ms,
                       decode_step_ms_mean=step_ms,
                       plan_share_of_decode_step=plan_ms / step_ms,
                       lockstep_share_of_decode_step=(
                           (plan_ms + verdict_ms) / step_ms))
            if fa.launches != want or k1["wgmma_bf16"] != want:
                raise AssertionError(f"mesh engine K1 launches {k1}, "
                                     f"expected {want} on wgmma_bf16")
        runs.append(run)
    if any(r["tokens"] != runs[0]["tokens"] for r in runs):
        raise AssertionError("GenEngine on make_mesh(1) served other tokens "
                             "than with no mesh")
    if any(r["kv_in_use_blocks"] for r in runs) or any(
            len(t) != MAX_NEW for r in runs for t in r["tokens"]):
        raise AssertionError(f"engine runs: {runs}")
    tokens = runs[0]["tokens"]
    for r in runs:
        del r["tokens"]
    del params
    torch.cuda.empty_cache()
    return {"model": f"Llama-2-7B widths, {MESH_SERVE_LAYERS} layers, bf16, "
                     "seeded", "prompt_lens": [len(p) for p in prompts],
            "first_tokens": [t[:4] for t in tokens], "card": _smi(),
            "runs": runs}, launches


def _mesh_world1() -> dict:
    """NCCL at world size 1: the mesh over the group, each collective on
    CUDA tensors, Llama on ``make_mesh(1, sp=1)`` against no mesh,
    GenEngine serving on the group's mesh against no mesh
    (:func:`_mesh_engines`), and placement with and without
    ``ici_complete`` (safetensors) or the mesh (GGUF). Returns the row and
    the K1 launches of the mesh model and the engines."""
    import tempfile

    import torch
    import torch.distributed as dist

    from demodel_tpu_torch.formats import gguf
    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.parallel import collectives as col
    from demodel_tpu_torch.parallel.mesh import GROUP_TIMEOUT, make_mesh
    from demodel_tpu_torch.sink import deliver_gguf, deliver_safetensors

    row: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "rdzv"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                timeout=GROUP_TIMEOUT)
        try:
            mesh = make_mesh()
            if not (mesh.distributed and mesh.device == torch.device(
                    "cuda", 0) and mesh.size == 1):
                raise AssertionError(f"mesh over the group: {mesh}")
            row["backend"] = dist.get_backend(mesh.group("tp"))
            gen = torch.Generator("cuda").manual_seed(70)
            x = torch.randn(8, 64, generator=gen, device="cuda")
            checks = {
                "replicate": col.replicate(x, mesh, ("tp", None)),
                "allgather_axis": col.allgather_axis(x, mesh, "tp"),
                "psum_across": col.psum_across(x, mesh, "dp"),
                "redistribute": col.redistribute(x, mesh, ("tp", None),
                                                 (None, "tp")),
                "fingerprint": col.fingerprint(x, mesh, ("tp", None)),
            }
            want_fp = col.fingerprint(x)
            torch.cuda.synchronize()
            bad = [k for k, v in checks.items() if not torch.equal(
                v, want_fp if k == "fingerprint" else x)]
            if bad:
                raise AssertionError(f"collectives at world size 1: {bad}")
            row["collectives"] = sorted(checks)

            # Llama-2-7B widths, 2 layers, bf16: a mesh of one is the
            # one-device path, bit for bit
            cfg = llama.LlamaConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                                    intermediate_size=INTER,
                                    num_hidden_layers=MESH_LAYERS,
                                    dtype="bfloat16")
            params = llama.init_params(
                torch.Generator("cuda").manual_seed(71), cfg, "cuda")
            one = make_mesh(1, sp=1)
            tokens = torch.tensor([_prompt(torch.Generator().manual_seed(72),
                                           128, VOCAB)], device="cuda")
            with torch.inference_mode():
                plain = llama.forward(params, tokens, cfg)
                _reset_k1()
                on_mesh = llama.forward(params, tokens, cfg, one)
                toks = llama.generate(params, cfg, tokens, MESH_NEW,
                                      mesh=one)
                launches = dict(fa.launches_by_kernel)
                toks_plain = llama.generate(params, cfg, tokens, MESH_NEW)
            if not torch.equal(plain, on_mesh) or \
                    not torch.equal(toks, toks_plain):
                raise AssertionError("Llama on make_mesh(1, sp=1) differs "
                                     "from the one-device path")
            row["llama"] = {"tokens": toks[0].tolist(), "bit_equal": True,
                            "k1": dict(launches)}
            del params, plain, on_mesh
            torch.cuda.empty_cache()

            # GenEngine on the group's mesh against no mesh
            row["serve"], served = _mesh_engines()
            for kernel, n in served.items():
                launches[kernel] = launches.get(kernel, 0) + n

            # placement: ici_complete changes no byte; the GGUF on the
            # group's mesh equals the one without a group
            src, files = _hf_checkpoint(MESH_LAYERS, seed=73)
            del src
            blobs = {k: v for k, v in files.items()
                     if k.endswith(".safetensors")}
            st_store = _BytesStore(blobs)
            for key in blobs:
                a = deliver_safetensors(st_store, key, mesh=mesh,
                                        ici_complete=False)
                b = deliver_safetensors(st_store, key, mesh=mesh,
                                        ici_complete=True)
                if set(a.arrays) != set(b.arrays) or any(
                        not torch.equal(a.arrays[n], b.arrays[n])
                        for n in a.arrays):
                    raise AssertionError(f"ici_complete changed {key}")
            row["ici_complete_tensors"] = sum(
                len(deliver_safetensors(st_store, k, mesh=mesh).arrays)
                for k in blobs)
            buf, _, _ = _build_gguf("q4_k_m", MESH_LAYERS, seed=74)
            grid = deliver_gguf(None, "q4_k_m", mesh=mesh, buffer=buf)
        finally:
            dist.destroy_process_group()
    # the same file with no process group up: the one-device mesh
    plain_g = deliver_gguf(None, "q4_k_m", mesh=make_mesh(), buffer=buf)
    torch.cuda.synchronize()
    if set(grid.arrays) != set(plain_g.arrays) or any(
            not torch.equal(grid.arrays[n], plain_g.arrays[n])
            for n in grid.arrays):
        raise AssertionError("deliver_gguf on the NCCL mesh differs")
    row["gguf_q4_k_m_tensors"] = len(gguf.parse(buf).tensors)
    row["group_destroyed"] = not dist.is_initialized()
    return row, launches


def _ring_schedule(q, k, v, n: int, causal: bool, T: int):
    """Every rank's body of an ``n``-rank ring in this process over
    :func:`local_rotation`: the K1 launches and windows each rank of a
    real ring makes. Returns the whole [B, T, H, D] output."""
    import torch

    from demodel_tpu_torch.ops import ring_attention as ra

    pad = (-T) % n
    blocks = [torch.chunk(torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, pad)), n, dim=1) for t in (q, k, v)]
    outs = [ra.ring_attention(
        blocks[0][my], blocks[1][my], blocks[2][my],
        ra.local_rotation(list(blocks[1]), list(blocks[2]), my), my, n,
        causal=causal, kv_len=T if pad else None, use_flash=True)
        for my in range(n)]
    return torch.cat(outs, dim=1)[:, :T]


def _ring_forward() -> tuple[list[dict], dict[str, int]]:
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa
    from demodel_tpu_torch.ops import ring_attention as ra

    rows, total = [], {k: 0 for k in K1_BY_DTYPE.values()}
    k1 = {"k1": lambda name: any(n in name for n in K1_KERNELS),
          "all": lambda name: True}
    for dtype, kernel in K1_BY_DTYPE.items():
        dt = getattr(torch, dtype)
        for H, G in RING_HEADS:
            for T in RING_T:
                gen = torch.Generator("cuda").manual_seed(80 + T + G)
                q, k, v = (torch.randn(1, T, h, RING_D, generator=gen,
                                       device="cuda").to(dt)
                           for h in (H, G, G))
                for causal in (True, False):
                    _reset_k1()
                    with torch.inference_mode():
                        out = _ring_schedule(q, k, v, RING_N, causal, T)
                    torch.cuda.synchronize()
                    launched = dict(fa.launches_by_kernel)
                    with torch.inference_mode():
                        plain = ra.dense_attention(q.float(), k.float(),
                                                   v.float(), causal=causal)
                    err = (out.float() - plain).abs().max().item()
                    del plain
                    r = {"dtype": dtype, "H": H, "G": G, "T": T,
                         "causal": causal, "n": RING_N,
                         "k1_launches": launched[kernel],
                         "max_abs_err": err, "tol": TOL[dtype]}
                    if (launched[kernel] != RING_N ** 2 or
                            sum(launched.values()) != RING_N ** 2 or
                            not math.isfinite(err) or err > TOL[dtype]):
                        raise AssertionError(f"ring schedule: {r}")
                    total[kernel] += launched[kernel]
                    if T == RING_T[0] and G == H:
                        r.update(_ring_device_ms(q, k, v, causal, T, k1))
                    rows.append(r)
    return rows, total


def _ring_device_ms(q, k, v, causal: bool, T: int, groups) -> dict:
    """Device ms of the ring schedule (K1's and every kernel's) beside K1
    over the whole sequence, from the profiler; reported, never a
    gate."""
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa

    def ring():
        with torch.inference_mode():
            _ring_schedule(q, k, v, RING_N, causal, T)

    def whole():
        with torch.inference_mode():
            fa.flash_attention(q, k, v, causal=causal)

    ring()
    whole()
    got = _device_ms(ring, groups, {"k1": lambda c: sum(c.values())
                                    == RING_N ** 2})
    one = _device_ms(whole, groups, {"k1": lambda c: sum(c.values()) == 1})
    out = {"ring_k1_device_ms": got and got[0]["k1"],
           "ring_device_ms": got and got[0]["all"],
           "whole_k1_device_ms": one and one[0]["k1"]}
    if got and one and one[0]["k1"]:
        out["ring_k1_over_whole"] = got[0]["k1"] / one[0]["k1"]
        out["ring_all_over_whole"] = got[0]["all"] / one[0]["k1"]
    return out


def _ring_grads() -> list[dict]:
    """dq, dk and dv of a loss linear in the output through the ring
    schedule (K1 a step, its recompute backward, the rotation handing
    blocks over in one process) against autograd through the plain
    dense attention in f32 on the same (dtype-rounded) tensors. The
    limit is the dtype's tolerance times the gradient's largest value
    (at least 1): a key every query sees gathers a gradient of ~10 at
    T=1024, where one bf16 ulp is 0.0625."""
    import torch

    from demodel_tpu_torch.ops import flash_attention as fa

    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        gen = torch.Generator("cuda").manual_seed(90)
        H, G, T = 32, 8, RING_GRAD_T
        base = [torch.randn(1, T, h, RING_D, generator=gen, device="cuda")
                .to(dt) for h in (H, G, G)]
        w = torch.randn(1, T, H, RING_D, generator=gen, device="cuda")
        grads = {}
        for path in ("ring", "plain"):
            if path == "ring":
                qkv = [t.detach().clone().requires_grad_() for t in base]
                out = _ring_schedule(*qkv, RING_GRAD_N, True, T)
            else:
                qkv = [t.detach().float().requires_grad_() for t in base]
                out = fa.reference_attention_lse(*qkv, causal=True)[0]
            (out.float() * w).sum().backward()
            grads[path] = [t.grad for t in qkv]
        torch.cuda.synchronize()
        if any(g is None or not torch.isfinite(g.float()).all()
               for g in grads["ring"]):
            raise AssertionError(f"ring grads {dtype}: missing or not "
                                 "finite")
        err, limit = {}, {}
        for n, a, b in zip(("dq", "dk", "dv"), grads["ring"],
                           grads["plain"]):
            err[n] = (a.float() - b).abs().max().item()
            limit[n] = TOL[dtype] * max(1.0, b.abs().max().item())
        r = {"dtype": dtype, "n": RING_GRAD_N, "T": T, "H": H, "G": G,
             "max_abs_err": err, "limit": limit, "tol": TOL[dtype]}
        if any(err[n] > limit[n] for n in err):
            raise AssertionError(f"ring grads: {r}")
        rows.append(r)
    return rows


def phase_mesh() -> dict[str, int]:
    """Multi-device, as far as one card shows it: NCCL at world size 1
    (the mesh, the collectives, Llama on a mesh of one, GenEngine serving
    on it, placement with ``ici_complete``), then the ring's per-rank
    schedule for n ranks in this process (a single-process schedule, not
    multi-GPU) against the plain dense attention, and its gradients.
    Returns the K1 launches by kernel of the mesh model, the engines and
    the ring schedule."""
    t0 = time.perf_counter()
    world1, launches = _mesh_world1()
    rows, total = _ring_forward()
    for kernel, n in launches.items():
        total[kernel] += n
    grads = _ring_grads()
    _say("mesh", world_size_1=world1,
         ring=("single-process schedule of an n-rank ring on one card, "
               "not multi-GPU"), ring_cases=rows, ring_grads=grads,
         k1_launches=total, phase_s=time.perf_counter() - t0)
    return total


def _dequant_entries(rows: dict[str, dict], launches: dict[str, int]
                     ) -> list[dict]:
    """The kernels-line entries of the dequant kernels: q8_0, q4_0, and
    k_quant with one sub-entry per format. k_quant's own numbers are its
    Q4_K instantiation's (the format the Q4_K_M file runs most), its
    launches the sum over the five formats."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "dtype")

    def entry(name: str, fmt: str, replaces: str) -> dict:
        return {"name": name, "route": "cuda",
                "source": "demodel_tpu_torch/csrc/dequant.cu",
                "replaces": replaces, "launches": launches[fmt],
                **{k: rows[fmt][k] for k in keys}}

    k_fmts = [f for f in DEQUANT_FORMATS if f.endswith("_k")]
    k_quant = entry("k_quant", "q4_k", DEQUANT_REPLACES["k_quant"])
    k_quant["launches"] = sum(launches[f] for f in k_fmts)
    k_quant["formats"] = [entry(f, f, DEQUANT_REPLACES["k_quant"])
                          for f in k_fmts]
    return [entry("q8_0", "q8_0", DEQUANT_REPLACES["q8_0"]),
            entry("q4_0", "q4_0", DEQUANT_REPLACES["q4_0"]), k_quant]


def _flash_entries(rows: dict[str, dict], launches: dict[str, int]
                   ) -> list[dict]:
    """The kernels-line entries of K1: the bf16 and f16 ``wgmma`` kernel
    at the 7B prefill (S=512) with its rows at head dims 8, 80, 96, 100
    (OpenLLaMA-3B) and 256 beside (bf16 also GPT-2's and BERT's D=64 at
    12 heads, causal and bidirectional), and the f32 3xTF32 kernel at
    OpenLLaMA-3B's prefill (D=100, S=512; the openllama f32 leg's shape)
    with its rows at head dims 8, 80, 100, 128, 256 and the two D=64
    ones (S=512) beside."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "device_ms_by", "library_device_ms",
            "library_device_ms_by", "shape", "dtype")

    def entry(name: str, row: dict, n: int) -> dict:
        return {"name": name, "route": "cuda",
                "source": "demodel_tpu_torch/csrc/flash_attention.cu",
                "replaces": "demodel_tpu/ops/flash_attention.py:136",
                "launches": n, **{k: row[k] for k in keys}}

    d64 = ("d64_h12_causal", "d64_h12_bidir")  # GPT-2's and BERT's
    out = []
    for name, row, dtype in (("flash_attention", "prefill_s512", "bfloat16"),
                             ("flash_attention_f16", "f16_prefill_s512",
                              "float16")):
        e = entry(name, rows[row], launches[K1_BY_DTYPE[dtype]])
        e["head_dims"] = [{k: rows[n][k] for k in keys} for n in (
            f"d8_{dtype}", f"d80_{dtype}", f"d96_{dtype}",
            f"openllama_s512_{dtype}", f"d256_{dtype}",
            *(f"{c}_{dtype}" for c in d64 if dtype == "bfloat16"))]
        out.append(e)
    e = entry("flash_attention_tf32x3_f32", rows["openllama_s512_float32"],
              launches["tf32x3_f32"])
    e["head_dims"] = [{k: rows[n][k] for k in keys} for n in (
        "d8_float32", "d80_float32", "openllama_s512_float32",
        "f32_d128_s512", "d256_float32", *(f"{c}_float32" for c in d64))]
    out.append(e)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import demodel_tpu_torch  # noqa: F401 - fails outside a checkout

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    phase_grads()
    dq_rows = phase_dequant()
    k1 = {"wgmma_bf16": phase_slice()}
    phase_parity()
    dq_launches = phase_gguf()
    for fmt, n in phase_ollama().items():
        dq_launches[fmt] += n
    rig = _HubRig()
    try:
        k1["wgmma_f16"], pulled = phase_pull(rig)
        k1["wgmma_f16"] += phase_peer(rig, pulled)
        k1["wgmma_f16"] += phase_sharded(rig, pulled)
        k1_mitm, dq_mitm = phase_mitm(rig, pulled)
        k1["wgmma_f16"] += k1_mitm
        k1["wgmma_f16"] += phase_restore(rig, pulled)
        for fmt, n in dq_mitm.items():
            dq_launches[fmt] += n
        del pulled
    finally:
        rig.close()
    del rig
    torch.cuda.empty_cache()
    for kernel, n in phase_tiny().items():
        k1[kernel] = k1.get(kernel, 0) + n
    k1["wgmma_f16"] += phase_openllama("float16", seed=11)
    k1["tf32x3_f32"] += phase_openllama("float32", seed=13)
    for phase in (phase_families, phase_train, phase_mesh):
        for kernel, n in phase().items():
            k1[kernel] += n
    _say("done", total_s=round(time.perf_counter() - t0, 3))
    print(smi, flush=True)
    print(json.dumps({"kernels": [*_flash_entries(rows, k1),
                                  *_dequant_entries(dq_rows, dq_launches)]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
