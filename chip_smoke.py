#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``demodel_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line:

1. device — the card, its power limit, and TF32 switched off for both
   matmul and cuDNN;
2. build — nvcc builds the flash-attention kernel (csrc/) for sm_90a;
3. kernel — the kernel against its plain PyTorch version on the card at
   the Llama-2-7B prefill shapes and every masking case (GQA, ragged
   decode, a kv_len-0 row, Sq > kv_len, non-causal, f32, return_lse),
   with kernel / plain / SDPA times and the roofline bound;
4. slice — a Llama-2-7B-width model (32 layers, bf16, seeded random
   weights) served by the continuous-batching engine: prefill logits
   kernel vs plain path, five requests (staggered joins, HTTP sync and
   NDJSON stream among them) whose first tokens must equal the argmax of
   their kernel-path prefill logits, kernel launches counted over the
   run, the KV pool back to zero blocks;
5. parity — full width, 2 layers, fp32: engine tokens equal the port's
   sequential ``generate``.

Then the card line from nvidia-smi, a JSON line with the kernels, and
last ``{"ok": true, "device": {...}}``. Any failed phase raises (exit
code 1, no last line); without a CUDA device the script exits 2.
Imports neither jax nor ``demodel_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

#: kernel vs plain version, max abs error on outputs of O(1)-scaled inputs:
#: bf16 output rounding (8-bit mantissa) and summation order; f32 summation
#: order only
BF16_TOL = 2e-2
F32_TOL = 1e-4
#: 7B prefill logits, kernel path vs plain path (dense einsum attention in
#: bf16), relative L2 error: bf16 scores in the plain path round to 8 bits
#: before the softmax and the difference compounds over 32 layers
LOGITS_REL_TOL = 5e-2
#: peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
#: cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
NEG_INF = -1e30

PROMPT_LENS = (17, 128, 64, 96)   # served together, staggered
LONG_PROMPT = 512                 # served alone afterwards
MAX_NEW = 16


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
    import torch

    if os.environ.get("DEMODEL_FLASH_ATTN", "").strip().lower() in (
            "0", "false", "no", "off"):
        raise SystemExit("chip_smoke: DEMODEL_FLASH_ATTN=0 turns the kernel "
                         "off; unset it")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say("device", card=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build() -> None:
    from demodel_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    lib = fa.build_library()
    fa._library()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    _say("build", seconds=round(secs, 3), library=lib.name, ptxas=ptxas)


# --------------------------------------------------------------- phase 3


def _case(name, B, Sq, Sk, H, G, D, dtype, causal=True, kv_len=None,
          offset=None, lse=False, seed=0):
    return dict(name=name, B=B, Sq=Sq, Sk=Sk, H=H, G=G, D=D, dtype=dtype,
                causal=causal, kv_len=kv_len, offset=offset, lse=lse,
                seed=seed)


CASES = [
    _case("prefill_s17", 1, 17, 17, 32, 32, 128, "bfloat16"),
    _case("prefill_s128", 1, 128, 128, 32, 32, 128, "bfloat16"),
    _case("prefill_s512", 1, 512, 512, 32, 32, 128, "bfloat16", lse=True),
    _case("gqa_h32_g8", 1, 256, 256, 32, 8, 128, "bfloat16"),
    _case("ragged_decode", 4, 1, 256, 32, 32, 128, "bfloat16",
          kv_len=[1, 100, 256, 37], offset=[0, 99, 255, 36]),
    _case("kv_len_zero_row", 2, 16, 64, 32, 32, 128, "bfloat16",
          kv_len=[0, 50], lse=True),
    _case("sq_gt_kv_len", 1, 48, 64, 32, 32, 128, "bfloat16", kv_len=20,
          lse=True),
    _case("non_causal", 2, 100, 100, 32, 32, 128, "bfloat16", causal=False),
    _case("f32_prefill", 1, 200, 200, 32, 32, 128, "float32", lse=True),
    _case("f32_d64_gqa_lse", 2, 70, 90, 8, 2, 64, "float32", causal=False,
          lse=True),
]


def _kernel_case(c) -> dict:
    import torch
    import torch.nn.functional as F

    from demodel_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, c["dtype"])
    gen = torch.Generator("cuda").manual_seed(c["seed"])
    B, Sq, Sk, H, G, D = (c[k] for k in ("B", "Sq", "Sk", "H", "G", "D"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, G, D), rnd(B, Sk, G, D)
    kv = (None if c["kv_len"] is None else
          torch.tensor(c["kv_len"], dtype=torch.int32, device="cuda"))
    off = (None if c["offset"] is None else
           torch.tensor(c["offset"], dtype=torch.int32, device="cuda"))
    scale = D ** -0.5

    def kernel():
        return fa.flash_attention(q, k, v, kv_len=kv, causal=c["causal"],
                                  causal_offset=off, return_lse=True)

    kvb, offb = fa._windows(kv, off, B, Sq, Sk, q.device)

    def plain():
        return fa._flash_plain(q, k, v, kvb, offb, c["causal"], scale)

    got, got_lse = kernel()
    want, want_lse = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if c["dtype"] == "bfloat16" else F32_TOL
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
    ms = _time_ms(lambda: fa.flash_attention(
        q, k, v, kv_len=kv, causal=c["causal"], causal_offset=off,
        return_lse=c["lse"]))
    plain_ms = _time_ms(plain)
    lib_ms = None
    if c["kv_len"] is None and c["offset"] is None and (
            not c["causal"] or Sq == Sk):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = {"enable_gqa": True} if G != H else {}
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=c["causal"], **gqa))
    # work this run's data needs: 4·D flops per visible (query, key) pair
    # per head; bytes of q, k, v read once and o (+ lse) written once
    pairs = int(fa._mask(kvb, offb, Sq, Sk, c["causal"]).sum().item()) * H
    flops = 4 * D * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    if c["lse"]:
        nbytes += got_lse.numel() * 4
    t_ops = flops / PEAK_FLOPS[c["dtype"]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"case": c["name"], "shape": [B, Sq, Sk, H, G, D],
            "dtype": c["dtype"], "causal": c["causal"],
            "max_abs_err": err, "lse_err": lse_err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def phase_kernel() -> dict:
    rows = [_kernel_case(c) for c in CASES]
    for r in rows:
        _say("kernel", **r)
    return next(r for r in rows if r["case"] == "prefill_s512")


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
    in_use = engine.pool.describe()["in_use_blocks"]
    if in_use != 0:
        raise AssertionError(f"KV pool still holds {in_use} blocks")
    _say("slice", model="Llama-2-7B widths, 32 layers, bf16, seeded",
         init_s=round(init_s, 3), requests=len(prompts),
         prompt_lens=[len(p) for p in prompts],
         logits_rel_err=rel_errs, logits_tol=LOGITS_REL_TOL,
         flash_launches=launches, serve_s=round(serve_s, 3),
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
    k512 = phase_kernel()
    launches = phase_slice()
    phase_parity()
    _say("done", total_s=round(time.perf_counter() - t0, 3))
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "demodel_tpu_torch/csrc/flash_attention.cu",
        "replaces": "demodel_tpu/ops/flash_attention.py:136",
        "launches": launches,
        "max_abs_err": k512["max_abs_err"],
        "ms": k512["ms"],
        "plain_ms": k512["plain_ms"],
        "bound_ms": k512["bound_ms"],
        "bound_by": k512["bound_by"],
        "library_ms": k512["library_ms"],
        "shape": k512["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
