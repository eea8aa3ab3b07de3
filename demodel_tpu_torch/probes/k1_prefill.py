"""Time K1 and an OpenLLaMA-3B-width prefill on the card, so that two
checkouts can be compared in one call.

Run from a checkout's root on a machine with one NVIDIA H100:

    python3 -m demodel_tpu_torch.probes.k1_prefill

It uses only what every port checkout since K1 took every head dim
has (``flash_attention``, ``launch_plan``, ``_flash_plain``,
``LlamaConfig``, ``init_params``, ``step_prefill``) and
:mod:`~demodel_tpu_torch.probes.device_time`, the device-time rule
``chip_smoke.py`` reads too, so this file and that one can be copied
into an older checkout's ``probes/`` and run there. It prints
one JSON line: the card and its power limit; the build log's ptxas
warnings; for each K1 case (B=1, causal; bf16, f16 or f32) the kernel
its plan picks, the max abs error against ``_flash_plain``, and K1's and
all kernels' device ms per call (torch.profiler over 20 calls after a
warm-up); and for a prefill of 512 and of 2048 tokens through
OpenLLaMA-3B's widths (hidden 3200, 32 heads of 100, 26 layers,
intermediate 8640, f16, seeded random weights) the ms per prefill (CUDA
events, mean of 5) and K1's and all kernels' device ms per prefill.
Where the checkout reads packed
heads through the row map, the D=100 cases and the prefills run a second
time with that map turned off (``pad``: q, k and v copied with their
head dim padded to 104), so the two designs are compared in one run. A
device time is null where every trace lost launched work.
"""

from __future__ import annotations

import json
import subprocess
import sys

#: (name, D, H, G, dtype name, S)
CASES = (("d64_bf16", 64, 32, 32, "bfloat16", 512),
         ("d128_bf16", 128, 32, 32, "bfloat16", 512),
         ("d128_f16", 128, 32, 32, "float16", 512),
         ("d128_bf16_s2048", 128, 32, 32, "bfloat16", 2048),
         ("d128_f16_s2048", 128, 32, 32, "float16", 2048),
         ("d80_bf16", 80, 32, 8, "bfloat16", 512),
         ("d96_bf16", 96, 32, 8, "bfloat16", 512),
         ("d256_bf16", 256, 32, 8, "bfloat16", 512),
         ("d100_f16", 100, 32, 32, "float16", 512),
         ("d100_f16_s2048", 100, 32, 32, "float16", 2048),
         ("d80_f32", 80, 32, 8, "float32", 512),
         ("d100_f32", 100, 32, 32, "float32", 512),
         ("d128_f32", 128, 32, 32, "float32", 512),
         ("d256_f32", 256, 32, 8, "float32", 512),
         ("d128_f32_s2048", 128, 32, 32, "float32", 2048))
#: OpenLLaMA-3B's config.json (openlm-research/open_llama_3b)
OPENLLAMA_3B = {"hidden_size": 3200, "intermediate_size": 8640,
                "num_attention_heads": 32, "num_hidden_layers": 26,
                "rms_norm_eps": 1e-6, "vocab_size": 32000}
PREFILL_LENS = (512, 2048)
ITERS = 20


def _pad_only(fa):
    """A context that turns the row map off (every packed-head tensor
    takes the padded copy), or None where the checkout has no row map."""
    import contextlib

    if not hasattr(fa, "tma_map"):
        return None
    real = fa.tma_map

    @contextlib.contextmanager
    def ctx():
        fa.tma_map = lambda t: None if real(t) == "rows" else real(t)
        try:
            yield
        finally:
            fa.tma_map = real
    return ctx


def _per_call(run, n: int) -> dict:
    """K1's and all kernels' device ms during ``run()``, which launches
    K1 ``n`` times."""
    from demodel_tpu_torch.probes import device_time

    got = device_time.device_ms(run, {"k1": lambda k: "flash_fwd" in k,
                                      "all": lambda k: True},
                                counts_ok={"k1": device_time.every_call(n)})
    if got is None:
        return {"k1_device_ms": None, "device_ms": None}
    return {"k1_device_ms": got[0]["k1"], "device_ms": got[0]["all"]}


def main() -> int:
    import contextlib
    import dataclasses

    import torch

    from demodel_tpu_torch.models import llama
    from demodel_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("k1_prefill: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log = fa.build_library().with_suffix(".log").read_text()
    out: dict = {"card": card, "cases": {}, "prefill": {},
                 "ptxas_warnings": [ln.strip() for ln in log.splitlines()
                                    if "warning" in ln.lower()]}
    pad = _pad_only(fa)
    variants = {"": contextlib.nullcontext}
    if pad is not None:
        variants["_pad"] = pad
    gen = torch.Generator("cuda").manual_seed(0)
    for name, D, H, G, dtype, S in CASES:
        dt = getattr(torch, dtype)
        q = torch.randn(1, S, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(1, S, G, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(1, S, G, D, generator=gen, device="cuda").to(dt)
        kvb, offb = fa._windows(S, None, 1, S, S, q.device)
        want, _ = fa._flash_plain(q, k, v, kvb, offb, True, D ** -0.5)
        rows = "rows" in getattr(fa.launch_plan(q, k, v, kv_len=S), "maps",
                                 ())
        for suffix, ctx in variants.items():
            if suffix and not rows:
                continue
            with ctx():
                plan = fa.launch_plan(q, k, v, kv_len=S)
                got = fa.flash_attention(q, k, v, kv_len=S)
                torch.cuda.synchronize()
                ms = _per_call(lambda: [fa.flash_attention(q, k, v, kv_len=S)
                                        for _ in range(ITERS)], ITERS)
            out["cases"][name + suffix] = {
                "kernel": plan.kernel, "maps": getattr(plan, "maps", None),
                "copy": plan.copy,
                "max_abs_err": (got.float() - want.float()).abs().max()
                .item(),
                **{key: None if x is None else x / ITERS
                   for key, x in ms.items()}}

    cfg = dataclasses.replace(llama.LlamaConfig.from_hf(OPENLLAMA_3B),
                              dtype="float16")
    params = llama.init_params(torch.Generator("cuda").manual_seed(11), cfg,
                               "cuda")
    with torch.inference_mode():
        for n in PREFILL_LENS:
            toks = torch.randint(0, cfg.vocab_size, (1, n), device="cuda",
                                 generator=gen)

            def prefill():
                return llama.step_prefill(params, toks, cfg)

            for suffix, ctx in variants.items():
                with ctx():
                    prefill()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        prefill()
                    end.record()
                    torch.cuda.synchronize()
                    ms = _per_call(prefill, cfg.num_hidden_layers)
                out["prefill"][f"{n}{suffix}"] = {
                    "ms": start.elapsed_time(end) / 5, **ms}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
