"""Auto dispatch: pulled checkpoint → (forward_fn, params, config), the
Llama branch of ``demodel_tpu/models/auto.py``.

Maps the pulled ``config.json``'s ``model_type`` onto a model family and
returns a ready forward function. Config features this stack does not
implement (rope scaling, sliding windows, attention biases) are refused
rather than silently mis-executed. GPT-2 and BERT come with ROADMAP A8.

One deliberate difference from the reference: the config's ``dtype`` is
the dtype the weights were stored in (a Llama-2 checkpoint: float16), so
the model's prefill cache and the flash kernel run in it. The reference
keeps its float32 default, and its ``step_prefill`` then refuses an F16
checkpoint (``lax.dynamic_update_slice`` of f16 keys into an f32 cache).
"""

from __future__ import annotations

import dataclasses
import functools
import json

from demodel_tpu_torch.models import llama as llama_mod
from demodel_tpu_torch.models.hf_loader import load_llama_params
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("models.auto")

#: config fields whose presence (non-null/non-default) changes numerics in
#: ways this stack does not implement — refuse rather than drift
_UNSUPPORTED = ("rope_scaling", "sliding_window", "attention_bias")
#: families of the JAX package that the port builds later
_LATER = {"gpt2": "ROADMAP A8", "bert": "ROADMAP A8"}


def _check_supported(config: dict) -> None:
    for fld in _UNSUPPORTED:
        v = config.get(fld)
        if v not in (None, False):
            raise ValueError(
                f"config field {fld}={v!r} is not supported by this stack")


def model_from_pull(store, report, mesh=None, placement=None):
    """(forward_fn, params, cfg) from a pulled snapshot, the params on the
    placement's device.

    ``placement`` (a delivered :class:`~demodel_tpu_torch.sink.hbm.Placement`)
    supplies the weights when given; otherwise they are delivered from
    the store now onto ``mesh`` (default: the CUDA device).
    """
    files = report["files"] if isinstance(report, dict) else [
        vars(f) for f in report.files]
    cfg_file = next((f for f in files if f["name"] == "config.json"), None)
    if cfg_file is None:
        raise ValueError("pulled snapshot has no config.json")
    config = json.loads(bytes(store.get(cfg_file["key"])).decode())
    model_type = config.get("model_type")
    if model_type in _LATER:
        raise NotImplementedError(f"model_type {model_type!r} is not ported "
                                  f"yet ({_LATER[model_type]})")
    if model_type != "llama":
        raise ValueError(f"unsupported model_type {model_type!r} "
                         "(supported: llama, gpt2, bert)")
    _check_supported(config)

    if placement is None:
        from demodel_tpu_torch.sink.hbm import deliver_report_to_hbm

        placement = deliver_report_to_hbm(store, report, mesh=mesh)
    weights = placement.arrays
    cfg = llama_mod.LlamaConfig.from_hf(config)
    stored = {str(t.dtype).removeprefix("torch.") for t in weights.values()}
    if len(stored) == 1 and stored <= set(llama_mod._DTYPES):
        cfg = dataclasses.replace(cfg, dtype=stored.pop())
    device = next(iter(weights.values())).device
    params = load_llama_params(weights, cfg, device=device)
    fn = functools.partial(llama_mod.forward, cfg=cfg)
    log.info("auto: built %s from pulled snapshot (%d tensors, %s)",
             model_type, len(weights), cfg.dtype)
    return fn, params, cfg
