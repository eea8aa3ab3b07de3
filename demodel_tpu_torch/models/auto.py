"""Auto dispatch: pulled checkpoint → (forward_fn, params, config), the
port of ``demodel_tpu/models/auto.py``.

Maps the pulled ``config.json``'s ``model_type`` onto a model family
(Llama, GPT-2, BERT) and returns a ready forward function (BERT's is
``encode``). Config features this stack does not implement (rope
scaling, sliding windows, attention biases) are refused rather than
silently mis-executed.

One deliberate difference from the reference: the config's ``dtype`` is
the dtype the weights were stored in (a Llama-2 checkpoint: float16;
GPT-2 and BERT as stored too), so the model, its prefill cache and the
flash kernel run in it. The reference keeps its float32 default, and its
``step_prefill`` then refuses an F16 checkpoint (``lax.dynamic_update_slice``
of f16 keys into an f32 cache).
"""

from __future__ import annotations

import dataclasses
import functools
import json

from demodel_tpu_torch.models import bert as bert_mod
from demodel_tpu_torch.models import gpt2 as gpt2_mod
from demodel_tpu_torch.models import llama as llama_mod
from demodel_tpu_torch.models.common import DTYPES
from demodel_tpu_torch.parallel.mesh import one_device
from demodel_tpu_torch.models.hf_loader import (
    load_bert_params,
    load_gpt2_params,
    load_llama_params,
)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("models.auto")

#: config fields whose presence (non-null/non-default) changes numerics in
#: ways this stack does not implement — refuse rather than drift
_UNSUPPORTED = ("rope_scaling", "sliding_window", "attention_bias")
#: model_type → (config class, loader, the function a caller runs)
_FAMILIES = {
    "llama": (llama_mod.LlamaConfig, load_llama_params, llama_mod.forward),
    "gpt2": (gpt2_mod.GPT2Config, load_gpt2_params, gpt2_mod.forward),
    "bert": (bert_mod.BertConfig, load_bert_params, bert_mod.encode),
}


def _check_supported(config: dict) -> None:
    for fld in _UNSUPPORTED:
        v = config.get(fld)
        if v not in (None, False):
            raise ValueError(
                f"config field {fld}={v!r} is not supported by this stack")


def model_from_pull(store, report, mesh=None, placement=None):
    """(forward_fn, params, cfg) from a pulled snapshot, the params on the
    placement's device; for BERT the function is ``encode``.

    ``placement`` (a delivered :class:`~demodel_tpu_torch.sink.hbm.Placement`)
    supplies the weights when given; otherwise they are delivered from
    the store now onto ``mesh`` (default: the CUDA device). Over a mesh
    of several ranks (Llama only; GPT-2 and BERT are ROADMAP A7's part
    two) the params are this rank's shards under ``param_shardings`` and
    the function runs on the mesh.
    """
    files = report["files"] if isinstance(report, dict) else [
        vars(f) for f in report.files]
    cfg_file = next((f for f in files if f["name"] == "config.json"), None)
    if cfg_file is None:
        raise ValueError("pulled snapshot has no config.json")
    config = json.loads(bytes(store.get(cfg_file["key"])).decode())
    model_type = config.get("model_type")
    if model_type not in _FAMILIES:
        raise ValueError(f"unsupported model_type {model_type!r} "
                         "(supported: llama, gpt2, bert)")
    _check_supported(config)

    if placement is None:
        from demodel_tpu_torch.sink.hbm import deliver_report_to_hbm

        placement = deliver_report_to_hbm(store, report, mesh=mesh)
    weights = placement.arrays
    cfg_cls, load, run = _FAMILIES[model_type]
    cfg = cfg_cls.from_hf(config)
    stored = {str(t.dtype).removeprefix("torch.") for t in weights.values()}
    if len(stored) == 1 and stored <= set(DTYPES):
        cfg = dataclasses.replace(cfg, dtype=stored.pop())
    device = next(iter(weights.values())).device
    if model_type == "llama":
        params = load(weights, cfg, device=device, mesh=mesh,
                      specs=placement.specs)
    else:
        if mesh is not None:
            one_device(mesh, f"{model_type} from a pull")
        params = load(weights, cfg, device=device)
    fn = functools.partial(run, cfg=cfg, mesh=mesh)
    log.info("auto: built %s from pulled snapshot (%d tensors, %s)",
             model_type, len(weights), cfg.dtype)
    return fn, params, cfg
