"""Placement plane of the port: blobs from a store or a host buffer onto
the device (``demodel_tpu/sink``)."""

from demodel_tpu_torch.sink.hbm import (
    Placement,
    deliver_gguf,
    deliver_report_to_hbm,
    deliver_safetensors,
    place_tensor,
)
from demodel_tpu_torch.sink.plan import ShardingPlan

__all__ = ["Placement", "deliver_gguf", "deliver_report_to_hbm",
           "deliver_safetensors", "place_tensor", "ShardingPlan"]
