"""Placement plane of the port: blobs from a store, a host buffer or warm
peers onto the device (``demodel_tpu/sink``)."""

from demodel_tpu_torch.sink.hbm import (
    Placement,
    deliver_gguf,
    deliver_report_to_hbm,
    deliver_safetensors,
    place_tensor,
)
from demodel_tpu_torch.sink.plan import ShardingPlan
from demodel_tpu_torch.sink.remote import PeerBlobReader, pull_manifest_to_hbm

__all__ = ["Placement", "deliver_gguf", "deliver_report_to_hbm",
           "deliver_safetensors", "place_tensor", "ShardingPlan",
           "PeerBlobReader", "pull_manifest_to_hbm"]
