"""Restore plane of the port (``demodel_tpu/restore``): so far the swarm's
serve surface only (:mod:`demodel_tpu_torch.restore.server`)."""
