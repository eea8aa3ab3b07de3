"""Registry adapters of the port: the streaming fetcher and the
HuggingFace Hub (``demodel_tpu/registry``)."""
