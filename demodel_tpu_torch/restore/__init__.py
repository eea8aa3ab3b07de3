"""Restore plane of the port (``demodel_tpu/restore``): the node's
``/restore`` server and registry (:mod:`~.server`), network restore onto
the device (:mod:`~.client`), DCP over the node (:mod:`~.orbax_http`) and
DCP files on disk (:mod:`~.orbax_compat`)."""
