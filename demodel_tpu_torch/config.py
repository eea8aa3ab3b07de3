"""Configuration: the part of ``demodel_tpu/config.py``'s ``ProxyConfig``
that delivery reads — where the store lives and which CA verifies the
upstream.

Paths follow XDG: data (CA material) under
``$XDG_DATA_HOME/demodel-tpu``, cache (the store root) under
``$XDG_CACHE_HOME/demodel-tpu``, the same directories the JAX package
uses, so both packages share one store.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path


def xdg_data_home() -> Path:
    return Path(os.environ.get("XDG_DATA_HOME",
                               Path.home() / ".local" / "share"))


def xdg_cache_home() -> Path:
    return Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache"))


def default_data_dir() -> Path:
    return xdg_data_home() / "demodel-tpu"


def default_cache_dir() -> Path:
    return xdg_cache_home() / "demodel-tpu"


@dataclass
class ProxyConfig:
    data_dir: Path = field(default_factory=default_data_dir)
    cache_dir: Path = field(default_factory=default_cache_dir)
    #: extra CA bundle for verifying UPSTREAM servers (tests, corp proxies)
    upstream_ca: str | None = None

    def __post_init__(self) -> None:
        self.data_dir = Path(self.data_dir)
        self.cache_dir = Path(self.cache_dir)
