"""Configuration: ``demodel_tpu/config.py``'s ``ProxyConfig`` — where the
store lives, which CA verifies the upstream, and how the proxy listens
and which hosts it would intercept — with the same defaults.

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


#: the hosts intercepted by default (``host:port``)
DEFAULT_MITM_HOSTS = ["huggingface.co:443"]


@dataclass
class ProxyConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    #: the port's proxy serves peers only, so it requires no_mitm; the
    #: MITM fields below are read by nothing until MITM lands with its
    #: leaf minter (ROADMAP.md A14)
    mitm_all: bool = False
    no_mitm: bool = False
    mitm_hosts: list[str] = field(
        default_factory=lambda: list(DEFAULT_MITM_HOSTS))
    use_ecdsa: bool = False
    cache_enabled: bool = True
    data_dir: Path = field(default_factory=default_data_dir)
    cache_dir: Path = field(default_factory=default_cache_dir)
    #: extra CA bundle for verifying UPSTREAM servers (tests, corp proxies)
    upstream_ca: str | None = None

    def __post_init__(self) -> None:
        self.data_dir = Path(self.data_dir)
        self.cache_dir = Path(self.cache_dir)
