"""Configuration: ``demodel_tpu/config.py``'s ``ProxyConfig`` — where the
store lives, which CA verifies the upstream, how the proxy listens and
which hosts it intercepts — with the same defaults and the same
``DEMODEL_*`` environment variables (:meth:`ProxyConfig.from_env`).

Paths follow XDG: data (CA material) under
``$XDG_DATA_HOME/demodel-tpu``, cache (the store root) under
``$XDG_CACHE_HOME/demodel-tpu``, the same directories the JAX package
uses, so both packages share one store.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

from demodel_tpu_torch.utils.env import env_bool, env_int


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
    #: which CONNECT authorities the proxy intercepts: none under
    #: ``no_mitm``, else all under ``mitm_all``, else the exact
    #: ``host:port`` entries of ``mitm_hosts``
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

    @classmethod
    def from_env(cls) -> "ProxyConfig":
        """The defaults, overridden by ``DEMODEL_PROXY_{HOST,PORT,
        MITM_ALL,NO_MITM,CA_USE_ECDSA}``, ``DEMODEL_{DATA,CACHE}_DIR`` and
        ``DEMODEL_UPSTREAM_CA``. ``DEMODEL_PROXY_MITM_HOSTS`` unset keeps
        the default hosts, set replaces them (empty clears);
        ``DEMODEL_PROXY_MITM_EXTRA_HOSTS`` always extends."""
        cfg = cls(
            host=os.environ.get("DEMODEL_PROXY_HOST", "0.0.0.0"),
            port=env_int("DEMODEL_PROXY_PORT", 8080),
            mitm_all=env_bool("DEMODEL_PROXY_MITM_ALL", False),
            no_mitm=env_bool("DEMODEL_PROXY_NO_MITM", False),
            use_ecdsa=env_bool("DEMODEL_PROXY_CA_USE_ECDSA", False),
        )
        hosts_env = os.environ.get("DEMODEL_PROXY_MITM_HOSTS")
        if hosts_env is not None:
            cfg.mitm_hosts = [h.strip() for h in hosts_env.split(",")
                              if h.strip()]
        extra = os.environ.get("DEMODEL_PROXY_MITM_EXTRA_HOSTS", "")
        cfg.mitm_hosts += [h.strip() for h in extra.split(",") if h.strip()]
        if "DEMODEL_DATA_DIR" in os.environ:
            cfg.data_dir = Path(os.environ["DEMODEL_DATA_DIR"])
        if "DEMODEL_CACHE_DIR" in os.environ:
            cfg.cache_dir = Path(os.environ["DEMODEL_CACHE_DIR"])
        if "DEMODEL_UPSTREAM_CA" in os.environ:
            cfg.upstream_ca = os.environ["DEMODEL_UPSTREAM_CA"]
        return cfg
