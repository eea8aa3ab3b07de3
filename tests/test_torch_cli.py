"""The port's proxy-side CLI (``demodel_tpu_torch/cli.py``) and
``ProxyConfig.from_env``, against ``demodel_tpu``'s, on the CPU.

Everything runs under ``tmp_path``: the CA through ``DEMODEL_DATA_DIR``,
the store through ``DEMODEL_CACHE_DIR``, the trust store through
``DEMODEL_TRUST_DIR``, and ``PATH`` pointed at a directory of stand-in
tools (or none), so no command reaches the system's trust stores.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from demodel_tpu import cli as jcli
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu_torch import cli as tcli
from demodel_tpu_torch import native
from demodel_tpu_torch import pki as tpki
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.store import Store as TStore

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """The CLI's directories under ``tmp_path``, an empty ``PATH`` (no
    ``update-ca-certificates``, no ``openssl``) and P-256 CAs. The store
    library is built first: its compiler needs the real ``PATH``."""
    native.lib()
    for var in list(os.environ):
        if var.startswith("DEMODEL_"):
            monkeypatch.delenv(var)
    monkeypatch.setenv("DEMODEL_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("DEMODEL_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("DEMODEL_TRUST_DIR", str(tmp_path / "trust"))
    monkeypatch.setenv("DEMODEL_PROXY_CA_USE_ECDSA", "1")
    (tmp_path / "bin").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    return tmp_path


def test_init_then_export_ca(env, capsys):
    """``init`` mints the CA once and writes it to the trust directory
    (no ``update-ca-certificates``: a warning, exit 0); ``export-ca``
    prints it, and the reference's ``export-ca`` prints the same PEM."""
    assert tcli.main(["export-ca"]) == 1
    assert "init" in capsys.readouterr().err
    assert tcli.main(["init"]) == 0
    err = capsys.readouterr().err
    assert "CA ready" in err and "update-ca-certificates not found" in err
    cert_path, key_path = tpki.ca_paths(env / "data")
    pem = cert_path.read_bytes()
    assert (env / "trust" / "demodel-tpu-ca.crt").read_bytes() == pem
    assert tcli.main(["init"]) == 0  # loads, does not mint again
    assert cert_path.read_bytes() == pem
    capsys.readouterr()
    assert tcli.main(["export-ca"]) == 0
    assert capsys.readouterr().out.encode() == pem
    assert jcli.main(["export-ca"]) == 0
    assert capsys.readouterr().out.encode() == pem
    assert b"BEGIN PRIVATE KEY" in key_path.read_bytes()


def test_init_with_an_unwritable_trust_dir_warns(env, monkeypatch, capsys):
    blocker = env / "trust-file"
    blocker.write_bytes(b"")
    monkeypatch.setenv("DEMODEL_TRUST_DIR", str(blocker / "sub"))
    assert tcli.main(["init"]) == 0
    assert "cannot write" in capsys.readouterr().err
    assert tpki.ca_paths(env / "data")[0].exists()


def test_export_ca_presets(env, monkeypatch, capsys):
    """``python-ssl`` into the capath ``ssl`` reports, ``python-certifi``
    appended once to the bundle beside the package (skipped quietly where
    certifi is absent), ``openssl`` into OPENSSLDIR's certs with the
    subject-hash link (a stand-in ``openssl`` on ``PATH``)."""
    assert tcli.main(["init"]) == 0
    pem = tpki.ca_paths(env / "data")[0].read_bytes()
    capath = env / "capath"
    monkeypatch.setattr(tcli.ssl, "get_default_verify_paths",
                        lambda: SimpleNamespace(capath=str(capath),
                                                cafile=None))
    certifi = env / "certifi"
    certifi.mkdir()
    (certifi / "cacert.pem").write_bytes(b"# roots\n")
    specs = {"certifi": SimpleNamespace(origin=str(certifi / "__init__.py"))}
    monkeypatch.setattr(tcli.importlib.util, "find_spec", specs.get)
    fake = env / "bin" / "openssl"
    fake.write_text("#!/bin/sh\n"
                    f"if [ \"$1\" = version ]; then echo 'OPENSSLDIR: "
                    f"\"{env / 'ssl'}\"'; else echo 0badc0de; fi\n")
    fake.chmod(0o755)
    capsys.readouterr()
    for _ in range(2):
        assert tcli.main(["export-ca", "--for", "python-ssl", "--for",
                          "python-certifi", "--for", "openssl"]) == 0
    err = capsys.readouterr().err
    assert (capath / "demodel-ca.crt").read_bytes() == pem
    assert (certifi / "cacert.pem").read_bytes() == b"# roots\n\n" + pem
    assert "already present" in err
    certs = env / "ssl" / "certs"
    assert (certs / "demodel-ca.crt").read_bytes() == pem
    assert os.readlink(certs / "0badc0de.0") == "demodel-ca.crt"
    specs.clear()
    assert tcli.main(["export-ca", "--for", "python-certifi"]) == 0
    assert "certifi not installed" in capsys.readouterr().err


def _warm(cache: Path) -> bytes:
    """A store as a client would leave it for ``org/m``: one public
    weight file under its resolve URI."""
    body = b"\x00" * 64
    with TStore(cache / "proxy") as s:
        s.put("publicentry00001", body, {
            "uri": "https://hub/org/m/resolve/main/model.safetensors",
            "status": 200, "sha256": hashlib.sha256(body).hexdigest()})
    return body


def test_manifest(env, monkeypatch, capsys):
    """exit 1 with the message when nothing is cached or only gated
    weights are; exit 0 with the reference's record otherwise."""
    assert tcli.main(["manifest", "org/m"]) == 1
    assert "was the model pulled through this proxy" in \
        capsys.readouterr().err
    body = _warm(env / "cache")
    shutil.copytree(env / "cache", env / "jcache")
    assert tcli.main(["manifest", "org/m"]) == 0
    record = json.loads(capsys.readouterr().out)
    monkeypatch.setenv("DEMODEL_CACHE_DIR", str(env / "jcache"))
    assert jcli.main(["manifest", "org/m"]) == 0
    assert json.loads(capsys.readouterr().out) == record
    assert [(f["name"], f["size"]) for f in record["files"]] == [
        ("model.safetensors", len(body))]
    with TStore(env / "jcache" / "proxy") as s:
        s.put("gatedweight00001", body, {
            "uri": "https://hub/org/g/resolve/main/model.safetensors",
            "status": 200, "auth_scope": "deadbeef00000000",
            "sha256": hashlib.sha256(body).hexdigest()})
    assert tcli.main(["manifest", "org/g"]) == 1
    assert "include-private" in capsys.readouterr().err
    assert tcli.main(["manifest", "org/g", "--include-private"]) == 0


def test_manifest_in_a_subprocess(env):
    """``python -m demodel_tpu_torch.cli manifest``, as users run it."""
    _warm(env / "cache")
    out = subprocess.run(
        [sys.executable, "-m", "demodel_tpu_torch.cli", "manifest", "org/m"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout)["files"][0]["name"] == "model.safetensors"


def test_pull_and_gc_refusals(env, capsys):
    """Without a card the CUDA sinks raise (exit 1, nothing placed on the
    CPU); ``--sharded`` needs a peer; ``gc`` needs a cap; ``serve``
    parses as the reference's does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main(["pull", "org/m", "--sink", "cuda"]) == 1
    assert "CUDA device requested" in capsys.readouterr().err
    assert tcli.main(["pull", "org/m", "--sharded", "--peer",
                      "http://127.0.0.1:9"]) == 1
    assert "CUDA device requested" in capsys.readouterr().err
    assert tcli.main(["pull", "org/m", "--sharded"]) == 2
    assert tcli.main(["gc"]) == 2
    for argv in (["serve"], ["serve", "--restore-port", "0",
                             "--serve-threads", "2", "--serve-queue", "8"]):
        got, want = (vars(m.build_parser().parse_args(argv))
                     for m in (tcli, jcli))
        assert got == want


def test_serve_node_in_a_subprocess(env):
    """``python -m demodel_tpu_torch.cli serve``: one stderr line names
    both ports; ``/restore/models`` is empty until the manifest request
    resolves the pulled model from its record; a tensor comes from the
    proxy port; ``/generate`` answers 503; SIGINT ends it with exit 0."""
    import queue
    import re
    import signal
    import threading
    import urllib.error
    import urllib.request

    from demodel_tpu_torch import delivery as tdelivery

    from .fake_registries import build_hf_repo, make_hf_handler
    from .servers import FakeUpstream

    repo = build_hf_repo(n_shards=2)
    with FakeUpstream(handler=make_hf_handler({"org/m": repo})) as up:
        tdelivery.pull("org/m", TConfig(cache_dir=env / "cache",
                                        data_dir=env / "data"),
                       endpoint=f"http://{up.authority}")
    child = subprocess.Popen(
        [sys.executable, "-m", "demodel_tpu_torch.cli", "serve",
         "--restore-port", "0", "--serve-threads", "2"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(REPO),
                        "DEMODEL_PROXY_HOST": "127.0.0.1",
                        "DEMODEL_PROXY_PORT": "0"})
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in child.stderr],
                     daemon=True).start()
    try:
        ports = None
        while ports is None:
            line = lines.get(timeout=60)
            ports = re.search(r"proxy\+peer on [^:]+:(\d+), restore API "
                              r"\+ /metrics on [^:]+:(\d+)", line)
        proxy, api = (f"http://127.0.0.1:{p}" for p in ports.groups())

        def get(url):
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.read()

        assert json.loads(get(f"{api}/restore/models")) == {"models": []}
        manifest = json.loads(get(f"{api}/restore/org/m/manifest"))
        assert manifest["data_endpoint"] == proxy
        assert json.loads(get(f"{api}/restore/models")) == {
            "models": ["org/m"]}
        w = np.frombuffer(get(f"{proxy}/restore/org/m/tensor/layer.1.w"),
                          np.float32)
        assert w.size == 64 * 64 and manifest["tensors"]["layer.1.w"][
            "nbytes"] == w.nbytes
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"{api}/generate", data=b'{"prompt":[1]}', method="POST"),
                timeout=30)
        assert ei.value.code == 503
        child.send_signal(signal.SIGINT)
        assert child.wait(timeout=30) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


def test_gc_evicts_to_the_cap(env, capsys):
    _warm(env / "cache")
    assert tcli.main(["gc", "--max-gb", "1"]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "cap_gb": 1, "in_use_bytes": 64, "freed_bytes": 0, "evicted": 0}


ENV_CASES = {
    "unset": {},
    "replace": {"DEMODEL_PROXY_MITM_HOSTS": "a:443, b:8443"},
    "clear": {"DEMODEL_PROXY_MITM_HOSTS": ""},
    "extend": {"DEMODEL_PROXY_MITM_EXTRA_HOSTS": "c:443,,d:443"},
    "replace-extend": {"DEMODEL_PROXY_MITM_HOSTS": "a:443",
                       "DEMODEL_PROXY_MITM_EXTRA_HOSTS": "c:443"},
    "flags": {"DEMODEL_PROXY_HOST": "127.0.0.1", "DEMODEL_PROXY_PORT": "9",
              "DEMODEL_PROXY_MITM_ALL": "yes", "DEMODEL_PROXY_NO_MITM": "1",
              "DEMODEL_PROXY_CA_USE_ECDSA": "true",
              "DEMODEL_UPSTREAM_CA": "/x/ca.pem"},
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_from_env_matches_the_reference(env, monkeypatch, case):
    monkeypatch.delenv("DEMODEL_PROXY_CA_USE_ECDSA")
    for k, v in ENV_CASES[case].items():
        monkeypatch.setenv(k, v)
    t, j = TConfig.from_env(), JConfig.from_env()
    fields = ("host", "port", "mitm_all", "no_mitm", "mitm_hosts",
              "use_ecdsa", "cache_enabled", "data_dir", "cache_dir",
              "upstream_ca")
    assert {f: getattr(t, f) for f in fields} == \
        {f: getattr(j, f) for f in fields}
    assert t.data_dir == env / "data" and t.cache_dir == env / "cache"

