"""Port parity: ``demodel_tpu_torch.store`` (over the port's own build of
the native library) against ``demodel_tpu.store`` on the CPU.

Both packages open one store root: objects that one writes — whole, as a
stream, by ranges, resumed from the other's partial — the other reads
byte-identically, with the same keys and meta records. The same writes
into two roots leave identical trees (objects, ``.meta`` sidecars,
digest links). Then the build rules of the port's library: it is built
by one g++ call with the Makefile's flags into the port's build
directory, never by ``make`` into ``native/build/``, and a missing
compiler or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from demodel_tpu import store as jstore
from demodel_tpu_torch import native as tnative
from demodel_tpu_torch import store as tstore
from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
URIS = ["https://huggingface.co/org/m/resolve/main/config.json",
        "https://cdn-lfs.huggingface.co/repos/ab/cd/0123?X-Sig=1",
        "demodel://models/hf/meta-llama/Llama-2-7b-hf", "", "ü/ß"]


def _body(seed: int, n: int = (3 << 20) + 17) -> bytes:
    return np.random.default_rng(seed).bytes(n)


@pytest.fixture()
def stores(tmp_path):
    """The port's and the reference's Store on one root."""
    root = tmp_path / "store"
    t = tstore.Store(root)
    j = jstore.Store(root)
    try:
        yield t, j
    finally:
        t.close()
        j.close()


def test_key_for_uri_matches_reference_and_native():
    out = ctypes.create_string_buffer(17)
    for uri in URIS:
        key = tstore.key_for_uri(uri)
        assert key == jstore.key_for_uri(uri)
        tnative.lib().dm_key_for_uri(uri.encode(), out)
        assert out.value.decode() == key


def _write(s, how: str, key: str, body: bytes, meta: dict) -> str:
    """Write ``body`` under ``key`` through store ``s`` (either package):
    whole, as a stream of chunks, or by ranges out of order (one of them
    from a numpy buffer). Returns the digest the store reports."""
    if how == "put":
        return s.put(key, body, meta)
    if how == "stream":
        w = s.begin(key)
        for off in range(0, len(body), 1 << 20):
            w.append(body[off:off + (1 << 20)])
        digest = w.digest()
        w.commit(meta)
        return digest
    rw = s.begin_ranged(key, len(body))
    cuts = [0, 1000, len(body) // 2, len(body)]
    for a, b in reversed(list(zip(cuts, cuts[1:]))):
        part = body[a:b]
        rw.pwrite(np.frombuffer(part, np.uint8).copy() if a == 0 else part, a)
    return rw.commit(meta, expected_digest=hashlib.sha256(body).hexdigest())


@pytest.mark.parametrize("how", ["put", "stream", "ranged"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_objects_cross_read_byte_identical(stores, writer, how):
    w = stores[0] if writer == "port" else stores[1]
    uri = f"https://hub.example/org/m/resolve/main/{how}.bin"
    key = tstore.key_for_uri(uri)
    body = _body(len(how))
    meta = {"uri": uri, "name": f"{how}.bin", "etag": "e1",
            "headers": {"content-type": "application/octet-stream"}}
    digest = _write(w, how, key, body, meta)
    assert digest == hashlib.sha256(body).hexdigest()
    metas = []
    for s in stores:
        assert s.has(key) and s.size(key) == len(body)
        assert s.get(key) == body
        assert s.pread(key, 1000, 12345) == body[12345:13345]
        out = np.zeros(5000, np.uint8)
        assert s.pread_into(key, out, 777) == 5000
        assert out.tobytes() == body[777:5777]
        assert b"".join(s.stream(key, chunk=1 << 20)) == body
        assert s.has_digest(digest) and key in s.list()
        metas.append(s.meta(key))
    assert metas[0] == metas[1] and metas[0]["sha256"] == digest
    assert {k: metas[0][k] for k in meta} == meta


@pytest.mark.parametrize("first", ["port", "reference"])
def test_partial_of_one_resumes_in_the_other(stores, first):
    """A stream one package keeps as a partial, the other resumes to the
    same object and digest."""
    a, b = stores if first == "port" else stores[::-1]
    key = tstore.key_for_uri(f"https://hub.example/resume/{first}")
    body = _body(7)
    w = a.begin(key)
    w.append(body[:1234567])
    w.abort(keep_partial=True)
    assert not b.has(key) and b.partial_size(key) == 1234567
    w = b.begin(key, resume=True)
    assert w.offset == 1234567
    w.append(body[1234567:])
    digest = w.digest()
    w.commit({"uri": "resume"})
    assert digest == hashlib.sha256(body).hexdigest()
    assert a.get(key) == body and a.meta(key)["sha256"] == digest


def test_remove_and_materialize_across_packages(stores):
    t, j = stores
    body = _body(9, 4096)
    k1, k2 = (tstore.key_for_uri(f"x://{i}") for i in range(2))
    digest = t.put(k1, body, {"uri": "x://0"})
    j.materialize(k2, digest, {"uri": "x://1", "sha256": digest})
    assert t.get(k2) == body and t.meta(k2)["uri"] == "x://1"
    j.remove(k1)
    assert not t.has(k1) and t.has(k2) and t.has_digest(digest)


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_same_writes_leave_identical_roots(tmp_path):
    """One sequence of writes through each package, each into its own
    root: the same files, byte for byte — objects, ``.meta`` sidecars
    and ``digests/`` links."""
    trees = []
    for name, mod in (("port", tstore), ("reference", jstore)):
        root = tmp_path / name
        s = mod.Store(root)
        try:
            for i, how in enumerate(("put", "stream", "ranged")):
                uri = f"https://hub.example/{how}"
                _write(s, how, mod.key_for_uri(uri), _body(i, 100_000 + i),
                       {"uri": uri, "size": 100_000 + i})
            s.put(mod.key_for_uri("demodel://models/hf/org/m"),
                  b'{"files": []}', {"kind": "model-manifest"})
            s.remove(mod.key_for_uri("https://hub.example/put"))
        finally:
            s.close()
        trees.append(_tree(root))
    assert trees[0] == trees[1]
    assert any(k.endswith(".meta") for k in trees[0])
    assert any(k.startswith("digests/") for k in trees[0])


def test_fault_hook_sees_writes_and_reads(stores):
    """The test-only disk fault hook is consulted before the native layer
    and its error surfaces unchanged."""
    t, _ = stores
    seen = []

    def hook(op, key, **info):
        seen.append(op)
        if op == "commit":
            raise OSError(28, "injected: no space left")

    key = tstore.key_for_uri("x://fault")
    tstore.set_fault_hook(hook)
    try:
        w = t.begin(key)
        w.append(b"abc")
        with pytest.raises(OSError, match="injected"):
            w.commit({})
        w.abort()
    finally:
        tstore.set_fault_hook(None)
    assert seen == ["append", "commit"] and not t.has(key)


# ------------------------------------------------------------ the build


def _makefile_var(name: str) -> list[str]:
    text = (REPO / "native" / "Makefile").read_text()
    return re.search(rf"^{name}\s*[?:]?=\s*(.*)$", text, re.M).group(1).split()


def test_library_is_one_gpp_call_with_the_makefile_flags():
    cmd = tnative.build_command(Path("/out.so"))
    assert cmd[0] == "/usr/bin/g++" and "make" not in cmd
    assert list(tnative.CXXFLAGS) == _makefile_var("CXXFLAGS")
    assert list(tnative.LDLIBS) == _makefile_var("LDLIBS")
    srcs = [Path(a) for a in cmd if a.endswith(".cc")]
    assert [p.name for p in srcs] == _makefile_var("SRCS")
    assert all(p.parent == REPO / "native" for p in srcs)
    assert cmd[-2:] == ["-o", "/out.so"] and "-shared" in cmd
    rel = tnative.BUILD_DIR.relative_to(REPO)
    assert rel.parts == ("build", "torch_kernels")


def test_loaded_library_lives_in_the_port_build_dir():
    path = Path(tnative.lib()._name)
    assert path.parent == tnative.BUILD_DIR
    assert REPO / "native" not in path.parents


_REFERENCE_LOAD = """
import json, sys
from pathlib import Path
from demodel_tpu import native as jnative
from demodel_tpu.store import Store
from tests.torch_refnative import reference_native
with reference_native():
    with Store(Path(sys.argv[1])) as s:
        s.put("k", b"x" * 4096)
        loaded = s._lib._name
    maps = open("/proc/self/maps").read()
print(json.dumps({"loaded": loaded, "restored": jnative._lib is None,
                  "so": str(jnative._SO),
                  "mapped_native_build": "native/build/" in maps}))
"""


def _mtimes(path: Path) -> dict[str, int]:
    return {str(p): p.stat().st_mtime_ns for p in path.rglob("*")} \
        if path.exists() else {}


def test_reference_store_loads_its_own_copy(tmp_path):
    """A reference ``Store`` built inside the helper's scope (in a fresh
    interpreter, so nothing else has loaded the library) maps the copy
    under ``build/torch_kernels/reference/``, never ``native/build/``,
    which stays as it was; leaving the scope restores the loader."""
    import json
    import subprocess
    import sys

    from .torch_refnative import REFERENCE_DIR

    before = _mtimes(REPO / "native" / "build")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_LOAD,
                          str(tmp_path / "s")], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert Path(got["loaded"]) == REFERENCE_DIR / tnative.LIB_NAME
    assert not got["mapped_native_build"]
    assert got["restored"]
    assert Path(got["so"]) == REPO / "native" / "build" / tnative.LIB_NAME
    assert _mtimes(REPO / "native" / "build") == before


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "CXX", tmp_path / "bin" / "g++")
    with pytest.raises(RuntimeError, match="g.. not found"):
        tnative.build(tmp_path / "b")
    assert not (tmp_path / "b" / tnative.LIB_NAME).exists()


def _fake_native(tmp_path: Path, store_cc: str) -> Path:
    src = tmp_path / "native"
    src.mkdir()
    (src / "store.cc").write_text(store_cc)
    (src / "proxy.cc").write_text('extern "C" int dm_fake_proxy() '
                                  '{ return 0; }\n')
    (src / "store.h").write_text("#pragma once\n")
    return src


def test_build_raises_on_a_failed_compile(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "NATIVE_DIR",
                        _fake_native(tmp_path, "this is not C++\n"))
    with pytest.raises(RuntimeError, match="store library build failed"):
        tnative.build(tmp_path / "b")
    assert list((tmp_path / "b").glob("*.so*")) == []


def test_build_reruns_only_when_a_source_is_newer(monkeypatch, tmp_path):
    src = _fake_native(tmp_path,
                       'extern "C" int dm_fake_store() { return 1; }\n')
    monkeypatch.setattr(tnative, "NATIVE_DIR", src)
    so = tnative.build(tmp_path / "b")
    assert ctypes.CDLL(str(so)).dm_fake_store() == 1
    built = so.stat().st_mtime_ns
    assert tnative.build(tmp_path / "b") == so
    assert so.stat().st_mtime_ns == built
    os.utime(src / "store.h", (so.stat().st_mtime + 10,) * 2)
    tnative.build(tmp_path / "b")
    assert so.stat().st_mtime_ns != built
    assert not list((tmp_path / "b").glob("*.tmp"))
