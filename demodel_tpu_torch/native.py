"""Loader for the C++ data plane (the store and the native upstream fetch
in ``native/store.cc`` and ``native/proxy.cc``), the port of
``demodel_tpu/native.py``.

The port builds the library itself, with one call of the system
compiler :data:`CXX` over both sources and the Makefile's flags, into
its own gitignored build directory (``build/torch_kernels/``), never
into ``native/build/``: a checkout needs nothing but the system g++, and
the port never
races the JAX package's ``make -C native``. The build runs once under an
exclusive file lock and lands by an atomic rename, so concurrent
processes never load a half-written library; it runs again when a
``native/*.cc`` or ``native/*.h`` is newer than the library. A missing
compiler or a failed build raises with the command it ran.

The compiler is named by its path, not taken from ``$CXX`` or from the
first ``g++`` on ``PATH``: on an H100 host whose ``CXX`` named another
g++ (a wrapper that links libstdc++ statically), that build of the same
sources crashed (SIGSEGV) in the native parallel fetch in every run of
``python -m demodel_tpu_torch.probes.native_fetch``, with PyTorch loaded
or not, while the system g++'s build ran clean in every run. Why that
build crashes is not established.

Every ctypes prototype the port calls is set once at load: the defaults
(int restype) would silently truncate 64-bit handles and offsets.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

from demodel_tpu_torch.ops import _build
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("native")

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("store.cc", "proxy.cc")
BUILD_DIR = _build.BUILD_DIR
LIB_NAME = "libdemodel_native.so"
#: the system C++ compiler (see the module docstring)
CXX = Path("/usr/bin/g++")
#: ``native/Makefile``'s CXXFLAGS, then ``-shared``, then its LDLIBS
CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-pthread")
LDLIBS = ("-ldl", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _stale(so: Path) -> bool:
    if not so.exists():
        return True
    so_mtime = so.stat().st_mtime
    return any(p.stat().st_mtime > so_mtime
               for pat in ("*.cc", "*.h") for p in NATIVE_DIR.glob(pat))


def build_command(out: Path) -> list[str]:
    return [str(CXX), *CXXFLAGS, "-shared",
            *(str(NATIVE_DIR / s) for s in SOURCES), *LDLIBS, "-o", str(out)]


def build(build_dir: Path | None = None) -> Path:
    """The store library under ``build_dir`` (default :data:`BUILD_DIR`),
    built first when missing or older than a source. Raises when the
    compiler is missing or fails."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    so = build_dir / LIB_NAME
    if not _stale(so):
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    # the file lock exists to make every other builder wait for this one
    # demodel: allow(no-blocking-io-under-lock) — single-flight build
    with open(build_dir / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(so):
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = build_command(tmp)
        if not os.access(CXX, os.X_OK):
            raise RuntimeError(f"{CXX} not found: cannot run "
                               f"{' '.join(cmd)}")
        log.info("building the store library: %s", " ".join(cmd))
        # demodel: allow(no-blocking-io-under-lock) — single-flight build
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        # demodel: allow(no-blocking-io-under-lock) — single-flight build
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"store library build failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def _configure(L: ctypes.CDLL) -> None:
    c = ctypes
    P, I, I64, CP = c.c_void_p, c.c_int, c.c_int64, c.c_char_p

    def sig(name, restype, argtypes):
        fn = getattr(L, name)
        fn.restype = restype
        fn.argtypes = argtypes

    # store lifecycle + queries
    sig("dm_store_open", P, [CP, CP, I])
    sig("dm_store_close", None, [P])
    sig("dm_store_has", I, [P, CP])
    sig("dm_store_size", I64, [P, CP])
    sig("dm_store_partial_size", I64, [P, CP])
    sig("dm_store_meta", I, [P, CP, CP, I])
    sig("dm_store_pread", I64, [P, CP, P, I64, I64])
    sig("dm_store_put", I, [P, CP, P, I64, CP, CP])
    sig("dm_store_remove", I, [P, CP])
    sig("dm_store_has_digest", I, [P, CP])
    sig("dm_store_materialize", I, [P, CP, CP, CP])
    sig("dm_store_begin", P, [P, CP, I, CP, I])
    sig("dm_store_begin_ranged", P, [P, CP, I64, CP, I])
    sig("dm_store_list", I, [P, CP, I])
    sig("dm_store_gc", I64, [P, I64, c.POINTER(I64), c.POINTER(I)])
    # streaming writer
    sig("dm_writer_append", I, [P, P, I64])
    sig("dm_writer_offset", I64, [P])
    sig("dm_writer_digest", None, [P, CP])
    sig("dm_writer_commit", I, [P, CP])
    sig("dm_writer_abort", None, [P, I])
    # parallel range writer
    sig("dm_rw_pwrite", I, [P, P, I64, I64])
    sig("dm_rw_written", I64, [P])
    sig("dm_rw_commit", I, [P, CP, CP, CP])
    sig("dm_rw_abort", None, [P, I])
    # upstream fetch over parallel Range connections (proxy.cc)
    sig("dm_upstream_fetch_parallel", I64,
        [P, CP, I, I, CP, CP, CP, I64, I, CP, CP, CP, I])
    # peer fetch into the store (proxy.cc)
    sig("dm_peer_fetch_parallel", I64,
        [P, CP, I, CP, CP, I64, I, CP, CP, CP, I])
    # one window of a peer object into a host buffer over Range streams
    # (proxy.cc; sink/remote.py's PeerBlobReader)
    sig("dm_peer_fetch_window", I64, [CP, I, CP, I64, I64, I64, I, P, CP, I])
    # the proxy that serves a store to peers (proxy.py)
    sig("dm_proxy_new", P,
        [CP, I, I, I, CP, CP, CP, I, P, I, I, I64, I64, I, I64, I, I, I, I,
         I, I])
    sig("dm_proxy_start", I, [P])
    sig("dm_proxy_port", I, [P])
    sig("dm_proxy_stop", None, [P])
    sig("dm_proxy_free", None, [P])
    sig("dm_proxy_metrics", I, [P, CP, I])


def lib() -> ctypes.CDLL:
    """The loaded library (built first if needed), prototypes set."""
    global _lib
    with _lock:
        if _lib is None:
            # demodel: allow(no-blocking-io-under-lock) — one thread
            # builds and loads; the others wait for the library
            L = ctypes.CDLL(str(build()))
            _configure(L)
            _lib = L
        return _lib
