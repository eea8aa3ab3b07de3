"""Probe: the native parallel upstream fetch (``dm_upstream_fetch_parallel``
in ``native/proxy.cc``) under two builds of the store library, with and
without PyTorch loaded.

On one H100 host a library built by ``$CXX`` (a g++ wrapper that links
libstdc++ statically) crashed (SIGSEGV) inside the fetch in a process
that had loaded PyTorch; the system g++'s build ran clean. Two causes
fit: two C++ runtimes in one process, or a race in the fetch itself
that happened to show only in those runs. The probe runs the same fetch
in fresh processes, in four variants:

- ``system+torch`` and ``system``: the library that
  :mod:`demodel_tpu_torch.native` builds, with PyTorch (and a CUDA
  context where there is a card) loaded, and without. A crash here is a
  fault of the fetch;
- ``cxx+torch`` and ``cxx``: the same sources and flags built by
  ``$CXX``, when it is set. Crashes with PyTorch loaded and none without
  point at the two runtimes.

Each child serves ``--files`` seeded random blobs of ``--mb`` MiB from
an in-process ``http.server`` with Range, as ``chip_smoke.py``'s
registry does, and fetches them all at once into a fresh store, each
over the native Range streams, ``--rounds`` times, checking every
digest. Run from the repo root::

    python -m demodel_tpu_torch.probes.native_fetch [--reps 3]

It prints one JSON line per child, then one per variant with its counts
(clean, crashed by signal, failed), and exits 0: a crash is a result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from demodel_tpu_torch import native


def _handler(blobs: list[bytes]):
    """``/blob/<i>``: HEAD with the size and ``Accept-Ranges``, GET whole
    or one ``bytes=a-b`` range."""

    class Blobs(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_HEAD(self):
            self.do_GET()

        def do_GET(self):
            try:
                body = memoryview(blobs[int(self.path.rsplit("/", 1)[1])])
            except (ValueError, IndexError):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            rng = self.headers.get("Range", "")
            status, part, extra = 200, body, {"Accept-Ranges": "bytes"}
            if rng.startswith("bytes="):
                a, _, b = rng[6:].partition("-")
                start, end = int(a), int(b) if b else len(body) - 1
                status, part = 206, body[start:end + 1]
                extra = {"Content-Range": f"bytes {start}-"
                         f"{start + len(part) - 1}/{len(body)}"}
            self.send_response(status)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(part)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(part)

    return Blobs


def _child(a) -> int:
    """One process: load the library in ``a.lib_dir`` (after PyTorch
    when ``a.torch``), serve the blobs, fetch them ``a.rounds`` times."""
    cuda = False
    if a.torch:
        import torch

        cuda = torch.cuda.is_available()
        if cuda:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
    native.BUILD_DIR = Path(a.lib_dir)  # built there by the parent
    so = Path(native.lib()._name)  # noqa: SLF001 — the loaded path
    from demodel_tpu_torch.registry.base import Fetcher
    from demodel_tpu_torch.store import Store

    rng = np.random.default_rng(a.seed)
    blobs = [rng.bytes(a.mb << 20) for _ in range(a.files)]
    digests = [hashlib.sha256(b).hexdigest() for b in blobs]
    server = ThreadingHTTPServer(("127.0.0.1", 0), _handler(blobs))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}/blob"
    secs = []
    try:
        for _ in range(a.rounds):
            root = tempfile.mkdtemp(prefix="native-fetch-probe-")
            store = Store(Path(root) / "store")
            fetcher = Fetcher(store)
            try:
                t0 = time.perf_counter()

                def one(i: int):
                    # the native path itself: Fetcher.fetch would take
                    # the single-stream path when it fails
                    return fetcher._try_upstream_parallel(  # noqa: SLF001
                        f"{base}/{i}", f"blob-{i}", digests[i], "", None, t0)

                with ThreadPoolExecutor(a.files) as ex:
                    arts = list(ex.map(one, range(a.files)))
                secs.append(time.perf_counter() - t0)
                for i, art in enumerate(arts):
                    if art is None or art.sha256 != digests[i]:
                        raise AssertionError(f"blob {i}: native fetch gave "
                                             f"{art}")
            finally:
                fetcher.close()
                store.close()
                shutil.rmtree(root, ignore_errors=True)
    finally:
        server.shutdown()
        server.server_close()
    print(json.dumps({"library": so.name, "torch": a.torch, "cuda": cuda,
                      "rounds": a.rounds, "secs": secs}), flush=True)
    return 0


def _libstdcxx_dynamic(so: Path) -> bool | None:
    """Does ``so`` load libstdc++ as a shared library (``ldd``)?"""
    if shutil.which("ldd") is None:
        return None
    out = subprocess.run(["ldd", str(so)], capture_output=True, text=True)
    return "libstdc++" in out.stdout


def _libraries() -> dict[str, Path]:
    """The library directories by name: ``system`` (:data:`native.CXX`)
    and, when ``$CXX`` names another compiler, ``cxx``."""
    libs = {"system": native.build().parent}
    cxx = shutil.which(os.environ.get("CXX", "").strip() or "-")
    if cxx and Path(cxx).resolve() != native.CXX.resolve():
        system = native.CXX
        native.CXX = Path(cxx)
        try:
            libs["cxx"] = native.build(native.BUILD_DIR / "probe_cxx").parent
        finally:
            native.CXX = system
    return libs


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=3,
                   help="child processes per variant")
    p.add_argument("--rounds", type=int, default=2,
                   help="fetches of all blobs per child")
    p.add_argument("--files", type=int, default=2)
    p.add_argument("--mb", type=int, default=1000, help="MiB per blob")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds per child")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--lib-dir", help=argparse.SUPPRESS)
    p.add_argument("--torch", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.child:
        return _child(a)

    libs = _libraries()
    print(json.dumps({"cxx": os.environ.get("CXX"),
                      "system": str(native.CXX), "libstdcxx_dynamic": {
                          k: _libstdcxx_dynamic(d / native.LIB_NAME)
                          for k, d in libs.items()}}), flush=True)
    for name, lib_dir in libs.items():
        for with_torch in (1, 0):
            variant = f"{name}+torch" if with_torch else name
            counts = {"clean": 0, "crashed": 0, "failed": 0}
            for rep in range(a.reps):
                cmd = [sys.executable, "-X", "faulthandler", "-m",
                       __spec__.name, "--child", "--lib-dir", str(lib_dir),
                       "--torch", str(with_torch), "--rounds", str(a.rounds),
                       "--files", str(a.files), "--mb", str(a.mb),
                       "--seed", str(a.seed + rep)]
                t0 = time.perf_counter()
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=a.timeout)
                    rc, out, err = r.returncode, r.stdout, r.stderr
                except subprocess.TimeoutExpired as e:
                    rc, out, err = None, e.stdout or "", e.stderr or ""
                kind = ("clean" if rc == 0 else
                        "crashed" if rc is not None and rc < 0 else "failed")
                counts[kind] += 1
                last = (out.strip().splitlines() or [""])[-1]
                print(json.dumps({
                    "variant": variant, "rep": rep, "rc": rc,
                    "wall_s": time.perf_counter() - t0,
                    "result": json.loads(last) if rc == 0 else None,
                    "stderr_tail": None if rc == 0 else str(err)[-2000:]}),
                    flush=True)
            print(json.dumps({"variant": variant, **counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
