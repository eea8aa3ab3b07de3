"""Build and load the port's CUDA kernels (route (b): nvcc by hand into a
shared library with a plain C interface, loaded with ctypes).

Each kernel source builds into its own library under
``build/torch_kernels/`` (gitignored), named by a hash of the sources and
flags so a changed source rebuilds and an unchanged one is reused. The
build writes a temporary name and renames it into place under an
exclusive file lock per library, so concurrent processes never load a
half-written library, and two libraries build in parallel. A missing
nvcc or a failed compile raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("ops.build")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build products live beside the checkout, in a directory .gitignore lists
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: conventional CUDA toolkit location, tried after PATH and CUDA_HOME
CUDA_DEFAULT = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc(cuda_default: Path) -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc")
                 if os.environ.get("CUDA_HOME") else None,
                 str(cuda_default / "bin" / "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME/bin, {cuda_default}/bin): "
        "the CUDA kernels cannot be built")


def build_library(stem: str, sources: tuple[Path, ...],
                  flags: tuple[str, ...], build_dir: Path,
                  cuda_default: Path) -> Path:
    """Compile ``sources`` into ``build_dir/lib<stem>_<hash>.so`` once per
    content; the compiler's output goes to the ``.log`` beside it."""
    nvcc = find_nvcc(cuda_default)
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    out = build_dir / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    # the file lock exists to make every other builder wait for this one
    # demodel: allow(no-blocking-io-under-lock) — single-flight build
    with open(build_dir / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), *map(str, sources)]
        # demodel: allow(no-blocking-io-under-lock) — single-flight build
        res = subprocess.run(cmd, capture_output=True, text=True)
        # demodel: allow(no-blocking-io-under-lock) — single-flight build
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    log.info("built %s", out.name)
    return out


class LazyLibrary:
    """A kernel library built and loaded at first use, once per process:
    ``build()`` returns the library's path and ``bind(lib)`` declares the
    argument and result types of its C functions."""

    def __init__(self, build: Callable[[], Path],
                 bind: Callable[[ctypes.CDLL], None]):
        self._build = build
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                # demodel: allow(no-blocking-io-under-lock) — one thread
                # builds and loads; the others wait for the library
                lib = ctypes.CDLL(str(self._build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
