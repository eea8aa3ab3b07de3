"""The reference's store library for the port's parity tests, built
apart from ``native/build/``.

``demodel_tpu.native`` builds its library on first use with ``make -C
native``, which writes ``native/build/*.o`` and the ``.so`` in place
under a lock that holds only within one process. Under ``pytest -n``
several workers may run that ``make`` at once, and a worker can then
load a library linked from a half-written object (one that lacks, say,
``dm_peer_fetch``) and keep that handle for every later test.

The port's tests therefore never load ``native/build/``. The port's own
build function (``demodel_tpu_torch.native.build``: the Makefile's sources,
flags and link, one g++ call under an exclusive file lock, landed by an
atomic rename) builds the same library into a directory of its own,
and :func:`reference_native` points the reference's loader at it for
the scope of a test module. It is a second file beside the port's
``build/torch_kernels/libdemodel_native.so``, so the two packages keep
separate native state in one process, as they did. On leaving the
scope the loader's path and cached handle are restored, so the
pre-port tests of the same worker load what they load without it.

A port test module that builds a reference ``Store``, ``ProxyServer``
or ``RestoreServer`` (or reaches the reference's native fetches) imports
:func:`reference_native_lib`, a module-scoped autouse fixture.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator

import pytest

from demodel_tpu import native as jnative
from demodel_tpu_torch import native as tnative

#: where the reference's copy of the store library is built
REFERENCE_DIR = tnative.BUILD_DIR / "reference"


@contextlib.contextmanager
def reference_native() -> Iterator[Path]:
    """Within the block, ``demodel_tpu.native.lib()`` loads the library
    built under :data:`REFERENCE_DIR` (building it first when missing or
    older than a source)."""
    so = tnative.build(REFERENCE_DIR)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", so)
        mp.setattr(jnative, "_lib", None)
        yield so


@pytest.fixture(scope="module", autouse=True)
def reference_native_lib() -> Iterator[Path]:
    with reference_native() as so:
        yield so
