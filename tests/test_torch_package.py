"""Package rules of the port (``demodel_tpu_torch``), checked on the CPU.

- It imports neither jax nor the JAX package, nor ``requests``,
  ``cryptography`` or the repo's ``tests``: not at run time (a fresh
  interpreter imports every module and ``chip_smoke`` and inspects
  ``sys.modules``) and not in its source (an AST scan of every module
  and of ``chip_smoke.py``, imports inside functions included, accepts
  the standard library, torch, numpy, triton and the port itself only).
  The port's own name starts with ``demodel_tpu``, so the checks match
  whole module names.
- Entry points default to CUDA and raise where there is none; nothing
  quietly drops to the CPU.
- The attention and dequant wrappers never reach their kernels for CPU
  tensors, and the kernel builders raise without nvcc instead of
  falling back.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from demodel_tpu_torch import serve
from demodel_tpu_torch import sink
from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.formats import gguf as tgguf
from demodel_tpu_torch.models import convert, hf_loader, llama
from demodel_tpu_torch.ops import dequant as tdq
from demodel_tpu_torch.ops import flash_attention as tfa
from demodel_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "demodel_tpu_torch"
MODULES = sorted(p for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "demodel_tpu", "requests", "cryptography",
             "tests")
#: what the port and chip_smoke.py may import besides the standard library
ALLOWED = ("torch", "numpy", "triton", "demodel_tpu_torch")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _module_name(path: Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_the_pull_and_swarm_modules_are_checked():
    """The sharded pull, the tuner and the swarm's serve surface are among
    the modules every check below imports and scans, and ``requests`` is
    as forbidden as jax: the port's wire is ``http.client``."""
    names = {_module_name(p) for p in MODULES}
    assert {"demodel_tpu_torch.sink.remote", "demodel_tpu_torch.sink.tuner",
            "demodel_tpu_torch.restore.server"} <= names
    assert _forbidden("requests") and _forbidden("requests.adapters")
    assert not _forbidden("requests_toolbelt_like")


def test_forbidden_names_match_whole_modules():
    assert _forbidden("jax.numpy") and _forbidden("demodel_tpu.serve")
    assert not _forbidden("demodel_tpu_torch.serve")
    assert not _forbidden("jaxtyping")


def test_runtime_imports_leave_jax_unloaded():
    """Every port module and ``chip_smoke`` imported in a fresh
    interpreter: no jax, no ``demodel_tpu`` / ``demodel_tpu.*``, no
    ``requests``, ``cryptography`` or ``tests`` in ``sys.modules``."""
    names = [_module_name(p) for p in MODULES] + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if any(\n"
        "    m == f or m.startswith(f + '.')\n"
        f"    for f in {FORBIDDEN!r}))\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize(
    "path", MODULES + [REPO / "chip_smoke.py"],
    ids=[str(p.relative_to(REPO)) for p in MODULES] + ["chip_smoke.py"])
def test_source_imports_no_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert bad == [], f"{path.name} imports {bad}"


def _allowed(name: str) -> bool:
    top = name.split(".")[0]
    return top in sys.stdlib_module_names or top in ALLOWED


def test_allowed_names_match_whole_modules():
    assert _allowed("os.path") and _allowed("http.client")
    assert _allowed("torch.profiler") and _allowed("demodel_tpu_torch.store")
    for bad in ("requests", "cryptography.x509", "jax", "demodel_tpu.store",
                "tests.fake_registries", "fake_registries", "torchvision"):
        assert not _allowed(bad), bad


@pytest.mark.parametrize(
    "path", MODULES + [REPO / "chip_smoke.py"],
    ids=[str(p.relative_to(REPO)) for p in MODULES] + ["chip_smoke.py"])
def test_source_imports_only_stdlib_torch_numpy_triton(path):
    """Every import in the source, at any depth, is of the standard
    library, torch, numpy, triton or the port: nothing that the machine
    with the card may lack."""
    bad = [n for n in _imports(path) if not _allowed(n)]
    assert bad == [], f"{path.name} imports {bad}"


@pytest.mark.parametrize("entry", [
    "init_params", "init_cache", "params_from_numpy", "load_llama_params",
    "GenEngine", "boot", "make_mesh", "deliver_gguf", "deliver_safetensors",
    "dequant_gguf_tensor", "load_model", "pull_manifest_to_hbm"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = {
        "init_params": lambda: llama.init_params(None, cfg),
        "init_cache": lambda: llama.init_cache(cfg, 1, 4),
        "params_from_numpy": lambda: convert.params_from_numpy(
            {"embed": np.zeros((2, 2), np.float32)}, cfg),
        "load_llama_params": lambda: hf_loader.load_llama_params({}, cfg),
        "GenEngine": lambda: serve.GenEngine(params, cfg),
        "boot": lambda: serve.boot(params, cfg),
        "make_mesh": lambda: make_mesh(),
        "deliver_gguf": lambda: sink.deliver_gguf(
            None, "k", buffer=tgguf.serialize({"w": np.ones(4, np.float32)})),
        "deliver_safetensors": lambda: sink.deliver_safetensors(
            None, "k", buffer=b"\x02\x00\x00\x00\x00\x00\x00\x00{}"),
        "dequant_gguf_tensor": lambda: tdq.dequant_gguf_tensor(
            tgguf.GGUFTensor("w", tgguf.GGML_F32, (4,), 0, 16),
            np.ones(4, np.float32)),
        "load_model": lambda: serve.load_model(
            "org/m", ProxyConfig(cache_dir="unused", data_dir="unused")),
        "pull_manifest_to_hbm": lambda: sink.pull_manifest_to_hbm(
            "org/m", ["http://127.0.0.1:9"]),
    }
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        calls[entry]()
    assert serve.current() is None


def test_wrapper_never_reaches_kernel_for_cpu_tensors(monkeypatch):
    def no_kernel():
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(tfa, "_library", no_kernel)
    before = tfa.launches
    q = torch.randn(1, 5, 2, 64, generator=torch.Generator().manual_seed(0))
    out, lse = tfa.flash_attention(q, q, q, return_lse=True)
    assert out.shape == q.shape and lse.shape == (1, 5, 2)
    assert tfa.launches == before


def test_wrapper_raises_on_other_devices():
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, q, q)


def test_kernel_source_and_flags():
    (src,) = tfa.SOURCES
    text = src.read_text()
    assert 'extern "C" int demodel_flash_attention_fwd(' in text
    assert "demodel_tpu/ops/flash_attention.py" in text  # what it replaces
    assert "arch=compute_90a,code=sm_90a" in tfa.NVCC_FLAGS
    assert tfa.BUILD_DIR.relative_to(REPO).parts[0] == "build"


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tfa, "CUDA_DEFAULT", tmp_path)
    monkeypatch.setattr(tfa, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tfa.build_library()
    assert not (tmp_path / "build").exists()


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds nothing else of the repo: non-zero exit
    and no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _dequant_parts(nb: int, device: str = "cpu"):
    """Parts of ``nb`` random blocks of every format, as decode_raw
    splits them, on ``device``."""
    rng = np.random.default_rng(0)
    out = {}
    for t, fn in tdq._FNS.items():
        blk, bpb = tgguf._BLOCK_GEOM[t]
        raw = rng.integers(0, 256, (nb, bpb), dtype=np.uint8)
        spec = tgguf.GGUFTensor("t", t, (nb * blk,), 0, raw.nbytes)
        parts = tgguf.decode_raw(spec, raw.reshape(-1))
        out[t] = [torch.from_numpy(np.array(p)).to(device) for p in parts]
    return out


def test_dequant_wrapper_never_loads_library_for_cpu_tensors(monkeypatch):
    def no_kernel():
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(tdq, "_library", no_kernel)
    before = dict(tdq.launches)
    for t, parts in _dequant_parts(3).items():
        out = tdq._FNS[t](*parts)
        assert out.dtype == torch.bfloat16
        assert out.numel() == 3 * tgguf._BLOCK_GEOM[t][0]
    assert tdq.launches == before


def test_dequant_wrapper_raises_on_other_devices():
    for t, parts in _dequant_parts(2, device="meta").items():
        with pytest.raises(ValueError, match="unsupported device"):
            tdq._FNS[t](*parts)


def test_dequant_kernel_source_and_flags():
    (src,) = tdq.SOURCES
    text = src.read_text()
    for fn in ("q8_0", "q4_0", "k_quant"):
        assert f'extern "C" int demodel_dequant_{fn}(' in text
    for replaced in ("_q8_0_kernel", "_q4_0_kernel", "_k_quant_call"):
        assert replaced in text  # what it replaces
    assert "demodel_tpu/ops/dequant.py" in text
    assert "arch=compute_90a,code=sm_90a" in tdq.NVCC_FLAGS
    assert "--fmad=false" in tdq.NVCC_FLAGS
    assert tdq.BUILD_DIR.relative_to(REPO).parts[0] == "build"


def test_dequant_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tdq, "CUDA_DEFAULT", tmp_path)
    monkeypatch.setattr(tdq, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tdq.build_library()
    assert not (tmp_path / "build").exists()
