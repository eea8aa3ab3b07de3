"""One rank of the port's multi-rank CPU tests: a process in a gloo group.

Run as ``python tests/torch_mesh_worker.py DIR WORLD RANK`` (the rig in
``tests/torch_mesh_rig.py`` starts WORLD of them). The rank joins the
group through a ``FileStore`` in DIR, then serves jobs until told to
exit: for job ``i`` the rig writes ``DIR/in-i.npz`` (numpy inputs, made
once from a seed in the test) and then ``DIR/job-i.json`` (``{"case":
name, "args": {...}}``); every rank runs ``CASES[name]`` and writes its
arrays to ``DIR/out-i-RANK.npz`` and ``DIR/done-i-RANK.json`` (``{"ok":
true, "meta": ...}``, or ``{"ok": false, "error": traceback}``).

Imports torch, numpy, the standard library and the port only — never
jax or ``demodel_tpu`` — so what a rank computes is the port's alone.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from demodel_tpu_torch import serve  # noqa: E402
from demodel_tpu_torch.config import ProxyConfig  # noqa: E402
from demodel_tpu_torch.models import auto, llama  # noqa: E402
from demodel_tpu_torch.ops import ring_attention as ra  # noqa: E402
from demodel_tpu_torch.parallel import collectives as col  # noqa: E402
from demodel_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from demodel_tpu_torch.serve import http as serve_http  # noqa: E402
from demodel_tpu_torch.sink import hbm, remote  # noqa: E402

#: a collective that a peer never reaches raises after this long
TIMEOUT = datetime.timedelta(seconds=60)
#: a worker with no job for this long (its rig gone) exits
IDLE_S = 900.0

_MESHES: dict = {}


def mesh_of(axes: dict):
    """One mesh per set of axis sizes (every rank asks in the same
    order, so the sub-groups line up)."""
    key = tuple(sorted(axes.items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(device="cpu", **axes)
    return _MESHES[key]


class DirStore:
    """The store surface the sinks read (``get``, ``pread``,
    ``pread_into``, ``size``) over files named by key in one directory,
    counting the bytes of every range read past a header's size."""

    def __init__(self, root):
        self.root = Path(root)
        self.bytes_read = 0

    def _count(self, n: int) -> None:
        if n > 4096:  # headers excluded
            self.bytes_read += n

    def get(self, key: str) -> bytes:
        return (self.root / key).read_bytes()

    def size(self, key: str) -> int:
        return (self.root / key).stat().st_size

    def pread(self, key: str, length: int, offset: int = 0) -> bytes:
        self._count(length)
        with open(self.root / key, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def pread_into(self, key: str, out, offset: int = 0) -> int:
        mv = memoryview(out).cast("B")
        self._count(mv.nbytes)
        with open(self.root / key, "rb") as f:
            f.seek(offset)
            return f.readinto(mv)

    def close(self) -> None:
        pass


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def unflatten_params(inputs: dict, prefix: str = "p.") -> dict:
    """``p.embed``, ``p.layers.0.q_proj``, ... → the params tree."""
    tree: dict = {"layers": []}
    for k, a in inputs.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i][parts[2]] = _t(a)
        else:
            tree[parts[0]] = _t(a)
    return tree


def _whole(x: torch.Tensor, mesh, spec) -> np.ndarray:
    return col.replicate(x.detach(), mesh, spec).numpy()


# ------------------------------------------------------------------ cases


def case_mesh(args, inp, rank):
    mesh = mesh_of(args["axes"])
    sizes = {a: dist.get_world_size(mesh.group(a)) for a in mesh.axis_names}
    members = {a: dist.get_process_group_ranks(mesh.group(a))
               for a in mesh.axis_names}
    return {}, {"shape": mesh.shape, "coords": mesh.coords,
                "device": str(mesh.device), "group_sizes": sizes,
                "members": members}


def _spec(s) -> tuple:
    """A spec from JSON (tuples of axis names arrive as lists)."""
    return tuple(tuple(p) if isinstance(p, list) else p for p in s)


def case_collectives(args, inp, rank):
    """Each ``(src, dst)`` pair: this rank's shard of ``x`` under src,
    redistributed to dst, replicated and fingerprinted; then
    ``allgather_axis`` and ``psum_across`` of its block over ``axis``."""
    mesh = mesh_of(args["axes"])
    x = _t(inp["x"])
    out = {}
    for i, (src, dst) in enumerate(args["pairs"]):
        src, dst = _spec(src), _spec(dst)
        shard = col.redistribute(x, mesh, (), src)
        out[f"moved{i}"] = col.redistribute(shard, mesh, src, dst).numpy()
        out[f"replicated{i}"] = col.replicate(shard, mesh, src).numpy()
        out[f"fp{i}"] = col.fingerprint(shard, mesh, src).numpy()
    axis = args["axis"]
    block = col.redistribute(x, mesh, (), (axis,))
    out["gathered"] = col.allgather_axis(block, mesh, axis).numpy()
    out["psum"] = col.psum_across(block, mesh, axis).numpy()
    return out, {}


def case_ring(args, inp, rank):
    """The global-view ring on an ``sp`` mesh (with gradients of a sum of
    squares when asked), and this rank's body once more over the
    in-process rotation."""
    mesh = mesh_of(args["axes"])
    flash, causal = args["flash"], args["causal"]
    q, k, v = (_t(inp[n]).requires_grad_(args["grad"]) for n in "qkv")
    out = ra.ring_attention_sharded(q, k, v, mesh, causal=causal,
                                    use_flash=flash)
    res = {"out": out.detach().numpy()}
    if args["grad"]:
        (out ** 2).sum().backward()
        res.update(dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
    # the per-rank body on this rank's rows, rotated by the gloo ring and
    # by the in-process rotation over every rank's rows
    n, my = mesh.axis_size("sp"), mesh.coords["sp"]
    T = q.shape[1]
    pad = (-T) % n
    blocks = [torch.chunk(torch.nn.functional.pad(
        t.detach(), (0, 0, 0, 0, 0, pad)), n, dim=1) for t in (q, k, v)]
    kw = dict(causal=causal, kv_len=T if pad else None, use_flash=flash)
    res["body_ring"] = ra.ring_attention(
        blocks[0][my], blocks[1][my], blocks[2][my],
        ra.ring_rotation(mesh), my, n, **kw).numpy()
    res["body_local"] = ra.ring_attention(
        blocks[0][my], blocks[1][my], blocks[2][my],
        ra.local_rotation(list(blocks[1]), list(blocks[2]), my), my, n,
        **kw).numpy()
    return res, {}


def _cfg(args) -> llama.LlamaConfig:
    return llama.LlamaConfig(**args["cfg"])


def case_llama_forward(args, inp, rank):
    mesh = mesh_of(args["axes"])
    cfg = _cfg(args)
    params = llama.shard_params(unflatten_params(inp), cfg, mesh)
    with torch.no_grad():
        logits = llama.forward(params, _t(inp["tokens"]), cfg, mesh)
    return {"logits": logits.numpy()}, {}


def case_llama_generate(args, inp, rank):
    mesh = mesh_of(args["axes"])
    cfg = _cfg(args)
    params = llama.shard_params(unflatten_params(inp), cfg, mesh)
    toks = llama.generate(params, cfg, _t(inp["prompt"]), args["new"],
                          mesh=mesh)
    return {"tokens": toks.numpy()}, {}


def case_llama_train(args, inp, rank):
    """One train step on the mesh: the loss, every new leaf and every new
    momentum leaf (``m.<path>``; from a zero momentum, the gradient),
    whole."""
    mesh = mesh_of(args["axes"])
    cfg = _cfg(args)
    params = llama.shard_params(unflatten_params(inp), cfg, mesh)
    init, step = llama.make_train_step(cfg, mesh)
    new, opt, loss = step(params, init(params), _t(inp["tokens"]))
    out = {"loss": np.asarray(loss.item())}
    specs = llama.param_shardings(cfg, mesh)
    for path, t, spec in named_leaves(new, specs):
        out[path] = _whole(t, mesh, spec)
    for path, t, spec in named_leaves(opt, specs):
        out["m." + path] = _whole(t, mesh, spec)
    return out, {}


def named_leaves(tree, specs, prefix: str = ""):
    """``(dotted path, leaf, spec)`` of a params tree and its specs."""
    if isinstance(specs, dict):
        for k in specs:
            yield from named_leaves(tree[k], specs[k], f"{prefix}{k}.")
    elif isinstance(specs, list):
        for i, s in enumerate(specs):
            yield from named_leaves(tree[i], s, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree, specs


def case_sink(args, inp, rank):
    """Deliver a stored blob onto the mesh; this rank's shards, their
    specs and fingerprints, and the bytes it read."""
    mesh = mesh_of(args["axes"])
    store = DirStore(args["store"])
    if args["format"] == "gguf":
        placed = hbm.deliver_gguf(store, args["key"], mesh=mesh,
                                  out_dtype=getattr(torch, args["dtype"]))
    else:
        placed = hbm.deliver_safetensors(
            store, args["key"], mesh=mesh,
            ici_complete=args.get("ici_complete"))
    out, specs, fps = {}, {}, {}
    for name, t in placed.arrays.items():
        out[name] = t.numpy() if t.dtype != torch.bfloat16 else \
            t.view(torch.int16).numpy()
        specs[name] = list(placed.specs[name])
        fps[name] = col.fingerprint(t, mesh, placed.specs[name]).tolist()
    return out, {"bytes_read": store.bytes_read, "specs": specs, "fp": fps,
                 "coords": mesh.coords}


def case_model_from_pull(args, inp, rank):
    mesh = mesh_of(args["axes"])
    store = DirStore(args["store"])
    fn, params, cfg = auto.model_from_pull(store, args["report"], mesh=mesh)
    with torch.no_grad():
        logits = fn(params, _t(inp["tokens"]))
    return {"logits": logits.numpy()}, {"bytes_read": store.bytes_read,
                                        "dtype": cfg.dtype}


# ------------------------------------------------- serving over the mesh
#
# rank 0 leads (submits, waits, stops); every other rank runs its
# engine's plans until rank 0 stops it. Each rank records its pool's
# blocks in use after every plan it runs, so the test can hold the
# followers' pools to rank 0's at each step.

#: seconds a request or a follower's engine may take here
SERVE_S = 60.0


def _prompts(inp) -> list[list[int]]:
    flat, lens = inp["prompts"], inp["prompt_lens"]
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [flat[a:b].tolist() for a, b in zip(offs[:-1], offs[1:])]


def _engine(args, inp, mesh, **kw) -> "serve.GenEngine":
    cfg = _cfg(args)
    params = llama.shard_params(unflatten_params(inp), cfg, mesh)
    kw.setdefault("kv_mb", 4)
    return serve.GenEngine(params, cfg, mesh, device="cpu",
                           max_new_tokens=args["new"], **kw)


def _log_pool(engine) -> list[int]:
    """Blocks in use after each plan this rank runs (prefill and decode
    steps, and every release of leases), in order."""
    seen: list[int] = []
    apply, free = engine._apply, engine._free

    def logged_apply(kind, words):
        out = apply(kind, words)
        seen.append(engine.pool.in_use_blocks)
        return out

    def logged_free(rids):
        free(rids)
        seen.append(engine.pool.in_use_blocks)

    engine._apply, engine._free = logged_apply, logged_free
    return seen


def _follow(engine) -> dict:
    """A follower: submit must refuse; then wait for rank 0's stop."""
    try:
        engine.submit([1, 2, 3], 2)
        refused = False
    except RuntimeError:
        refused = True
    return {"refused": refused, "joined": engine.join(SERVE_S)}


def _staggered(engine, prompts, new) -> list[list[int]]:
    """Request 0 alone, 1 and 2 joining its running batch, then 3 (the
    chip phase's mix)."""
    r0 = engine.submit(prompts[0], new)
    it = r0.iter_tokens(timeout=SERVE_S)
    next(it)
    reqs = [r0] + [engine.submit(p, new) for p in prompts[1:3]]
    next(it)
    reqs += [engine.submit(p, new) for p in prompts[3:]]
    return [r.result(timeout=SERVE_S) for r in reqs]


def case_serve(args, inp, rank):
    """The staggered mix through ``GenEngine`` on the mesh: rank 0's
    tokens, each rank's pool log and its blocks in use at the end. The
    followers are given twice rank 0's KV budget, which must not change
    their block count."""
    mesh = mesh_of(args["axes"])
    engine = _engine(args, inp, mesh, max_batch=args["max_batch"],
                     kv_mb=4 if rank == 0 else 8)
    seen = _log_pool(engine)
    engine.start()
    meta: dict = {"leader": engine.leader}
    if engine.leader:
        try:
            meta["tokens"] = _staggered(engine, _prompts(inp), args["new"])
        finally:
            engine.stop()
        meta["joined"] = engine.join(SERVE_S)
    else:
        meta.update(_follow(engine))
    meta["in_use"] = engine.pool.in_use_blocks
    meta["num_blocks"] = engine.pool.num_blocks
    meta["heads"] = int(engine.pool.k.shape[3])
    return {"pool_log": np.asarray(seen, np.int64)}, meta


def case_serve_stop(args, inp, rank):
    """``stop()`` on rank 0 with one request running and one waiting."""
    mesh = mesh_of(args["axes"])
    engine = _engine(args, inp, mesh, max_batch=1).start()
    meta: dict = {}
    if engine.leader:
        prompts = _prompts(inp)
        running = engine.submit(prompts[0], args["new"])
        waiting = engine.submit(prompts[1], args["new"])
        next(running.iter_tokens(timeout=SERVE_S))
        engine.stop()
        meta["errors"] = []
        for r in (running, waiting):
            try:
                r.result(timeout=SERVE_S)
                meta["errors"].append(None)
            except RuntimeError as exc:
                meta["errors"].append(str(exc))
        meta["generated"] = len(running.tokens)
        meta["joined"] = engine.join(SERVE_S)
        meta["outstanding"] = engine.admission.describe()["outstanding"]
    else:
        meta.update(_follow(engine))
    meta["in_use"] = engine.pool.in_use_blocks
    return {}, meta


def case_serve_fail(args, inp, rank):
    """Rank ``fail_rank``'s ``_decode`` raises at its ``fail_at``-th call
    on a mesh whose groups time out after ``timeout_s``: every request
    on rank 0 settles with an error, and every rank's engine ends."""
    mesh = make_mesh(device="cpu", timeout=datetime.timedelta(
        seconds=args["timeout_s"]), **args["axes"])
    engine = _engine(args, inp, mesh, max_batch=4)
    if rank == args["fail_rank"]:
        decode, calls = engine._decode, [0]

        def failing(*a):
            calls[0] += 1
            if calls[0] == args["fail_at"]:
                raise RuntimeError("injected decode failure")
            return decode(*a)

        engine._decode = failing
    t0 = time.monotonic()
    engine.start()
    meta: dict = {}
    if engine.leader:
        reqs = [engine.submit(p, args["new"]) for p in _prompts(inp)]
        meta["errors"], meta["tokens"] = [], []
        for r in reqs:
            try:
                r.result(timeout=SERVE_S)
                meta["errors"].append(None)
            except RuntimeError as exc:
                meta["errors"].append(str(exc))
            meta["tokens"].append(list(r.tokens))
        try:
            engine.submit(_prompts(inp)[0], 1)
            meta["submit_after"] = "accepted"
        except RuntimeError as exc:
            meta["submit_after"] = str(exc)
    meta["joined"] = engine.join(SERVE_S)
    meta["stopped_s"] = time.monotonic() - t0
    if engine.leader:
        engine.stop()
    meta["in_use"] = engine.pool.in_use_blocks
    return {}, meta


def case_serve_http(args, inp, rank):
    """``serve.boot`` on every rank; rank 0 alone installs its engine and
    answers ``/generate`` (and ``submit``) with the same tokens."""
    mesh = mesh_of(args["axes"])
    cfg = _cfg(args)
    params = llama.shard_params(unflatten_params(inp), cfg, mesh)
    engine = serve.boot(params, cfg, mesh, device="cpu", kv_mb=4,
                        max_new_tokens=args["new"])
    meta: dict = {"installed": serve.current() is engine}
    try:
        if engine.leader:
            server = serve_http.start()
            try:
                meta["http"] = [_post_generate(server.url, p, args["new"])
                                for p in _prompts(inp)]
                meta["submit"] = [engine.generate(p, args["new"],
                                                  timeout=SERVE_S)
                                  for p in _prompts(inp)]
            finally:
                server.stop()
                engine.stop()
            meta["joined"] = engine.join(SERVE_S)
        else:
            meta.update(_follow(engine))
    finally:
        serve.install(None)
    meta["in_use"] = engine.pool.in_use_blocks
    return {}, meta


def _post_generate(url: str, prompt: list[int], n: int) -> list[int]:
    req = urllib.request.Request(
        f"{url}/generate", method="POST",
        data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode())
    with urllib.request.urlopen(req, timeout=SERVE_S) as resp:
        return json.loads(resp.read())["tokens"]


def case_serve_load_model(args, inp, rank):
    """A cold ``serve.load_model`` over the mesh from a Hub, each rank
    pulling into its own store under ``root/rank-R``."""
    mesh = mesh_of(args["axes"])
    root = Path(args["root"]) / f"rank-{rank}"
    cfg = ProxyConfig(cache_dir=root / "cache", data_dir=root / "data")
    os.environ["DEMODEL_FETCH_WORKERS"] = "2"
    engine = serve.load_model(args["model"], cfg, endpoint=args["hub"],
                              mesh=mesh, device="cpu", kv_mb=4,
                              max_new_tokens=args["new"])
    meta: dict = {"installed": serve.current() is engine}
    try:
        if engine.leader:
            try:
                meta["tokens"] = [engine.generate(p, args["new"],
                                                  timeout=SERVE_S)
                                  for p in _prompts(inp)]
            finally:
                engine.stop()
            meta["joined"] = engine.join(SERVE_S)
        else:
            meta.update(_follow(engine))
    finally:
        serve.install(None)
    meta["in_use"] = engine.pool.in_use_blocks
    meta["store"] = sorted(p.name for p in (root / "cache").iterdir())
    return {}, meta


# ------------------------------------------------- the pod pull over ranks


def _pull_env(args) -> None:
    for k, v in args.get("env", {}).items():
        os.environ[k] = v


def _pulled(report, placed, mesh) -> tuple[dict, dict]:
    out, specs, fps = {}, {}, {}
    for name, t in placed.arrays.items():
        out[name] = t.numpy()
        specs[name] = list(placed.specs[name])
        fps[name] = col.fingerprint(t, mesh, placed.specs[name]).tolist()
    return out, {"network_bytes": report["network_bytes"],
                 "weight_bytes": report["weight_bytes"],
                 "pipelined": report["pipelined"], "specs": specs,
                 "fp": fps, "coords": mesh.coords}


def case_pod_pull(args, inp, rank):
    """``pull_manifest_to_hbm`` off the peers onto this rank's shards."""
    _pull_env(args)
    mesh = mesh_of(args["axes"])
    report, placed = remote.pull_manifest_to_hbm(
        args["model"], args["peers"], mesh=mesh,
        ici_complete=args.get("ici_complete"))
    return _pulled(report, placed, mesh)


def case_pod_pull_dies(args, inp, rank):
    """A pull off a peer that dies mid-window (for the ranks in
    ``dying_ranks``; the others pull off the live peer), on a fresh mesh
    whose groups time out after ``timeout_s``: the error each rank
    raised (or None), then the same pull off the live peer on another
    fresh mesh."""
    _pull_env(args)
    timeout = datetime.timedelta(seconds=args["timeout_s"])
    peer = args["dying"] if rank in args["dying_ranks"] else args["live"]
    t0 = time.monotonic()
    meta: dict = {}
    try:
        remote.pull_manifest_to_hbm(
            args["model"], [peer],
            mesh=make_mesh(device="cpu", timeout=timeout, **args["axes"]),
            ici_complete=args.get("ici_complete"))
        meta["error"] = None
    except OSError as exc:
        meta["error"] = f"{type(exc).__name__}: {exc}"
    meta["abort_s"] = time.monotonic() - t0
    mesh = make_mesh(device="cpu", timeout=timeout, **args["axes"])
    report, placed = remote.pull_manifest_to_hbm(
        args["model"], [args["live"]], mesh=mesh)
    out, retry = _pulled(report, placed, mesh)
    meta["retry"] = retry
    return out, meta


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


# ------------------------------------------------------------------- loop


def _wait_for(path: Path) -> bool:
    """Wait for ``path``; False when the rig is gone or never writes."""
    parent = os.getppid()
    t0 = time.monotonic()
    while not path.exists():
        if os.getppid() != parent or time.monotonic() - t0 > IDLE_S:
            return False
        time.sleep(0.002)
    return True


def _write_json(path: Path, doc: dict) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(doc))
    tmp.rename(path)


def main() -> int:
    root, world, rank = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    store = dist.FileStore(str(root / "rdzv"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        i = 0
        while _wait_for(root / f"job-{i}.json"):
            job = json.loads((root / f"job-{i}.json").read_text())
            if job["case"] == "exit":
                return 0
            try:
                with np.load(root / f"in-{i}.npz") as f:
                    inp = dict(f)
                arrays, meta = CASES[job["case"]](job.get("args", {}), inp,
                                                  rank)
                np.savez(root / f"out-{i}-{rank}.npz", **arrays)
                done = {"ok": True, "meta": meta}
            except Exception:  # noqa: BLE001 - reported to the rig
                done = {"ok": False, "error": traceback.format_exc()}
            _write_json(root / f"done-{i}-{rank}.json", done)
            if not done["ok"]:
                return 1  # the group may be broken; the rig starts anew
            i += 1
        return 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
