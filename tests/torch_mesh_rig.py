"""Rig for the port's multi-rank CPU tests: WORLD worker processes
(``tests/torch_mesh_worker.py``) in one gloo group, kept for a whole test
module and given one job at a time.

Rendezvous goes through a ``FileStore`` under the module's temporary
directory, never a fixed port, so modules on parallel xdist workers never
meet. Every wait has a deadline: a job that a rank fails, or that does
not finish in time, kills every rank and raises with the tracebacks and
the end of each rank's stderr; the next job starts a fresh group.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
ROOT = WORKER.parents[1]
#: seconds a job may take on every rank (the workers' collectives time
#: out at 60 s, so a hung peer shows up as a traceback before this)
JOB_S = 150.0
#: seconds a worker may take to exit when told to
JOIN_S = 10.0


class Ranks:
    def __init__(self, world: int, root: Path):
        self.world = world
        self.root = Path(root)
        self.generation = 0
        self.procs: list[subprocess.Popen] = []
        self.dir: Path | None = None
        self.i = 0

    def _start(self) -> None:
        self.generation += 1
        self.dir = self.root / f"group-{self.generation}"
        self.dir.mkdir(parents=True)
        # a failed span's flight-recorder dump lands here, not in /tmp
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                   DEMODEL_RECORDER_DIR=str(self.dir))
        self.procs = []
        for r in range(self.world):
            with open(self.dir / f"stderr-{r}.log", "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(WORKER), str(self.dir),
                     str(self.world), str(r)], cwd=ROOT, env=env,
                    stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                    stderr=log))
        self.i = 0

    def _stderr(self, r: int) -> str:
        try:
            return (self.dir / f"stderr-{r}.log").read_text()[-3000:]
        except OSError:
            return ""

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=JOIN_S)
        self.procs = []

    def run(self, case: str, args: dict | None = None,
            inputs: dict | None = None) -> list[tuple[dict, dict]]:
        """Run ``case`` on every rank: per rank, ``(arrays, meta)``."""
        if not self.procs:
            self._start()
        i, d = self.i, self.dir
        np.savez(d / f"in-{i}.npz", **(inputs or {}))
        tmp = d / f"job-{i}.tmp"
        tmp.write_text(json.dumps({"case": case, "args": args or {}}))
        tmp.rename(d / f"job-{i}.json")
        self.i += 1
        done: dict[int, dict] = {}
        deadline = time.monotonic() + JOB_S
        while len(done) < self.world:
            for r in range(self.world):
                f = d / f"done-{i}-{r}.json"
                if r not in done and f.exists():
                    done[r] = json.loads(f.read_text())
            failed = [r for r, doc in done.items() if not doc["ok"]]
            dead = [r for r, p in enumerate(self.procs)
                    if p.poll() is not None and r not in done]
            if failed or dead or time.monotonic() > deadline:
                self.kill()
                report = "\n".join(
                    f"--- rank {r}: "
                    + (done[r]["error"] if r in done and not done[r]["ok"]
                       else "no result\n" + self._stderr(r))
                    for r in range(self.world) if not done.get(r, {}).get(
                        "ok"))
                raise AssertionError(f"case {case!r} failed on ranks "
                                     f"{failed or dead or 'all (timeout)'}"
                                     f":\n{report}")
            if len(done) < self.world:
                time.sleep(0.005)
        out = []
        for r in range(self.world):
            with np.load(d / f"out-{i}-{r}.npz") as f:
                out.append((dict(f), done[r]["meta"]))
        return out

    def close(self) -> None:
        if not self.procs:
            return
        tmp = self.dir / f"job-{self.i}.tmp"
        tmp.write_text(json.dumps({"case": "exit"}))
        tmp.rename(self.dir / f"job-{self.i}.json")
        t0 = time.monotonic()
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, JOIN_S - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=JOIN_S)
        self.procs = []


def flat_params(tree, prefix: str = "p.") -> dict:
    """A params tree of numpy arrays → ``{"p.embed": ..., "p.layers.0.
    q_proj": ...}``, the worker's input names."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for i, layer in enumerate(v):
                for n, a in layer.items():
                    out[f"{prefix}layers.{i}.{n}"] = np.asarray(a)
        else:
            out[prefix + k] = np.asarray(v)
    return out
