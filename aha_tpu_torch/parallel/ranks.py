"""The ranks of a tensor-parallel group as processes.

Rank 0 is the process that serves HTTP or runs `run`; `start` spawns
ranks 1 … tp − 1 with torch.multiprocessing (spawn), joins the group
with them through a file store in a temporary directory (no TCP port to
collide over), and builds rank 0's engine; each worker builds its own
engine over its shard with the same `build` and then waits for commands.
`build` may return a dict of named engines over one model: they share
the group, each operation naming its engine.

Only rank 0 schedules.  Before each device operation of its engine
(`engine._dev(op, ...)`) rank 0 sends the workers the operation's name
and arguments over a pipe each, then runs it itself; the workers make the
same call on their shards.  So every rank issues the same collectives in
the same order, whatever rank 0's host decides between operations (eos
read back, stop strings, a client gone, max_tokens): a rank that stopped
or branched on its own would leave the others waiting in a collective.

Workers never outlive rank 0, and rank 0 does not serve without them:
- a worker exits when its pipe from rank 0 closes, and a watchdog thread
  exits it when rank 0 is gone (its parent pid changes: a killed rank 0
  closes nothing in order);
- rank 0 watches its workers; when one dies, or an operation fails on
  rank 0 itself (the group is then out of step), it reports it and exits
  with FAILED_EXIT a moment later (the failing request gets its error
  first), since a collective with a dead peer may never return;
- `shutdown` stops the workers and leaves the group.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable

import torch

from aha_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh

#: exit code of a rank whose group failed
FAILED_EXIT = 70
#: seconds the workers may take to join the group and build their engines
START_SECS = 600.0
#: seconds between a failure and rank 0's exit
FAIL_GRACE_SECS = 1.0
#: seconds a worker's watchdog sleeps between looks at its parent
WATCH_SECS = 0.2


def _watch_parent(parent: int) -> None:
    while True:
        time.sleep(WATCH_SECS)
        if os.getppid() != parent:
            os._exit(0)


def _worker(rank: int, mesh: Mesh, init_method: str, conn, build: Callable,
            parent: int) -> None:
    """A worker rank: join, build, then make every call rank 0 sends."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True,
                     name="aha-tp-watchdog").start()
    conn.send(("started", None))
    try:
        mesh = mesh.at(rank).join(init_method)
        with torch.no_grad():
            built = build(mesh)
    except BaseException:  # noqa: BLE001 — reported to rank 0, then exit
        conn.send(("error", traceback.format_exc()))
        os._exit(FAILED_EXIT)
    conn.send(("ready", None))
    with torch.no_grad():
        while True:
            try:
                name, op, args = conn.recv()
            except (EOFError, OSError):
                os._exit(0)              # rank 0 is gone
            if op == "shutdown":
                break
            try:
                if callable(op):
                    op(built, *args)
                elif op.startswith("_op_"):
                    engine = built if name is None else built[name]
                    getattr(engine, op)(*args)
                else:
                    raise ValueError(f"unknown operation {op!r}")
            except BaseException:  # noqa: BLE001 — the group is broken
                print(f"[tp rank {rank}] {op} failed:\n"
                      f"{traceback.format_exc()}", file=sys.stderr,
                      flush=True)
                os._exit(FAILED_EXIT)
    mesh.leave()
    os._exit(0)


class Ranks:
    """Rank 0's handle on the workers of its tp group."""

    def __init__(self, mesh: Mesh, procs: list, conns: list, store: str,
                 built: Any = None):
        self.mesh = mesh
        #: rank 0's engine, or dict of named engines
        self.built = built
        self.procs = procs
        self.conns = conns
        self._store = store
        self._closing = False
        self._lock = threading.Lock()
        self.failed: str | None = None
        threading.Thread(target=self._watch, daemon=True,
                         name="aha-tp-monitor").start()

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self.procs]

    def _watch(self) -> None:
        from multiprocessing.connection import wait

        by_sentinel = {p.sentinel: r for r, p in enumerate(self.procs, 1)}
        while not self._closing:
            dead = wait(list(by_sentinel), timeout=0.5)
            if dead and not self._closing:
                r = by_sentinel[dead[0]]
                code = self.procs[r - 1].exitcode
                self.fail(f"tp rank {r} exited with code {code}")
                return

    def fail(self, why: str) -> None:
        """The group is out of step: report it and exit rank 0 with
        FAILED_EXIT after FAIL_GRACE_SECS."""
        if self.failed is not None:
            return
        self.failed = why
        print(f"[tp] {why}; rank 0 exits", file=sys.stderr, flush=True)

        def leave():
            time.sleep(FAIL_GRACE_SECS)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
            os._exit(FAILED_EXIT)

        threading.Thread(target=leave, daemon=True).start()

    def _send(self, msg: tuple) -> None:
        if self.failed is not None:
            raise RuntimeError(f"tensor-parallel group failed: {self.failed}")
        if self._closing:
            raise RuntimeError("tensor-parallel group is shut down")
        try:
            for c in self.conns:
                c.send(msg)
        except (OSError, EOFError) as e:
            self.fail(f"a worker's pipe broke ({e!r})")
            raise RuntimeError(f"tensor-parallel group failed: {e!r}")

    def run(self, engine, op: str, args: tuple):
        """Device operation `op` of `engine` on every rank: sent, then run
        here."""
        with self._lock:
            self._send((engine.tp_name, op, args))
            try:
                return getattr(engine, op)(*args)
            except BaseException as e:
                self.fail(f"rank 0 failed in {op}: {e!r}")
                raise

    def call(self, fn: Callable, *args) -> Any:
        """`fn(built, *args)` on every rank, `built` what the rank's
        `build` returned (`fn` a top-level function: it is pickled to the
        workers); rank 0's result.  Collectives inside `fn` pair up across
        the ranks as in an operation."""
        with self._lock:
            self._send((None, fn, args))
            try:
                return fn(self.built, *args)
            except BaseException as e:
                self.fail(f"rank 0 failed in {fn.__name__}: {e!r}")
                raise

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the workers (killed past `timeout`) and leave the group."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        for c in self.conns:
            try:
                c.send((None, "shutdown", ()))
            except (OSError, EOFError):
                pass
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5)
        for c in self.conns:
            c.close()
        self.mesh.leave()
        shutil.rmtree(self._store, ignore_errors=True)


def _expect(rank: int, proc, conn, kind: str, deadline: float) -> None:
    """Wait for a worker's `kind` message; raise if it reports an error,
    exits first (it could not even start: rank 0 would otherwise wait in
    the group's rendezvous) or passes the deadline."""
    while not conn.poll(0.2):
        if proc.exitcode is not None:
            raise RuntimeError(f"tp rank {rank} exited with code "
                               f"{proc.exitcode} before it was {kind}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"tp rank {rank} was not {kind} in time")
    got, detail = conn.recv()
    if got != kind:
        raise RuntimeError(f"tp rank {rank} failed to start:\n{detail}")


def backend_for(devices, backend: str | None = None) -> str | None:
    """The backend asked for; else gloo where a device is listed twice
    (ranks sharing a card: NCCL refuses them), else None (the devices'
    own, make_mesh's default)."""
    if backend is None and devices is not None and \
            len({str(torch.device(d)) for d in devices}) < len(devices):
        return "gloo"
    return backend


def start(cfg: MeshConfig, build: Callable[[Mesh], Any],
          devices=None, backend: str | None = None,
          timeout: float = START_SECS) -> tuple[Any, Ranks]:
    """Start a tp group: `build(mesh)` → an engine, or a dict of named
    engines, on every rank (a picklable callable: a top-level function or
    a partial of one).  Returns rank 0's, each engine's `ranks` set, and
    the handle.  Ranks on one card talk over gloo (`backend_for`).  Raises
    if a worker fails to build or does not report within `timeout`
    seconds."""
    import torch.multiprocessing as mp

    if cfg.dp != 1:
        raise ValueError("a tp group is one row of the mesh: dp replicas "
                         "are parallel/replicas.py's")
    mesh = make_mesh(cfg, devices, backend_for(devices, backend))
    store = tempfile.mkdtemp(prefix="aha-tp-")
    init = "file://" + os.path.join(store, "rendezvous")
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        for r in range(1, cfg.tp):
            parent_end, child_end = ctx.Pipe()
            p = ctx.Process(target=_worker, name=f"aha-tp-rank{r}",
                            args=(r, mesh, init, child_end, build,
                                  os.getpid()), daemon=True)
            p.start()
            child_end.close()
            procs.append(p)
            conns.append(parent_end)
        deadline = time.monotonic() + timeout
        for r, (p, c) in enumerate(zip(procs, conns), 1):
            _expect(r, p, c, "started", deadline)
        mesh.join(init)
        with torch.no_grad():
            built = build(mesh)
        for r, (p, c) in enumerate(zip(procs, conns), 1):
            _expect(r, p, c, "ready", deadline)
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        mesh.leave()
        shutil.rmtree(store, ignore_errors=True)
        raise
    ranks = Ranks(mesh, procs, conns, store, built)
    named = built.items() if isinstance(built, dict) else [(None, built)]
    for name, engine in named:
        engine.ranks, engine.tp_name = ranks, name
    return built, ranks
