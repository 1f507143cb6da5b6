"""A cell over several ranks (`"ranks": W` in its traffic file), one card
each.  The run's own process is rank 0: it starts ranks 1..W-1 as workers of
the same command (`--rank k` added), each with the variables `torchrun`
would set (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, TORCHELASTIC_USE_AGENT_STORE), so that every rank joins the
program's process group through its own
`parallel/mesh.maybe_init_distributed` and `make_mesh`, as
`scripts.train --mesh` under `torchrun` does.  As under `torchrun`, the
group's TCP store is the launcher's: rank 0 opens it on a port of
localhost that the system chooses (no port is picked first and bound
later, which another socket can take in between) and sends the port to
each worker on its standard input; every rank's group joins it as a
client.

Rank 0 forwards each worker's output to its standard error, line by line,
prefixed with the worker's rank, and ends the run (exit code 3, no result,
every worker killed) when a worker exits with another code than 0 or a
deadline it set passes; a worker ends itself when rank 0 is gone.  The
store also carries, under keys of the harness's own, what the host needs and
no device waits on: barriers with a timeout, rank 0's word after each
iteration of the window on whether another runs, and small values sent to
rank 0.  The captured rows are joined on rank 0 over the program's group
(`joiner`)."""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import threading
import time

# seconds rank 0 gives each stretch of a run before it ends the run
JOIN_S = 300.0          # the workers started and the group joined
SETUP_S = 1100.0        # the job built (a first run compiles) and warmed
CHECK_S = 600.0         # the capture joined and the reference's check
# seconds a barrier or a word from rank 0 may be waited for
WAIT_S = 600.0


def log(msg: str):
    # one write a line, so that lines forwarded from other ranks do not
    # break into it
    sys.stderr.write(f"portbench: {msg}\n")
    sys.stderr.flush()


def _store(port: int, world: int, master: bool):
    """The run's TCP store on localhost: rank 0 opens it (`port` 0: the
    system's choice), the others join it."""
    import torch.distributed as dist
    return dist.TCPStore("127.0.0.1", port, world, master,
                         timeout=datetime.timedelta(seconds=WAIT_S),
                         wait_for_workers=False)


class Ranks:
    """This process's place among the run's ranks, and the store they
    share.  Rank 0 holds the workers it started."""

    def __init__(self, rank: int, world: int, store, procs=()):
        self.rank = rank
        self.world = world
        self.store = store
        self.procs = list(procs)
        self._readers = []
        self._timer = None
        self._done = False
        self._count = 0         # names of barriers and words, in step

    # -- rank 0's watch over the workers ----------------------------------------
    def _forward(self, k: int, proc):
        for line in proc.stdout:
            sys.stderr.write(f"rank {k}: {line}")
            sys.stderr.flush()

    def _watch(self):
        while not self._done:
            for k, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0):
                    self._readers[k - 1].join(timeout=10)
                    self.abort(f"rank {k} exited with code {rc}")
            time.sleep(0.2)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def abort(self, why: str):
        """Ends the run: every worker killed, exit code 3, no result."""
        log(f"{why}: the run ends without a result")
        self.kill()
        sys.stderr.flush()
        os._exit(3)

    def deadline(self, seconds: float, what: str):
        """On rank 0, end the run if `what` is not done in `seconds` (until
        the next deadline)."""
        if self.rank:
            return
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(
            seconds, self.abort, (f"{what} took more than {seconds:.0f} s",))
        self._timer.daemon = True
        self._timer.start()

    def finish(self, timeout: float = 120.0) -> bool:
        """On rank 0, wait for every worker to exit; whether each exited
        with 0 (one still running after `timeout` is killed)."""
        self._done = True
        if self._timer is not None:
            self._timer.cancel()
        ok = True
        for k, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                log(f"rank {k} still running after {timeout:.0f} s: killed")
                rc = None
            if rc != 0:
                ok = False
                if rc is not None:
                    log(f"rank {k} exited with code {rc}")
        self.kill()
        for r in self._readers:
            r.join(timeout=10)
        return ok

    # -- host-side exchange ------------------------------------------------------
    def _key(self, kind: str) -> str:
        """A new key, the same on every rank: each rank makes the same
        calls in the same order."""
        self._count += 1
        return f"{kind}/{self._count}"

    def barrier(self):
        """Every rank's host waits here for the others (WAIT_S at most)."""
        key = self._key("barrier")
        self.store.set(f"{key}/{self.rank}", b"1")
        self.store.wait([f"{key}/{r}" for r in range(self.world)],
                        datetime.timedelta(seconds=WAIT_S))

    def go_on(self, mine: bool) -> bool:
        """After an iteration of a window: rank 0 says whether another
        runs (`mine`); every rank returns rank 0's word."""
        key = self._key("go")
        if self.rank == 0:
            self.store.set(key, b"1" if mine else b"0")
            return mine
        return self.store.get(key) == b"1"

    def gather(self, value):
        """Rank 0: every rank's `value` (picklable and small), in rank
        order; the others: None."""
        key = self._key("value")
        self.store.set(f"{key}/{self.rank}", pickle.dumps(value))
        if self.rank:
            return None
        return [pickle.loads(self.store.get(f"{key}/{r}"))
                for r in range(self.world)]


def start(module: str, argv, world: int, root: str) -> Ranks:
    """Rank 0: ranks 1..world-1 started as `python -m module argv --rank k`
    from `root` (first, so that their imports overlap this process's),
    the store opened, its port sent to each on its standard input, and the
    launcher's variables set for this process."""
    env = dict(os.environ, WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               TORCHELASTIC_USE_AGENT_STORE="True")
    # NCCL's shared-memory transport is not used between the cards of one
    # host joined by NVLink, and a container's small /dev/shm can fail it
    env.setdefault("NCCL_SHM_DISABLE", "1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(k)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=root,
        env=dict(env, RANK=str(k), LOCAL_RANK=str(k)))
        for k in range(1, world)]
    r = Ranks(0, world, None, procs)
    for k, p in enumerate(procs, 1):
        t = threading.Thread(target=r._forward, args=(k, p), daemon=True)
        t.start()
        r._readers.append(t)
    threading.Thread(target=r._watch, daemon=True).start()
    r.store = _store(0, world, True)
    os.environ.update(env, MASTER_PORT=str(r.store.port), RANK="0",
                      LOCAL_RANK="0")
    for p in procs:
        p.stdin.write(f"{r.store.port}\n")
        p.stdin.close()
    return r


def attach(rank: int, world: int) -> Ranks:
    """A worker: the store's port read from rank 0 on standard input and
    the store joined, and a watch that ends this process when rank 0, its
    parent, is gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(3)
    threading.Thread(target=watch, daemon=True).start()
    port = sys.stdin.readline().strip()
    if not port:
        log("rank 0 sent no store port")
        os._exit(3)
    os.environ["MASTER_PORT"] = port
    return Ranks(rank, world, _store(int(port), world, False))


def join_mesh(device: str):
    """This rank's env mesh: the program's process group joined from the
    launcher's variables (parallel/mesh.maybe_init_distributed), then the
    mesh over it, on this rank's card (`device` "cuda") or the CPU; the
    program picks the backend (NCCL with a card a rank, gloo on the CPU).
    The program's kernel builds are made one rank at a time from here
    on (`one_build_at_a_time`)."""
    from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod
    one_build_at_a_time()
    mesh_mod.maybe_init_distributed(device=device)
    return mesh_mod.make_mesh(device=device)


def one_build_at_a_time():
    """The program's kernel builds (`ops/_build.build_libraries`) made
    under an exclusive lock on a file of its build directory: the ranks of
    a run share that directory, and a build there rewrites files that
    another rank's compiler may be reading.  The first rank to come builds
    what is missing; the others then find it built and load it."""
    import fcntl

    from walk_these_ways_tpu_torch.ops import _build
    orig = _build.build_libraries
    lock = os.path.join(_build.build_dir(), ".portbench.lock")

    def build_libraries(specs):
        os.makedirs(os.path.dirname(lock), exist_ok=True)
        with open(lock, "a") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                return orig(specs)
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)
    _build.build_libraries = build_libraries


def joiner(rank: int, world: int, device):
    """`join(x, axis)` for capture.join_ranks: every rank's `x` (same
    shape and dtype on every rank) gathered to rank 0 over the process
    group, through `device`, and joined along `axis` on the host there."""
    import torch
    import torch.distributed as dist

    def join(x, axis):
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        t = wire.contiguous().to(device)
        parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 \
            else None
        dist.gather(t, parts, dst=0)
        if rank:
            return None
        out = torch.cat(parts, dim=axis).cpu()
        del parts
        return out.to(torch.bool) if x.dtype == torch.bool else out
    return join
