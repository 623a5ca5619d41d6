"""Start the ranks of a data-parallel run of the port from a test.

Each rank is a fresh Python process with the environment ``torchrun``
gives its children (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` on a free port of this host), one
thread each, so ``parallel.create_mesh`` joins a ``gloo`` group on the
CPU. The ranks are joined with a timeout: a collective that deadlocks
fails the test instead of holding the suite.
"""
import os
import pathlib
import socket
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The processes of one launch, started; ``join`` waits for them."""

    def __init__(self, script: str, world: int, workdir, args=(),
                 timeout=150):
        workdir = pathlib.Path(workdir)
        path = workdir / "rank_script.py"
        path.write_text(script)
        port = str(free_port())
        self.world, self.timeout = world, timeout
        self.procs, self.logs = [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                       PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
            # files, not pipes: a rank never blocks on a full pipe while
            # the test is busy before its join
            logs = (workdir / f"rank{rank}.stdout",
                    workdir / f"rank{rank}.stderr")
            with open(logs[0], "w") as out, open(logs[1], "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(path), *map(str, args)],
                    cwd=str(workdir), env=env, stdout=out, stderr=err))
            self.logs.append(logs)

    def join(self):
        """Each rank's stdout. Fails the test with the ranks' stderr if one
        exits non-zero or the launch outlasts its timeout (counted from
        the join)."""
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait()
            pytest.fail(f"the {self.world} ranks outlasted {self.timeout} s "
                        "(a collective deadlocked?)")
        outs = [(p.returncode, out.read_text(), err.read_text())
                for p, (out, err) in zip(self.procs, self.logs)]
        failed = [(r, rc, err) for r, (rc, _, err) in enumerate(outs) if rc]
        if failed:
            pytest.fail("\n".join(f"rank {r} exited {rc}:\n{err[-3000:]}"
                                   for r, rc, err in failed))
        return [out for _, out, _ in outs]


def run_ranks(script: str, world: int, workdir, args=(), timeout=150):
    """Run ``script`` (Python source) as ``world`` ranks in ``workdir``
    with ``args`` after the script's path and wait for them: each rank's
    stdout (see ``Ranks.join``)."""
    return Ranks(script, world, workdir, args, timeout).join()
