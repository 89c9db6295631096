"""Processes for the port's multi-rank tests on the CPU: N ranks of one
``gloo`` world, each a process of its own (never the pytest process, so
no default process group leaks into other tests), and the one-process
children (a JAX child with forced host devices, a fake-world child),
each at a nice level of 10.

Rendezvous is through a file under the test's temporary directory, so
files that run at the same time under ``pytest -n`` never share a port.
A rank script is :data:`PRELUDE` + the test's body + :data:`EPILOGUE`:
the body fills ``RESULTS``, which the epilogue saves for the test to
read with :func:`load_ranks`."""

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Sequence

import torch

REPO = Path(__file__).resolve().parents[1]

# a child yields the CPU to the test workers beside it: timing tests in
# other files must not see its load
NICE = "import os\nos.nice(10)\n"

PRELUDE = NICE + r"""
import sys
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        rank=RANK, world_size=WORLD)
RESULTS = {}
"""

EPILOGUE = r"""
torch.save(RESULTS, f"{OUT}/rank{RANK}.pt")
dist.barrier()
dist.destroy_process_group()
"""


def _env() -> dict:
    src = str(REPO / "src")
    old = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": f"{src}:{old}" if old else src,
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def _start(cmd: List[str], log: Path) -> subprocess.Popen:
    # output to a file, never a pipe: a chatty child cannot block on it
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                text=True, env=_env())
    proc.log = log
    return proc


def start_ranks(body: str, world: int, tmp: Path,
                args: Sequence[str] = ()) -> List[subprocess.Popen]:
    """Start ``world`` gloo ranks running ``body``; their results go to
    ``tmp``.  Extra ``args`` follow the four the prelude reads."""
    script = tmp / "ranks.py"
    script.write_text(PRELUDE + body + EPILOGUE)
    rdzv = tmp / "rdzv"
    return [_start([sys.executable, str(script), str(r), str(world),
                    str(rdzv), str(tmp), *args], tmp / f"rank{r}.log")
            for r in range(world)]


def start_child(script: str, tmp: Path, name: str,
                args: Sequence[str] = ()) -> subprocess.Popen:
    """Start one child process running ``script`` with ``args`` (the
    file is ``child_<name>.py``: a ``jax.py`` would shadow the package)."""
    path = tmp / f"child_{name}.py"
    path.write_text(NICE + script)
    return _start([sys.executable, str(path), *args],
                  tmp / f"child_{name}.log")


def finish(procs: Sequence[subprocess.Popen], timeout: float = 240) -> None:
    """Wait for every process.  As soon as one fails (a rank's peers would
    wait on it forever), or at ``timeout`` seconds, kill the rest and
    fail with the failed processes' output."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(p.args[1:3], p.returncode, p.log.read_text()[-4000:])
           for p in procs if p.returncode != 0]
    assert not bad, bad


def load_ranks(tmp: Path, world: int) -> list:
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
