"""Spawned gloo worlds for the port's multi-rank tests on the CPU.

``run_world`` starts ``world`` ranks of ``python <script> worker <rank>
<tmp>``, each logging to ``<tmp>/rank<r>.log``; the script's worker
meets its peers over a ``file://`` rendezvous in ``tmp`` (so parallel
test workers never share a port). ``join_world`` waits for them and
kills the rest once one fails or the deadline passes, so a world fails
its tests and never hangs them.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_world(script, world: int, tmp: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(script), "worker", str(r), str(tmp)],
                                       stdout=log, stderr=subprocess.STDOUT, env=env,
                                       cwd=str(ROOT)), log))
    return procs


def join_world(procs, tmp: Path, deadline: float, timeout_s: float):
    """Wait for every rank; once one fails (its peers then wait on it for
    ever) or the deadline passes, kill the rest."""
    while time.monotonic() < deadline:
        rcs = [p.poll() for p, _ in procs]
        if all(rc is not None for rc in rcs) or any(rc not in (None, 0) for rc in rcs):
            break
        time.sleep(0.2)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    rcs = [p.returncode for p, _ in procs]
    if any(rc != 0 for rc in rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}):\n" + (tmp / f"rank{r}.log").read_text()[-3000:]
                          for r, rc in enumerate(rcs) if rc not in (0, -9))
        raise AssertionError(f"gloo world failed or timed out ({timeout_s} s):\n{tails}")
