"""Runs of ``portbench/run.py --rehearse`` for the tests: on the CPU, at a
tiny size, each in a session of its own so that any process it leaves
behind can be found afterwards."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def session_members(sid):
    """Pids of live processes whose session id is ``sid``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if fields[0] != "Z" and int(fields[3]) == sid:
            out.append(int(entry))
    return out


class Result:
    def __init__(self, code, out, err, seconds, leftovers):
        self.code = code
        self.out = out
        self.err = err
        self.seconds = seconds
        self.leftovers = leftovers
        lines = [l for l in out.splitlines() if l.strip()]
        self.line = json.loads(lines[-1]) if lines else None

    def check(self, name):
        return self.line["checks"][name]["value"]


def rehearse(tmp_path, *extra, workload="dedup-stresstest.pipes", seed=7,
             seconds=2, timeout=300):
    env = dict(os.environ, TMPDIR=str(tmp_path), HOME=str(tmp_path),
               XDG_CACHE_HOME=str(tmp_path / "cache"), OMP_NUM_THREADS="2")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
         "--rehearse", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds_taken = time.monotonic() - t0
    time.sleep(0.2)
    leftovers = session_members(proc.pid)
    for pid in leftovers:
        try:
            os.kill(pid, 9)
        except ProcessLookupError:
            pass
    return Result(proc.returncode, out, err, seconds_taken, leftovers)
