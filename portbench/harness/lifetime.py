"""A run's processes and its end.

A run is one process.  It serves the port in-process and sends from
threads; it starts no server or client process.  What the port itself
spawns (``nvcc`` and ``g++`` while it builds, waited for) ends before the
window.  At the end the run lists its own children, kills any it finds
and counts that as a failure, then leaves with ``os._exit`` so that no
thread holds the process open.  A watchdog thread ends a run that
overruns its deadline, after printing a failing last line.
"""

import json
import os
import signal
import sys
import threading
import time


def children(pid=None):
    """Pids of the direct children of this process (every thread's)."""
    pid = os.getpid() if pid is None else pid
    out = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tasks:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                out.extend(int(x) for x in f.read().split())
        except OSError:
            continue
    return sorted(set(out))


def kill_children():
    """Kill and reap every child; returns the pids found."""
    found = children()
    for child in found:
        try:
            os.kill(child, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for child in found:
        try:
            os.waitpid(child, 0)
        except ChildProcessError:
            pass
    return found


def failing_line(reason, device=None):
    """The last line of a run that cannot stand: ``correct`` false."""
    return json.dumps({"correct": False, "attempted": 0, "failed": 0,
                       "metrics": {}, "device": device or {},
                       "error": reason})


class Watchdog:
    """Ends the process at ``deadline`` (monotonic) unless cancelled."""

    def __init__(self, deadline, exit_code=3):
        self.deadline = deadline
        self.exit_code = exit_code
        self._cancel = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="portbench-watchdog")

    def start(self):
        self._thread.start()
        return self

    def extend_to(self, deadline):
        self.deadline = deadline

    def cancel(self):
        self._cancel.set()

    def _run(self):
        while not self._cancel.wait(0.2):
            if time.monotonic() >= self.deadline:
                found = kill_children()
                reason = "the watchdog ended a run that overran its deadline"
                if found:
                    reason += f"; killed child processes {found}"
                print(reason, file=sys.stderr, flush=True)
                print(failing_line(reason), flush=True)
                os._exit(self.exit_code)


def leave(code):
    """Flush and exit without waiting for any thread."""
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    finally:
        os._exit(code)
