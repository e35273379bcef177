"""Device-timeline captures (the JAX package's ``utils/profiling.py`` on
``torch.profiler``), at two levels.

**Per-block traces.**  ``PROFILE_TRACE_DIR=/path`` wraps the first ``PROFILE_TRACE_BATCHES``
(default 3) scored blocks in ``torch.profiler.profile`` (CPU and, where
there is a card, CUDA activity) with a ``record_function`` span named
after the block, and writes one Chrome trace per block into the
directory.  Bounded because traces are large and the service runs long;
``reset_trace_budget`` re-arms the budget.

The window holds a block's dispatch and the wait for its results
(``dispatch_block`` and ``resolve_block`` in ``engine.device_matcher``):
the profiler records only kernels launched while it is open, so while a
trace is armed (``trace_armed``) the scorer holds back its one-block
lookahead and dispatches each traced block inside its own window.

**On-demand capture.**  ``start_capture(seconds)`` (``POST
/debug/profile?seconds=N``) opens a ``torch.profiler`` capture now, for N
seconds, with no restart and no env preconfiguration; a timer thread
stops it and writes one Chrome trace (``capture-<pid>-<n>.json``) into
``PROFILE_TRACE_DIR`` or a fresh temporary directory.  While it is live,
tracing spans created with ``annotate=True`` (the engine's encode and
persist phases, the streamed append) also open
``torch.profiler.record_function`` ranges.  The capture is process-wide:
CUPTI records every kernel the process launches, whichever thread
launched it, and the CPU-side operators and ranges of the threads that
run while it is live (the scheduler's dispatcher, the HTTP handlers).
Only one capture runs at a time; a second ``start_capture`` raises
``CaptureActiveError``.  A per-block trace armed at the same moment
would collide with it (the profiler is one per process), so leave
``PROFILE_TRACE_DIR``'s budget spent while capturing on demand.

**One clock with the spans.**  As the profiler starts, the session reads
``time.monotonic_ns()`` and opens a ``duke.clock_anchor`` range back to
back; the span clock and the trace's clock then differ by the range's
start less that reading.  When the profiler stops, the session writes
every retained span (``telemetry.tracing.RECORDER``) that overlaps the
capture into the Chrome trace, shifted by that offset, on a process row
of its own (``SPAN_ROW_PID``, a thread row per trace): an idle gap on
the device rows then lies under the host span that was open.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Any, Dict, Optional

from ..env import env_int, env_str
from ..telemetry import tracing as _tracing

logger = logging.getLogger("profiling")

_lock = threading.Lock()
_traced_batches = 0


def trace_dir() -> str:
    return env_str("PROFILE_TRACE_DIR", "")


def _trace_budget() -> int:
    return env_int("PROFILE_TRACE_BATCHES", 3)


def trace_armed() -> bool:
    """Whether the next ``trace_batch`` would trace (budget not spent)."""
    if not trace_dir():
        return False
    with _lock:
        return _traced_batches < _trace_budget()


def reset_trace_budget() -> int:
    """Re-arm the PROFILE_TRACE_DIR block-capture budget.  Returns the
    re-armed budget."""
    global _traced_batches
    with _lock:
        _traced_batches = 0
    return _trace_budget()


@contextlib.contextmanager
def trace_batch(label: str):
    """Wrap one scored block in a ``torch.profiler`` trace when enabled.

    No-op unless ``PROFILE_TRACE_DIR`` is set and the trace budget has not
    been spent.  Only profiler setup / teardown failures are swallowed
    (they log); exceptions of the traced block propagate untouched.
    """
    global _traced_batches
    directory = trace_dir()
    if not directory:
        yield
        return
    with _lock:
        spent = _traced_batches >= _trace_budget()
        if not spent:
            _traced_batches += 1
            n = _traced_batches
    if spent:
        yield
        return
    stack = contextlib.ExitStack()
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = stack.enter_context(profile(activities=activities))
        stack.enter_context(record_function(label))
    except Exception:
        # return the unused budget slot so later healthy blocks still trace
        stack.close()
        prof = None
        with _lock:
            _traced_batches -= 1
        logger.exception("device trace setup failed (block continues)")
    try:
        yield
    finally:
        try:
            stack.close()
            if prof is not None:
                os.makedirs(directory, exist_ok=True)
                name = re.sub(r"[^\w.-]+", "_", label)
                path = os.path.join(
                    directory, f"trace-{os.getpid()}-{n:04d}-{name}.json")
                prof.export_chrome_trace(path)
                logger.info("captured device trace %d/%d (%s) into %s",
                            n, _trace_budget(), label, path)
        except Exception:
            logger.exception("device trace teardown failed (block continues)")


# -- on-demand capture (POST /debug/profile) ---------------------------------

_CAPTURE_SEQ = itertools.count(1)
# the clock anchor's range name, and the process row the retained spans
# take in a capture's Chrome trace (far from the profiler's own rows:
# the host's pid and the cards' indices)
CLOCK_ANCHOR = "duke.clock_anchor"
SPAN_ROW_PID = 1 << 30


def _write_spans(path: str, anchor_mono_ns: int, stop_mono_ns: int) -> None:
    """Write every span the flight recorder retained that overlaps
    [anchor_mono_ns, stop_mono_ns] (monotonic) into the Chrome trace at
    ``path``, on the trace's clock: the offset is the ``CLOCK_ANCHOR``
    range's start in the file less ``anchor_mono_ns``, the monotonic
    reading taken as the range opened."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    anchor_us = next((e["ts"] for e in events
                      if e.get("name") == CLOCK_ANCHOR and "ts" in e), None)
    if anchor_us is None:
        logger.warning("%s holds no %s range: no spans written", path,
                       CLOCK_ANCHOR)
        return
    offset_us = float(anchor_us) - anchor_mono_ns / 1e3
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_ROW_PID,
                   "tid": 0, "args": {"name": "duke spans"}})
    recorder = _tracing.RECORDER
    for tid, row in enumerate(recorder.summaries()):
        record = recorder.get(row["trace_id"])
        if record is None:
            continue
        for s in record.spans:
            if s.end_ns < anchor_mono_ns or s.start_ns > stop_mono_ns:
                continue
            events.append({
                "ph": "X", "cat": "duke", "name": s.name,
                "pid": SPAN_ROW_PID, "tid": tid,
                "ts": s.start_ns / 1e3 + offset_us,
                "dur": max(s.duration_ns, 0) / 1e3,
                "args": {"trace_id": record.trace_id, "span_id": s.span_id,
                         "parent_id": s.parent_id, "status": s.status,
                         **(s.attributes or {})},
            })
    with open(path, "w") as f:
        json.dump(doc, f, default=str)


class _Session:
    """One ``torch.profiler`` session on a thread of its own.

    The profiler must stop on the thread that started it (stopping it
    from another thread finds no session there and crashes the process),
    so the session's thread starts it, waits for the deadline or an
    early stop, then stops it and writes the Chrome trace."""

    def __init__(self, logdir: str, seconds: float):
        self.logdir = logdir
        self.seconds = seconds
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._started = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="profile-capture")

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            self._thread.join()
            raise self.error

    def _run(self) -> None:
        try:
            import torch
            from torch.profiler import (
                ProfilerActivity,
                profile,
                record_function,
            )

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            # the clock anchor: a monotonic reading and a range opened
            # back to back (the range's start is the reading on the
            # trace's clock)
            anchor = record_function(CLOCK_ANCHOR)
            anchor_ns = time.monotonic_ns()
            anchor.__enter__()
            anchor.__exit__(None, None, None)
        except BaseException as e:  # reported by start()
            self.error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait(self.seconds)
        try:
            prof.stop()
            stop_ns = time.monotonic_ns()
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(
                self.logdir,
                f"capture-{os.getpid()}-{next(_CAPTURE_SEQ):04d}.json")
            prof.export_chrome_trace(path)
            self.path = path
        except BaseException as e:  # reported by stop()
            self.error = e
            return
        try:
            _write_spans(path, anchor_ns, stop_ns)
        except Exception:
            # the device capture stands without the spans
            logger.exception("writing the spans into %s failed", path)

    def stop(self) -> str:
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.path


# the live session of the on-demand capture (None when idle)
_SESSION: Optional[_Session] = None


# seam for tests: the two torch.profiler touch points, monkeypatchable so
# endpoint tests never spin a real profiler session
def profiler_start(logdir: str, seconds: float) -> None:
    """Open a process-wide ``torch.profiler`` session (CPU activity, and
    CUDA activity where there is a card) that ends by itself after
    ``seconds``."""
    global _SESSION
    session = _Session(logdir, seconds)
    session.start()
    _SESSION = session


def profiler_stop() -> str:
    """End the session and return the Chrome trace file it wrote."""
    global _SESSION
    session, _SESSION = _SESSION, None
    return session.stop()


MAX_CAPTURE_SECONDS = 600.0

_capture_lock = threading.Lock()
_capture: Optional[Dict[str, Any]] = None


def capture_status() -> Optional[Dict[str, Any]]:
    """The live capture's public info, or None."""
    with _capture_lock:
        if _capture is None:
            return None
        info = {k: _capture[k] for k in
                ("dir", "seconds", "started_unix", "owner",
                 "deadline_unix")}
        info["remaining_seconds"] = round(
            max(0.0, _capture["until"] - time.monotonic()), 3)
        return info


def start_capture(seconds: float, logdir: Optional[str] = None,
                  owner: str = "app") -> Dict[str, Any]:
    """Open a ``torch.profiler`` capture now for ``seconds`` seconds.

    A timer thread ends the capture (``stop_capture``), and while it is
    live the tracing layer bridges its ``annotate=True`` spans into
    ``record_function`` ranges.  A second ``start_capture`` raises
    ``CaptureActiveError`` carrying the live capture's owner and deadline
    (the endpoint's 409 body); a failure to start propagates to the
    caller (the endpoint answers 500) with no state latched.
    """
    seconds = float(seconds)
    if not (0 < seconds <= MAX_CAPTURE_SECONDS):
        raise ValueError(
            f"capture seconds must be in (0, {MAX_CAPTURE_SECONDS:g}]"
        )
    global _capture
    with _capture_lock:
        if _capture is not None:
            raise CaptureActiveError(
                f"a device capture (owner={_capture['owner']}) is "
                f"already running into {_capture['dir']}",
                owner=_capture["owner"],
                deadline_unix=_capture["deadline_unix"],
                remaining_seconds=round(
                    max(0.0, _capture["until"] - time.monotonic()), 3),
            )
        directory = (logdir or trace_dir()
                     or tempfile.mkdtemp(prefix="duke-profile-"))
        profiler_start(directory, seconds)
        _tracing.set_device_annotations(True)
        timer = threading.Timer(seconds, stop_capture)
        timer.daemon = True
        _capture = {
            "dir": directory,
            "seconds": seconds,
            "started_unix": round(time.time(), 3),
            "deadline_unix": round(time.time() + seconds, 3),
            "until": time.monotonic() + seconds,
            "owner": owner,
            "timer": timer,
        }
        timer.start()
        logger.info("on-demand device capture started: %.3gs into %s "
                    "(owner=%s)", seconds, directory, owner)
        return {k: _capture[k] for k in
                ("dir", "seconds", "started_unix", "deadline_unix",
                 "owner")}


def stop_capture() -> Optional[Dict[str, Any]]:
    """End the live capture (timer callback; also callable early).
    Returns the finished capture's info (with ``trace_file``, the Chrome
    trace written), or None if none was live."""
    global _capture
    with _capture_lock:
        if _capture is None:
            return None
        done, _capture = _capture, None
        done.pop("until", None)
        timer = done.pop("timer", None)
        if timer is not None:
            timer.cancel()
        _tracing.set_device_annotations(False)
        try:
            done["trace_file"] = profiler_stop()
            logger.info("on-demand device capture finished: %s",
                        done["trace_file"])
        except Exception:
            logger.exception("on-demand capture teardown failed")
            done["error"] = "profiler stop failed (see logs)"
        return done


class CaptureActiveError(RuntimeError):
    """A second ``start_capture`` while one is live (endpoint: 409).

    Carries the live capture's owner and deadline so the 409 body can say
    who holds the profiler and until when."""

    def __init__(self, message: str, owner: Optional[str] = None,
                 deadline_unix: Optional[float] = None,
                 remaining_seconds: Optional[float] = None):
        super().__init__(message)
        self.owner = owner
        self.deadline_unix = deadline_unix
        self.remaining_seconds = remaining_seconds
