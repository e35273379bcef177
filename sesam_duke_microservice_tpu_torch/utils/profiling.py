"""Per-block device traces (the ``trace_batch`` level of the JAX package's
``utils/profiling.py``, on ``torch.profiler``).

``PROFILE_TRACE_DIR=/path`` wraps the first ``PROFILE_TRACE_BATCHES``
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
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import threading

from ..env import env_int, env_str

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
