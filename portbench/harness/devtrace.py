"""The device trace of a ``--trace 1`` run, over the run's own window.

``torch.profiler`` records the device work of every thread (CUPTI) and
the CPU ranges of the thread that started it.  That thread opens one
range, ``portbench.window``, from the window's start to its close, so the
window is known on the trace's own clock; device time outside it is not
counted.  The port's request spans (monotonic clock) are put on the same
clock by the offset between the range's start and the monotonic reading
taken as it opened.
"""

import time

from .stats import gaps, union_length

WINDOW_RANGE = "portbench.window"
TOP = 10


class Trace:
    """What a traced window read: busy and window seconds, device time
    and kernel launches by name, the longest idle gaps."""

    def __init__(self, window_s, busy_s, by_name, launches, idle, offset_ns):
        self.window_s = window_s
        self.busy_s = busy_s
        self.by_name = by_name        # name -> [launches, seconds]
        self.launches = launches
        self.idle = idle              # [(start_ns, end_ns)] on the trace clock
        self.offset_ns = offset_ns

    def seconds_of(self, fragment):
        return sum(s for name, (_, s) in self.by_name.items()
                   if fragment in name)

    def device_ops(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name[:120], seconds] for name, (_, seconds) in top]

    def idle_gaps(self, spans):
        """The TOP longest idle gaps, each named by the innermost of the
        port's request spans open on the host at the gap's middle."""
        longest = sorted(self.idle, key=lambda g: g[0] - g[1])[:TOP]
        out = []
        for start, end in longest:
            mid = (start + end) // 2 - self.offset_ns
            label, width = "no request span open", None
            for name, s0, s1 in spans:
                if s0 <= mid < s1 and (width is None or s1 - s0 < width):
                    label, width = name, s1 - s0
            out.append([label, (end - start) / 1e9])
        return out


def _start_ns(e):
    try:
        return e.start_ns()
    except AttributeError:
        return int(e.start_us() * 1000)


def _duration_ns(e):
    try:
        return e.duration_ns()
    except AttributeError:
        return int(e.duration_us() * 1000)


def _is_device(event):
    import torch

    return event.device_type() == torch.autograd.DeviceType.CUDA


def _is_launch(name):
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def summarize(events, mono_at_window_start):
    """A ``Trace`` from kineto events, or None when the window range or
    any device work in it is missing."""
    marker = [e for e in events if e.name() == WINDOW_RANGE]
    if not marker:
        return None
    w0 = _start_ns(marker[0])
    w1 = w0 + _duration_ns(marker[0])
    intervals, by_name, launches = [], {}, 0
    for e in events:
        if not _is_device(e):
            continue
        s = _start_ns(e)
        t = s + _duration_ns(e)
        if t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        intervals.append((s, t))
        row = by_name.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += (t - s) / 1e9
        if _is_launch(e.name()):
            launches += 1
    if not intervals:
        return None
    busy = union_length(intervals, w0, w1)
    idle = gaps(intervals, w0, w1)
    return Trace((w1 - w0) / 1e9, busy / 1e9, by_name, launches, idle,
                 w0 - mono_at_window_start)


class DeviceTracer:
    """Profiler around the window.  ``open_window`` on the thread that
    started it; ``close_window`` and ``stop`` after the window."""

    def __init__(self, cuda):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.range = None
        self.mono0 = None

    def start(self):
        self.prof.start()

    def open_window(self):
        from torch.profiler import record_function

        self.range = record_function(WINDOW_RANGE)
        self.mono0 = time.monotonic_ns()
        self.range.__enter__()

    def close_window(self):
        self.range.__exit__(None, None, None)

    def stop(self):
        self.prof.stop()
        return summarize(self.prof.profiler.kineto_results.events(),
                         self.mono0)
