"""Device kernel launches in the window (profiler) per scoring pass
(``ProfileStats.batches`` over the window)."""

NAME = "scan.launches_per_pass"
UNIT = "launches"
LAYER = "scoring"
MOVES = "records_per_s"
SOURCE = "device_trace"


def read(run):
    passes = run.window.get("proc.batches", 0)
    if run.trace is None or passes <= 0:
        return None
    return run.trace.launches / passes
