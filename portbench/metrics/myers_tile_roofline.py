"""The Myers tile kernel's share of its roofline over the window: the
least time the card could take for the Levenshtein tile work of the
window's scoring calls (``harness.peaks``: int32 ops over the int32 peak,
bytes over 3.35 TB/s, the larger, call by call) over the profiler's
summed device time of that kernel in the window."""

NAME = "myers_tile_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "records_per_s"
SOURCE = "device_trace"

KERNEL = "myers_tile_kernel"


def read(run):
    trace = run.trace
    if trace is None or run.myers_least_s is None:
        return None
    seconds = trace.seconds_of(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.myers_least_s / seconds
