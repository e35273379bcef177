"""Share of the measured window in which no operation ran on the device."""

NAME = "device.idle_share"
UNIT = "%"
LAYER = "device"
MOVES = "records_per_s"
SOURCE = "device_trace"


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
