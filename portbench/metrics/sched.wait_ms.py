"""Mean queue wait of a request in the ingest scheduler over the window
(``wait_hist`` total over its count, both as deltas)."""

NAME = "sched.wait_ms"
UNIT = "ms"
LAYER = "ingest scheduler"
MOVES = "post_p50_ms"
SOURCE = "program_counter"


def read(run):
    count = run.window.get("sched.wait_count", 0)
    if count <= 0:
        return None
    return 1e3 * run.window["sched.wait_total_s"] / count
