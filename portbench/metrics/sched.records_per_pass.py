"""Records the ingest scheduler dispatched per microbatch in the window."""

NAME = "sched.records_per_pass"
UNIT = "records"
LAYER = "ingest scheduler"
MOVES = "records_per_s"
SOURCE = "program_counter"


def read(run):
    passes = run.window.get("sched.microbatches", 0)
    if passes <= 0:
        return None
    return run.window["sched.records_dispatched"] / passes
