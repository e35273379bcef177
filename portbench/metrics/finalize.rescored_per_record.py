"""Survivor pairs the host rescored in f64 per record processed in the
window (``ProfileStats.pairs_rescored`` over ``records_processed``)."""

NAME = "finalize.rescored_per_record"
UNIT = "pairs"
LAYER = "finalize"
MOVES = "records_per_s"
SOURCE = "program_counter"


def read(run):
    records = run.window.get("proc.records_processed", 0)
    if records <= 0:
        return None
    return run.window["proc.pairs_rescored"] / records
