"""Median wall of the poller's ``?since=`` reads in the window."""

import statistics

NAME = "feed.poll_ms"
UNIT = "ms"
LAYER = "service read surface"
MOVES = "post_p50_ms"
SOURCE = "host_clock"


def read(run):
    if not run.polls_ms:
        return None
    return statistics.median(run.polls_ms)
