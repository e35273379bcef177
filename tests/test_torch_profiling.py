"""The port's per-block device trace (``utils.profiling.trace_batch``)."""

import json
import logging

import pytest

from sesam_duke_microservice_tpu_torch.utils import profiling as P
from test_torch_growth import DEDUP, PORT, Run
from torch_jax_cache import jax_cache_off  # noqa: F401


@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setenv("PROFILE_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("PROFILE_TRACE_BATCHES", "2")
    P.reset_trace_budget()
    yield tmp_path
    P.reset_trace_budget()


def test_scored_blocks_write_one_chrome_trace_each_up_to_the_budget(traced):
    run = Run(PORT, PORT.schema(DEDUP))
    for k in range(3):
        run.feed([PORT.record(f"r{k}_{i}", name=f"acme {i}", city="oslo",
                              amount="100") for i in range(5)])
    traces = sorted(traced.glob("trace-*.json"))
    assert len(traces) == 2
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "score_block[5]" for e in events)
    assert P.reset_trace_budget() == 2


def test_block_errors_propagate_and_setup_errors_do_not(traced, monkeypatch,
                                                       caplog):
    with pytest.raises(KeyError):
        with P.trace_batch("boom"):
            raise KeyError("from the block")
    assert len(list(traced.glob("trace-*.json"))) == 1

    import torch.profiler

    def broken(*args, **kwargs):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with caplog.at_level(logging.ERROR, logger="profiling"):
        with P.trace_batch("setup fails"):
            ran.append(True)
    assert ran == [True]
    assert "device trace setup failed" in caplog.text
    # the slot was given back: the budget of 2 still has one left
    monkeypatch.undo()
    monkeypatch.setenv("PROFILE_TRACE_DIR", str(traced))
    monkeypatch.setenv("PROFILE_TRACE_BATCHES", "2")
    with P.trace_batch("second"):
        pass
    assert len(list(traced.glob("trace-*.json"))) == 2


def test_traced_blocks_hold_their_own_dispatch(traced, monkeypatch):
    """While a trace is armed the one-block lookahead is held back: each
    traced block's window holds its own dispatch and no other block's.
    Once the budget is spent the lookahead resumes, and the events are
    those of an untraced run."""
    from torch.profiler import record_function

    def batch():
        return [PORT.record(f"r{i}", name=f"acme {i % 9}", city="oslo",
                            amount="100") for i in range(110)]

    plain = Run(PORT, PORT.schema(DEDUP))
    with monkeypatch.context() as m:
        m.delenv("PROFILE_TRACE_DIR")
        plain.feed(batch())

    run = Run(PORT, PORT.schema(DEDUP))
    scorers = run.proc._scorers
    real = scorers.dispatch_block

    def marked(block, **kwargs):
        with record_function(f"dispatch_of_{block[0].record_id}"):
            return real(block, **kwargs)

    monkeypatch.setattr(scorers, "dispatch_block", marked)
    run.feed(batch())  # blocks of 32: r0, r32, r64, r96
    traces = sorted(traced.glob("trace-*.json"))
    assert len(traces) == 2
    for path, first in zip(traces, ("r0", "r32")):
        names = {e.get("name") for e in
                 json.loads(path.read_text())["traceEvents"]}
        assert {n for n in names if n and n.startswith("dispatch_of_")} == {
            f"dispatch_of_{first}"}
    assert run.tape.events == plain.tape.events
