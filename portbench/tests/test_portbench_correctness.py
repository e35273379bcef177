"""``correct`` comes out false when the timed path is broken underneath
(each fault the cells can have) and when the control, the reference in
float32, takes the program's place."""

import pytest

from .rehearsal import rehearse


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter", "volatile"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    workload = ("linkage-stresstest.pipes" if fault == "volatile"
                else "dedup-stresstest.pipes")
    r = rehearse(tmp_path, "--rehearse-fault", fault, workload=workload,
                 seed=11)
    assert r.code == 0, r.err[-3000:]
    assert r.line["correct"] is False
    if fault == "alter":
        assert r.check("confidence_gap") > r.line["checks"][
            "confidence_gap"]["limit"]
    elif fault == "volatile":
        assert r.check("links_missing") == 0
        assert r.check("durable_links_missing") > 0
    else:
        assert r.check("links_missing") > 0


@pytest.mark.parametrize("workload", ["dedup-stresstest.pipes",
                                      "linkage-stresstest.pipes"])
def test_the_control_fails_where_the_program_passes(tmp_path, workload):
    program = rehearse(tmp_path, workload=workload, seed=13)
    assert program.code == 0, program.err[-3000:]
    assert program.line["correct"] is True, program.err[-3000:]
    r = rehearse(tmp_path, "--control", workload=workload, seed=13)
    assert r.code == 0, r.err[-3000:]
    checks = r.line["checks"]
    assert r.line["correct"] is False
    assert checks["links_missing"]["value"] == 0
    gap = checks["confidence_gap"]
    assert program.check("confidence_gap") <= gap["limit"] < gap["value"]
