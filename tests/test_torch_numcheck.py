"""The port's runtime certified-numerics sanitizer (``DUKE_NUMCHECK``)
against the JAX package's, on the CPU.

* the runtime cases of tests/test_numcheck.py, run on both modules with
  the same arguments: the violation strings, the observation counts and
  the latched ring must be equal;
* the hostprop and mixed schemas of tests/test_torch_finalize.py through
  both packages' device workloads with ``DUKE_NUMCHECK=1``: equal
  observation counts, more than zero, and no violation;
* a broken reject bound injected into the port's finalization is caught.

The gate is per test here (an autouse fixture resets the port's module
before each test and asserts it recorded no violation after it): the JAX
package's session-wide gate lives in tests/conftest.py and reads only the
JAX module.  An injection test resets its own deliberate violation.
"""

import math

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine import device_matcher as jdm
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)
from sesam_duke_microservice_tpu.utils import numcheck as jnumcheck
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import device_matcher as tdm
from sesam_duke_microservice_tpu_torch.engine.workload import (
    build_workload as tbuild,
)
from sesam_duke_microservice_tpu_torch.ops import bounds as TB
from sesam_duke_microservice_tpu_torch.utils import numcheck as tnumcheck

from test_torch_finalize import _BATCH, _config, _entities
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

MODULES = (jnumcheck, tnumcheck)


@pytest.fixture(autouse=True)
def _numcheck_gate():
    """The port's gate, per test: nothing recorded before, no violation
    left after (the JAX module is reset too: its session gate must not
    see this file's traffic twice)."""
    for mod in MODULES:
        mod.reset()
    yield
    found = tnumcheck.violations()
    for mod in MODULES:
        mod.reset()
    assert found == [], found


def _p(logit):
    return 1.0 / (1.0 + math.exp(-logit))


# (kind, id1, id2, total, prob, threshold, maybe, margin) per observation
UNIT_CASES = {
    "agreeing_reject": [("reject", "a", "b", -3.0, _p(-3.0), 0.8, 0.6,
                         1e-9)],
    "reject_disagreement": [("reject", "a", "b", -3.0, 0.95, 0.8, 0.6,
                             1e-9)],
    "event_disagreement": [("event", "a", "b", 4.0, 0.30, 0.8, 0.6, 1e-9)],
    "margin_bound_violation": [("reject", "a", "b", -3.5, _p(-3.0), 0.8,
                                None, 1e-6)],
    "margin_skipped_outside_interior": [("reject", "a", "b", -40.0, 1e-9,
                                         0.8, None, 1e-9)],
    "maybe_threshold_emits": [("reject", "a", "b", -1.0, 0.7, 0.8, 0.6,
                               1e-9),
                              ("event", "c", "d", math.log(0.7 / 0.3), 0.7,
                               0.8, 0.6, 1e-9)],
    "zero_maybe_is_off": [("reject", "a", "b", math.log(0.62 / 0.38), 0.62,
                           0.8, 0.0, 1e-9)],
    "violation_latches_in_ring": (
        [("reject", "a", "b", -3.0, 0.95, 0.8, None, 1e-9)]
        + [("reject", f"x{i}", "y", -5.0, _p(-5.0), 0.8, None, 1e-9)
           for i in range(600)]),
}


def _observe_all(mod, observations):
    for kind, id1, id2, total, prob, threshold, maybe, margin in observations:
        mod.observe(kind, id1, id2, total, prob, threshold, maybe, margin)
    rep = mod.report()
    return (mod.violations(), rep["checked"], rep["ring_entries"],
            [r for r in rep["recent"] if r["violation"]])


@pytest.mark.parametrize("name", sorted(UNIT_CASES))
def test_runtime_case_equals_jax(name):
    got = _observe_all(tnumcheck, UNIT_CASES[name])
    want = _observe_all(jnumcheck, UNIT_CASES[name])
    assert got == want
    violations = got[0]
    if name in ("reject_disagreement", "violation_latches_in_ring",
                "maybe_threshold_emits"):
        assert len(violations) == 1 and "CERTIFIED-REJECT" in violations[0]
        # the violation survives the flood in the latched ring
        assert got[3] and got[3][0]["id1"] == "a"
    elif name == "event_disagreement":
        assert len(violations) == 1 and "CERTIFIED-EVENT" in violations[0]
    elif name == "margin_bound_violation":
        assert len(violations) == 1 and "MARGIN-BOUND" in violations[0]
    else:
        assert violations == []
    tnumcheck.reset()  # the deliberate violations stay out of the gate


@pytest.mark.parametrize("frac", [0.25, 0.1, 1.0, 0.0])
def test_sampling_stride_equals_jax(frac):
    got = [tnumcheck.take_sample(frac) for _ in range(1000)]
    want = [jnumcheck.take_sample(frac) for _ in range(1000)]
    assert got == want
    assert sum(got) == round(1000 * frac)


def test_sample_fraction_knob(monkeypatch):
    for value in ("0.5", "7", "-1"):
        monkeypatch.setenv("DUKE_NUMCHECK_SAMPLE", value)
        assert tnumcheck.sample_fraction() == jnumcheck.sample_fraction()
    monkeypatch.delenv("DUKE_NUMCHECK", raising=False)
    assert tnumcheck.enabled() is jnumcheck.enabled() is False


def _run(mod, schema, monkeypatch):
    """Two POSTs' worth of the schema's traffic through one package's
    device workload (the whole corpus one top-K, as in
    tests/test_torch_finalize.py); returns the workload's stats."""
    sc = (jparse if mod is jnumcheck else tparse)(_config(schema))
    wc = sc.deduplications[schema]
    if mod is jnumcheck:
        wl = jbuild(wc, sc, backend="device", persistent=False)
    else:
        wl = tbuild(wc, sc, backend="device", device="cpu",
                    persistent=False)
    try:
        for k in range(2):
            wl.submit_batch("crm", _entities(schema, _BATCH, 10 + k,
                                             f"b{k}_"))
        return wl.processor.stats
    finally:
        wl.close()


@pytest.mark.parametrize("schema", ["hostprop", "mixed"])
def test_live_traffic_clean_with_equal_observations(schema, monkeypatch):
    monkeypatch.setenv("DUKE_NUMCHECK", "1")
    monkeypatch.delenv("DUKE_NUMCHECK_SAMPLE", raising=False)
    monkeypatch.delenv("DUKE_DEVICE_FINALIZE", raising=False)
    monkeypatch.delenv("DUKE_FINALIZE_THREADS", raising=False)
    for module in (jdm, tdm):
        monkeypatch.setattr(module, "_INITIAL_TOP_K", 1 << 20)
    stats = {mod: _run(mod, schema, monkeypatch) for mod in MODULES}
    checked = {mod: mod.report()["checked"] for mod in MODULES}
    assert tnumcheck.violations() == jnumcheck.violations() == []
    assert checked[tnumcheck] == checked[jnumcheck] > 0
    assert (stats[tnumcheck].pairs_device_certified
            == stats[jnumcheck].pairs_device_certified > 0)
    # one observation per certified reject (every one sampled at the
    # default 1.0) plus one per certified event
    recent = tnumcheck.report()["recent"]
    assert {r["kind"] for r in recent} <= {"reject", "event"}


def test_numcheck_off_observes_nothing(monkeypatch):
    monkeypatch.delenv("DUKE_NUMCHECK", raising=False)
    monkeypatch.setattr(tdm, "_INITIAL_TOP_K", 1 << 20)
    stats = _run(tnumcheck, "hostprop", monkeypatch)
    assert stats.pairs_device_certified > 0
    assert tnumcheck.report()["checked"] == 0


def test_broken_reject_bound_injection_caught(monkeypatch):
    """Force every survivor to 'certify' as a reject: the shadow oracle
    must catch the real events being certified away."""
    monkeypatch.setenv("DUKE_NUMCHECK", "1")
    monkeypatch.delenv("DUKE_NUMCHECK_SAMPLE", raising=False)
    monkeypatch.setattr(tdm, "_INITIAL_TOP_K", 1 << 20)
    monkeypatch.setattr(TB, "dd_reject_bound", lambda schema, plan: 1e9)
    _run(tnumcheck, "hostprop", monkeypatch)
    found = tnumcheck.violations()
    tnumcheck.reset()  # the deliberate violations stay out of the gate
    assert found and any("CERTIFIED-REJECT" in line for line in found)
