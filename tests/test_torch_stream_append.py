"""The port's streamed extract -> upload append (``DUKE_STREAM_APPEND``)
held against the JAX package's, bit for bit.

Counterparts of ``tests/test_feature_cache.py``'s streamed-append cases,
run on both packages in one process at small knobs (``DEVICE_CHUNK`` 64
from tests/conftest.py, ``DEVICE_UPDATE_SLICE`` patched to 8): with the
knob on and at 0, the ordered event tapes, the link rows, the row mapping
and the corpus host mirrors equal each other and the JAX package's; the
port's device tensors (on the CPU here) equal its host mirror and their
twins of the other knob setting; ``duke_stream_append_slices_total``
moves by the same count in both packages (a slice counts only when its
flush copied rows to the device).  A full upload pending (a cold corpus,
a capacity doubling the pre-grow forces, a released device copy) keeps
the whole-batch path.  Every comparison is exact: no tolerance.
"""

import numpy as np
import pytest
import torch

from sesam_duke_microservice_tpu import telemetry as jtelemetry
from sesam_duke_microservice_tpu.engine import device_matcher as JDM
from sesam_duke_microservice_tpu_torch import telemetry as ttelemetry
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from test_torch_feature_cache import dedup_schema, random_records
from test_torch_growth import BOTH, JAX, PORT, Run, assert_same
from torch_jax_cache import jax_cache_off  # noqa: F401

SLICE = 8


def _slices(pkg):
    tel = jtelemetry if pkg is JAX else ttelemetry
    return tel.STREAM_APPEND_SLICES.single().value


def batches(pkg):
    """A cold first batch (whole-batch path), a warm one that streams
    (24 rows, 3 slices, capacity 64 still fits), one that re-indexes ids
    of the first and crosses the 64-row capacity (pre-grow -> full upload
    pending -> whole batch), one that streams with those tombstones
    flushed (30 rows, 4 slices), and one more (17 rows, 3 slices)."""
    return [
        random_records(40, seed=21, pkg=pkg),
        random_records(24, seed=22, prefix="s", pkg=pkg),
        random_records(12, seed=23, pkg=pkg),
        random_records(30, seed=24, prefix="t", pkg=pkg),
        random_records(17, seed=25, prefix="u", pkg=pkg),
    ]


EXPECTED_SLICES = [0, 3, 0, 4, 3]


@pytest.fixture
def small_slices(monkeypatch):
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    monkeypatch.setattr(JDM, "_UPDATE_SLICE", SLICE)
    monkeypatch.setattr(TDM, "_UPDATE_SLICE", SLICE)


def run_pkg(pkg, knob, monkeypatch):
    """Feed ``batches`` through one package with the knob set; returns
    (run, slice-counter delta per batch)."""
    monkeypatch.setenv("DUKE_STREAM_APPEND", knob)
    run = Run(pkg, dedup_schema(pkg))
    deltas = []
    for batch in batches(pkg):
        before = _slices(pkg)
        run.feed(batch)
        deltas.append(_slices(pkg) - before)
    return run, deltas


def assert_device_equals_mirror(corpus):
    """Every device tensor of the port's corpus equals its host mirror
    (chars widen uint16 -> int32 on the device, as ``_to_device`` does)."""
    feats, valid, deleted, group = corpus.device_arrays()
    for prop, tensors in corpus.feats.items():
        for name, arr in tensors.items():
            np.testing.assert_array_equal(
                feats[prop][name].cpu().numpy(),
                arr.astype(np.int32) if arr.dtype == np.uint16 else arr,
                err_msg=f"{prop}.{name}")
    for dev, host in ((valid, corpus.row_valid),
                      (deleted, corpus.row_deleted),
                      (group, corpus.row_group)):
        np.testing.assert_array_equal(dev.cpu().numpy(), host)


@pytest.mark.parametrize("knob", ["1", "0"])
def test_stream_append_equals_jax(knob, small_slices, monkeypatch):
    """Tapes, link rows, row mapping and host mirrors equal the JAX
    package's at the same knob, and the slice counter moves alike."""
    jrun, jdeltas = run_pkg(JAX, knob, monkeypatch)
    trun, tdeltas = run_pkg(PORT, knob, monkeypatch)
    assert_same(jrun, trun)
    assert trun.index.id_to_row == jrun.index.id_to_row
    jc, tc = jrun.index.corpus, trun.index.corpus
    n = jc.size
    np.testing.assert_array_equal(tc.row_valid[:n], jc.row_valid[:n])
    np.testing.assert_array_equal(tc.row_deleted[:n], jc.row_deleted[:n])
    np.testing.assert_array_equal(tc.row_group[:n], jc.row_group[:n])
    assert tc.row_ids == jc.row_ids
    assert tc.capacity == jc.capacity
    assert tdeltas == jdeltas
    assert tdeltas == (EXPECTED_SLICES if knob == "1" else [0] * 5)
    assert_device_equals_mirror(tc)


def test_stream_append_on_equals_off(small_slices, monkeypatch):
    """Knob on and at 0 in the port: equal tapes, rows, mapping, host
    mirrors, dirty state and device tensors (``torch.equal``)."""
    on, _ = run_pkg(PORT, "1", monkeypatch)
    off, _ = run_pkg(PORT, "0", monkeypatch)
    assert on.tape.events == off.tape.events
    assert on.rows() == off.rows()
    assert on.index.id_to_row == off.index.id_to_row
    a, b = on.index.corpus, off.index.corpus
    assert (a.size, a.capacity, a.live_rows) == (b.size, b.capacity,
                                                 b.live_rows)
    assert a.row_ids == b.row_ids
    for prop, tensors in a.feats.items():
        for name, arr in tensors.items():
            np.testing.assert_array_equal(arr, b.feats[prop][name])
    da, db = a.device_arrays(), b.device_arrays()
    for prop, tensors in da[0].items():
        for name, t in tensors.items():
            assert torch.equal(t, db[0][prop][name]), (prop, name)
    for x, y in zip(da[1:], db[1:]):
        assert torch.equal(x, y)
    assert (a._pending_rows, a._mask_rows, a._dirty_full) == (
        b._pending_rows, b._mask_rows, b._dirty_full)


def test_stream_append_slice_sizing(monkeypatch):
    """``tests/test_feature_cache.py::test_stream_append_slice_sizing`` on
    both packages."""
    for dm in (JDM, TDM):
        monkeypatch.setenv("DUKE_STREAM_APPEND", "0")
        monkeypatch.delenv("DEVICE_EXTRACT_WORKERS", raising=False)
        assert dm._stream_append_slice(10_000) is None
        monkeypatch.setenv("DUKE_STREAM_APPEND", "1")
        monkeypatch.setattr(dm, "_UPDATE_SLICE", 512)
        assert dm._stream_append_slice(512) is None  # nothing to overlap
        assert dm._stream_append_slice(513) == 512
        # a slab that qualifies for the process-pool fan-out keeps it
        monkeypatch.setenv("DEVICE_EXTRACT_WORKERS", "4")
        monkeypatch.setenv("DEVICE_EXTRACT_PARALLEL_MIN", "2048")
        assert dm._stream_append_slice(10_000) == 2048
        assert dm._stream_append_slice(2048) is None


def test_pending_full_upload_keeps_the_whole_batch(small_slices,
                                                   monkeypatch):
    """A released device copy (a closed or reloaded corpus) leaves a full
    upload pending: the next batch appends whole, no slice counts, and
    the scoring-time upload restores the device copy."""
    monkeypatch.setenv("DUKE_STREAM_APPEND", "1")
    run = Run(PORT, dedup_schema(PORT))
    run.feed(random_records(20, seed=31, pkg=PORT))
    corpus = run.index.corpus
    corpus.spill_device()
    assert corpus.stream_flush() is False
    before = _slices(PORT)
    calls = []
    real = corpus.stream_flush
    monkeypatch.setattr(corpus, "stream_flush",
                        lambda: calls.append(1) or real())
    run.feed(random_records(20, seed=32, prefix="s", pkg=PORT))
    assert calls == [] and _slices(PORT) == before
    assert_device_equals_mirror(corpus)


def test_reserve_pre_grows_once_before_the_first_slice(small_slices,
                                                       monkeypatch):
    """The pre-grow happens before any slice: one capacity growth for a
    batch that crosses the capacity, in both packages, and no slice of
    it counts (the full upload it forces is pending)."""
    monkeypatch.setenv("DUKE_STREAM_APPEND", "1")
    growths = []
    for pkg in BOTH:
        tel = jtelemetry if pkg is JAX else ttelemetry
        run = Run(pkg, dedup_schema(pkg))
        run.feed(random_records(40, seed=41, pkg=pkg))
        g0, s0 = tel.CORPUS_GROWTHS.single().value, _slices(pkg)
        run.feed(random_records(60, seed=42, prefix="v", pkg=pkg))
        growths.append((tel.CORPUS_GROWTHS.single().value - g0,
                        _slices(pkg) - s0, run.index.corpus.capacity))
    assert growths[0] == growths[1] == (1, 0, 128)
    # before the first append there is nothing to reserve
    fresh = TDM.DeviceCorpus(PORT.index(dedup_schema(PORT)).plan, "cpu")
    fresh.reserve(1000)
    assert fresh.capacity == 0
