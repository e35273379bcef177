"""The reference's example-config flow end to end on the port.

tests/test_example_e2e.py's flow -- the example country CSVs through both
workloads' sink endpoints over HTTP, the ``?since=`` feeds, the
incremental poll and the four http-transform endpoints -- against the
port's ``DukeApp(load_default_config(), persistent=False, device="cpu")``
on every backend it serves: ``host``, ``device``, ``sharded-brute`` and
``sharded`` (on ``[cpu] * 8``) and ``ann``.  The oracle is
``tests/torch_longhand.py``: links computed longhand from Duke's published
comparator math, independent of both packages; linkage at 0.7 and dedup
at 0.9 must equal the longhand sets with confidences within 1e-9 (the
host's f64 values).  ``ann`` may lose pairs to retrieval recall, so its
links need only be a subset with equal confidences; on this corpus it
finds them all, which is asserted too.  One differential case serves the
JAX package's app and the port's, both on ``device``, the same POSTs:
their feeds must be equal row for row, ``_updated`` aside.
"""

import itertools
import threading

import pytest
import torch

from sesam_duke_microservice_tpu.core.config import (
    load_default_config as jload,
)
from sesam_duke_microservice_tpu.links import base as jlinkbase
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu_torch.core.config import (
    load_default_config as tload,
)
from sesam_duke_microservice_tpu_torch.engine import sharded_matcher as TSM
from sesam_duke_microservice_tpu_torch.links import base as tlinkbase
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve

import torch_longhand as LH
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

BACKENDS = ["host", "device", "sharded-brute", "sharded", "ann"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # a tiny corpus: the host backend must not prune on tf-idf relevance
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    for knob in ("CONFIG_STRING", "DUKE_FAULTS", "FEED_PAGE_SIZE"):
        monkeypatch.delenv(knob, raising=False)
    # one link clock per package, each a counter: the same links in the
    # same order get the same timestamps, so the feeds order alike
    for base in (jlinkbase, tlinkbase):
        ticks = itertools.count(1_700_000_000_000)
        monkeypatch.setattr(base, "now_millis", lambda t=ticks: next(t))
    TSM.set_serving_devices([torch.device("cpu")] * 8)
    yield
    TSM.set_serving_devices(None)


class _Served:
    def __init__(self, app, serve):
        self.app = app
        self.server = serve(app, port=0, host="127.0.0.1")
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        self.app.close()


def _port(backend):
    return _Served(TApp(tload(), backend=backend, persistent=False,
                        device="cpu"), tserve)


@pytest.mark.parametrize("backend", BACKENDS)
def test_example_config_flow(backend):
    served = _port(backend)
    try:
        out = LH.example_flow(served.base, subset=backend == "ann")
    finally:
        served.close()
    # every backend, ann included, finds every longhand pair here
    assert out["missing_linkage"] == [] and out["missing_dedup"] == []
    assert len(LH.expected_links(0.9)) > 0


def _rows(rows):
    return [{k: v for k, v in r.items() if k != "_updated"} for r in rows]


def test_device_feeds_equal_the_jax_apps():
    jax_served = _Served(JApp(jload(), backend="device", persistent=False),
                         jserve)
    try:
        want = LH.example_flow(jax_served.base)
    finally:
        jax_served.close()
    served = _port("device")
    try:
        got = LH.example_flow(served.base)
    finally:
        served.close()
    for feed in ("linkage", "dedup"):
        assert got[feed], feed
        assert _rows(got[feed]) == _rows(want[feed]), feed
