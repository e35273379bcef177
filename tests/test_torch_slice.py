"""The slice as a whole: the port's HTTP service against the JAX ``device``
backend, POST for POST.

Both apps -- the JAX ``DukeApp(sc, backend="device", persistent=False)``
and the port's ``DukeApp(sc, device="cpu", persistent=False)`` -- serve
over real HTTP and receive the same requests: three stresstest batches (~600 records, 15%
perturbed near-duplicates plus exact-name repeats), a batch of 40-120-char
names that grows the name width past the one-word kernel (here to 192
chars, doubling from the tests' 24-char base), a ``_deleted`` entity
that tombstones a linked record and retracts its links, and a one-to-one
``recordlinkage`` workload fed from its two datasets (group filtering).

The ``?since=0`` feed bodies must be bit-identical once the link
timestamps are normalized, and so must the ordered listener event tapes.
"""

import json
import os
import re
import threading
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

CONFIG_XML = """
<DukeMicroService>
  <Deduplication name="people" link-database-type="in-memory">
    <duke>
      <object class="no.priv.garshol.duke.comparators.NumericComparator"
              name="AreaComparator">
        <param name="min-ratio" value="0.7"/>
      </object>
      <schema>
        <threshold>0.9</threshold>
        <maybe-threshold>0.7</maybe-threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.88</high>
        </property>
        <property><name>AREA</name>
          <comparator>AreaComparator</comparator><low>0.45</low><high>0.65</high>
        </property>
        <property><name>SSN</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="area" property="AREA"/>
        <column name="ssn" property="SSN"/>
      </data-source>
    </duke>
  </Deduplication>
  <RecordLinkage name="registry" link-mode="one-to-one"
                 link-database-type="in-memory">
    <duke>
      <schema>
        <threshold>0.85</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.2</low><high>0.9</high>
        </property>
        <property><name>SSN</name>
          <comparator>exact</comparator><low>0.35</low><high>0.9</high>
        </property>
      </schema>
      <group>
        <data-source class="io.sesam.dukemicroservice.IncrementalRecordLinkageDataSource">
          <param name="dataset-id" value="left"/>
          <column name="name" property="NAME"/>
          <column name="ssn" property="SSN"/>
        </data-source>
      </group>
      <group>
        <data-source class="io.sesam.dukemicroservice.IncrementalRecordLinkageDataSource">
          <param name="dataset-id" value="right"/>
          <column name="name" property="NAME"/>
          <column name="ssn" property="SSN"/>
        </data-source>
      </group>
    </duke>
  </RecordLinkage>
</DukeMicroService>
"""


def _stresstest_entities(n, seed, prefix):
    with mock.patch.dict(os.environ):
        import bench
    out = []
    rng = np.random.default_rng(seed)
    for i, r in enumerate(bench.stresstest_records(n, seed=seed)):
        ent = {"_id": f"{prefix}{i}", "name": r.get_value("name"),
               "area": r.get_value("area"), "ssn": r.get_value("ssn")}
        if out and rng.random() < 0.2:  # an exact-name repeat: many ties
            ent["name"] = out[int(rng.integers(len(out)))]["name"]
        out.append(ent)
    return out


def _long_name_entities(n, seed):
    rng = np.random.default_rng(seed)
    words = ["nordre", "gate", "holmenkollveien", "stortingsgata", "bygdoy",
             "alle", "kirkeveien", "vest", "ost", "karl", "johans"]
    out = []
    for i in range(n):
        target = int(rng.integers(40, 121))
        name = ""
        while len(name) < target:
            name += words[int(rng.integers(len(words)))] + " "
        name = name[:target]
        if i % 3 == 1:  # a near-duplicate of the previous long name
            prev = out[-1]["name"]
            pos = int(rng.integers(len(prev)))
            name = prev[:pos] + "x" + prev[pos + 1:]
        out.append({"_id": f"long{i}", "name": name, "area": "5",
                    "ssn": str(int(rng.integers(1, 50)))})
    return out


class _Tape:
    """Ordered listener event tape."""

    def __init__(self):
        self.events = []

    def batch_ready(self, size):
        self.events.append(("batch_ready", size))

    def matches(self, r1, r2, confidence):
        self.events.append(("matches", r1.record_id, r2.record_id,
                            confidence))

    def matches_perhaps(self, r1, r2, confidence):
        self.events.append(("maybe", r1.record_id, r2.record_id, confidence))

    def no_match_for(self, record):
        self.events.append(("none", record.record_id))

    def batch_done(self):
        self.events.append(("batch_done",))


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        assert resp.status == 200
        return resp.read()


def _status(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=body.encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _feed(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}?since=0",
                                timeout=60) as resp:
        assert resp.status == 200
        return resp.read()


_TS = re.compile(rb'"_updated": \d+')


@pytest.fixture
def served_apps(monkeypatch):
    # both feature modules were imported with this module, so they share
    # the test run's base width; now let char widths grow with the data
    assert JF.MAX_CHARS == TF.MAX_CHARS
    monkeypatch.delenv("DEVICE_MAX_CHARS", raising=False)
    japp = JApp(jparse(CONFIG_XML), backend="device", persistent=False)
    tapp = TApp(tparse(CONFIG_XML), device="cpu", persistent=False)
    servers = [jserve(japp, port=0, host="127.0.0.1"),
               tserve(tapp, port=0, host="127.0.0.1")]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        yield [(japp, servers[0].server_address[1]),
               (tapp, servers[1].server_address[1])]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
        japp.close()
        tapp.close()


def test_port_feed_and_events_bit_identical_to_jax(served_apps):
    batches = [_stresstest_entities(200, 1234 + k, f"b{k}_")
               for k in range(3)]
    long_batch = _long_name_entities(30, 5)
    left = _stresstest_entities(120, 99, "L")
    right = _stresstest_entities(120, 99, "R")[::-1]

    tapes = []
    for app, port in served_apps:
        people, registry = _Tape(), _Tape()
        app.deduplications["people"].processor.add_match_listener(people)
        app.record_linkages["registry"].processor.add_match_listener(
            registry)
        tapes.append((people, registry))
        for batch in batches:
            _post(port, "/deduplication/people/crm", batch)
        _post(port, "/deduplication/people/crm", long_batch)
        # tombstone a record that carries links: they must retract
        _post(port, "/deduplication/people/crm",
              [{"_id": "b0_1", "_deleted": True}])
        _post(port, "/recordlinkage/registry/left", left)
        _post(port, "/recordlinkage/registry/right", right)

    (japp, jport), (tapp, tport) = served_apps
    for path in ("/deduplication/people", "/recordlinkage/registry"):
        jbody, tbody = _feed(jport, path), _feed(tport, path)
        assert _TS.sub(b'"_updated": 0', tbody) == \
            _TS.sub(b'"_updated": 0', jbody), path
        rows = json.loads(tbody)
        assert len(rows) > 20, path
    people_rows = json.loads(_feed(tport, "/deduplication/people"))
    assert any(r["_deleted"] for r in people_rows)
    assert tapes[1][0].events == tapes[0][0].events
    assert tapes[1][1].events == tapes[0][1].events
    assert any(e[0] == "maybe" for e in tapes[1][0].events)

    # http-transform answers (duke_links) and the error surface agree too
    probe = [dict(batches[0][3], _id="t1"), dict(long_batch[4], _id="t2")]
    bodies = [_post(port, "/deduplication/people/crm/httptransform", probe)
              for _, port in served_apps]
    assert bodies[1] == bodies[0]
    assert any(row["duke_links"] for row in json.loads(bodies[1]))
    for method, path, body in (
            ("GET", "/deduplication/people/crm", None),
            ("GET", "/deduplication/people/crm/httptransform", None),
            ("POST", "/deduplication/nobody/crm", "[]"),
            ("POST", "/deduplication/people/nowhere", "[]"),
            ("POST", "/recordlinkage/registry/left", "{not json"),
            ("GET", "/deduplication/nobody", None),
            ("GET", "/deduplication/people?since=soon", None)):
        answers = [_status(port, method, path, body)
                   for _, port in served_apps]
        assert answers[1] == answers[0], (method, path)
        assert answers[1][0] in (400, 404, 405), (method, path)

    # the long batch widened the name tensors onto the multi-word path
    spec = tapp.deduplications["people"].index.plan.device_props[0]
    assert spec.name == "NAME" and spec.chars > 32
    jspec = japp.deduplications["people"].index.plan.device_props[0]
    assert jspec.chars == spec.chars
