"""Slice 2 end to end: certified dd finalization over HTTP, port vs JAX.

The JAX ``DukeApp(backend="device", persistent=False)`` and the port's
``DukeApp(device="cpu", persistent=False)`` serve the same POSTs on two schemas:

  * ``hostprop``: Levenshtein ``name`` plus a host-only PersonName
    ``person`` (the JAX package's tests/test_dd.py fixture): the optimistic
    host bound widens the survivor filter, so many survivors are
    non-events for the dd rescorer to certify away;
  * ``mixed``: the scan kernels' comparator kinds, all of which the dd
    path certifies (Levenshtein, Jaro-Winkler, q-gram, Jaccard), Exact, a
    Numeric property that falls back to the host per pair, and the
    host-only PersonName.

The initial top-K is the corpus capacity on both sides, and both POSTs
together fill one capacity granule (tests/conftest.py's DEVICE_CHUNK), so
each side compiles (JAX) or runs (port) one program shape: the JAX scan and
dd programs' CPU compiles, once per schema and knob, are what this test's
time goes to.

With ``DUKE_DEVICE_FINALIZE`` at its default (on) on both sides, the
``?since=0`` feeds (timestamps normalized) and the ordered listener event
tapes are bit-identical, and both sides certify the same number of pairs,
more than zero.  With ``DUKE_DEVICE_FINALIZE=0`` on both sides the tapes
are bit-identical again and nothing is certified.
"""

import json
import random
import threading

import pytest

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine import device_matcher as jdm
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import device_matcher as tdm
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve

from test_torch_slice import _TS, _Tape, _feed, _post
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

_DS = """
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        {columns}
      </data-source>"""

_SCHEMAS = {
    "hostprop": (0.8, 0.6, [
        ("name", "levenshtein", 0.3, 0.9),
        ("person", "person-name", 0.4, 0.8),
    ]),
    "mixed": (0.8, 0.6, [
        ("name", "levenshtein", 0.3, 0.9),
        ("given", "jaro-winkler", 0.35, 0.88),
        ("address", "qgram", 0.3, 0.85),
        ("employer", "jaccard", 0.4, 0.7),
        ("ssn", "exact", 0.3, 0.95),
        ("size", "numeric", 0.45, 0.65),
        ("person", "person-name", 0.4, 0.8),
    ]),
}


def _config(name: str) -> str:
    threshold, maybe, props = _SCHEMAS[name]
    body = "".join(
        f"<property><name>{p.upper()}</name><comparator>{cmp}</comparator>"
        f"<low>{low}</low><high>{high}</high></property>"
        for p, cmp, low, high in props)
    columns = "".join(f'<column name="{p}" property="{p.upper()}"/>'
                      for p, _, _, _ in props)
    return (
        f'<DukeMicroService><Deduplication name="{name}" '
        f'link-database-type="in-memory"><duke><schema>'
        f"<threshold>{threshold}</threshold>"
        f"<maybe-threshold>{maybe}</maybe-threshold>{body}</schema>"
        + _DS.format(columns=columns)
        + "</duke></Deduplication></DukeMicroService>")


_POOLS = {
    "name": ["acme corp", "acme corporation", "globex", "globex inc",
             "initech", "umbrella", "umbrela", "stark industries"],
    "given": ["ole", "ola", "kari", "karin", "per", "pål", "anne", "anna"],
    "address": ["kirkeveien 5", "kirkeveien 50", "tollbugata 1",
                "tollbugata 11", "akersgata 7"],
    "employer": ["acme oslo", "acme bergen", "globex oslo", "initech"],
    "ssn": [str(n) for n in range(12)],
    "size": ["1", "2", "3", "4"],
    "person": ["ole olsen", "ola olsen", "kari nordmann", "k nordmann",
               "per hansen", "pär hansen"],
}


# records per POST: two POSTs fill one DEVICE_CHUNK=64 capacity granule
_BATCH = 32


def _entities(schema: str, n: int, seed: int, prefix: str):
    """Seeded entities from small pools with one-char noise: many near
    duplicates on both sides of the thresholds, and exact copies."""
    rng = random.Random(seed)
    props = [p for p, _, _, _ in _SCHEMAS[schema][2]]
    out = []
    for i in range(n):
        if out and rng.random() < 0.15:
            out.append(dict(rng.choice(out), _id=f"{prefix}{i}"))
            continue
        ent = {"_id": f"{prefix}{i}"}
        for p in props:
            value = rng.choice(_POOLS[p])
            if p not in ("ssn", "size") and rng.random() < 0.4:
                pos = rng.randrange(len(value))
                value = value[:pos] + rng.choice("abcdefgh") + value[pos + 1:]
            ent[p] = value
        out.append(ent)
    return out


@pytest.mark.parametrize("device_finalize", ["1", "0"])
@pytest.mark.parametrize("schema", ["hostprop", "mixed"])
def test_certified_finalization_bit_identical_to_jax(schema, device_finalize,
                                                     monkeypatch):
    if device_finalize == "1":
        monkeypatch.delenv("DUKE_DEVICE_FINALIZE", raising=False)  # default
    else:
        monkeypatch.setenv("DUKE_DEVICE_FINALIZE", "0")
    monkeypatch.delenv("DUKE_FINALIZE_THREADS", raising=False)
    for module in (jdm, tdm):
        monkeypatch.setattr(module, "_INITIAL_TOP_K", 1 << 20)
    japp = JApp(jparse(_config(schema)), backend="device", persistent=False)
    tapp = TApp(tparse(_config(schema)), device="cpu", persistent=False)
    servers = [jserve(japp, port=0, host="127.0.0.1"),
               tserve(tapp, port=0, host="127.0.0.1")]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    batches = [_entities(schema, _BATCH, 10 + k, f"b{k}_") for k in range(2)]
    path = f"/deduplication/{schema}"
    try:
        tapes, stats = [], []
        for app, server in zip((japp, tapp), servers):
            port = server.server_address[1]
            tape = _Tape()
            wl = app.deduplications[schema]
            wl.processor.add_match_listener(tape)
            for batch in batches:
                _post(port, f"{path}/crm", batch)
            tapes.append(tape.events)
            stats.append(wl.processor.stats)
            assert wl.processor.finalizer.device is (device_finalize == "1")
        feeds = [_TS.sub(b'"_updated": 0', _feed(s.server_address[1], path))
                 for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
        japp.close()
        tapp.close()
    assert feeds[1] == feeds[0]
    assert tapes[1] == tapes[0]
    assert len(json.loads(feeds[1])) > 10
    assert any(e[0] == "maybe" for e in tapes[1])
    jstats, tstats = stats
    for counter in ("pairs_device_certified", "pairs_rescored",
                    "pairs_skipped", "dd_residue_margin", "dd_residue_kind",
                    "dd_residue_truncation", "candidates_retrieved"):
        assert getattr(tstats, counter) == getattr(jstats, counter), counter
    if device_finalize == "1":
        assert tstats.pairs_device_certified > 0
        assert tstats.dd_blocks > 0
    else:
        assert tstats.pairs_device_certified == 0
        assert tstats.dd_blocks == 0
