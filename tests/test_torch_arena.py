"""The port's shared device arena against the JAX package's, on the CPU.

* the unit cases of tests/test_multitenant.py ``TestArenaUnit``, run as
  one script of admits on both packages' ``DeviceArena``: the victims,
  the counters, the tiers and the debug snapshot must be equal;
* two device tenants through the JAX package's multi-tenant requests with
  a budget of 1.5 tenants: the event tapes and link rows equal the JAX
  package's spilling run and the port's ``DUKE_ARENA=0`` run, with equal
  spill and fault-in counts;
* the ``duke_arena_*`` families after a spill, the ledger counting the
  arena once, and the over-budget 503 with ``Retry-After`` over HTTP;
* a spill racing the streamed append (``stream_flush``): the slice's rows
  stay on the host, the corpus re-uploads whole, the tape is unchanged.

The lease bytes differ by design: the port's corpus holds char units as
int32 on the device (``DeviceCorpus._device_nbytes`` counts them so),
where the JAX package leases its host mirrors' uint16 bytes; each side's
budget in the differential cases is set from its own tenant's bytes.
"""

import gc
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from sesam_duke_microservice_tpu import telemetry as jtelemetry
from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine.workload import (
    build_workload as jbuild,
)
from sesam_duke_microservice_tpu.ops import arena as jarena
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu.telemetry import memory as jmemory
from sesam_duke_microservice_tpu_torch import telemetry as ttelemetry
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.engine.workload import (
    build_workload as tbuild,
)
from sesam_duke_microservice_tpu_torch.ops import arena as tarena
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve
from sesam_duke_microservice_tpu_torch.telemetry import memory as tmemory

from test_observability import parse_exposition
from test_scheduler import CONFIG_XML, EventLog, link_rows
from test_torch_growth import PORT, Run
from test_torch_stream_append import (
    assert_device_equals_mirror,
    batches,
    small_slices,  # noqa: F401 -- fixture
)
from test_torch_feature_cache import dedup_schema
from torch_jax_cache import jax_cache_off  # noqa: F401

ARENAS = (jarena, tarena)


@pytest.fixture(autouse=True)
def _clean_arenas(monkeypatch):
    monkeypatch.setenv("DUKE_ARENA", "1")
    for mod in ARENAS:
        mod.ARENA._reset_for_tests()
    yield
    for mod in ARENAS:
        mod.ARENA._reset_for_tests()


class _Owner:
    """A fake corpus: admission needs only a spill callable."""

    def __init__(self):
        self.spilled = 0

    def spill(self) -> int:
        self.spilled += 1
        return 0


def _arena(mod, budget):
    a = mod.DeviceArena()
    a._budget_bytes = lambda: float(budget)
    return a


def _refusal(mod, fn):
    """Run ``fn``; the package's admission error as comparable fields."""
    try:
        fn()
    except mod.ArenaAdmissionError as e:
        return ("refused", e.need, e.budget, e.resident, str(e))
    return ("admitted",)


# -- the TestArenaUnit cases, one script per case, run on both arenas --------


def case_within_budget(mod):
    a = _arena(mod, 1000)
    o1, o2 = _Owner(), _Owner()
    a.admit(o1, 400, spill=o1.spill, label="t1")
    a.admit(o2, 400, spill=o2.spill, label="t2")
    return a.tier_bytes(), (o1.spilled, o2.spilled), a.admissions, a.spills


def case_coldest_first(mod):
    a = _arena(mod, 1000)
    hot, cold, new = _Owner(), _Owner(), _Owner()
    a.admit(cold, 400, spill=cold.spill, label="cold", heat=lambda: 0.01)
    a.admit(hot, 400, spill=hot.spill, label="hot", heat=lambda: 99.0)
    a.admit(new, 400, spill=new.spill, label="new")
    return (cold.spilled, hot.spilled, a.tier_bytes(), a.spills,
            a.debug_snapshot()["leases"])


def case_recency_breaks_heat_ties(mod):
    a = _arena(mod, 1000)
    first, second, new = _Owner(), _Owner(), _Owner()
    a.admit(first, 400, spill=first.spill, label="first")
    a.admit(second, 400, spill=second.spill, label="second")
    a.admit(first, 400, spill=first.spill, label="first")  # touch
    a.admit(new, 400, spill=new.spill, label="new")
    return first.spilled, second.spilled, a.tier_bytes()


def case_never_its_own_victim(mod):
    a = _arena(mod, 1000)
    o = _Owner()
    a.admit(o, 900, spill=o.spill)
    out = _refusal(mod, lambda: a.admit(o, 1100, spill=o.spill))
    return out, o.spilled, a.rejections


def case_exhaustion_refuses(mod):
    a = _arena(mod, 500)
    o1, o2 = _Owner(), _Owner()
    a.admit(o1, 300, spill=o1.spill, label="resident")
    out = _refusal(mod, lambda: a.admit(o2, 600, spill=o2.spill,
                                        label="huge"))
    return out, o1.spilled, a.tier_bytes()


def case_fault_in_after_spill(mod):
    a = _arena(mod, 500)
    o1, o2 = _Owner(), _Owner()
    a.admit(o1, 300, spill=o1.spill)     # cold start: not a fault
    a.admit(o2, 300, spill=o2.spill)     # spills o1
    seen = [a.faults]
    a.admit(o1, 300, spill=o1.spill)     # fault-in (spills o2)
    seen.append(a.faults)
    a.admit(o1, 300, spill=o1.spill)     # steady state: no-op
    seen.append(a.faults)
    return seen, a.admissions, a.spills, (o1.spilled, o2.spilled)


def case_disabled_is_noop(mod, monkeypatch):
    monkeypatch.setenv("DUKE_ARENA", "0")
    a = _arena(mod, 10)
    o = _Owner()
    a.admit(o, 1 << 30, spill=o.spill)
    return a.tier_bytes(), a.admissions


def case_dead_owners_pruned(mod):
    a = _arena(mod, 1000)
    o = _Owner()
    a.admit(o, 400, spill=o.spill)
    del o
    gc.collect()
    return a.tier_bytes()


def case_debug_snapshot(mod):
    a = _arena(mod, 1000)
    o = _Owner()
    a.admit(o, 400, spill=o.spill, label="dedup/people", heat=lambda: 1.25)
    return a.debug_snapshot()


def case_forget_and_release(mod):
    a = _arena(mod, 1000)
    o1, o2 = _Owner(), _Owner()
    a.admit(o1, 400, spill=o1.spill, label="a")
    a.admit(o2, 300, spill=o2.spill, label="b")
    a.forget(o1)
    after_release = a.tier_bytes()
    a.forget(o2)
    return after_release, a.tier_bytes(), a.debug_snapshot()["leases"]


UNIT_CASES = {fn.__name__[5:]: fn for fn in (
    case_within_budget, case_coldest_first, case_recency_breaks_heat_ties,
    case_never_its_own_victim, case_exhaustion_refuses,
    case_fault_in_after_spill, case_disabled_is_noop,
    case_dead_owners_pruned, case_debug_snapshot, case_forget_and_release)}


@pytest.mark.parametrize("name", sorted(UNIT_CASES))
def test_arena_unit_case_equals_jax(name, monkeypatch):
    fn = UNIT_CASES[name]
    args = (monkeypatch,) if name == "disabled_is_noop" else ()
    got = fn(tarena, *args)
    want = fn(jarena, *args)
    assert got == want


def test_arena_unit_expectations():
    """The JAX package's own expectations, held on the port's arena."""
    assert case_within_budget(tarena) == (
        {"device": 800, "host": 0}, (0, 0), 2, 0)
    cold, hot, tiers, spills, _ = case_coldest_first(tarena)
    assert (cold, hot, tiers, spills) == (
        1, 0, {"device": 800, "host": 400}, 1)
    out, spilled, rejections = case_never_its_own_victim(tarena)
    assert out[0] == "refused" and spilled == 0 and rejections == 1
    out, spilled, tiers = case_exhaustion_refuses(tarena)
    assert out[:3] == ("refused", 600, 500) and spilled == 0
    assert tiers["device"] == 300
    assert case_fault_in_after_spill(tarena)[0] == [0, 1, 1]
    assert case_dead_owners_pruned(tarena) == {"device": 0, "host": 0}
    snap = case_debug_snapshot(tarena)
    assert snap["enabled"] is True and snap["tiers"] == {
        "device": 400, "host": 0}
    assert snap["leases"] == [{"label": "dedup/people", "bytes": 400,
                               "resident": True, "faults": 0,
                               "heat_device_seconds": 1.25}]


# -- two device tenants: spill and fault-in change nothing -------------------


REQUESTS = [
    ("crm", [{"_id": "a1", "name": "acme corp", "email": "a@x.no"},
             {"_id": "a2", "name": "acme corp", "email": "a@x.no"}]),
    ("reg", [{"_id": "r1", "name": "bolt ltd"},
             {"_id": "r2", "name": "bolt ltd"}]),
    ("crm", [{"_id": "a3", "name": "quux as", "email": "q@x.no"},
             {"_id": "a4", "name": "quux as", "email": "q@x.no"}]),
    ("reg", [{"_id": "r3", "name": "acme corp"}]),
]


@pytest.fixture()
def configs(monkeypatch):
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    return {jarena: jparse(CONFIG_XML), tarena: tparse(CONFIG_XML)}


def _build(mod, sc, name):
    wc = sc.deduplications[name]
    if mod is jarena:
        return jbuild(wc, sc, backend="device", persistent=False)
    return tbuild(wc, sc, backend="device", device="cpu", persistent=False)


def _one_tenant_bytes(mod, sc):
    """One tenant's leased bytes after its first request."""
    wl = _build(mod, sc, "people")
    try:
        wl.submit_batch("crm", REQUESTS[0][1])
        return wl.index.corpus._device_nbytes()
    finally:
        wl.close()
        mod.ARENA._reset_for_tests()


def _run_two_tenants(mod, sc, budget=None):
    """Both tenants through REQUESTS, optionally with the arena's budget
    forced; (tapes, rows, faults, spills)."""
    wls = {"people": _build(mod, sc, "people"),
           "orgs": _build(mod, sc, "orgs")}
    logs = {}
    for name, wl in wls.items():
        logs[name] = EventLog()
        wl.processor.add_match_listener(logs[name])
    arena = mod.ARENA
    old = arena._budget_bytes
    try:
        if budget is not None:
            arena._budget_bytes = lambda: float(budget)
        for dataset, entities in REQUESTS:
            wl = wls["people"] if dataset == "crm" else wls["orgs"]
            wl.submit_batch(dataset, entities)
        return ({n: logs[n].events for n in wls},
                {n: link_rows(wls[n]) for n in wls}, arena.faults,
                arena.spills)
    finally:
        arena._budget_bytes = old
        for wl in wls.values():
            wl.close()


def test_spill_and_fault_in_tapes_equal_jax_and_arena_off(configs,
                                                          monkeypatch):
    monkeypatch.setenv("DUKE_ARENA", "0")
    control_tapes, control_rows, _, _ = _run_two_tenants(tarena,
                                                         configs[tarena])
    monkeypatch.setenv("DUKE_ARENA", "1")
    runs = {}
    for mod in ARENAS:
        sc = configs[mod]
        one = _one_tenant_bytes(mod, sc)
        assert one > 0
        runs[mod] = _run_two_tenants(mod, sc, budget=int(one * 1.5))
    ttapes, trows, tfaults, tspills = runs[tarena]
    jtapes, jrows, jfaults, jspills = runs[jarena]
    assert tspills >= 2, "the budget must actually force spills"
    assert tfaults >= 1, "a spilled tenant must fault back in"
    assert (tfaults, tspills) == (jfaults, jspills)
    assert ttapes == jtapes == control_tapes
    assert trows == jrows == control_rows
    assert trows["people"], "the duplicate upserts must have linked"


def _uint16_bytes(corpus):
    return sum(int(arr.nbytes) for tensors in corpus.feats.values()
               for arr in tensors.values() if arr.dtype == np.uint16)


def test_arena_families_after_spill_equal_jax(configs):
    scraped = {}
    char_bytes = {}
    for mod, tel in ((jarena, jtelemetry), (tarena, ttelemetry)):
        sc = configs[mod]
        wl = _build(mod, sc, "people")
        try:
            wl.submit_batch("crm", REQUESTS[0][1])
            one = wl.index.corpus._device_nbytes()
            old = mod.ARENA._budget_bytes
            mod.ARENA._budget_bytes = lambda: float(one * 1.1)
            try:
                wl2 = _build(mod, sc, "orgs")
                try:
                    wl2.submit_batch("reg", REQUESTS[1][1])  # spills wl
                    wl.submit_batch("crm", REQUESTS[2][1])   # fault-in
                    scraped[mod] = {
                        k: v for k, v in parse_exposition(
                            tel.render(tel.GLOBAL)).items()
                        if k[0].startswith("duke_arena_")}
                    # the resident tenant and the spilled one's chars
                    char_bytes[mod] = (_uint16_bytes(wl.index.corpus),
                                       _uint16_bytes(wl2.index.corpus))
                finally:
                    wl2.close()
            finally:
                mod.ARENA._budget_bytes = old
        finally:
            wl.close()
    got, want = scraped[tarena], scraped[jarena]
    assert set(got) == set(want)
    faults = ("duke_arena_faults_total", ())
    assert got[faults] == want[faults] >= 1.0
    # tiers: the JAX lease bytes plus the int32 widening of the chars
    resident, spilled = char_bytes[tarena]
    assert char_bytes[tarena] == char_bytes[jarena]
    assert got[("duke_arena_bytes", (("tier", "device"),))] == (
        want[("duke_arena_bytes", (("tier", "device"),))] + resident)
    assert got[("duke_arena_bytes", (("tier", "host"),))] == (
        want[("duke_arena_bytes", (("tier", "host"),))] + spilled)


@pytest.mark.parametrize("mod", ARENAS, ids=["jax", "port"])
def test_ledger_counts_the_arena_once(mod, configs):
    """Resident corpus bytes sit under the arena owner while the tenant
    keeps a LOGICAL view: the budget totals count them exactly once (the
    JAX package's case, on both)."""
    memory = jmemory if mod is jarena else tmemory
    memory._reset_for_tests()
    wl = _build(mod, configs[mod], "people")
    try:
        wl.submit_batch("crm", REQUESTS[0][1])
        snap = memory.debug_snapshot()
        arena_rows = [r for r in snap["workloads"] if r["kind"] == "arena"]
        logical_rows = [r for r in snap["workloads"] if r.get("logical")]
        assert arena_rows, "the arena must re-enroll after a ledger reset"
        assert logical_rows, "tenants must keep logical views"
        arena_total = sum(r["bytes"] for r in arena_rows)
        logical_corpus = sum(
            r["bytes"] for r in logical_rows
            if r["component"] in memory._ARENA_VIEW_COMPONENTS)
        assert arena_total == logical_corpus
        process_total = sum(snap["process"].values())
        assert snap["total_bytes"] == arena_total + process_total
        assert snap["arena"]["tiers"]["device"] == arena_total
        if mod is tarena:
            # the logical view is the corpus tensors' own nbytes
            assert arena_total == sum(wl.index.corpus.device_bytes().values())
    finally:
        wl.close()
        memory._reset_for_tests()


# -- the over-budget 503 ------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.mark.parametrize("scheduler", ["1", "0"])
def test_exhausted_budget_answers_503_with_retry_after(scheduler,
                                                       monkeypatch):
    monkeypatch.setenv("MIN_RELEVANCE", "0.05")
    monkeypatch.setenv("DUKE_SCHEDULER", scheduler)
    apps = {jarena: JApp(jparse(CONFIG_XML), backend="device",
                         persistent=False),
            tarena: TApp(tparse(CONFIG_XML), device="cpu",
                         persistent=False)}
    replies = {}
    for mod, app in apps.items():
        server = (jserve if mod is jarena else tserve)(
            app, port=0, host="127.0.0.1")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = (f"http://127.0.0.1:{server.server_address[1]}"
               "/deduplication/people/crm")
        old = mod.ARENA._budget_bytes
        try:
            mod.ARENA._budget_bytes = lambda: 16.0  # nothing fits
            refused = _post(url, [{"_id": "x1", "name": "acme",
                                   "email": "a@x"}])
            # raising the ceiling heals the tenant without a restart
            mod.ARENA._budget_bytes = old
            healed = _post(url, [{"_id": "x2", "name": "acme",
                                  "email": "a@x"}])
            replies[mod] = (refused, healed)
        finally:
            mod.ARENA._budget_bytes = old
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
            app.close()
    for mod in ARENAS:
        (status, headers, body), (healed, _, _) = replies[mod]
        assert status == 503 and healed == 200
        assert body.decode().startswith(
            "HBM budget exhausted: HBM budget exhausted admitting "
            "deduplication/people: need ")
        assert "budget 16, 0 still resident after spilling" in body.decode()
    assert (replies[tarena][0][1]["Retry-After"]
            == replies[jarena][0][1]["Retry-After"] == "30")


# -- a spill racing the streamed append ---------------------------------------


_STREAM_FLUSH = TDM.DeviceCorpus.stream_flush


def _feed_port(monkeypatch, spill_between=None):
    """``batches(PORT)`` through a port device backend; ``spill_between``
    (slice number -> bool) spills the corpus after that slice's rows are
    appended and before its ``stream_flush``, as an admission of another
    tenant would.  Returns (run, flush results)."""
    flushes = []
    original = _STREAM_FLUSH

    def flush(corpus):
        if spill_between is not None and spill_between(len(flushes)):
            corpus.spill_device()
        out = original(corpus)
        flushes.append(out)
        return out

    monkeypatch.setattr(TDM.DeviceCorpus, "stream_flush", flush)
    run = Run(PORT, dedup_schema(PORT))
    for batch in batches(PORT):
        run.feed(batch)
    return run, flushes


def test_spill_between_slices_keeps_rows_on_host(small_slices, monkeypatch):
    control, control_flushes = _feed_port(monkeypatch)
    assert control_flushes and all(control_flushes)
    spilled, flushes = _feed_port(monkeypatch,
                                  spill_between=lambda i: i % 3 == 1)
    # a flush that meets a spilled corpus copies nothing (nor do the
    # batch's later slices: the corpus stays dirty until the query)...
    assert len(flushes) == len(control_flushes)
    assert not any(flushes[i] for i in range(1, len(flushes), 3))
    # ...and the next query's full upload brings every row back
    assert spilled.tape.events == control.tape.events
    assert spilled.rows() == control.rows()
    assert_device_equals_mirror(spilled.index.corpus)


def test_spill_thread_racing_streamed_ingest(small_slices, monkeypatch):
    """A thread spilling the corpus as fast as it can while the workload
    ingests streamed batches: tapes, links and device tensors as without
    it (each spill takes the upload lock, so no slice is half copied)."""
    control, _ = _feed_port(monkeypatch)
    run = Run(PORT, dedup_schema(PORT))
    stop = threading.Event()
    spills = []

    def spiller():
        # a short pause between spills: back to back, every spill would
        # force the next slice and query into a full re-upload
        while not stop.wait(0.002):
            spills.append(run.index.corpus.spill_device())

    t = threading.Thread(target=spiller, daemon=True)
    t.start()
    try:
        for batch in batches(PORT):
            run.feed(batch)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert len(spills) > 1
    assert run.tape.events == control.tape.events
    assert run.rows() == control.rows()
    assert_device_equals_mirror(run.index.corpus)


def test_spill_frees_the_corpus_tensors(configs):
    """After a spill no corpus tensor is reachable from the corpus, the
    ledger's view reads 0 bytes and the next query faults back in."""
    wl = _build(tarena, configs[tarena], "people")
    try:
        wl.submit_batch("crm", REQUESTS[0][1])
        corpus = wl.index.corpus
        before = sum(corpus.device_bytes().values())
        assert before == corpus._device_nbytes() > 0
        assert corpus.spill_device() == before
        assert corpus._device_feats is None and corpus._device_masks is None
        assert sum(corpus.device_bytes().values()) == 0
        tarena.ARENA.forget(corpus)
        wl.submit_batch("crm", REQUESTS[2][1])
        assert sum(corpus.device_bytes().values()) == corpus._device_nbytes()
    finally:
        wl.close()


def _scheduled_two_tenants(sc, budget=None):
    """REQUESTS queued on a stopped scheduler over both tenants, then
    dispatched as merged microbatches: each tenant's dispatch admits its
    corpus, spilling the other under a one-tenant budget, while the
    other's requests wait in the queue.  (tapes, rows, spills)."""
    from sesam_duke_microservice_tpu_torch.engine.scheduler import (
        IngestScheduler,
    )

    from test_torch_scheduler import DRAIN, depth, wait_until

    wls = {"people": _build(tarena, sc, "people"),
           "orgs": _build(tarena, sc, "orgs")}
    logs = {}
    for name, wl in wls.items():
        logs[name] = EventLog()
        wl.processor.add_match_listener(logs[name])
    arena = tarena.ARENA
    old = arena._budget_bytes
    sched = IngestScheduler(lambda kind, name: wls.get(name), start=False)
    threads = []
    try:
        if budget is not None:
            arena._budget_bytes = lambda: float(budget)
        for i, (dataset, entities) in enumerate(REQUESTS * 2):
            name = "people" if dataset == "crm" else "orgs"
            rows = [dict(e, _id=f"{e['_id']}-{i}") for e in entities]
            t = threading.Thread(target=sched.submit, args=(
                "deduplication", name, dataset, rows))
            t.start()
            threads.append(t)
            assert wait_until(lambda: depth(sched) == i + 1)
        sched.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        return ({n: logs[n].events for n in wls},
                {n: link_rows(wls[n]) for n in wls}, arena.spills)
    finally:
        sched.shutdown(DRAIN)
        arena._budget_bytes = old
        for wl in wls.values():
            wl.close()


def test_spills_racing_scheduler_microbatches(configs, monkeypatch):
    # a one-record quantum: the dispatcher alternates the tenants, so
    # each microbatch's admission spills the other tenant
    monkeypatch.setenv("DUKE_SCHED_QUANTUM", "1")
    sc = configs[tarena]
    monkeypatch.setenv("DUKE_ARENA", "0")
    control = _scheduled_two_tenants(sc)
    monkeypatch.setenv("DUKE_ARENA", "1")
    one = _one_tenant_bytes(tarena, sc)
    tapes, rows, spills = _scheduled_two_tenants(sc, budget=int(one * 1.5))
    assert spills >= 2 and tarena.ARENA.faults >= 1
    assert (tapes, rows) == control[:2]
    assert rows["people"] and rows["orgs"]
