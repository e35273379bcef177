"""The port's ``ann`` backend against the JAX package's, on the CPU.

* the segment-max kernel's plain version against the Pallas kernel in
  interpret mode: ``seg_max`` within ``4 * D * 2^-24`` and ``seg_arg``
  equal wherever a bin's best leads its next lower score by more than that
  (group filtering on and off, tombstones, self rows, all-masked bins and
  an adjacent duplicate cluster);
* ``retrieval_scan`` on both routes: the fused route (the JAX side with
  ``DUKE_TPU_PALLAS=1``; ``DEVICE_ANN_SEG=8``, recall target 0.8, C = 16,
  N = 1,024, D = 128, as tests/test_fused_retrieval.py sets them) and the
  scan route with ``DEVICE_ANN_EXACT_TOPK`` on and off, bf16 and int8; and
  the fused route's gate, shape for shape;
* ``build_ann_scorer`` on one corpus: top_index and count equal, logits
  within ``certified_f32_margin``;
* the slice: the JAX ``DukeApp(backend="ann")`` and the port's
  ``DukeApp(backend="ann", device="cpu")`` over HTTP on the stresstest
  schema (dedup with width growth and a tombstone, one-to-one linkage) and
  on the mixed schema (certified dd finalization), with knobs that reach
  the fused route on both sides; runs of the scan route in bf16 and int8
  storage and a recall escalation that moves from the fused route to the
  scan route.  Feeds and
  ordered event tapes must be bit-identical.

The JAX package reads ``DEVICE_INITIAL_CAPACITY`` and the initial C when
its modules are imported, so the tests patch ``device_matcher.
_INITIAL_CAPACITY`` and set ``AnnIndex.initial_top_c`` on its workloads;
the port reads both knobs when an index is built.  Both sides run the
numpy encoder (see tests/test_torch_encoder.py).
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.engine import device_matcher as jdm
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.ops import features as JF
from sesam_duke_microservice_tpu.ops import pallas_kernels as pk
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu.service.app import DukeApp as JApp
from sesam_duke_microservice_tpu.service.app import serve as jserve
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.engine import device_matcher as tdm
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
from sesam_duke_microservice_tpu_torch.ops import embedding as TH
from sesam_duke_microservice_tpu_torch.ops import encoder as TE
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import scoring as TS
from sesam_duke_microservice_tpu_torch.service.app import DukeApp as TApp
from sesam_duke_microservice_tpu_torch.service.app import serve as tserve

from test_torch_finalize import _config as mixed_config
from test_torch_finalize import _entities as mixed_entities
from test_torch_slice import (
    CONFIG_XML,
    _TS,
    _Tape,
    _feed,
    _long_name_entities,
    _post,
    _stresstest_entities,
)
from torch_jax_cache import jax_cache_off  # noqa: F401

FUSED_KNOBS = {"DUKE_TPU_PALLAS": "1", "DEVICE_ANN_FUSED": "1",
               "DEVICE_ANN_EXACT_TOPK": "0", "DEVICE_ANN_SEG": "8",
               "DEVICE_ANN_RECALL_TARGET": "0.8"}
TOP_C = 16


_JE_NATIVE_EMBED = JE._native_embed
_TH_NATIVE_EMBED = TH._native_embed


@pytest.fixture(autouse=True)
def _numpy_encoder(monkeypatch):
    # both sides on their numpy encoders, which agree bit for bit (the
    # C++ encoders agree with each other: the *_native_encoders test)
    monkeypatch.setattr(JE, "_native_embed", lambda: None)
    monkeypatch.setattr(TH, "_native_embed", lambda: None)


def _knobs(monkeypatch, knobs):
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)


# -- the segment-max kernel's plain version vs the Pallas kernel -------------


def _segmax_inputs(q, n, d, seed, *, cluster=False):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    valid = rng.random(n) > 0.05
    deleted = rng.random(n) < 0.05
    group = rng.integers(1, 3, n).astype(np.int32)
    qgroup = rng.integers(1, 3, q).astype(np.int32)
    qrow = np.where(rng.random(q) < 0.5, rng.integers(0, n, q),
                    -1).astype(np.int32)
    if cluster:  # 24 identical adjacent rows, the queries' own vector
        corpus[100:124] = corpus[100]
        queries[:] = corpus[100]
        valid[:] = True
        deleted[:] = False
        qrow[:] = -1
    return (TE.bf16_bits(queries), TE.bf16_bits(corpus), valid, deleted,
            group, qrow, qgroup)


def _pallas_segmax(inputs, *, tc, seg, gf):
    qbits, cbits, valid, deleted, group, qrow, qgroup = inputs
    bf16 = jnp.bfloat16
    live = valid & ~deleted
    enc = np.where(live, np.clip(group, -1, 100) + pk.GROUP_OFFSET,
                   0).astype(np.int8)
    seg_max, seg_arg = pk.retrieval_segmax(
        jnp.asarray(TE.bf16_to_f32(qbits)).astype(bf16).T,
        jnp.asarray(TE.bf16_to_f32(cbits)).astype(bf16),
        jnp.asarray(np.broadcast_to(enc[:, None], (enc.shape[0], 128))),
        jnp.asarray(qrow[None, :]),
        jnp.asarray((np.clip(qgroup, -1, 100) + pk.GROUP_OFFSET)[None, :]
                    .astype(np.int32)),
        tc=tc, seg=seg, group_filtering=gf, interpret=True)
    return (torch.from_numpy(np.asarray(seg_max).T.copy()),
            torch.from_numpy(np.asarray(seg_arg).T.copy()))


def _torch_inputs(inputs):
    qbits, cbits, valid, deleted, group, qrow, qgroup = inputs
    as_bf16 = [torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
               for b in (qbits, cbits)]
    return as_bf16 + [torch.from_numpy(a) for a in
                      (valid, deleted, group, qrow, qgroup)]


@pytest.mark.parametrize("seg,gf,cluster", [
    (8, False, False), (8, True, False), (64, True, False), (8, False, True),
    (64, False, True),
])
def test_segmax_plain_version_matches_pallas(seg, gf, cluster):
    tc, d = 1024, 128
    inputs = _segmax_inputs(128, 2 * tc, d, seg + gf, cluster=cluster)
    if not cluster:
        inputs[2][:tc:tc // seg] = False  # bin 0: every row masked
    got = _pallas_segmax(inputs, tc=tc, seg=seg, gf=gf)
    tin = _torch_inputs(inputs)
    want = ck.retrieval_segmax_reference(*tin, tc=tc, seg=seg,
                                         group_filtering=gf, runner_up=True)
    err, bad = ck.segmax_disagreement(*got, *want, d)
    assert err <= ck.segmax_tolerance(d) and bad == 0, (err, bad)
    # the wrapper runs the plain version for CPU tensors
    again = ck.retrieval_segmax(*tin, tc=tc, seg=seg, group_filtering=gf)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    assert ck.LAUNCHES["retrieval_segmax"] == 0
    if not cluster:
        assert bool((want[0][:, 0] == ck.SEGMAX_NEG).all())
        assert bool((want[1][:, 0] == 0).all())
    else:  # every cluster row wins its own bin (up to tc/seg bins) ...
        in_cluster = (want[1] >= 100) & (want[1] < 124)
        assert bool((in_cluster.sum(dim=1) == min(24, tc // seg)).all())
        # ... and tied duplicates resolve to the same smallest row
        assert torch.equal(got[1][in_cluster], want[1][in_cluster])


# -- retrieval_scan on both routes ------------------------------------------


def _retrieval_problem(n=1024, q=96, d=128, seed=0, groups=False):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    corpus[200:224] = corpus[200]        # an adjacent duplicate cluster
    queries[:4] = corpus[200]
    cvalid = rng.random(n) > 0.05
    cdel = rng.random(n) < 0.05
    cgroup = (rng.integers(1, 3, n) if groups
              else np.full(n, -1)).astype(np.int32)
    qgroup = (rng.integers(1, 3, q) if groups
              else np.full(q, -2)).astype(np.int32)
    qrow = np.where(rng.random(q) < 0.5, rng.integers(0, n, q),
                    -1).astype(np.int32)
    # the cluster is live and, under group filtering, of the other group
    cvalid[200:224], cdel[200:224], qrow[:4] = True, False, -1
    if groups:
        cgroup[200:224], qgroup[:4] = 2, 1
    return queries, corpus, cvalid, cdel, cgroup, qgroup, qrow


def _run_both(problem, *, top_c, gf, int8=False, chunk=512):
    queries, corpus, *rest = problem
    if int8:
        qc, qs = JE.quantize_rows(queries)
        cc, cs = JE.quantize_rows(corpus)
        jq = {JE.ANN_TENSOR: jnp.asarray(qc), JE.ANN_SCALE: jnp.asarray(qs)}
        jc = {JE.ANN_TENSOR: jnp.asarray(cc), JE.ANN_SCALE: jnp.asarray(cs)}
        tq = {TE.ANN_TENSOR: torch.from_numpy(qc),
              TE.ANN_SCALE: torch.from_numpy(qs)}
        tc = {TE.ANN_TENSOR: torch.from_numpy(cc),
              TE.ANN_SCALE: torch.from_numpy(cs)}
    else:
        jq = jnp.asarray(queries)
        jc = jnp.asarray(corpus.astype(JE.STORAGE_DTYPE))
        tq = torch.from_numpy(queries)
        tc = torch.from_numpy(TE.bf16_bits(corpus).view(np.int16)).view(
            torch.bfloat16)
    js, ji = JE.retrieval_scan(jq, jc, *(jnp.asarray(a) for a in rest),
                               chunk=chunk, top_c=top_c, group_filtering=gf)
    ts, ti = TE.retrieval_scan(tq, tc, *(torch.from_numpy(a) for a in rest),
                               chunk=chunk, top_c=top_c, group_filtering=gf)
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def _assert_same_retrieval(jax_out, port_out, tol):
    """Scores within ``tol``; indices equal except where two kept scores
    sit within ``tol`` of each other without an exact tie (their order is
    rounding's; exact ties go to the lower position on both sides)."""
    (js, ji), (ts, ti) = jax_out, port_out
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_allclose(ts, js, rtol=0, atol=tol)
    gap = np.abs(np.diff(js, axis=1))
    gaps = (gap == 0) | (gap > tol)
    decided = np.ones_like(ji, dtype=bool)
    decided[:, 1:] &= gaps
    decided[:, :-1] &= gaps
    np.testing.assert_array_equal(ti[decided], ji[decided])
    assert decided.mean() > 0.9


@pytest.mark.parametrize("gf", [False, True])
def test_retrieval_scan_fused_route_matches_jax(gf, monkeypatch):
    _knobs(monkeypatch, FUSED_KNOBS)
    problem = _retrieval_problem(groups=gf, seed=3)
    before = dict(TE.ROUTES)
    jax_out, port_out = _run_both(problem, top_c=TOP_C, gf=gf)
    assert TE.ROUTES["fused"] == before["fused"] + 1
    _assert_same_retrieval(jax_out, port_out, ck.segmax_tolerance(128))
    # the duplicate cluster's queries retrieve a full top-C of its rows
    ti = port_out[1]
    assert (((ti[:4] >= 200) & (ti[:4] < 224)).sum(axis=1) == TOP_C).all()


@pytest.mark.parametrize("exact", ["0", "1"])
@pytest.mark.parametrize("int8", [False, True])
def test_retrieval_scan_scan_route_matches_jax(exact, int8, monkeypatch):
    _knobs(monkeypatch, {"DUKE_TPU_PALLAS": "0", "DEVICE_ANN_FUSED": "0",
                         "DEVICE_ANN_EXACT_TOPK": exact,
                         "DEVICE_ANN_RETRIEVAL_CHUNK": "256"})
    problem = _retrieval_problem(groups=True, seed=5)
    before = dict(TE.ROUTES)
    jax_out, port_out = _run_both(problem, top_c=TOP_C, gf=True, int8=int8,
                                  chunk=64)
    assert TE.ROUTES["scan"] == before["scan"] + 1
    if int8:  # the integer dot and its rescale are exact: bit for bit
        np.testing.assert_array_equal(port_out[0], jax_out[0])
        np.testing.assert_array_equal(port_out[1], jax_out[1])
    else:
        _assert_same_retrieval(jax_out, port_out, ck.segmax_tolerance(128))


@pytest.mark.parametrize("n,d,q,top_c,seg,recall", [
    (1024, 192, 8, 16, 64, 0.8),       # D not a multiple of 128
    (16384, 128, 96, 64, 64, 0.95),    # below the bin floor
    (16384, 128, 96, 16, 64, 0.8),
    (1024, 128, 96, 16, 8, 0.8),       # the differential tests' config
    (1024, 128, 96, 16, 64, 0.8),      # 16 bins < 80
    (512, 128, 96, 16, 8, 0.8),        # tc = 512 < 1024
    (2048, 128, 1500, 16, 8, 0.8),     # 2^21 / Qp = 1365 does not divide N
    (2048, 128, 1024, 16, 8, 0.8),
    (2048, 128, 2048, 16, 8, 0.8),
])
def test_fused_route_gate_matches_jax(n, d, q, top_c, seg, recall,
                                      monkeypatch):
    monkeypatch.setenv("DEVICE_ANN_SEG", str(seg))
    args = _retrieval_problem(n=n, q=q, d=d, seed=9)
    queries, corpus, cvalid, cdel, cgroup, qgroup, qrow = args
    jax_out = JE._fused_retrieval(
        jnp.asarray(queries), jnp.asarray(corpus.astype(JE.STORAGE_DTYPE)),
        *(jnp.asarray(a) for a in (cvalid, cdel, cgroup, qgroup, qrow)),
        top_c=top_c, group_filtering=False, row_offset=0,
        recall_target=recall)
    route = TE.fused_route(n, d, q, top_c, recall)
    assert (route is None) == (jax_out is None)
    if route is not None:
        tc, _ = route
        port_out = TE._fused_retrieval(
            torch.from_numpy(queries),
            torch.from_numpy(TE.bf16_bits(corpus).view(np.int16)).view(
                torch.bfloat16),
            *(torch.from_numpy(a) for a in (cvalid, cdel, cgroup, qgroup,
                                            qrow)),
            top_c=top_c, tc=tc, seg=seg, group_filtering=False)
        _assert_same_retrieval([np.asarray(a) for a in jax_out],
                               [a.numpy() for a in port_out],
                               ck.segmax_tolerance(d))


def test_fused_route_at_the_main_path_shapes(monkeypatch):
    """524,288 rows, D = 256, production knobs: a 2,048-query block takes
    the kernel at tc = 1,024; a 4,096-query block and an escalated C = 128
    take the scan route."""
    monkeypatch.delenv("DEVICE_ANN_SEG", raising=False)
    n = 524288
    assert TE.fused_route(n, 256, 2048, 64, 0.99) == (1024, 64)
    assert TE.fused_route(n, 256, 4096, 64, 0.99) is None
    assert TE.fused_route(n, 256, 2048, 128, 0.99) is None
    assert TE.fused_route(131072, 256, 2048, 64, 0.99) is None


# -- build_ann_scorer on one corpus -------------------------------------------


@pytest.mark.parametrize("route", ["fused", "scan"])
def test_ann_scorer_matches_jax(route, monkeypatch):
    if route == "fused":
        _knobs(monkeypatch, FUSED_KNOBS)
        monkeypatch.setattr(jdm, "_INITIAL_CAPACITY", 1024)
    else:
        _knobs(monkeypatch, {"DUKE_TPU_PALLAS": "0", "DEVICE_ANN_FUSED": "0"})
    japp = JApp(jparse(CONFIG_XML), backend="ann", persistent=False)
    wl = japp.deduplications["people"]
    with wl.lock:
        wl.process_batch("crm", _stresstest_entities(300, 77, "s"))
    index = wl.index
    corpus = index.corpus
    jplan = index.plan
    tplan = TF.SchemaFeatures.plan(
        tparse(CONFIG_XML).deduplications["people"].duke)
    for jspec, tspec in zip(jplan.device_props, tplan.device_props):
        tspec.values_per_record = jspec.values_per_record
        tspec.max_chars = jspec.max_chars
    feats = {p: dict(t) for p, t in corpus.feats.items()}
    emb = feats[JE.ANN_PROP]
    emb[JE.ANN_TENSOR] = np.asarray(emb[JE.ANN_TENSOR]).view(np.uint16)
    tcorpus = tdm.DeviceCorpus.from_numpy(
        tplan, feats, corpus.row_valid, corpus.row_deleted, corpus.row_group,
        "cpu")
    assert tcorpus.capacity == corpus.capacity
    min_logit = JS.emit_bound_logit(index.schema, jplan, 1e-3)
    query_row = np.arange(32, dtype=np.int32)
    query_row[-3:] = -1                    # bucket padding
    query_group = np.full(32, -2, dtype=np.int32)

    jf, jv, jd, jg = corpus.device_arrays()
    jscore = JS.build_ann_scorer(jplan, chunk=64, top_c=TOP_C,
                                 queries_from_rows=True)
    want = [np.asarray(x) for x in jscore(
        jnp.float32(0.0), {}, jf[JE.ANN_PROP],
        {p: t for p, t in jf.items() if p != JE.ANN_PROP}, jv, jd, jg,
        jnp.asarray(query_group), jnp.asarray(query_row),
        jnp.float32(min_logit))]
    tf_, tv, td, tg = tcorpus.device_arrays()
    before = dict(TE.ROUTES)
    tscore = TS.build_ann_scorer(tplan, chunk=64, top_c=TOP_C,
                                 queries_from_rows=True)
    got = [x.numpy() for x in tscore(
        {}, {}, tf_[TE.ANN_PROP],
        {p: t for p, t in tf_.items() if p != TE.ANN_PROP}, tv, td, tg,
        torch.from_numpy(query_group), torch.from_numpy(query_row),
        min_logit)]
    assert TE.ROUTES[route] == before[route] + 1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=JS.certified_f32_margin(jplan))
    assert (got[2] > 0).any()


# -- the slice: JAX DukeApp(backend="ann") vs the port over HTTP --------------


def _serve_both(japp, tapp):
    servers = [jserve(japp, port=0, host="127.0.0.1"),
               tserve(tapp, port=0, host="127.0.0.1")]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    return servers, threads


def _shutdown(servers, threads, apps):
    for s in servers:
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=10)
    for app in apps:
        app.close()


def _apps(config_xml, monkeypatch, *, fused, top_c=TOP_C):
    if fused:
        _knobs(monkeypatch, FUSED_KNOBS)
        monkeypatch.setenv("DEVICE_INITIAL_CAPACITY", "1024")
        monkeypatch.setattr(jdm, "_INITIAL_CAPACITY", 1024)
    else:
        _knobs(monkeypatch, {"DUKE_TPU_PALLAS": "0", "DEVICE_ANN_FUSED": "0"})
    monkeypatch.setenv("DEVICE_ANN_CANDIDATES", str(top_c))
    japp = JApp(jparse(config_xml), backend="ann", persistent=False)
    tapp = TApp(tparse(config_xml), backend="ann", device="cpu",
                persistent=False)
    for wl in (list(japp.deduplications.values())
               + list(japp.record_linkages.values())):
        wl.index.initial_top_c = top_c
    for wl in (list(tapp.deduplications.values())
               + list(tapp.record_linkages.values())):
        assert wl.index.initial_top_c == top_c
    return japp, tapp


def _counting_pallas_segmax(monkeypatch):
    calls = []
    real = pk.retrieval_segmax

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(pk, "retrieval_segmax", counted)
    return calls


@pytest.mark.parametrize("route", ["fused", "scan", "scan-int8"])
def test_ann_service_bit_identical_to_jax(route, monkeypatch):
    _ann_service_bit_identical(route, monkeypatch)


def test_ann_service_bit_identical_to_jax_native_encoders(monkeypatch):
    """Both packages' C++ encoders (their default): the same feeds and
    tapes as each other.  Both feature caches are off, so no row embedded
    by an earlier test's numpy encoder is served here, and each C++
    encoder is counted."""
    monkeypatch.setenv("DUKE_FEATURE_CACHE_MB", "0")
    monkeypatch.setattr(JE, "_native_embed", _JE_NATIVE_EMBED)
    monkeypatch.setattr(TH, "_native_embed", _TH_NATIVE_EMBED)
    assert JE._native_embed() is not None and TH._native_embed() is not None
    calls = {}
    for side, lib in (("jax", JE._native_embed()), ("port", TH._native_embed())):
        def counted(*args, _real=lib.embed_batch, _side=side, **kwargs):
            calls[_side] = calls.get(_side, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(lib, "embed_batch", counted)
    _ann_service_bit_identical("scan", monkeypatch)
    assert calls.get("jax", 0) > 0 and calls.get("port", 0) > 0, calls


def _ann_service_bit_identical(route, monkeypatch):
    # both feature modules were imported with this module: let char widths
    # grow with the data from the same base
    assert JF.MAX_CHARS == TF.MAX_CHARS
    monkeypatch.delenv("DEVICE_MAX_CHARS", raising=False)
    monkeypatch.setenv("DUKE_EMB_INT8", "1" if route == "scan-int8" else "0")
    fused = route == "fused"
    japp, tapp = _apps(CONFIG_XML, monkeypatch, fused=fused)
    jcalls = _counting_pallas_segmax(monkeypatch)
    before = dict(TE.ROUTES)
    servers, threads = _serve_both(japp, tapp)
    batches = [_stresstest_entities(200, 1234 + k, f"b{k}_")
               for k in range(2)]
    long_batch = _long_name_entities(30, 5)
    left = _stresstest_entities(120, 99, "L")
    right = _stresstest_entities(120, 99, "R")[::-1]
    try:
        tapes, bodies = [], []
        for app, server in zip((japp, tapp), servers):
            port = server.server_address[1]
            people, registry = _Tape(), _Tape()
            app.deduplications["people"].processor.add_match_listener(people)
            app.record_linkages["registry"].processor.add_match_listener(
                registry)
            tapes.append((people.events, registry.events))
            for batch in batches + [long_batch]:
                _post(port, "/deduplication/people/crm", batch)
            _post(port, "/deduplication/people/crm",
                  [{"_id": "b0_1", "_deleted": True}])
            _post(port, "/recordlinkage/registry/left", left)
            _post(port, "/recordlinkage/registry/right", right)
            probe = [dict(batches[0][3], _id="t1")]
            bodies.append(_post(
                port, "/deduplication/people/crm/httptransform", probe))
        feeds = [[_TS.sub(b'"_updated": 0', _feed(s.server_address[1], path))
                  for path in ("/deduplication/people",
                               "/recordlinkage/registry")]
                 for s in servers]
    finally:
        _shutdown(servers, threads, (japp, tapp))
    assert feeds[1] == feeds[0]
    assert tapes[1] == tapes[0]
    assert bodies[1] == bodies[0]
    assert len(json.loads(feeds[1][0])) > 20
    assert len(json.loads(feeds[1][1])) > 5
    assert any(e[0] == "maybe" for e in tapes[1][0])
    spec = tapp.deduplications["people"].index.plan.device_props[0]
    assert spec.chars > 32                # the long batch widened NAME
    stats = tapp.deduplications["people"].processor.stats
    assert 0 < stats.pairs_compared <= stats.records_processed * 2 * TOP_C
    if fused:  # the fused route really ran, on both sides
        assert TE.ROUTES["fused"] > before["fused"] and jcalls
    else:
        assert TE.ROUTES["fused"] == before["fused"] and not jcalls


def test_ann_mixed_schema_certified_bit_identical_to_jax(monkeypatch):
    monkeypatch.delenv("DUKE_DEVICE_FINALIZE", raising=False)
    japp, tapp = _apps(mixed_config("mixed"), monkeypatch, fused=True)
    servers, threads = _serve_both(japp, tapp)
    batches = [mixed_entities("mixed", 32, 10 + k, f"b{k}_")
               for k in range(2)]
    try:
        tapes, stats = [], []
        for app, server in zip((japp, tapp), servers):
            tape = _Tape()
            wl = app.deduplications["mixed"]
            wl.processor.add_match_listener(tape)
            for batch in batches:
                _post(server.server_address[1], "/deduplication/mixed/crm",
                      batch)
            tapes.append(tape.events)
            stats.append(wl.processor.stats)
        feeds = [_TS.sub(b'"_updated": 0',
                         _feed(s.server_address[1], "/deduplication/mixed"))
                 for s in servers]
    finally:
        _shutdown(servers, threads, (japp, tapp))
    assert feeds[1] == feeds[0]
    assert tapes[1] == tapes[0]
    assert len(json.loads(feeds[1])) > 10
    jstats, tstats = stats
    for counter in ("pairs_device_certified", "pairs_rescored",
                    "pairs_skipped", "candidates_retrieved",
                    "pairs_compared"):
        assert getattr(tstats, counter) == getattr(jstats, counter), counter
    assert tstats.pairs_device_certified > 0 and tstats.dd_blocks > 0


def test_ann_recall_escalation_moves_to_the_scan_route(monkeypatch):
    """24 identical records from C = 2: every retrieved row clears the
    bound, so C doubles (fused while the bins carry it, then the scan
    route) until all 23 others of each record are found."""
    japp, tapp = _apps(CONFIG_XML, monkeypatch, fused=True, top_c=2)
    before = dict(TE.ROUTES)
    esc = tdm.ESCALATIONS["top_c"]
    batch = [{"_id": f"d{i}", "name": "acme corp", "area": "5",
              "ssn": "100"} for i in range(24)]
    tapes = []
    for app in (japp, tapp):
        tape = _Tape()
        wl = app.deduplications["people"]
        wl.processor.add_match_listener(tape)
        with wl.lock:
            wl.process_batch("crm", batch)
        tapes.append(tape.events)
        app.close()
    assert tapes[1] == tapes[0]
    pairs = {(e[1], e[2]) for e in tapes[1] if e[0] == "matches"}
    assert len(pairs) == 24 * 23
    assert tdm.ESCALATIONS["top_c"] > esc
    assert TE.ROUTES["fused"] > before["fused"]
    assert TE.ROUTES["scan"] > before["scan"]
