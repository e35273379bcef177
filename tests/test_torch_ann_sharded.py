"""The port's mesh-sharded ``ann`` scorers against the JAX package's.

The inputs of tests/test_ann_sharded.py (JAX features and embeddings of
the ``random_records`` corpus) go through the port's
``build_sharded_ann_scorer`` on ``[cpu] * 8`` and the JAX one on its
8-device CPU mesh: equal index sets and saturation counts, logits within
``certified_f32_margin``.  Against the port's single-device ``ann``
scorer the sharded pool is a superset (each shard keeps its own local
top-C before the merge); group filtering and self-exclusion hold; every
corpus row a duplicate of the queries makes the saturation signal the
whole merged pool.  IVF with ``nshards`` = 8: the stacked local-row
membership equals the JAX package's ``IvfState(nshards=8)`` on the same
rows and centroids, and the sharded IVF scorer equals the JAX one.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.ops import ivf as JIVF
from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu.parallel import ShardedCorpus as JPlacer
from sesam_duke_microservice_tpu.parallel import corpus_mesh as jmesh
from sesam_duke_microservice_tpu.parallel.ann_sharded import (
    build_sharded_ann_scorer as jbsa,
    build_sharded_ivf_scorer as jbsi,
)
from sesam_duke_microservice_tpu.parallel.sharded import rule_sharding
from sesam_duke_microservice_tpu_torch.ops import encoder as TE
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import ivf as TIVF
from sesam_duke_microservice_tpu_torch.ops import scoring as TS
from sesam_duke_microservice_tpu_torch.parallel import ann_sharded as TA
from sesam_duke_microservice_tpu_torch.parallel import sharded as TP

from test_ann_sharded import CHUNK, DIM, TOP_C, build_inputs
from test_torch_growth import DEDUP, PORT
from torch_jax_cache import jax_cache_off  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

MESH = TP.Mesh([torch.device("cpu")] * 8)


def _port_plan(jplan):
    plan = TF.SchemaFeatures.plan(PORT.schema(DEDUP))
    for spec, jspec in zip(plan.device_props, jplan.device_props):
        spec.values_per_record = jspec.values_per_record
        spec.max_chars = jspec.chars
    return plan


def _bits(feats):
    """The JAX host tree with its bf16 embeddings as the port's uint16
    bit patterns."""
    out = {p: dict(t) for p, t in feats.items()}
    emb = out[JE.ANN_PROP]
    emb[JE.ANN_TENSOR] = np.asarray(emb[JE.ANN_TENSOR]).view(np.uint16)
    return out


def _tq(tree):
    return {p: {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                    else a) for k, a in t.items()}
            for p, t in tree.items()}


def _both(n, nq, *, group=None, query_group=None, gf=False):
    (plan, feats, valid, deleted, grp, qfeats, q_emb, query_row,
     qgroup) = build_inputs(n, nq)
    grp = grp if group is None else group
    qgroup = qgroup if query_group is None else query_group
    jm = jmesh()
    sf, sv, sd, sg = JPlacer(jm, chunk=CHUNK).place(feats, valid, deleted,
                                                   grp)
    jq = {p: {k: jnp.asarray(a) for k, a in t.items()}
          for p, t in qfeats.items()}
    want = [np.asarray(x) for x in jbsa(
        plan, jm, chunk=CHUNK, top_c=TOP_C, group_filtering=gf)(
        jnp.asarray(q_emb), jq, sf, sv, sd, sg, jnp.asarray(qgroup),
        jnp.asarray(query_row), jnp.float32(0.0))]
    tplan = _port_plan(plan)
    tf_, tv, td, tg = TP.ShardedCorpus(MESH, chunk=CHUNK).place(
        _bits(feats), valid, deleted, grp)
    got = [x.numpy() for x in TA.build_sharded_ann_scorer(
        tplan, MESH, chunk=CHUNK, top_c=TOP_C, group_filtering=gf)(
        torch.from_numpy(q_emb), _tq(qfeats), tf_, tv, td, tg,
        torch.from_numpy(qgroup), torch.from_numpy(query_row), 0.0)]
    return plan, tplan, feats, (valid, deleted, grp), qfeats, q_emb, \
        query_row, qgroup, want, got


def test_sharded_ann_equals_jax_and_is_a_superset_of_one_device():
    n = 8 * CHUNK * 2
    (plan, tplan, feats, (valid, deleted, grp), qfeats, q_emb, query_row,
     qgroup, want, got) = _both(n, 16)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=JS.certified_f32_margin(plan))
    # the port's single-device ann over the same corpus
    emb = _bits(feats)[JE.ANN_PROP][JE.ANN_TENSOR]
    single = TS.build_ann_scorer(tplan, chunk=CHUNK, top_c=TOP_C)
    d_log, d_idx, _ = (x.numpy() for x in single(
        torch.from_numpy(q_emb), _tq(qfeats),
        torch.from_numpy(emb.view(np.int16)).view(torch.bfloat16),
        _tq({p: t for p, t in feats.items() if p != JE.ANN_PROP}),
        torch.from_numpy(valid), torch.from_numpy(deleted),
        torch.from_numpy(grp), torch.from_numpy(qgroup),
        torch.from_numpy(query_row), 0.0))
    s_log, s_idx = got[0], got[1]
    for qi in range(s_idx.shape[0]):
        single_hits = {int(r): float(v)
                       for r, v in zip(d_idx[qi], d_log[qi]) if v > 0.0}
        hits = {int(r): float(v)
                for r, v in zip(s_idx[qi], s_log[qi]) if v > 0.0}
        worst = min(hits.values(), default=float("inf"))
        for row, logit in single_hits.items():
            if row in hits:
                assert hits[row] == logit
            else:
                assert logit <= worst
        assert len(hits) >= len(single_hits) or len(hits) == TOP_C
        assert qi not in hits and n // 3 not in hits and n // 2 not in hits


def test_sharded_ann_group_filtering():
    n = 8 * CHUNK
    group = np.asarray([1 + (i % 2) for i in range(n)], dtype=np.int32)
    qgroup = np.asarray([1 + (i % 2) for i in range(8)], dtype=np.int32)
    *_, want, got = _both(n, 8, group=group, query_group=qgroup, gf=True)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for qi in range(8):
        for r, v in zip(got[1][qi], got[0][qi]):
            if v > TS.NEG_INF / 2 and r >= 0:
                assert group[int(r)] != qgroup[qi]


def test_sharded_ann_saturation_signal():
    """Every corpus row identical to the queries: every local top-C clears
    the bound on every shard and so does the merged pool, so the signal is
    the whole merged pool, 8 * TOP_C (the JAX package's value)."""
    from test_device_matcher import dedup_schema, make_record

    from sesam_duke_microservice_tpu.ops import features as JF

    schema = dedup_schema()
    jplan = JF.SchemaFeatures.plan(schema)
    enc = JE.RecordEncoder(schema, DIM)
    n = 8 * CHUNK
    records = [make_record(f"r{i}", name="acme corp", city="oslo",
                           amount="100") for i in range(n)]
    feats = JF.extract_batch(jplan, records)
    feats[JE.ANN_PROP] = {JE.ANN_TENSOR: enc.encode_corpus(records)}
    queries = records[:4]
    qfeats = JF.extract_batch(jplan, queries)
    tf_, tv, td, tg = TP.ShardedCorpus(MESH, chunk=CHUNK).place(
        _bits(feats), np.ones(n, bool), np.zeros(n, bool),
        np.full(n, -1, np.int32))
    _, _, sat = TA.build_sharded_ann_scorer(
        _port_plan(jplan), MESH, chunk=CHUNK, top_c=TOP_C)(
        torch.from_numpy(enc.encode_batch(queries)), _tq(qfeats), tf_, tv,
        td, tg, torch.full((4,), -2, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32), 0.0)
    assert int(sat.max()) == 8 * TOP_C


@pytest.fixture
def ivf_env(monkeypatch):
    for name, value in (("DUKE_IVF", "1"), ("DUKE_IVF_MIN_ROWS", "16"),
                        ("DUKE_IVF_CELLS", "8"), ("DUKE_IVF_NPROBE", "3"),
                        ("DUKE_IVF_SCAN_SLOTS", "64")):
        monkeypatch.setenv(name, value)
    # the JAX package's k-means behind the port's training: one identical
    # set of centroids, so the assignments and membership compare exactly
    monkeypatch.setattr(
        TIVF, "train_kmeans",
        lambda x, k, *, seed, iters, device: JIVF.train_kmeans(
            x, k, seed=seed, iters=iters))


def _ivf_corpus(feats, valid, deleted, size, capacity, bits):
    tree = _bits(feats) if bits else feats
    return types.SimpleNamespace(
        feats={JE.ANN_PROP: tree[JE.ANN_PROP]}, row_valid=valid,
        row_deleted=deleted, size=size, capacity=capacity)


def test_ivf_nshards_membership_and_scorer_equal_jax(ivf_env):
    n = 8 * CHUNK * 2
    (plan, feats, valid, deleted, grp, qfeats, q_emb, query_row,
     qgroup) = build_inputs(n, 16)
    first = n - 40  # the rest arrives as an incremental append
    jstate = JIVF.IvfState(nshards=8)
    tstate = TIVF.IvfState(nshards=8)
    for size in (first, n):
        jc = _ivf_corpus(feats, valid, deleted, size, n, bits=False)
        tc = _ivf_corpus(feats, valid, deleted, size, n, bits=True)
        if size == n:  # the same corpus object: no reset, no retrain
            jc, tc = jcorp, tcorp
            jc.size = tc.size = n
        jcorp, tcorp = jc, tc
        assert jstate.sync(jc) and tstate.sync(tc)
        np.testing.assert_array_equal(tstate.centroids, jstate.centroids)
        np.testing.assert_array_equal(tstate.cell_of, jstate.cell_of)
        np.testing.assert_array_equal(tstate.cell_rows, jstate.cell_rows)
        np.testing.assert_array_equal(tstate.counts, jstate.counts)
    assert tstate.trained_rows == first
    assert tstate.cell_rows.shape[0] == 8 * tstate.ncells
    # every listed row is local to its shard's block
    local = n // 8
    assert tstate.cell_rows.max() < local
    # the sharded IVF scorer on the carried state
    jm = jmesh()
    sf, sv, sd, sg = JPlacer(jm, chunk=CHUNK).place(feats, valid, deleted,
                                                   grp)
    jcent, jcells = jstate.device_tensors(
        lambda a: jax.device_put(a, rule_sharding(jm, "centroids", 2)),
        lambda a: jax.device_put(a, rule_sharding(jm, "ivf_membership", 2)))
    jq = {p: {k: jnp.asarray(a) for k, a in t.items()}
          for p, t in qfeats.items()}
    want = [np.asarray(x) for x in jbsi(plan, jm, top_c=TOP_C, nprobe=3)(
        jnp.asarray(q_emb), jq, sf, jcent, jcells, sv, sd, sg,
        jnp.asarray(qgroup), jnp.asarray(query_row), jnp.float32(0.0))]
    tf_, tv, td, tg = TP.ShardedCorpus(MESH, chunk=CHUNK).place(
        _bits(feats), valid, deleted, grp)
    repl = TP.rule_sharding(MESH, "centroids")
    split = TP.rule_sharding(MESH, "ivf_membership")
    tcent, tcells = tstate.device_tensors(
        lambda a: repl(torch.from_numpy(a)),
        lambda a: split(torch.from_numpy(a).to(torch.int64)))
    got = [x.numpy() for x in TA.build_sharded_ivf_scorer(
        _port_plan(plan), MESH, top_c=TOP_C, nprobe=3)(
        torch.from_numpy(q_emb), _tq(qfeats), tf_, tcent, tcells, tv, td,
        tg, torch.from_numpy(qgroup), torch.from_numpy(query_row), 0.0)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=JS.certified_f32_margin(plan))
    assert (got[1] >= 0).any()
