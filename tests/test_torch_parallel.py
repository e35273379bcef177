"""The port's mesh-sharded brute-force scorer against the JAX package's.

One corpus -- the stresstest records of tests/test_torch_scoring.py, with
exact-duplicate names (ties) and tombstones, indexed by the JAX
``DeviceIndex`` -- is scored by the port's ``build_sharded_scorer`` on
``[cpu] * D`` for D in {1, 3, 8}, by the JAX ``build_sharded_scorer`` on
its 8-device CPU mesh and by the JAX single-device
``build_corpus_scorer``.  The index sets must be equal, ties included (the
merge keeps shard 0's K first, then a stable sort), the counts equal, the
logits within ``certified_f32_margin``.  Group filtering and
self-exclusion by global row, and ``merge_topk`` on hand-made ties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesam_duke_microservice_tpu.ops import scoring as JS
from sesam_duke_microservice_tpu.parallel import ShardedCorpus as JPlacer
from sesam_duke_microservice_tpu.parallel import build_sharded_scorer as jbss
from sesam_duke_microservice_tpu.parallel import corpus_mesh as jmesh
from sesam_duke_microservice_tpu_torch.ops import scoring as TS
from sesam_duke_microservice_tpu_torch.parallel import sharded as TP

from test_torch_scoring import CHUNK, TOP_K, _jax_corpus, _port_plan, _schemas

CPU = torch.device("cpu")


def _inputs(group_filtering):
    jschema, tschema = _schemas(group_filtering)
    jindex = _jax_corpus(jschema, group_filtering)
    corpus = jindex.corpus
    nq = 48
    rows = np.arange(nq, dtype=np.int32) * 6
    query_group = (corpus.row_group[rows].astype(np.int32)
                   if group_filtering else np.full((nq,), -2, np.int32))
    qfeats = {prop: {name: arr[rows] for name, arr in t.items()}
              for prop, t in corpus.feats.items()}
    min_logit = JS.emit_bound_logit(jschema, jindex.plan, 1e-3)
    return (jindex, _port_plan(tschema, jindex.plan), qfeats, rows,
            query_group, min_logit)


def _jax_results(jindex, qfeats, rows, query_group, min_logit,
                 group_filtering):
    corpus = jindex.corpus
    n = corpus.size
    jq = {p: {k: jnp.asarray(a) for k, a in t.items()}
          for p, t in qfeats.items()}
    args = (jnp.asarray(query_group), jnp.asarray(rows),
            jnp.float32(min_logit))
    jf, jv, jd, jg = corpus.device_arrays()
    single = JS.build_corpus_scorer(jindex.plan, chunk=CHUNK, top_k=TOP_K,
                                    group_filtering=group_filtering)
    want = [np.asarray(x) for x in single(jq, jf, jv, jd, jg, *args)]
    mesh = jmesh()
    assert mesh.size == 8
    placer = JPlacer(mesh, chunk=CHUNK)
    feats = {p: {k: a[:n] for k, a in t.items()}
             for p, t in corpus.feats.items()}
    sf, sv, sd, sg = placer.place(feats, corpus.row_valid[:n],
                                  corpus.row_deleted[:n],
                                  corpus.row_group[:n])
    sharded = jbss(jindex.plan, mesh, chunk=CHUNK, top_k=TOP_K,
                   group_filtering=group_filtering)
    got8 = [np.asarray(x) for x in sharded(jq, sf, sv, sd, sg, *args)]
    return want, got8


def _port_results(jindex, tplan, qfeats, rows, query_group, min_logit,
                  group_filtering, d):
    corpus = jindex.corpus
    n = corpus.size
    mesh = TP.Mesh([CPU] * d)
    placer = TP.ShardedCorpus(mesh, chunk=CHUNK)
    feats = {p: {k: a[:n] for k, a in t.items()}
             for p, t in corpus.feats.items()}
    sf, sv, sd, sg = placer.place(feats, corpus.row_valid[:n],
                                  corpus.row_deleted[:n],
                                  corpus.row_group[:n])
    assert len(sv) == d and all(t.shape[0] % CHUNK == 0 for t in sv)
    tq = {p: {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                  else a) for k, a in t.items()}
          for p, t in qfeats.items()}
    score = TP.build_sharded_scorer(tplan, mesh, chunk=CHUNK, top_k=TOP_K,
                                    group_filtering=group_filtering)
    return [x.numpy() for x in score(
        tq, sf, sv, sd, sg, torch.from_numpy(query_group),
        torch.from_numpy(rows), min_logit)]


@pytest.mark.parametrize("group_filtering", [False, True])
def test_sharded_scorer_equals_jax_mesh_and_single_device(group_filtering):
    jindex, tplan, qfeats, rows, qgroup, min_logit = _inputs(group_filtering)
    want, jax8 = _jax_results(jindex, qfeats, rows, qgroup, min_logit,
                              group_filtering)
    margin = JS.certified_f32_margin(jindex.plan)
    # the JAX mesh itself equals its single device, ties included
    np.testing.assert_array_equal(jax8[1], want[1])
    for d in (1, 3, 8):
        top_logit, top_index, count = _port_results(
            jindex, tplan, qfeats, rows, qgroup, min_logit, group_filtering,
            d)
        np.testing.assert_array_equal(top_index, want[1], err_msg=f"D={d}")
        np.testing.assert_array_equal(top_index, jax8[1], err_msg=f"D={d}")
        np.testing.assert_array_equal(count, want[2], err_msg=f"D={d}")
        np.testing.assert_array_equal(count, jax8[2], err_msg=f"D={d}")
        np.testing.assert_allclose(top_logit, want[0], rtol=0, atol=margin)
        np.testing.assert_allclose(top_logit, jax8[0], rtol=0, atol=margin)
    # the corpus really carries exact ties inside the kept top-K
    kept = top_logit[top_logit > JS.NEG_INF]
    assert len(np.unique(kept)) < len(kept)
    # and the sharded port equals the port's own single-device scorer
    corpus = jindex.corpus
    tcorp = TS.build_corpus_scorer(tplan, chunk=CHUNK, top_k=TOP_K,
                                   group_filtering=group_filtering)
    from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
        DeviceCorpus,
    )

    dc = DeviceCorpus.from_numpy(tplan, corpus.feats, corpus.row_valid,
                                 corpus.row_deleted, corpus.row_group, CPU)
    tq = {p: {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                  else a) for k, a in t.items()}
          for p, t in qfeats.items()}
    single = [x.numpy() for x in tcorp(
        tq, *dc.device_arrays(), torch.from_numpy(qgroup),
        torch.from_numpy(rows), min_logit)]
    for got, exp in zip((top_logit, top_index, count), single):
        np.testing.assert_array_equal(got, exp)


def test_group_filtering_and_self_exclusion_by_global_row():
    """Queries ARE corpus rows (query i is row 6 i, spread over every
    shard): the sharded scorer never returns a query's own global row nor
    a row of its own group, though each shard numbers its rows locally."""
    jindex, tplan, qfeats, rows, qgroup, min_logit = _inputs(True)
    group = jindex.corpus.row_group
    for d in (3, 8):
        top_logit, top_index, _ = _port_results(
            jindex, tplan, qfeats, rows, qgroup, min_logit, True, d)
        assert (top_index >= 0).any()
        for qi, row in enumerate(rows):
            live = top_index[qi][top_logit[qi] > JS.NEG_INF / 2]
            assert row not in live
            for r in live:
                assert group[r] != qgroup[qi]
        # shard-local rows are never leaked: every row is a global id
        assert top_index.max() < jindex.corpus.size


def test_merge_topk_on_hand_made_ties():
    """Equal logits across shards: shard 0's entry wins, then shard 1's
    (the JAX merge's layout and ``lax.top_k``'s position tie-break), and
    the empty (-1, NEG_INF) slots stay last."""
    mesh = TP.Mesh([CPU] * 3)
    neg = TS.NEG_INF
    logits = [torch.tensor([[2.0, 1.0, neg, neg], [0.5, neg, neg, neg]]),
              torch.tensor([[2.0, 1.0, 1.0, neg], [0.5, 0.5, neg, neg]]),
              torch.tensor([[3.0, 2.0, neg, neg], [neg, neg, neg, neg]])]
    index = [torch.tensor([[0, 1, -1, -1], [2, -1, -1, -1]],
                          dtype=torch.int32),
             torch.tensor([[10, 11, 12, -1], [13, 14, -1, -1]],
                          dtype=torch.int32),
             torch.tensor([[20, 21, -1, -1], [-1, -1, -1, -1]],
                          dtype=torch.int32)]
    out_logit, out_index, merged = TP.merge_topk(mesh, logits, index, 4)
    assert out_index.tolist() == [[20, 0, 10, 21], [2, 13, 14, -1]]
    f32neg = float(np.float32(neg))
    assert out_logit.tolist() == [[3.0, 2.0, 2.0, 2.0],
                                  [0.5, 0.5, 0.5, f32neg]]
    assert merged.shape == (2, 12)
    # the JAX merge on the same inputs
    from sesam_duke_microservice_tpu.parallel.sharded import merge_topk

    jm = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("shard",))
    jl, ji, _ = jax.jit(lambda a, b: merge_topk(jm, a, b, 4))(
        jnp.asarray(np.stack([t.numpy() for t in logits])),
        jnp.asarray(np.stack([t.numpy() for t in index])))
    np.testing.assert_array_equal(out_index.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(out_logit.numpy(), np.asarray(jl))
    counts = [torch.tensor([1, 2], dtype=torch.int32)] * 3
    assert TP.sum_counts(mesh, counts).tolist() == [3, 6]


def test_scan_topk_defaults_unchanged_and_offset_init():
    """``row_offset`` and ``init`` at their defaults give exactly the old
    results; an offset shifts the rows, a carried init resumes a scan."""
    jindex, tplan, qfeats, rows, qgroup, min_logit = _inputs(False)
    corpus = jindex.corpus
    from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
        DeviceCorpus,
    )

    dc = DeviceCorpus.from_numpy(tplan, corpus.feats, corpus.row_valid,
                                 corpus.row_deleted, corpus.row_group, CPU)
    cf, cv, cd, cg = dc.device_arrays()
    tq = {p: {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                  else a) for k, a in t.items()}
          for p, t in qfeats.items()}
    pl = TS.build_pair_logits(tplan)
    qg, qr = torch.from_numpy(qgroup), torch.from_numpy(rows)
    kw = dict(chunk=CHUNK, top_k=TOP_K, group_filtering=False)
    full = TS.scan_topk(pl, tq, cf, cv, cd, cg, qg, qr, min_logit, **kw)
    same = TS.scan_topk(pl, tq, cf, cv, cd, cg, qg, qr, min_logit,
                        row_offset=0, init=None, **kw)
    for a, b in zip(full, same):
        assert torch.equal(a, b)
    half = cv.shape[0] // 2
    first = TS.scan_topk(pl, tq, {p: {k: a[:half] for k, a in t.items()}
                                  for p, t in cf.items()},
                         cv[:half], cd[:half], cg[:half], qg, qr, min_logit,
                         **kw)
    resumed = TS.scan_topk(pl, tq, {p: {k: a[half:] for k, a in t.items()}
                                    for p, t in cf.items()},
                           cv[half:], cd[half:], cg[half:], qg, qr,
                           min_logit, row_offset=half, init=first, **kw)
    for a, b in zip(full, resumed):
        assert torch.equal(a, b)
