"""The port's ring scorer against the JAX package's, at D = 8.

The JAX ring runs in a child interpreter with a timeout of its own
(tests/torch_ring_jax_child.py): in a process where certain service tests
ran before it, it aborts on its collectives, and an abort here would cost
the test run its worker.  The child writes its inputs and outputs; the
port's ``build_ring_scorer`` on ``[cpu] * 8`` scores the same inputs and
must give the JAX ring's index sets with ties in the same places (the
visit order is the JAX ring's), equal counts, and logits within
``certified_f32_margin``; rows strictly above each query's K-th score
equal the port's single-device scorer's, self-exclusion and group
filtering hold, and a query count the mesh does not divide pads cleanly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sesam_duke_microservice_tpu_torch.ops import bounds as TB
from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.ops import scoring as TS
from sesam_duke_microservice_tpu_torch.parallel import ring as TR
from sesam_duke_microservice_tpu_torch.parallel import sharded as TP

from test_torch_growth import DEDUP, PORT
from torch_jax_cache import jax_cache_off  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK, TOP_K = 16, 8
CASES = {"two_chunks": False, "groups": True, "padding": False}


@pytest.fixture(scope="module")
def jax_ring(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring") / "jax_ring.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_ring_jax_child.py"),
             str(out)], env=env, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the JAX ring child ran past its timeout: {e}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _case(data, case):
    pre = case + "/"
    feats, qfeats = {}, {}
    for key, arr in data.items():
        if not key.startswith(pre):
            continue
        parts = key[len(pre):].split("/")
        if parts[0] in ("feat", "qfeat"):
            tree = feats if parts[0] == "feat" else qfeats
            tree.setdefault(parts[1], {})[parts[2]] = arr
    plan = TF.SchemaFeatures.plan(PORT.schema(DEDUP))
    for spec, (v, chars) in zip(plan.device_props, data[pre + "plan"]):
        spec.values_per_record = int(v)
        spec.max_chars = int(chars)
    return plan, feats, qfeats, {k: data[pre + k] for k in (
        "valid", "deleted", "group", "query_row", "query_group",
        "top_logit", "top_index", "count")}


def _tq(tree):
    return {p: {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                    else a) for k, a in t.items()}
            for p, t in tree.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_equals_jax_ring_ties_included(jax_ring, case):
    groups = CASES[case]
    plan, feats, qfeats, a = _case(jax_ring, case)
    mesh = TP.Mesh([torch.device("cpu")] * 8)
    sf, sv, sd, sg = TP.ShardedCorpus(mesh, chunk=CHUNK).place(
        feats, a["valid"], a["deleted"], a["group"])
    rq, rg, rr = TR.RingQueryPlacer(mesh).place(qfeats, a["query_group"],
                                                a["query_row"])
    ring = TR.build_ring_scorer(plan, mesh, chunk=CHUNK, top_k=TOP_K,
                                group_filtering=groups)
    tl, ti, cnt = ring(rq, sf, sv, sd, sg, rg, rr, np.float32(-5.0))
    # block s came home to shard s
    assert len(tl) == 8 and all(t.shape == tl[0].shape for t in tl)
    top_logit = torch.cat(tl).numpy()
    top_index = torch.cat(ti).numpy()
    count = torch.cat(cnt).numpy()
    np.testing.assert_array_equal(top_index, a["top_index"])
    np.testing.assert_array_equal(count, a["count"])
    np.testing.assert_allclose(top_logit, a["top_logit"], rtol=0,
                               atol=TB.certified_f32_margin(plan))
    nq = a["query_row"].shape[0]
    top_logit, top_index, count = top_logit[:nq], top_index[:nq], count[:nq]
    # against the port's single device over the same padded corpus
    cap = TP.ShardedCorpus(mesh, chunk=CHUNK).padded_capacity(
        a["valid"].shape[0])
    n = a["valid"].shape[0]

    def pad(arr, fill=0):
        out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:n] = arr
        return torch.from_numpy(out.astype(np.int32) if out.dtype == np.uint16
                                else out)

    single = TS.build_corpus_scorer(plan, chunk=CHUNK, top_k=TOP_K,
                                    group_filtering=groups)
    d_log, d_idx, d_cnt = (x.numpy() for x in single(
        _tq(qfeats), {p: {k: pad(v) for k, v in t.items()}
                      for p, t in feats.items()},
        pad(a["valid"], False), pad(a["deleted"], False), pad(a["group"], -1),
        torch.from_numpy(a["query_group"]), torch.from_numpy(a["query_row"]),
        np.float32(-5.0)))
    np.testing.assert_array_equal(count, d_cnt)
    np.testing.assert_array_equal(top_logit, d_log)
    for qi in range(nq):
        kth = d_log[qi, -1]
        assert ({int(r) for r, v in zip(d_idx[qi], d_log[qi]) if v > kth}
                == {int(r) for r, v in zip(top_index[qi], top_logit[qi])
                    if v > kth})
        live = top_index[qi][top_logit[qi] > TS.NEG_INF / 2]
        assert a["query_row"][qi] not in live
        if groups:
            for row in live:
                assert a["group"][row] != a["query_group"][qi]
    # ties sit inside the kept top-K, so the tie places are exercised
    kept = top_logit[top_logit > TS.NEG_INF / 2]
    assert len(np.unique(kept)) < len(kept)
