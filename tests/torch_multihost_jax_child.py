"""Child of tests/test_torch_multihost.py: the JAX package's sharded
scorer and ring scorer on a 4-device CPU mesh, in an interpreter of its
own.

    python tests/torch_multihost_jax_child.py OUT.npz

Writes, per case (a query count the mesh does not divide; group
filtering), the inputs (tests/test_parallel.py's ``build_inputs``), the
feature plan's value slots and char widths, its ``certified_f32_margin``
and both scorers' outputs.  The JAX ring aborts its process when certain
service tests ran earlier in it, which is why it runs here.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402

# n corpus rows (2 scan chunks a shard at D = 4), queries, group filtering
CASES = {"padding": (4 * 16 * 2, 11, False),
         "groups": (4 * 16 * 2, 16, True)}
MIN_LOGIT = -5.0


def main(out_path: str) -> int:
    import jax
    import jax.numpy as jnp

    from sesam_duke_microservice_tpu.ops import scoring as S
    from sesam_duke_microservice_tpu.parallel import (
        RingQueryPlacer,
        ShardedCorpus,
        build_ring_scorer,
        build_sharded_scorer,
        corpus_mesh,
    )
    from test_parallel import CHUNK, TOP_K, build_inputs

    assert jax.device_count() == 4
    mesh = corpus_mesh()
    out = {}
    for case, (n, nq, groups) in CASES.items():
        (plan, feats, valid, deleted, group, qfeats, query_row,
         query_group) = build_inputs(n, nq)
        if groups:
            group = np.asarray([1 + (i % 2) for i in range(n)], np.int32)
            query_group = np.asarray([1 + (i % 2) for i in range(nq)],
                                     np.int32)
        sf, sv, sd, sg = ShardedCorpus(mesh, chunk=CHUNK).place(
            feats, valid, deleted, group)
        qf = {p: {k: jnp.asarray(a) for k, a in t.items()}
              for p, t in qfeats.items()}
        merged = build_sharded_scorer(plan, mesh, chunk=CHUNK, top_k=TOP_K,
                                      group_filtering=groups)(
            qf, sf, sv, sd, sg, jnp.asarray(query_group),
            jnp.asarray(query_row), jnp.float32(MIN_LOGIT))
        rq, rg, rr = RingQueryPlacer(mesh).place(qfeats, query_group,
                                                 query_row)
        ring = build_ring_scorer(plan, mesh, chunk=CHUNK, top_k=TOP_K,
                                 group_filtering=groups)(
            rq, sf, sv, sd, sg, rg, rr, jnp.float32(MIN_LOGIT))
        for key, arr in (("valid", valid), ("deleted", deleted),
                         ("group", group), ("query_row", query_row),
                         ("query_group", query_group),
                         ("merge/top_logit", merged[0]),
                         ("merge/top_index", merged[1]),
                         ("merge/count", merged[2]),
                         ("ring/top_logit", ring[0]),
                         ("ring/top_index", ring[1]),
                         ("ring/count", ring[2])):
            out[f"{case}/{key}"] = np.asarray(arr)
        for tree, side in ((feats, "feat"), (qfeats, "qfeat")):
            for prop, tensors in tree.items():
                for name, arr in tensors.items():
                    out[f"{case}/{side}/{prop}/{name}"] = arr
        out[f"{case}/plan"] = np.array(
            [(s.values_per_record, s.chars) for s in plan.device_props])
        out[f"{case}/margin"] = np.float64(S.certified_f32_margin(plan))
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
