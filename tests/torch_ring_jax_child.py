"""Child of tests/test_torch_ring.py: the JAX package's ring scorer on its
8-device CPU mesh, run in an interpreter of its own.

    python tests/torch_ring_jax_child.py OUT.npz

Writes, per case of tests/test_ring.py (two chunks a shard; group
filtering; a query count the mesh does not divide), the inputs
(tests/test_parallel.py's ``build_inputs``) and the ring's outputs, plus
the feature plan's value slots and char widths.  The JAX ring aborts its
process when certain service tests ran earlier in it, which is why the
port's test does not run it in its own process.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402

CASES = {"two_chunks": (8 * 16 * 2, 16, False),
         "groups": (8 * 16, 16, True),
         "padding": (8 * 16, 11, False)}


def main(out_path: str) -> int:
    import jax
    import jax.numpy as jnp

    from sesam_duke_microservice_tpu.parallel import (
        RingQueryPlacer,
        ShardedCorpus,
        build_ring_scorer,
        corpus_mesh,
    )
    from test_parallel import CHUNK, TOP_K, build_inputs

    assert jax.device_count() == 8
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
        rq, rg, rr = RingQueryPlacer(mesh).place(qfeats, query_group,
                                                 query_row)
        ring = build_ring_scorer(plan, mesh, chunk=CHUNK, top_k=TOP_K,
                                 group_filtering=groups)
        tl, ti, cnt = ring(rq, sf, sv, sd, sg, rg, rr, jnp.float32(-5.0))
        for key, arr in (("valid", valid), ("deleted", deleted),
                         ("group", group), ("query_row", query_row),
                         ("query_group", query_group),
                         ("top_logit", np.asarray(tl)),
                         ("top_index", np.asarray(ti)),
                         ("count", np.asarray(cnt))):
            out[f"{case}/{key}"] = arr
        for tree, side in ((feats, "feat"), (qfeats, "qfeat")):
            for prop, tensors in tree.items():
                for name, arr in tensors.items():
                    out[f"{case}/{side}/{prop}/{name}"] = arr
        out[f"{case}/plan"] = np.array(
            [(s.values_per_record, s.chars) for s in plan.device_props])
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
