"""Child of tests/test_torch_multihost.py: one rank of a two-process
``torch.distributed`` job (gloo) scoring on a global mesh of 4 CPU
shards, two of them its own.  Imports nothing of the JAX package.

    python tests/torch_multihost_mesh_child.py RANK COORDINATOR IN OUT

``IN`` is a pickle of ``{"plan": ..., "cases": {case: inputs}}`` (the
port's feature plan and each case's host arrays); for every case this
rank places its shards of the corpus, runs the sharded scorer (the merge:
one ``all_gather`` and one ``all_reduce``) and the ring scorer (the hops
cross the process boundary), gathers the ring's query-split outputs, and
writes all of it to ``OUT`` (npz) with the collective counts.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK, TOP_K = 16, 8


def main(rank: int, coordinator: str, in_path: str, out_path: str) -> int:
    import numpy as np
    import torch

    from sesam_duke_microservice_tpu_torch.parallel import multihost
    from sesam_duke_microservice_tpu_torch.parallel import ring as R
    from sesam_duke_microservice_tpu_torch.parallel import sharded as P

    with open(in_path, "rb") as f:
        spec = pickle.load(f)
    local = [torch.device("cpu")] * 2
    assert multihost.initialize(coordinator, 2, rank, devices=local)
    mesh = multihost.global_corpus_mesh(local)
    assert (mesh.size, mesh.local_size, mesh.shard_base) == (4, 2, 2 * rank)
    out = {"backend": np.array(mesh.backend)}
    for case, c in spec["cases"].items():
        plan, groups = spec["plan"][case], c["groups"]
        sf, sv, sd, sg = P.ShardedCorpus(mesh, chunk=CHUNK).place(
            c["feats"], c["valid"], c["deleted"], c["group"])
        tq = {p: {k: torch.from_numpy(a.astype(np.int32)
                                      if a.dtype == np.uint16 else a)
                  for k, a in t.items()} for p, t in c["qfeats"].items()}
        merged = P.build_sharded_scorer(
            plan, mesh, chunk=CHUNK, top_k=TOP_K, group_filtering=groups)(
            tq, sf, sv, sd, sg, torch.from_numpy(c["query_group"]),
            torch.from_numpy(c["query_row"]), c["min_logit"])
        rq, rg, rr = R.RingQueryPlacer(mesh).place(
            c["qfeats"], c["query_group"], c["query_row"])
        ring = R.build_ring_scorer(plan, mesh, chunk=CHUNK, top_k=TOP_K,
                                   group_filtering=groups)(
            rq, sf, sv, sd, sg, rg, rr, c["min_logit"])
        for i, name in enumerate(("top_logit", "top_index", "count")):
            out[f"{case}/merge/{name}"] = merged[i].numpy()
            out[f"{case}/ring/{name}"] = P.gather_shards(mesh, ring[i])
    out["collectives"] = np.array(
        [multihost.COLLECTIVES[k] for k in ("all_gather", "all_reduce",
                                            "ring_hop")])
    np.savez(out_path, **out)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]))
