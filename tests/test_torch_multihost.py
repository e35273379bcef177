"""The port's multi-process mesh against the JAX package's mesh.

Two OS processes join a ``torch.distributed`` job (gloo) through
``parallel.multihost.initialize`` and score on a global mesh of 4 CPU
shards, two a process (tests/torch_multihost_mesh_child.py): the sharded
scorer's merge gathers both processes' local top-Ks with one
``all_gather`` and sums the counts with one ``all_reduce``; the ring
scorer's hops cross the process boundary point to point.  The JAX
package's sharded and ring scorers run on its own 4-device CPU mesh in a
child interpreter (tests/torch_multihost_jax_child.py) on the same inputs
(tests/test_parallel.py's ``build_inputs``).

Tolerances: top-K index sets and counts equal the JAX mesh's, ties and
their order included; logits within the plan's ``certified_f32_margin``;
both ranks' results and the port's own single-process 4-shard mesh's equal
bit for bit.  Each child gets its own 90 s timeout.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sesam_duke_microservice_tpu_torch.ops import features as TF
from sesam_duke_microservice_tpu_torch.parallel import multihost as MH
from sesam_duke_microservice_tpu_torch.parallel import ring as TR
from sesam_duke_microservice_tpu_torch.parallel import sharded as TP

from test_torch_growth import DEDUP, PORT

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CPU = torch.device("cpu")
CHUNK, TOP_K = 16, 8
MIN_LOGIT = -5.0
CASES = ("padding", "groups")
CHILD_TIMEOUT_S = 90


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


# the cases of tests/torch_multihost_jax_child.py: corpus rows (2 scan
# chunks a shard at D = 4), queries (11: the mesh does not divide them),
# group filtering
CASE_SHAPES = {"padding": (4 * 16 * 2, 11, False),
               "groups": (4 * 16 * 2, 16, True)}


def port_inputs():
    """Each case's host inputs (tests/test_parallel.py's seeded
    ``build_inputs``, which the JAX child calls too) and the port's plan
    at the JAX plan's value slots and char widths."""
    from test_parallel import build_inputs

    spec = {"plan": {}, "cases": {}}
    for case, (n, nq, groups) in CASE_SHAPES.items():
        (jplan, feats, valid, deleted, group, qfeats, query_row,
         query_group) = build_inputs(n, nq)
        if groups:
            group = np.asarray([1 + (i % 2) for i in range(n)], np.int32)
            query_group = np.asarray([1 + (i % 2) for i in range(nq)],
                                     np.int32)
        plan = TF.SchemaFeatures.plan(PORT.schema(DEDUP))
        for spec_, jspec in zip(plan.device_props, jplan.device_props):
            spec_.values_per_record = jspec.values_per_record
            spec_.max_chars = jspec.chars
        spec["plan"][case] = plan
        spec["cases"][case] = dict(
            feats=feats, qfeats=qfeats, valid=valid, deleted=deleted,
            group=group, query_row=query_row, query_group=query_group,
            groups=groups, min_logit=MIN_LOGIT)
    return spec


def _spawn(script, *args):
    return subprocess.Popen([sys.executable, os.path.join(HERE, script),
                             *map(str, args)], env=child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)


def _wait(procs):
    """(returncode, stderr) of each child, each under its own timeout."""
    results = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            results.append((p.returncode, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return results


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh child and both ranks of the port's group, started
    together on the same inputs: (JAX outputs, [rank 0, rank 1], the
    port's spec).  The group retries once with a fresh coordinator port
    (another process may win the probed port before rank 0 binds it)."""
    out_dir = tmp_path_factory.mktemp("multihost")
    spec = port_inputs()
    spec_path = out_dir / "spec.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    jax_out = out_dir / "jax.npz"
    jax_child = _spawn("torch_multihost_jax_child.py", jax_out)
    try:
        for attempt in range(2):
            coordinator = f"127.0.0.1:{free_port()}"
            outs = [out_dir / f"rank{r}-{attempt}.npz" for r in (0, 1)]
            group = _wait([_spawn("torch_multihost_mesh_child.py", r,
                                  coordinator, spec_path, outs[r])
                           for r in (0, 1)])
            if all(rc == 0 for rc, _ in group):
                break
        (rc, err), = _wait([jax_child])
    finally:
        if jax_child.poll() is None:
            jax_child.kill()
            jax_child.communicate()
    assert rc == 0, err[-4000:]
    for rc, err in group:
        assert rc == 0, err[-4000:]
    return _load(jax_out), [_load(path) for path in outs], spec


def _jax_case(data, case):
    """The JAX child's inputs and outputs of ``case``, and its margin."""
    pre = case + "/"
    return ({k[len(pre):]: v for k, v in data.items()
             if k.startswith(pre)}, float(data[pre + "margin"]))


def _tq(tree):
    return {p: {k: torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                                    else a) for k, a in t.items()}
            for p, t in tree.items()}


def one_process(plan, c, kind):
    """The port's single-process 4-shard mesh on the same inputs."""
    mesh = TP.Mesh([CPU] * 4)
    sf, sv, sd, sg = TP.ShardedCorpus(mesh, chunk=CHUNK).place(
        c["feats"], c["valid"], c["deleted"], c["group"])
    if kind == "merge":
        out = TP.build_sharded_scorer(
            plan, mesh, chunk=CHUNK, top_k=TOP_K,
            group_filtering=c["groups"])(
            _tq(c["qfeats"]), sf, sv, sd, sg,
            torch.from_numpy(c["query_group"]),
            torch.from_numpy(c["query_row"]), MIN_LOGIT)
        return [x.numpy() for x in out]
    rq, rg, rr = TR.RingQueryPlacer(mesh).place(
        c["qfeats"], c["query_group"], c["query_row"])
    out = TR.build_ring_scorer(plan, mesh, chunk=CHUNK, top_k=TOP_K,
                               group_filtering=c["groups"])(
        rq, sf, sv, sd, sg, rg, rr, MIN_LOGIT)
    return [np.concatenate([t.numpy() for t in x]) for x in out]


def _survivor_pairs(rows, top_logit, top_index, nq):
    """The (query row, candidate row) pairs a rematch would finalize:
    above the bound, each unordered pair once."""
    pairs = set()
    for q in range(nq):
        for logit, c in zip(top_logit[q], top_index[q]):
            if logit > MIN_LOGIT and c >= 0 and c > rows[q]:
                pairs.add((int(rows[q]), int(c)))
    return pairs


@pytest.mark.parametrize("kind", ["merge", "ring"])
@pytest.mark.parametrize("case", CASES)
def test_two_processes_equal_jax_mesh_and_one_process(runs, case, kind):
    jax_data, (rank0, rank1), spec = runs
    jax_case, margin = _jax_case(jax_data, case)
    plan, inputs = spec["plan"][case], spec["cases"][case]
    # the JAX child scored the same seeded inputs
    for key in ("valid", "deleted", "group", "query_row", "query_group"):
        np.testing.assert_array_equal(jax_case[key], inputs[key])
    for side in ("feat", "qfeat"):
        for prop, tensors in inputs[side + "s"].items():
            for name, arr in tensors.items():
                np.testing.assert_array_equal(
                    jax_case[f"{side}/{prop}/{name}"], arr)
    names = ("top_logit", "top_index", "count")
    got = [rank0[f"{case}/{kind}/{n}"] for n in names]
    # every process gets the same result, bit for bit
    for n, a in zip(names, got):
        np.testing.assert_array_equal(rank1[f"{case}/{kind}/{n}"], a)
    want = [jax_case[f"{kind}/{n}"] for n in names]
    assert got[1].shape == want[1].shape
    np.testing.assert_array_equal(got[1], want[1])  # ties and their order
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=margin)
    # and the port's one-process mesh of 4, bit for bit
    for a, b in zip(got, one_process(plan, inputs, kind)):
        np.testing.assert_array_equal(a, b)
    if kind == "ring":
        nq = inputs["query_row"].shape[0]
        rows = inputs["query_row"]
        assert (_survivor_pairs(rows, got[0], got[1], nq)
                == _survivor_pairs(rows, want[0], want[1], nq))


def test_collectives_per_scoring_call_are_fixed(runs):
    """A merge is one all_gather and one all_reduce; a ring pass is one
    hop a global shard; a gathered ring output one all_gather."""
    hops = 4
    for rank in runs[1]:
        assert str(rank["backend"]) == "gloo"
        all_gather, all_reduce, ring_hop = rank["collectives"]
        assert all_reduce == len(CASES)
        assert all_gather == len(CASES) * (1 + 3)
        assert ring_hop == len(CASES) * hops


@pytest.mark.parametrize("layouts, backend", [
    ([{"types": ["cpu", "cpu"], "cards": []}] * 2, "gloo"),
    ([{"types": ["cuda"], "cards": ["GPU-a"]},
      {"types": ["cuda"], "cards": ["GPU-b"]}], "nccl"),
    ([{"types": ["cuda", "cuda"], "cards": ["GPU-a", "GPU-a"]},
      {"types": ["cuda", "cuda"], "cards": ["GPU-a", "GPU-a"]}], "gloo"),
    ([{"types": ["cuda"], "cards": ["GPU-a"]},
      {"types": ["cuda"], "cards": ["GPU-a"]},
      {"types": ["cuda"], "cards": ["GPU-b"]}], "gloo"),
])
def test_backend_follows_the_layout(layouts, backend):
    assert MH.choose_backend(layouts) == backend


def test_mixed_device_types_refuse():
    with pytest.raises(RuntimeError, match="one device type"):
        MH.choose_backend([{"types": ["cpu"], "cards": []},
                           {"types": ["cuda"], "cards": ["GPU-a"]}])


def test_initialize_without_coordinator_is_a_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert MH.initialize(devices=[CPU]) is False
    assert MH.job() is None
    assert (MH.process_count(), MH.process_index()) == (1, 0)
    mesh = MH.global_corpus_mesh([CPU] * 2)
    assert not mesh.spans_processes and mesh.size == 2


def test_a_ranks_view_of_the_global_mesh():
    """Rank 1 of two, two shards each: its shards are global shards 2
    and 3 -- their rows, their offsets -- and ``local()`` is a mesh of
    one process."""
    mesh = TP.Mesh([CPU] * 2, world=2, rank=1, backend="gloo")
    assert (mesh.size, mesh.local_size, mesh.shard_base) == (4, 2, 2)
    assert TP.shard_offsets(mesh, 16) == [32, 48]
    parts = TP.split(mesh, torch.arange(8))
    assert [p.tolist() for p in parts] == [[4, 5], [6, 7]]
    local = mesh.local()
    assert (local.size, local.shard_base, local.spans_processes) == (
        2, 0, False)
    with pytest.raises(ValueError, match="every shard"):
        TP.build_replicated_gather(mesh)
