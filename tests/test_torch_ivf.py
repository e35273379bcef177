"""The port's IVF cell-probe retrieval (``DUKE_IVF``) against the JAX
package's, on the CPU -- the cases of tests/test_ivf.py on both packages.

* ``train_kmeans`` on the same rows: centroids within 1e-6 (absolute) of
  the JAX package's, and the rows' nearest-centroid assignments equal
  wherever a row's best centroid leads its second by more than 1e-5; two
  trainings of the port equal bit for bit;
* with the JAX package's trained state carried across
  (``IvfState.load_arrays`` from its numpy fields): ``ivf_probe_topc``'s
  index sets equal -- bit for bit under int8 storage (an exact integer
  dot); under bf16 scores within ``4 D 2^-24`` and rows equal except
  where two kept scores sit within that of each other without an exact
  tie (their order is f32 rounding's, as tests/test_torch_ann.py holds
  the flat scan) -- and, with the JAX package's k-means behind the port's
  training, the ordered event tapes bit-identical;
* each package training its own index: the event tapes equal;
* saturation escalating to the flat fallback, group filtering, the
  streamed-append assignment, the refresh on doubling, recall against
  the flat scan and the brute-force oracle, the feature-cache
  fingerprint flip and the explain ``ivf`` block.

Both packages run their numpy encoders (see tests/test_torch_encoder.py)
and the flat scan route (``DUKE_TPU_PALLAS=0``, ``DEVICE_ANN_FUSED=0``).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.core.config import MatchTunables
from sesam_duke_microservice_tpu.engine import ann_matcher as JANN
from sesam_duke_microservice_tpu.engine import device_matcher as JDM
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.ops import feature_cache as JFC
from sesam_duke_microservice_tpu.ops import ivf as JIVF
from sesam_duke_microservice_tpu_torch.engine import ann_matcher as TANN
from sesam_duke_microservice_tpu_torch.engine import device_matcher as TDM
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
from sesam_duke_microservice_tpu_torch.ops import embedding as TH
from sesam_duke_microservice_tpu_torch.ops import encoder as TE
from sesam_duke_microservice_tpu_torch.ops import feature_cache as TFC
from sesam_duke_microservice_tpu_torch.ops import ivf as TIVF

from test_torch_ann import _assert_same_retrieval
from test_torch_growth import BOTH, DEDUP, JAX, PORT
from torch_jax_cache import jax_cache_off  # noqa: F401

_FIRST = ["ole", "kari", "per", "anne", "nils", "ingrid", "lars", "berit",
          "jan", "liv", "arne", "astrid", "knut", "solveig", "odd", "randi"]
_LAST = ["hansen", "johansen", "olsen", "larsen", "andersen", "pedersen",
         "nilsen", "kristiansen", "jensen", "karlsen", "johnsen",
         "pettersen"]
_NAMES = ["acme corp", "acme corporation", "globex", "globex inc",
          "initech", "initech llc", "umbrella", "umbrela",
          "stark industries", "stark ind", "wayne enterprises", "wayne ent",
          "hooli", "hooli xyz", "pied piper"]
_CITIES = ["oslo", "bergen", "trondheim", "stavanger", "tromso"]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    # both sides on their numpy encoders, which agree bit for bit
    monkeypatch.setattr(JE, "_native_embed", lambda: None)
    monkeypatch.setattr(TH, "_native_embed", lambda: None)
    for name, value in (("DUKE_TPU_PALLAS", "0"), ("DEVICE_ANN_FUSED", "0"),
                        ("DUKE_FEATURE_CACHE_MB", "0")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("DUKE_EMB_INT8", raising=False)


@pytest.fixture
def ivf_env(monkeypatch):
    """Small-corpus IVF geometry: train at once, few cells (the JAX
    package's tests/test_ivf.py fixture)."""
    for name, value in (("DUKE_IVF", "1"), ("DUKE_IVF_MIN_ROWS", "16"),
                        ("DUKE_IVF_CELLS", "8"), ("DUKE_IVF_NPROBE", "3"),
                        ("DUKE_IVF_SCAN_SLOTS", "64")):
        monkeypatch.setenv(name, value)


def random_records(n, seed, pkg, with_group=False, prefix="r"):
    """tests/test_device_matcher.py's ``random_records`` in ``pkg``."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        base = rng.choice(_NAMES)
        if rng.random() < 0.4:
            pos = rng.randrange(len(base))
            base = base[:pos] + rng.choice("abcdefgh") + base[pos + 1:]
        out.append(pkg.record(
            f"{prefix}{i}", group=(1 + i % 2) if with_group else None,
            name=base, city=rng.choice(_CITIES),
            amount=str(rng.choice([100, 200, 200, 300, 1000]))))
    return out


def stress_records(identities, seed, pkg):
    """tests/test_ivf.py's ``stress_records`` in ``pkg``: each identity an
    exact row and a one-character typo of it."""
    rng = random.Random(seed)
    out = []
    for i in range(identities):
        name = (f"{rng.choice(_FIRST)} {rng.choice(_LAST)} "
                f"x{rng.randint(100, 999)}")
        city = rng.choice(["oslo", "bergen", "tromso", "stavanger"])
        amount = str(rng.choice([100, 200, 300, 1000]))
        out.append(pkg.record(f"a{i}", name=name, city=city, amount=amount))
        pos = rng.randrange(len(name))
        typo = name[:pos] + rng.choice("abcdefgh") + name[pos + 1:]
        out.append(pkg.record(f"b{i}", name=typo, city=city, amount=amount))
    return out


class Log:
    """Ordered events, confidences as exact floats."""

    def __init__(self):
        self.events = []

    def batch_ready(self, size):
        pass

    def batch_done(self):
        pass

    def start_processing(self):
        pass

    def end_processing(self):
        pass

    def matches(self, r1, r2, confidence):
        self.events.append(("match", r1.record_id, r2.record_id,
                            confidence.hex()))

    def matches_perhaps(self, r1, r2, confidence):
        self.events.append(("maybe", r1.record_id, r2.record_id,
                            confidence.hex()))

    def no_match_for(self, record):
        self.events.append(("none", record.record_id))

    def match_set(self):
        return {e for e in self.events if e[0] != "none"}

    def links(self):
        """Unordered matched pairs with confidence (the link store's
        view: either retrieval direction makes the link)."""
        return {(min(e[1], e[2]), max(e[1], e[2]), e[3])
                for e in self.events if e[0] == "match"}


def schema(pkg, threshold=0.8):
    return pkg.schema(DEDUP, threshold=threshold)


def run(pkg, batches, *, group_filtering=False, backend="ann",
        initial_top_c=None, threshold=0.8):
    """One package's ``ann`` (or brute-force ``device``) backend over
    ``batches``: (log, index)."""
    sch = schema(pkg, threshold)
    if backend == "device":
        index = pkg.index(sch)
        proc = pkg.DM.DeviceProcessor(sch, index,
                                      group_filtering=group_filtering)
    elif pkg is JAX:
        kw = {} if initial_top_c is None else {"initial_top_c":
                                               initial_top_c}
        index = JANN.AnnIndex(sch, tunables=MatchTunables(), **kw)
        proc = JANN.AnnProcessor(sch, index, group_filtering=group_filtering)
    else:
        index = TANN.AnnIndex(sch, device="cpu")
        if initial_top_c is not None:
            index.initial_top_c = initial_top_c
        proc = TANN.AnnProcessor(sch, index, group_filtering=group_filtering)
    log = Log()
    proc.add_match_listener(log)
    for batch in batches(pkg):
        proc.deduplicate(batch)
    return log, index


# -- k-means and the policies -------------------------------------------------


def _unit_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,k,iters", [(200, 64, 16, 6), (333, 32, 8, 8),
                                         (40, 16, 64, 3)])
def test_train_kmeans_matches_jax(n, d, k, iters):
    x = _unit_rows(n, d, seed=n + k)
    want = JIVF.train_kmeans(x, k, seed=42, iters=iters)
    got = TIVF.train_kmeans(x, k, seed=42, iters=iters)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # nearest centroids agree wherever the choice is not a near tie
    scores = x @ want.T
    top2 = np.sort(scores, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-5
    np.testing.assert_array_equal(np.argmax(x @ got.T, axis=1)[decided],
                                  np.argmax(scores, axis=1)[decided])
    if k <= n:  # past n the seeded init repeats rows: exact ties
        assert decided.mean() > 0.9
    # deterministic: a second training equals the first bit for bit
    np.testing.assert_array_equal(
        TIVF.train_kmeans(x, k, seed=42, iters=iters), got)
    norms = np.linalg.norm(got, axis=1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=1e-5)


@pytest.mark.parametrize("n", [0, 3, 16, 100, 4096, 131072, 10 ** 7])
def test_policies_equal_jax(n, monkeypatch):
    for cells, nprobe in ((None, None), ("8", "3"), ("1000", "50")):
        for name, value in (("DUKE_IVF_CELLS", cells),
                            ("DUKE_IVF_NPROBE", nprobe)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        k = TIVF.configured_cells(n)
        assert k == JIVF.configured_cells(n)
        assert TIVF.configured_nprobe(k) == JIVF.configured_nprobe(k)
    assert TIVF._slot_bucket(max(1, n % 300)) == JIVF._slot_bucket(
        max(1, n % 300))


# -- the probe on one trained state -------------------------------------------


def _jax_trained(monkeypatch, int8, n=200):
    """A JAX ``AnnIndex`` with IVF trained over ``n`` records."""
    monkeypatch.setenv("DUKE_EMB_INT8", "1" if int8 else "0")
    _, index = run(JAX, lambda pkg: [random_records(n, 23, pkg)])
    assert index.ivf is not None and index.ivf.ready
    return index


def _port_corpus(jindex):
    """The JAX corpus' host mirrors as a port ``DeviceCorpus`` (on the
    CPU) and a port ``IvfState`` carrying the JAX package's state."""
    corpus = jindex.corpus
    feats = {p: dict(t) for p, t in corpus.feats.items()}
    emb = feats[JE.ANN_PROP]
    if np.asarray(emb[JE.ANN_TENSOR]).dtype != np.int8:
        emb[JE.ANN_TENSOR] = np.asarray(emb[JE.ANN_TENSOR]).view(np.uint16)
    plan = TANN.AnnIndex(schema(PORT), device="cpu").plan
    tcorpus = TDM.DeviceCorpus.from_numpy(
        plan, feats, corpus.row_valid, corpus.row_deleted, corpus.row_group,
        "cpu")
    j = jindex.ivf
    state = TIVF.IvfState(device="cpu")
    state.load_arrays(j.centroids, j.cell_of, j.cell_rows, j.assigned_upto,
                      j.trained_rows, j.nprobe0, corpus=tcorpus)
    return tcorpus, state


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("gf", [False, True])
def test_probe_topc_with_carried_state_equals_jax(int8, gf, ivf_env,
                                                  monkeypatch):
    jindex = _jax_trained(monkeypatch, int8)
    tcorpus, state = _port_corpus(jindex)
    j = jindex.ivf
    n = jindex.corpus.size
    rows = np.arange(0, n, 3, dtype=np.int32)
    groups = (rows % 2 + 1).astype(np.int32)
    jf, jv, jd, jg = jindex.corpus.device_arrays()
    jtree = jf[JE.ANN_PROP]
    jq = {name: jnp.take(arr, jnp.asarray(rows), axis=0)
          for name, arr in jtree.items()}
    cents, cells = j.device_tensors()
    top_c, nprobe = 16, 3
    want = [np.asarray(a) for a in JIVF.ivf_probe_topc(
        jq, jtree, cents, cells, jv, jd, jg, jnp.asarray(groups),
        jnp.asarray(rows), top_c=top_c, nprobe=nprobe, slot_chunk=64,
        group_filtering=gf)]
    tf_, tv, td, tg = tcorpus.device_arrays()
    ttree = tf_[TE.ANN_PROP]
    tq = {name: arr.index_select(0, torch.from_numpy(rows).long())
          for name, arr in ttree.items()}
    tcents, tcells = state.device_tensors()
    got = [a.numpy() for a in TIVF.ivf_probe_topc(
        tq, ttree, tcents, tcells, tv, td, tg, torch.from_numpy(groups),
        torch.from_numpy(rows), top_c=top_c, nprobe=nprobe, slot_chunk=64,
        group_filtering=gf)]
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32
    if int8:  # the integer dot and its rescale are exact: bit for bit
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        _assert_same_retrieval(want, got, ck.segmax_tolerance(256))
    # the sentinel slots and the self-row / group exclusions hold
    assert not (got[1] == rows[:, None]).any()
    assert (got[1] >= 0).any()


def _carry_jax_kmeans(monkeypatch):
    """The port's training runs the JAX package's k-means on the same
    sample (the state carried across at every (re)training)."""
    monkeypatch.setattr(
        TIVF, "train_kmeans",
        lambda x, k, *, seed, iters, device: JIVF.train_kmeans(
            x, k, seed=seed, iters=iters))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tapes_with_carried_kmeans_bit_identical(int8, ivf_env, monkeypatch):
    monkeypatch.setenv("DUKE_EMB_INT8", "1" if int8 else "0")
    _carry_jax_kmeans(monkeypatch)

    def batches(pkg):
        return [random_records(120, 1, pkg),
                random_records(40, 2, pkg, prefix="s"),
                random_records(150, 3, pkg, prefix="t")]

    (jlog, jindex), (tlog, tindex) = (run(pkg, batches) for pkg in BOTH)
    assert tindex.ivf.ready and tindex.ivf.trained_rows == 310
    np.testing.assert_array_equal(tindex.ivf.centroids, jindex.ivf.centroids)
    n = tindex.corpus.size
    np.testing.assert_array_equal(tindex.ivf.cell_of[:n],
                                  jindex.ivf.cell_of[:n])
    np.testing.assert_array_equal(tindex.ivf.cell_rows, jindex.ivf.cell_rows)
    assert tlog.events == jlog.events
    assert tlog.match_set()


def test_tapes_with_own_training_equal_jax(ivf_env):
    def batches(pkg):
        return [random_records(200, 23, pkg)]

    (jlog, jindex), (tlog, tindex) = (run(pkg, batches) for pkg in BOTH)
    assert tindex.ivf.ready and jindex.ivf.ready
    assert tindex.ivf.ncells == jindex.ivf.ncells
    np.testing.assert_allclose(tindex.ivf.centroids, jindex.ivf.centroids,
                               rtol=0, atol=1e-6)
    assert tlog.events == jlog.events


# -- the cases of tests/test_ivf.py on the port --------------------------------


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("DUKE_IVF", raising=False)
    assert TANN.AnnIndex(schema(PORT), device="cpu").ivf is None


def test_stays_flat_below_min_rows(monkeypatch):
    monkeypatch.setenv("DUKE_IVF", "1")
    monkeypatch.setenv("DUKE_IVF_MIN_ROWS", "4096")

    def batches(pkg):
        return [random_records(30, 3, pkg)]

    ann, index = run(PORT, batches)
    assert index.ivf is not None and not index.ivf.ready
    device, _ = run(PORT, batches, backend="device")
    assert ann.match_set() == device.match_set()


def test_recall_vs_flat_scan_and_brute_force(ivf_env, monkeypatch):
    """Recall >= 0.99 of the flat scan's links and >= 0.98 of the
    brute-force oracle's on the stresstest shape, and every IVF event in
    the oracle with an equal confidence."""
    def batches(pkg):
        return [stress_records(200, 11, pkg)]

    oracle, _ = run(PORT, batches, backend="device")
    ivf, index = run(PORT, batches)
    assert index.ivf is not None and index.ivf.ready
    monkeypatch.setenv("DUKE_IVF", "0")
    flat, flat_index = run(PORT, batches)
    assert flat_index.ivf is None
    assert ivf.match_set() <= oracle.match_set()
    olinks, flinks, ilinks = oracle.links(), flat.links(), ivf.links()
    assert len(ilinks & flinks) / max(1, len(flinks)) >= 0.99
    assert len(ilinks & olinks) / max(1, len(olinks)) >= 0.98


def test_retrieved_pairs_subset_of_flat_scan(ivf_env, monkeypatch):
    def batches(pkg):
        return [random_records(200, 23, pkg)]

    ivf, index = run(PORT, batches)
    assert index.ivf.ready
    monkeypatch.setenv("DUKE_IVF", "0")
    flat, _ = run(PORT, batches)
    assert ivf.match_set() <= flat.match_set()


def test_int8_plus_ivf_match_oracle(ivf_env, monkeypatch):
    monkeypatch.setenv("DUKE_EMB_INT8", "1")
    monkeypatch.setenv("DUKE_IVF_NPROBE", "4")

    def batches(pkg):
        return [stress_records(150, 31, pkg)]

    oracle, _ = run(PORT, batches, backend="device")
    ivf, index = run(PORT, batches)
    assert index.emb_storage == "int8" and index.ivf.ready
    assert ivf.match_set() <= oracle.match_set()
    olinks = oracle.links()
    assert len(ivf.links() & olinks) / max(1, len(olinks)) >= 0.98


def test_saturation_escalates_to_flat_fallback(monkeypatch):
    """Tiny C and nprobe on an all-identical corpus: every probe
    saturates, the ladder widens nprobe past the cells and ends in the
    flat scan -- every pair surfaces, on both packages alike."""
    for name, value in (("DUKE_IVF", "1"), ("DUKE_IVF_MIN_ROWS", "8"),
                        ("DUKE_IVF_CELLS", "4"), ("DUKE_IVF_NPROBE", "1")):
        monkeypatch.setenv(name, value)

    def batches(pkg):
        return [[pkg.record(f"d{i}", name="acme corp", city="oslo",
                            amount="100") for i in range(24)]]

    esc = dict(TDM.ESCALATIONS)
    jesc = JDM.ESCALATIONS
    tlog, tindex = run(PORT, batches, initial_top_c=2, threshold=0.5)
    jlog, _ = run(JAX, batches, initial_top_c=2, threshold=0.5)
    assert tindex.ivf is not None and tindex.ivf.ready
    pairs = {(e[1], e[2]) for e in tlog.events if e[0] == "match"}
    assert len(pairs) == 24 * 23
    assert TDM.ESCALATIONS["ivf"] > esc["ivf"]
    assert JDM.ESCALATIONS > jesc
    assert tlog.events == jlog.events


def test_group_filtering_record_linkage(monkeypatch):
    for name, value in (("DUKE_IVF", "1"), ("DUKE_IVF_MIN_ROWS", "16"),
                        ("DUKE_IVF_CELLS", "4"), ("DUKE_IVF_NPROBE", "3")):
        monkeypatch.setenv(name, value)

    def batches(pkg):
        return [random_records(40, 11, pkg, with_group=True)]

    oracle, _ = run(PORT, batches, backend="device", group_filtering=True)
    ivf, index = run(PORT, batches, group_filtering=True)
    jlog, _ = run(JAX, batches, group_filtering=True)
    assert index.ivf is not None and index.ivf.ready
    found = ivf.match_set()
    assert found <= oracle.match_set()
    for _, id1, id2, _ in found:  # alternating groups: no same-group link
        assert int(id1[1:]) % 2 != int(id2[1:]) % 2
    assert len(found) >= 0.8 * len(oracle.match_set())
    assert ivf.events == jlog.events


def test_streaming_append_assignment_parity(ivf_env):
    """Per-slice assignment equals assigning every row in one pass under
    the same centroids, and the membership matrix lists exactly them."""
    def batches(pkg):
        second = random_records(12, 2, pkg, prefix="s")
        return [random_records(40, 1, pkg), second]

    _, index = run(PORT, batches)
    ivf = index.ivf
    n = index.corpus.size
    assert ivf.ready and ivf.assigned_upto == n
    assert ivf.trained_rows == 40  # 52 < 2 * 40: no retrain
    emb = TE.dequantize_rows({name: arr[:n] for name, arr in
                              index.corpus.feats[TE.ANN_PROP].items()})
    oracle = ivf._assign_rows(emb)
    np.testing.assert_array_equal(ivf.cell_of[:n], oracle)
    for k in range(ivf.ncells):
        listed = sorted(int(r) for r in ivf.cell_rows[k] if r >= 0)
        assert listed == sorted(np.flatnonzero(oracle == k).tolist())
    assert ivf.counts.sum() == n


def test_refresh_on_doubling(ivf_env):
    def batches(pkg):
        return [random_records(24, 5, pkg),
                random_records(40, 6, pkg, prefix="g")]

    _, index = run(PORT, batches)
    ivf = index.ivf
    assert ivf.ready
    assert ivf.trained_rows == index.corpus.size == ivf.assigned_upto


def _fingerprint(pkg, fc):
    sch = schema(pkg)
    if pkg is JAX:
        index = JANN.AnnIndex(sch, tunables=MatchTunables())
    else:
        index = TANN.AnnIndex(sch, device="cpu")
    return fc.plan_fingerprint(index.plan, index.encoder)


def test_fingerprint_flips_with_ivf_and_storage(monkeypatch):
    for pkg, fc in ((JAX, JFC), (PORT, TFC)):
        monkeypatch.setenv("DUKE_IVF", "0")
        base = _fingerprint(pkg, fc)
        monkeypatch.setenv("DUKE_IVF", "1")
        ivf = _fingerprint(pkg, fc)
        monkeypatch.setenv("DUKE_EMB_INT8", "1")
        int8 = _fingerprint(pkg, fc)
        monkeypatch.delenv("DUKE_EMB_INT8")
        monkeypatch.setenv("DUKE_IVF", "0")
        assert len({base, ivf, int8}) == 3, pkg.name
        assert _fingerprint(pkg, fc) == base


def test_explain_ivf_block_equals_jax(ivf_env, monkeypatch):
    _carry_jax_kmeans(monkeypatch)

    def batches(pkg):
        return [random_records(64, 13, pkg)]

    outs = []
    for pkg in BOTH:
        _, index = run(pkg, batches)
        records = batches(pkg)[0]
        assert index.ivf is not None and index.ivf.ready
        outs.append(index.explain_retrieval(records[0], records[1]))
    jout, tout = outs
    assert tout["ivf"] == jout["ivf"]
    assert tout["effective_top_c"] == jout["effective_top_c"]
    assert (tout["retrieved"], tout["rank"]) == (jout["retrieved"],
                                                 jout["rank"])
    ivf = tout["ivf"]
    assert len(ivf["probed_cells"]) == ivf["nprobe"]
    assert 0 <= ivf["candidate_cell"] < ivf["cells"]
    assert isinstance(ivf["cell_probed"], bool)
    monkeypatch.setenv("DUKE_IVF", "0")
    _, flat = run(PORT, batches)
    records = batches(PORT)[0]
    assert "ivf" not in flat.explain_retrieval(records[0], records[1])


def test_ledger_counts_the_ivf_membership(ivf_env):
    from sesam_duke_microservice_tpu_torch.engine.workload import (
        _hbm_components,
    )

    _, index = run(PORT, lambda pkg: [random_records(64, 13, pkg)])

    class _Wl:
        pass

    wl = _Wl()
    wl.index = index
    comps = _hbm_components(lambda: wl)
    ivf = index.ivf
    assert comps["ivf_membership"] == (
        ivf.centroids.nbytes + ivf.cell_of.nbytes + ivf.cell_rows.nbytes
        + ivf.counts.nbytes)
