"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version at odd sizes (Q, C and K multiples of no tile, every
width, empty strings and sets, garbage set padding; for the Myers tile,
Jaro-Winkler and gathered Myers kernels also every kind of wide UTF-16
alphabet in tests/wide_units.py, and length extremes for Jaro-Winkler;
for the intersection kernel also every id-set kind there; for the
segment-max kernel one to three tiles of 1024 and 2048 rows, 8 to 1024
bins a tile, partly filled and full query tiles, group filtering on and
off, masked bins and a duplicate cluster), the dd
rescorer on ``cuda`` against the same program on ``cpu``, the
``device`` and ``ann`` services on ``cuda`` against the same services on
``cpu``, and the one-pair shapes an explain call launches (the tile
kernels at Q = C = 1, the gathered Myers kernel at Q = 1 and K = 1 or the
live top width) with the mixed schema's ``device_breakdown`` on ``cuda``
against ``cpu``.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so on a machine without it run::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os
import time

import pytest
import torch

# small device-matcher shapes for runs without tests/conftest.py (which
# sets its own): the service test's CPU half runs the plain version
for _knob, _value in (("DEVICE_CHUNK", "512"),
                      ("DEVICE_QUERY_BUCKETS", "64,256"), ("DEVICE_TOP_K", "16")):
    os.environ.setdefault(_knob, _value)

from sesam_duke_microservice_tpu_torch.core.config import parse_config  # noqa: E402
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from sesam_duke_microservice_tpu_torch.service.app import DukeApp  # noqa: E402
from wide_units import (KINDS, SET_KINDS, set_kind_inputs,  # noqa: E402
                        wide_unit_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # decided at run time, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(q, c, l, seed, device):
    g = torch.Generator().manual_seed(seed)
    qc = torch.randint(97, 101, (q, l), generator=g, dtype=torch.int32)
    cc = torch.randint(97, 101, (c, l), generator=g, dtype=torch.int32)
    ql = torch.randint(0, l + 1, (q,), generator=g, dtype=torch.int32)
    cl = torch.randint(0, l + 1, (c,), generator=g, dtype=torch.int32)
    ql[:3] = torch.tensor([0, l, 1])
    cl[:3] = torch.tensor([l, 0, l])
    cc[2] = qc[1]
    pos = torch.arange(l)
    qc = torch.where(pos[None, :] < ql[:, None], qc, 0)
    cc = torch.where(pos[None, :] < cl[:, None], cc, 0)
    return [t.contiguous().to(device) for t in (qc, ql, cc, cl)]


@pytest.mark.parametrize("l", [1, 24, 32, 33, 64, 96, 128, 200, 256])
def test_kernel_equals_plain_version(l, cuda_device):
    qc, ql, cc, cl = _inputs(37, 300, l, l, cuda_device)
    ck.reset_launch_counts()
    got = ck.myers_distance_tiles(qc, ql, cc, cl)
    torch.cuda.synchronize()
    want = ck.myers_distance_tiles_reference(qc, ql, cc, cl)
    assert torch.equal(got, want)
    assert sum(ck.LAUNCHES.values()) == 1
    # the plain version on the CPU agrees as well
    cpu = ck.myers_distance_tiles(*(t.cpu() for t in (qc, ql, cc, cl)))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("kind", KINDS + ("all",))
@pytest.mark.parametrize("l", [24, 32, 64, 128, 200, 256])
def test_kernel_equals_plain_version_on_wide_units(l, kind, cuda_device):
    # the match table's side list, low-byte collisions, surrogates, U+0000
    # inside the length, > 32 distinct units, runs (tests/wide_units.py)
    qc, ql, cc, cl = [torch.from_numpy(a).to(cuda_device)
                      for a in wide_unit_inputs(kind, l, 37, 300, l)]
    ck.reset_launch_counts()
    got = ck.myers_distance_tiles(qc, ql, cc, cl)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.myers_distance_tiles_reference(qc, ql, cc, cl))
    assert sum(ck.LAUNCHES.values()) == 1


def _length_extremes(q, c, l, seed, device):
    """Three-letter rows whose lengths cycle through 0, 1, l - 1 and l
    (queries and corpus rows out of step, so l1 != l2 at the extremes)."""
    qc, ql, cc, cl = _inputs(q, c, l, seed, "cpu")
    ends = torch.tensor([0, 1, l - 1, l], dtype=torch.int32)
    ql = ends[torch.arange(q) % 4]
    cl = ends[(torch.arange(c) // 3) % 4]
    pos = torch.arange(l)
    qc = torch.where(pos[None, :] < ql[:, None], qc, 0)
    cc = torch.where(pos[None, :] < cl[:, None], cc, 0)
    return [t.contiguous().to(device) for t in (qc, ql, cc, cl)]


# the small alphabet at every width; every wide UTF-16 alphabet of
# tests/wide_units.py (the match table's side list, shared low bytes,
# surrogates, U+0000 inside the length, runs) at 24 and 32; lengths 0, 1,
# 31 and 32 against each other
@pytest.mark.parametrize(
    "l,kind",
    [(l, "abcd") for l in (1, 2, 7, 16, 24, 31, 32)]
    + [(l, kind) for kind in KINDS + ("all",) for l in (24, 32)]
    + [(32, "extremes")],
    ids=[str(l) for l in (1, 2, 7, 16, 24, 31, 32)]
    + [f"{kind}-{l}" for kind in KINDS + ("all",) for l in (24, 32)]
    + ["extremes-32"])
def test_jw_kernel_equals_plain_version(l, kind, cuda_device):
    if kind == "abcd":
        qc, ql, cc, cl = _inputs(45, 301, l, 100 + l, cuda_device)
    elif kind == "extremes":
        qc, ql, cc, cl = _length_extremes(45, 301, l, 100 + l, cuda_device)
    else:
        qc, ql, cc, cl = [torch.from_numpy(a).to(cuda_device)
                          for a in wide_unit_inputs(kind, l, 45, 301, l)]
    cc[5, :2] = qc[5, :2]                 # shared prefixes: the boost
    equal = torch.zeros((45, 301), dtype=torch.bool, device=cuda_device)
    equal[3, 7] = True
    kw = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
    ck.reset_launch_counts()
    got = ck.jaro_winkler_sim_tiles(qc, ql, cc, cl, equal, **kw)
    torch.cuda.synchronize()
    want = ck.jaro_winkler_sim_tiles_reference(qc, ql, cc, cl, equal, **kw)
    # separate IEEE operations in both, in the same order: bit for bit
    assert torch.equal(got, want)
    assert ck.LAUNCHES["jw_tile"] == 1
    cpu = ck.jaro_winkler_sim_tiles(*(t.cpu() for t in (qc, ql, cc, cl,
                                                        equal)), **kw)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("l,k", [(1, 3), (8, 37), (24, 64), (32, 129),
                                 (32, 64), (32, 130)])
def test_gathered_myers_kernel_equals_plain_version(l, k, cuda_device):
    qc, ql, pool, pool_len = _inputs(19, 77, l, 200 + l, cuda_device)
    g = torch.Generator().manual_seed(l)
    rows = torch.randint(0, 77, (19, k), generator=g).to(cuda_device)
    cc = pool[rows].contiguous()
    cl = pool_len[rows].contiguous()
    ck.reset_launch_counts()
    got = ck.myers_distance_gathered(qc, ql, cc, cl)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.myers_distance_gathered_reference(
        qc, ql, cc, cl))
    assert ck.LAUNCHES["myers_gathered"] == 1


@pytest.mark.parametrize("kind", KINDS + ("all",))
@pytest.mark.parametrize("l,k", [(24, 64), (32, 64), (32, 130)])
def test_gathered_myers_kernel_equals_plain_version_on_wide_units(
        l, k, kind, cuda_device):
    # the match table's side list, shared low bytes, surrogates, U+0000
    # inside the length, runs (tests/wide_units.py); every query meets an
    # empty and a full-width text, and query 0 has an empty pattern
    qc, ql, pool, pool_len = [torch.from_numpy(a).to(cuda_device) for a in
                              wide_unit_inputs(kind, 300 + l, 21, 77, l)]
    g = torch.Generator().manual_seed(k)
    rows = torch.randint(0, 77, (21, k), generator=g)
    rows[:, :2] = torch.tensor([1, 0])
    rows = rows.to(cuda_device)
    cc = pool[rows].contiguous()
    cl = pool_len[rows].contiguous()
    ck.reset_launch_counts()
    got = ck.myers_distance_gathered(qc, ql, cc, cl)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.myers_distance_gathered_reference(
        qc, ql, cc, cl))
    assert ck.LAUNCHES["myers_gathered"] == 1


def _sets(q, g, seed, device, garbage):
    gen = torch.Generator().manual_seed(seed)
    n = torch.randint(0, g + 1, (q,), generator=gen, dtype=torch.int32)
    n[:2] = torch.tensor([0, g])
    ids = torch.full((q, g), 2**31 - 1, dtype=torch.int32)
    for i in range(q):
        row = torch.randperm(4 * g, generator=gen)[: int(n[i])] - 2 * g
        ids[i, : int(n[i])] = torch.sort(row).values.to(torch.int32)
        if garbage:
            ids[i, int(n[i]):] = torch.randint(
                -2 * g, 2 * g, (g - int(n[i]),), generator=gen,
                dtype=torch.int32)
    return ids.to(device), n.to(device)


# small-range sorted sets, then every id-set kind of tests/wide_units.py
# at each width (the hash tables' edge cases: full-range hashed ids, ids
# sharing their low 10 bits, SET_PAD / 0x80000000 / 0 / -1 inside n, full
# rows, identical rows at every size, ids sharing one home slot -- windows
# past the unrolled 1 to 4 slots), over several blocks of queries and rows
@pytest.mark.parametrize("g,garbage,kind", [
    pytest.param(16, False, None, id="16-False"),
    pytest.param(64, False, None, id="64-False"),
    pytest.param(64, True, None, id="64-True"),
    pytest.param(256, False, None, id="256-False"),
    pytest.param(37, True, None, id="37-True"),
] + [pytest.param(g, False, kind, id=f"{kind}-{g}") for kind in SET_KINDS
     for g in (16, 64, 256)])
def test_intersection_kernel_equals_plain_version(g, garbage, kind,
                                                  cuda_device):
    if kind is not None:
        qg, qn = set_kind_inputs(kind, g, 70, g)
        cg, cn = set_kind_inputs(kind, g + 1, 300, g, copies_of=(
            (qg, qn) if kind == "identical" else None))
        qg, qn, cg, cn = (torch.from_numpy(a).to(cuda_device)
                          for a in (qg, qn, cg, cn))
    else:
        qg, qn = _sets(23, g, g, cuda_device, garbage)
        cg, cn = _sets(141, g, g + 1, cuda_device, garbage)
    cg[4], cn[4] = qg[1], qn[1]
    ck.reset_launch_counts()
    got = ck.set_intersection_tiles(qg, qn, cg, cn)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.set_intersection_tiles_reference(qg, qn,
                                                                cg, cn))
    assert int(got[1, 4]) == g
    assert ck.LAUNCHES["intersect_tile"] == 1


# -- one-pair shapes: the explain replay's launches ----------------------------
# ``POST /explain`` runs the per-property logits and the dd replay for ONE
# pair, so on the card the tile kernels launch at Q = C = 1 and the
# gathered Myers kernel at Q = 1, K = 1 (the dd replay) or K = the live
# top width (the ``ann`` explain's one-query rescore).  Each must equal its
# plain version there, bit for bit, with exactly one launch.

@pytest.mark.parametrize("l", [1, 24, 32, 64, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_myers_tile_kernel_at_one_pair(l, seed, cuda_device):
    qc, ql, cc, cl = (t[i:i + 1].contiguous() for t, i in zip(
        _inputs(4, 4, l, 900 + seed, cuda_device), (seed, seed, 0, 0)))
    ck.reset_launch_counts()
    got = ck.myers_distance_tiles(qc, ql, cc, cl)
    torch.cuda.synchronize()
    assert got.shape == (1, 1)
    assert torch.equal(got, ck.myers_distance_tiles_reference(qc, ql, cc,
                                                              cl))
    assert sum(ck.LAUNCHES.values()) == 1


@pytest.mark.parametrize("l", [1, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jw_kernel_at_one_pair(l, seed, cuda_device):
    qc, ql, cc, cl = (t[i:i + 1].contiguous() for t, i in zip(
        _inputs(4, 4, l, 910 + seed, cuda_device), (seed, seed, 1, 1)))
    cc[0, :1] = qc[0, :1]
    equal = torch.zeros((1, 1), dtype=torch.bool, device=cuda_device)
    kw = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
    ck.reset_launch_counts()
    got = ck.jaro_winkler_sim_tiles(qc, ql, cc, cl, equal, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.jaro_winkler_sim_tiles_reference(
        qc, ql, cc, cl, equal, **kw))
    assert ck.LAUNCHES["jw_tile"] == 1


@pytest.mark.parametrize("l,k", [(1, 1), (24, 1), (32, 1), (24, 64),
                                 (32, 64), (32, 128)])
def test_gathered_myers_kernel_at_one_query(l, k, cuda_device):
    # _inputs needs three rows a side for its fixed lengths: cut one query
    qc, ql, pool, pool_len = _inputs(4, 9, l, 920 + l + k, cuda_device)
    qc, ql = qc[1:2].contiguous(), ql[1:2].contiguous()
    g = torch.Generator().manual_seed(k)
    rows = torch.randint(0, 9, (1, k), generator=g).to(cuda_device)
    cc = pool[rows].contiguous()
    cl = pool_len[rows].contiguous()
    ck.reset_launch_counts()
    got = ck.myers_distance_gathered(qc, ql, cc, cl)
    torch.cuda.synchronize()
    assert got.shape == (1, k)
    assert torch.equal(got, ck.myers_distance_gathered_reference(
        qc, ql, cc, cl))
    assert ck.LAUNCHES["myers_gathered"] == 1


@pytest.mark.parametrize("g", [1, 16, 24, 64, 256])
@pytest.mark.parametrize("same", [False, True])
def test_intersection_kernel_at_one_pair(g, same, cuda_device):
    # _sets pins its first two rows' counts (0 and g): cut row 1, a full set
    qg, qn = (t[1:2].contiguous()
              for t in _sets(3, g, 930 + g, cuda_device, False))
    cg, cn = (t[2:3].contiguous()
              for t in _sets(3, g, 931 + g, cuda_device, True))
    if same:
        cg, cn = qg.clone(), qn.clone()
    ck.reset_launch_counts()
    got = ck.set_intersection_tiles(qg, qn, cg, cn)
    torch.cuda.synchronize()
    assert got.shape == (1, 1)
    assert torch.equal(got, ck.set_intersection_tiles_reference(qg, qn,
                                                                cg, cn))
    if same:
        assert int(got[0, 0]) == int(qn[0])
    assert ck.LAUNCHES["intersect_tile"] == 1


def test_explain_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """The mixed schema's ``device_breakdown`` on the card (the hand
    kernels at one-pair shapes, the gathered Myers kernel at K = 1 in the
    dd replay) against the same call on a CPU index (the plain versions):
    per-property f32 logits within ``certified_f32_margin``, the same
    band verdict and ``decided_path``, and the kernels launched."""
    from sesam_duke_microservice_tpu_torch.engine import explain as X
    from sesam_duke_microservice_tpu_torch.engine.workload import (
        build_workload,
    )
    from sesam_duke_microservice_tpu_torch.ops import bounds as B

    props = [("name", "levenshtein", 0.3, 0.9),
             ("given", "jaro-winkler", 0.35, 0.88),
             ("address", "qgram", 0.3, 0.85),
             ("employer", "jaccard", 0.4, 0.7),
             ("ssn", "exact", 0.3, 0.95),
             ("person", "person-name", 0.4, 0.8)]
    body = "".join(
        f"<property><name>{p.upper()}</name><comparator>{c}</comparator>"
        f"<low>{lo}</low><high>{hi}</high></property>"
        for p, c, lo, hi in props)
    cols = "".join(f'<column name="{p}" property="{p.upper()}"/>'
                   for p, _, _, _ in props)
    xml = ('<DukeMicroService><Deduplication name="m" '
           'link-database-type="in-memory"><duke><schema>'
           "<threshold>0.8</threshold><maybe-threshold>0.6</maybe-threshold>"
           f"{body}</schema><data-source class=\"io.sesam.dukemicroservice."
           'IncrementalDeduplicationDataSource"><param name="dataset-id" '
           f'value="crm"/>{cols}</data-source></duke></Deduplication>'
           "</DukeMicroService>")
    ents = [{"_id": str(i), "name": n, "given": gv, "address": a,
             "employer": e, "ssn": str(i % 3), "person": pn}
            for i, (n, gv, a, e, pn) in enumerate([
                ("acme corp", "ole", "kirkeveien 5", "acme oslo",
                 "ole olsen"),
                ("acme corporation", "ola", "kirkeveien 50", "acme oslo",
                 "ola olsen"),
                ("globex", "kari", "tollbugata 1", "globex oslo",
                 "kari nordmann"),
                ("globex inc", "karin", "tollbugata 11", "globex oslo",
                 "k nordmann")])]
    sc = parse_config(xml)
    out = []
    for device in ("cpu", cuda_device):
        wl = build_workload(sc.deduplications["m"], sc, device=device,
                            persistent=False)
        try:
            with wl.lock:
                wl.process_batch("crm", ents)
            r1, r2 = (wl.index.find_record_by_id(f"crm__{i}")
                      for i in (0, 1))
            ck.reset_launch_counts()
            out.append(X.device_breakdown(wl.index, r1, r2))
            launches = dict(ck.LAUNCHES)
            margin = B.certified_f32_margin(wl.index.plan)
        finally:
            wl.close()
    cpu, gpu = out
    for a, b in zip(cpu["per_property"], gpu["per_property"]):
        assert abs(a["logit"] - b["logit"]) <= margin, a["name"]
    for key in ("band_verdict", "decided_path", "dd_unsafe"):
        assert gpu.get(key) == cpu.get(key), key
    for name in ("myers_tile", "jw_tile", "intersect_tile"):
        assert launches[name] >= 1, (name, launches)
    if "dd_logit" in gpu:
        assert launches["myers_gathered"] >= 1, launches


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    qc, ql, cc, cl = _inputs(4, 4, 8, 0, cuda_device)
    with pytest.raises(TypeError, match="int32"):
        ck.myers_distance_tiles(qc.long(), ql, cc, cl)
    with pytest.raises(ValueError, match="share a device"):
        ck.myers_distance_tiles(qc, ql.cpu(), cc, cl)
    empty = ck.myers_distance_tiles(qc[:0], ql[:0], cc, cl)
    assert empty.shape == (0, 4)


CONFIG = """
<DukeMicroService>
  <Deduplication name="people" link-database-type="in-memory">
    <duke>
      <schema>
        <threshold>0.8</threshold>
        <maybe-threshold>0.6</maybe-threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.9</high>
        </property>
        <property><name>SSN</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="ssn" property="SSN"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""


MIXED = """
<DukeMicroService>
  <Deduplication name="mixed" link-database-type="in-memory">
    <duke>
      <schema>
        <threshold>0.8</threshold>
        <maybe-threshold>0.6</maybe-threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.9</high>
        </property>
        <property><name>GIVEN</name>
          <comparator>jaro-winkler</comparator><low>0.35</low><high>0.88</high>
        </property>
        <property><name>ADDRESS</name>
          <comparator>qgram</comparator><low>0.3</low><high>0.85</high>
        </property>
        <property><name>PERSON</name>
          <comparator>person-name</comparator><low>0.4</low><high>0.8</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="given" property="GIVEN"/>
        <column name="address" property="ADDRESS"/>
        <column name="person" property="PERSON"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""


def test_mixed_service_on_cuda_matches_cpu_and_certifies(cuda_device):
    """A JW / q-gram / host-only schema: the scan kernels and the dd
    program's gathered Myers kernel all launch, the feed equals the CPU
    run's, and both certify the same pairs on the dd path."""
    g = torch.Generator().manual_seed(9)
    words = ["ole", "ola", "kari", "hansen", "olsen", "gate", "vei"]

    def pick(n):
        return " ".join(words[int(k)] for k in
                        torch.randint(0, len(words), (n,), generator=g))

    batch = [{"_id": f"m{i}", "name": pick(2), "given": pick(1),
              "address": pick(2), "person": pick(2)} for i in range(300)]
    feeds, certified = [], []
    for device in (cuda_device, "cpu"):
        app = DukeApp(parse_config(MIXED), device=device, persistent=False)
        wl = app.deduplications["mixed"]
        ck.reset_launch_counts()
        with wl.lock:
            wl.process_batch("crm", batch)
            rows = wl.links_since(0)
        if device != "cpu":
            assert all(ck.LAUNCHES[k] > 0 for k in
                       ("myers_tile", "jw_tile", "intersect_tile",
                        "myers_gathered"))
        for r in rows:
            r.pop("_updated")
        feeds.append(json.dumps(rows))
        certified.append(wl.processor.stats.pairs_device_certified)
        app.close()
    assert feeds[0] == feeds[1]
    assert certified[0] == certified[1] > 0


def test_pass_device_time_from_cuda_events(cuda_device):
    """The mixed schema's passes on the card: the CUDA-event time of the
    scan and dd programs lands in ``device_seconds`` and in the cost
    ledger's device ledger, inside the scoring loop's host intervals (a
    lookahead block's scan runs while the host finalizes the block
    before it, so the bound counts finalize too); on the CPU the same
    passes read 0."""
    from sesam_duke_microservice_tpu_torch.telemetry import costs

    g = torch.Generator().manual_seed(11)
    words = ["ole", "ola", "kari", "hansen", "olsen", "gate", "vei"]

    def pick(n):
        return " ".join(words[int(k)] for k in
                        torch.randint(0, len(words), (n,), generator=g))

    batches = [[{"_id": f"e{b}_{i}", "name": pick(2), "given": pick(1),
                 "address": pick(2), "person": pick(2)} for i in range(300)]
               for b in range(2)]
    for device in (cuda_device, "cpu"):
        app = DukeApp(parse_config(MIXED), device=device, persistent=False)
        wl = app.deduplications["mixed"]
        ledger0 = costs.device_seconds_total()
        for batch in batches:
            with wl.lock:
                wl.process_batch("crm", batch)
        st = wl.processor.stats
        assert st.h2d_bytes > 0 and st.dd_blocks > 0
        if device == "cpu":
            assert st.device_seconds == 0.0
        else:
            assert st.device_seconds > 0
            # the programs' events lie inside the scoring loop, whose
            # intervals follow one another
            assert st.device_seconds <= 1.01 * (
                st.dispatch_seconds + st.wait_seconds + st.dd_seconds
                + st.finalize_seconds) + 1e-3
            if costs.enabled():
                assert costs.device_seconds_total() - ledger0 == \
                    pytest.approx(st.device_seconds)
        app.close()


def test_escalated_lookahead_device_time_within_the_wall(cuda_device,
                                                         monkeypatch):
    """A width escalation re-runs a block's scan behind the next block's
    lookahead scan; the re-run is timed from an event of its own, so the
    lookahead's device time is not counted twice and the pass's
    ``device_seconds`` stays within its wall."""
    from sesam_duke_microservice_tpu_torch.engine import device_matcher as DM

    monkeypatch.setattr(DM, "_INITIAL_TOP_K", 1)
    app = DukeApp(parse_config(MIXED), device=cuda_device, persistent=False)
    wl = app.deduplications["mixed"]
    names = ["ole hansen", "ola hansen", "kari olsen", "kari olssen"]
    # 300 records a pass: several query blocks, the second and later
    # dispatched as lookaheads
    batch = [{"_id": f"x{i}", "name": names[i % 4], "given": "ole",
              "address": "gate 1", "person": names[(i + 1) % 4]}
             for i in range(600)]
    with wl.lock:
        wl.process_batch("crm", batch[:300])
    escalations0 = sum(DM.ESCALATIONS.values())
    st = wl.processor.stats
    device0 = st.device_seconds
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with wl.lock:
        wl.process_batch("crm", batch[300:])
    wall = time.monotonic() - t0
    assert sum(DM.ESCALATIONS.values()) > escalations0
    device = st.device_seconds - device0
    assert 0 < device <= wall, (device, wall)
    app.close()


def test_service_on_cuda_matches_service_on_cpu(cuda_device, monkeypatch):
    # char widths grow with the data: the last batch's long names take
    # the multi-word kernel
    monkeypatch.delenv("DEVICE_MAX_CHARS", raising=False)
    g = torch.Generator().manual_seed(5)
    words = ["ole", "kari", "hansen", "olsen", "nordre", "gate", "vest"]
    batches = []
    for b in range(3):
        batch = []
        for i in range(200):
            n = int(torch.randint(2, 8 if b < 2 else 18, (1,), generator=g))
            name = " ".join(words[int(k)] for k in
                            torch.randint(0, len(words), (n,), generator=g))
            batch.append({"_id": f"{b}_{i}", "name": name,
                          "ssn": str(int(torch.randint(0, 40, (1,),
                                                       generator=g)))})
        batches.append(batch)
    feeds = []
    for device in (cuda_device, "cpu"):
        app = DukeApp(parse_config(CONFIG), device=device, persistent=False)
        wl = app.deduplications["people"]
        for batch in batches:
            with wl.lock:
                wl.process_batch("crm", batch)
        with wl.lock:
            rows = wl.links_since(0)
        for r in rows:
            r.pop("_updated")
        feeds.append(json.dumps(rows))
        assert wl.index.plan.device_props[0].chars > 32
        app.close()
    assert feeds[0] == feeds[1]
    assert len(json.loads(feeds[0])) > 10


# -- the ann backend's segment-max kernel ----------------------------------------


def _segmax_problem(q, n, d, seed, device, *, cluster=False):
    """Unit rows in bf16 with tombstones, invalid rows, two groups, self
    rows and (``cluster``) 24 identical adjacent rows every query hits."""
    g = torch.Generator().manual_seed(seed)
    corpus = torch.randn((n, d), generator=g)
    corpus = corpus / corpus.norm(dim=1, keepdim=True)
    queries = torch.randn((q, d), generator=g)
    queries = queries / queries.norm(dim=1, keepdim=True)
    if cluster:
        corpus[100:124] = corpus[100]
        queries[:] = corpus[100]
    valid = torch.rand((n,), generator=g) > 0.05
    deleted = torch.rand((n,), generator=g) < 0.05
    group = torch.randint(1, 3, (n,), generator=g, dtype=torch.int32)
    qgroup = torch.randint(1, 3, (q,), generator=g, dtype=torch.int32)
    qrow = torch.where(torch.rand((q,), generator=g) < 0.5,
                       torch.randint(0, n, (q,), generator=g),
                       -1).to(torch.int32)
    return [t.contiguous().to(device) for t in (
        queries.to(torch.bfloat16), corpus.to(torch.bfloat16), valid,
        deleted, group, qrow, qgroup)]


# bins = tc / seg of 8, 16, 128 and 1024 (the kernel's narrow and wide
# bin layouts), tc 1024 and 2048, query tiles of 128 partly filled (Q 1,
# 19, 33, 77, 130, 200) and full (2048), a corpus of exactly one tile, D
# 128 to 1024 (from 640 on, the query tile streams through the ring beside
# 128-row corpus slabs; beside 64-row slabs it stays resident at 640), and
# group filtering on and off
@pytest.mark.parametrize("q,tc,tiles,seg,d,gf", [
    (77, 1024, 2, 64, 256, False), (130, 1024, 3, 64, 256, True),
    (33, 1024, 2, 8, 128, True), (200, 1024, 3, 8, 256, False),
    (19, 1024, 2, 1, 128, False), (64, 1024, 3, 1, 256, True),
    (1, 1024, 1, 128, 256, False), (2048, 1024, 2, 64, 256, True),
    (130, 2048, 2, 256, 256, False), (77, 2048, 1, 16, 128, True),
    (130, 2048, 2, 2, 256, True), (2048, 2048, 1, 128, 256, False),
    (77, 1024, 2, 64, 512, True), (77, 1024, 2, 64, 640, True),
    (130, 2048, 2, 2, 640, False), (200, 1024, 2, 8, 1024, False),
    (2048, 1024, 1, 128, 1024, True),
])
def test_segmax_kernel_equals_plain_version(q, tc, tiles, seg, d, gf,
                                            cuda_device):
    args = _segmax_problem(q, tiles * tc, d, q + seg, cuda_device)
    args[2][:tc:tc // seg] = False        # bin 0's rows: all masked
    kw = dict(tc=tc, seg=seg, group_filtering=gf)
    ck.reset_launch_counts()
    got_max, got_arg = ck.retrieval_segmax(*args, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["retrieval_segmax"] == 1
    want = ck.retrieval_segmax_reference(*args, runner_up=True, **kw)
    err, bad = ck.segmax_disagreement(got_max, got_arg, *want, d)
    assert err <= ck.segmax_tolerance(d) and bad == 0, (err, bad)
    # the all-masked bin reports NEG and its smallest row
    assert bool((got_max[:, 0] == ck.SEGMAX_NEG).all())
    assert bool((got_arg[:, 0] == 0).all())
    # the plain version on the CPU holds the same bar
    cpu = ck.retrieval_segmax(*(t.cpu() for t in args), **kw)
    err, bad = ck.segmax_disagreement(*(t.to(cuda_device) for t in cpu),
                                      *want, d)
    assert err <= ck.segmax_tolerance(d) and bad == 0, (err, bad)


@pytest.mark.parametrize("seg", [8, 64])
def test_segmax_kernel_resolves_duplicate_clusters_alike(seg, cuda_device):
    args = _segmax_problem(70, 2048, 128, seg, cuda_device, cluster=True)
    args[2][:] = True
    args[3][:] = False
    args[5][:] = -1
    kw = dict(tc=1024, seg=seg, group_filtering=False)
    got_max, got_arg = ck.retrieval_segmax(*args, **kw)
    want = ck.retrieval_segmax_reference(*args, runner_up=True, **kw)
    err, bad = ck.segmax_disagreement(got_max, got_arg, *want, 128)
    assert err <= ck.segmax_tolerance(128) and bad == 0, (err, bad)
    in_cluster = (want[1] >= 100) & (want[1] < 124)
    assert bool((in_cluster.sum(dim=1) == min(24, 1024 // seg)).all())
    # identical rows score bit-identically: ties go to the smallest row
    assert torch.equal(got_arg[in_cluster], want[1][in_cluster])


def test_segmax_kernel_rejects_what_it_cannot_take(cuda_device):
    args = _segmax_problem(8, 1024, 128, 0, cuda_device)
    kw = dict(tc=1024, seg=8, group_filtering=False)
    with pytest.raises(TypeError, match="bf16"):
        ck.retrieval_segmax(args[0].float(), *args[1:], **kw)
    with pytest.raises(ValueError, match="seg"):
        ck.retrieval_segmax(*args, tc=1000, seg=8, group_filtering=False)
    # shapes the plain version takes but the kernel does not: raised before
    # any launch
    ck.reset_launch_counts()
    with pytest.raises(ValueError, match="tc / seg >= 8"):
        ck.retrieval_segmax(*args, tc=1024, seg=256, group_filtering=False)
    assert ck.LAUNCHES["retrieval_segmax"] == 0


def test_ann_service_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """One ann POST on the card and on the CPU: the fused route launches
    the segment-max kernel and the feeds are equal."""
    for knob, value in (("DEVICE_INITIAL_CAPACITY", "2048"),
                        ("DEVICE_ANN_SEG", "8"),
                        ("DEVICE_ANN_RECALL_TARGET", "0.8"),
                        ("DEVICE_ANN_CANDIDATES", "16")):
        monkeypatch.setenv(knob, value)
    g = torch.Generator().manual_seed(11)
    words = ["ole", "kari", "hansen", "olsen", "nordre", "gate", "vest"]
    batch = [{"_id": f"a{i}",
              "name": " ".join(words[int(k)] for k in torch.randint(
                  0, len(words), (3,), generator=g)),
              "ssn": str(int(torch.randint(0, 40, (1,), generator=g)))}
             for i in range(250)]
    feeds = []
    for device in (cuda_device, "cpu"):
        app = DukeApp(parse_config(CONFIG), backend="ann", device=device,
                     persistent=False)
        wl = app.deduplications["people"]
        ck.reset_launch_counts()
        with wl.lock:
            wl.process_batch("crm", batch)
            rows = wl.links_since(0)
        if device != "cpu":
            assert ck.LAUNCHES["retrieval_segmax"] > 0
            assert ck.LAUNCHES["myers_gathered"] > 0
        for r in rows:
            r.pop("_updated")
        feeds.append(json.dumps(rows))
        app.close()
    assert feeds[0] == feeds[1]
    assert len(json.loads(feeds[0])) > 10


# -- IVF and the arena on the card ---------------------------------------------


def _unit_rows(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    return (x / x.norm(dim=1, keepdim=True)).numpy()


def test_kmeans_on_cuda_is_deterministic(cuda_device):
    """Two trainings on the card give equal centroids bit for bit (the
    per-cell sums are a one-hot product, not float atomics), within 1e-6
    of the CPU's."""
    import numpy as np

    from sesam_duke_microservice_tpu_torch.ops import ivf as IVF

    x = _unit_rows(70000, 256, 3)  # two row steps of the trainer
    first = IVF.train_kmeans(x, 256, seed=1234, iters=4, device=cuda_device)
    second = IVF.train_kmeans(x, 256, seed=1234, iters=4,
                              device=cuda_device)
    assert np.array_equal(first, second)
    cpu = IVF.train_kmeans(x, 256, seed=1234, iters=4)
    assert np.abs(first - cpu).max() <= 1e-6


def _ivf_problem(device, int8):
    import numpy as np

    from sesam_duke_microservice_tpu_torch.ops import encoder as E
    from sesam_duke_microservice_tpu_torch.ops import ivf as IVF

    n, d = 6000, 256
    x = _unit_rows(n, d, 5)
    x[4000:4100] = x[4000]                     # a duplicate cluster
    if int8:
        codes, scale = E.quantize_rows(x)
        tree = {E.ANN_TENSOR: torch.from_numpy(codes),
                E.ANN_SCALE: torch.from_numpy(scale)}
    else:
        bits = E.bf16_bits(x).view(np.int16)
        tree = {E.ANN_TENSOR: torch.from_numpy(bits).view(torch.bfloat16)}
    cents = IVF.train_kmeans(x, 64, seed=7, iters=3)
    assign = np.argmax(x @ cents.T, axis=1)
    bucket = int(np.bincount(assign, minlength=64).max())
    cells = np.full((64, bucket), -1, dtype=np.int64)
    for k in range(64):
        rows = np.flatnonzero(assign == k)
        cells[k, :rows.size] = rows
    g = torch.Generator().manual_seed(9)
    valid = torch.rand(n, generator=g) > 0.05
    deleted = torch.rand(n, generator=g) < 0.05
    group = torch.randint(1, 3, (n,), generator=g, dtype=torch.int32)
    qrow = torch.arange(0, n, 7, dtype=torch.int32)
    qgroup = torch.randint(1, 3, qrow.shape, generator=g, dtype=torch.int32)
    args = [{k: v.to(device) for k, v in tree.items()},
            torch.from_numpy(cents).to(device),
            torch.from_numpy(cells).to(device)]
    args += [t.to(device) for t in (valid, deleted, group, qgroup, qrow)]
    return args


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("gf", [False, True])
def test_ivf_probe_on_cuda_matches_cpu(int8, gf, cuda_device):
    """The probe on the card against its CPU run on the same state: equal
    index sets (bit for bit under int8; under bf16 scores within
    ``4 D 2^-24`` and rows equal wherever neighbouring kept scores differ
    by more)."""
    from sesam_duke_microservice_tpu_torch.ops import ivf as IVF

    outs = []
    for device in (cuda_device, torch.device("cpu")):
        tree, cents, cells, valid, deleted, group, qgroup, qrow = \
            _ivf_problem(device, int8)
        q_tree = {k: v.index_select(0, qrow.long()) for k, v in tree.items()}
        sims, idx = IVF.ivf_probe_topc(
            q_tree, tree, cents, cells, valid, deleted, group, qgroup, qrow,
            top_c=32, nprobe=6, slot_chunk=256, group_filtering=gf)
        outs.append((sims.cpu(), idx.cpu()))
    (gs, gi), (ws, wi) = outs
    if int8:
        assert torch.equal(gs, ws) and torch.equal(gi, wi)
        return
    tol = ck.segmax_tolerance(256)
    assert float((gs - ws).abs().max()) <= tol
    gap = (ws[:, 1:] - ws[:, :-1]).abs()
    ok = (gap == 0) | (gap > tol)
    decided = torch.ones_like(wi, dtype=torch.bool)
    decided[:, 1:] &= ok
    decided[:, :-1] &= ok
    assert torch.equal(gi[decided], wi[decided])
    assert float(decided.float().mean()) > 0.9


def test_spill_lowers_memory_allocated(cuda_device, monkeypatch):
    """An arena spill drops every reference to the corpus tensors: the
    caching allocator's ``memory_allocated`` falls by at least the
    spilled bytes, and the next query faults the corpus back in."""
    from sesam_duke_microservice_tpu_torch.ops.arena import ARENA

    monkeypatch.setenv("DEVICE_INITIAL_CAPACITY", "65536")
    app = DukeApp(parse_config(CONFIG), device=cuda_device,
                  persistent=False)
    try:
        wl = app.deduplications["people"]
        batch = [{"_id": f"a{i}", "name": f"ole hansen {i}",
                  "ssn": str(i % 50)} for i in range(300)]
        with wl.lock:
            wl.process_batch("crm", batch)
        corpus = wl.index.corpus
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        freed = corpus.spill_device()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(cuda_device)
        assert freed == corpus._device_nbytes() > 0
        assert before - after >= freed
        ARENA.forget(corpus)
        with wl.lock:
            wl.process_batch("crm", batch[:10])
        assert torch.cuda.memory_allocated(cuda_device) - after >= freed
    finally:
        app.close()


# -- the single-process mesh: four logical shards on one card ------------------


def _cuda_names(n, seed):
    g = torch.Generator().manual_seed(seed)
    words = ["ole", "kari", "hansen", "olsen", "nordre", "gate", "vest"]
    out = []
    for i in range(n):
        k = int(torch.randint(1, 4, (1,), generator=g))
        out.append({"_id": f"s{seed}_{i}", "name": " ".join(
            words[int(j)] for j in torch.randint(0, len(words), (k,),
                                                 generator=g)),
            "ssn": str(int(torch.randint(0, 30, (1,), generator=g)))})
    return out


@pytest.mark.parametrize("gf", [False, True])
def test_sharded_scorer_on_four_shards_of_one_card_matches_one_device(
        gf, cuda_device):
    """The sharded scorer on ``[cuda:0] * 4`` (the Myers kernel launched
    per shard at the local shape) equals the single-device scorer on the
    same corpus: top-K rows and counts exactly, logits bit for bit."""
    import numpy as np

    from sesam_duke_microservice_tpu_torch.engine.device_matcher import (
        _CHUNK,
        DeviceCorpus,
    )
    from sesam_duke_microservice_tpu_torch.ops import scoring as S
    from sesam_duke_microservice_tpu_torch.parallel import sharded as P

    app = DukeApp(parse_config(CONFIG), device=cuda_device,
                  persistent=False)
    try:
        wl = app.deduplications["people"]
        with wl.lock:
            wl.process_batch("crm", _cuda_names(3000, 1))
        index = wl.index
        corpus = index.corpus
        n = corpus.size
        group = (np.arange(corpus.capacity, dtype=np.int32) % 2) + 1
        rows = np.arange(0, n, 7, dtype=np.int32)
        qgroup = group[rows] if gf else np.full(rows.size, -2, np.int32)
        mesh = P.Mesh([cuda_device] * 4)
        feats = {p: {k: a[:n] for k, a in t.items()}
                 for p, t in corpus.feats.items()}
        sf, sv, sd, sg = P.ShardedCorpus(mesh, chunk=_CHUNK).place(
            feats, corpus.row_valid[:n], corpus.row_deleted[:n], group[:n])
        single = DeviceCorpus.from_numpy(
            index.plan, feats, corpus.row_valid[:n], corpus.row_deleted[:n],
            group[:n], cuda_device)
        cf, cv, cd, cg = single.device_arrays()
        qf = S.gather_rows(cf, torch.from_numpy(rows).to(cuda_device).long())
        args = (torch.from_numpy(qgroup).to(cuda_device),
                torch.from_numpy(rows).to(cuda_device), np.float32(-2.0))
        ck.reset_launch_counts()
        got = P.build_sharded_scorer(index.plan, mesh, chunk=_CHUNK,
                                     top_k=16, group_filtering=gf)(
            qf, sf, sv, sd, sg, *args)
        assert ck.LAUNCHES["myers_tile"] >= 4
        want = S.build_corpus_scorer(index.plan, chunk=_CHUNK, top_k=16,
                                     group_filtering=gf)(
            qf, cf, cv, cd, cg, *args)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
        assert (got[2] > 0).any()
    finally:
        app.close()


def test_sharded_brute_service_on_cuda_matches_device_service(cuda_device):
    """``backend="sharded-brute"`` on four logical shards of the card: the
    feed equals the ``device`` app's, and the rematch leaves it as it
    was."""
    from sesam_duke_microservice_tpu_torch.engine import sharded_matcher
    from sesam_duke_microservice_tpu_torch.engine.rematch import ring_rematch

    sharded_matcher.set_serving_devices([cuda_device] * 4)
    try:
        feeds = []
        for backend in ("sharded-brute", "device"):
            app = DukeApp(parse_config(CONFIG), backend=backend,
                          device=cuda_device, persistent=False)
            wl = app.deduplications["people"]
            for seed in (1, 2):
                with wl.lock:
                    wl.process_batch("crm", _cuda_names(600, seed))
            with wl.lock:
                rows = wl.links_since(0)
                if backend == "sharded-brute":
                    stats = ring_rematch(wl)
                    assert stats["devices"] == 4
                    assert wl.links_since(0) == rows
            feeds.append(json.dumps([{k: v for k, v in r.items()
                                      if k != "_updated"} for r in rows]))
            app.close()
        assert feeds[0] == feeds[1]
        assert len(json.loads(feeds[0])) > 10
    finally:
        sharded_matcher.set_serving_devices(None)
