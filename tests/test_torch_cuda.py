"""Card tests of the PyTorch port: the CUDA Myers kernel against its plain
PyTorch version, and the service on ``cuda`` against the service on ``cpu``.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so on a machine without it run::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os

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
        app = DukeApp(parse_config(CONFIG), device=device)
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
