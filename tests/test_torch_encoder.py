"""The port's record encoder and embedding storage against the JAX package's.

``embed_values``, the batched ``embed_batch`` and ``RecordEncoder`` must
give the JAX numpy path's f32 embeddings bit for bit (unicode, non-BMP and lone-surrogate values, empty
records, field salting); the bf16 storage bits must be ``ml_dtypes``'
round-to-nearest-even bits; int8 quantization, reconstruction and both
cosine-error bounds must be equal.

Both packages' C++ bulk encoders (``_native_embed``, on by default) round
the L2 normalization differently from the numpy paths in the last f32
bits of some components, so a record-level comparison holds numpy to
numpy and C++ to C++ (``tests/test_torch_native.py`` bounds C++ against
numpy).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.core.config import parse_config as jparse
from sesam_duke_microservice_tpu.ops import encoder as JE
from sesam_duke_microservice_tpu.service.datasource import (
    IncrementalDataSource as JDS,
)
from sesam_duke_microservice_tpu_torch.core.config import (
    parse_config as tparse,
)
from sesam_duke_microservice_tpu_torch.ops import embedding as TH
from sesam_duke_microservice_tpu_torch.ops import encoder as TE
from sesam_duke_microservice_tpu_torch.service.datasource import (
    IncrementalDataSource as TDS,
)

VALUES = [
    [("name", "acme corporation"), ("city", "oslo")],
    [("name", "Ærlig Østby"), ("city", "tromsø")],
    [("name", "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 name 😀"), ("city", "東京")],
    [("name", "lone \ud800 surrogate")],
    [("name", "a")],
    [("name", "x" * 300), ("city", "y"), ("city", "oslo")],
    [("name", ""), ("city", "q")],    # an empty value: one zero-filled window
    [],
]


@pytest.mark.parametrize("dim", [64, 256])
@pytest.mark.parametrize("i", range(len(VALUES)))
def test_embed_values_bit_identical(i, dim):
    want = JE.embed_values(VALUES[i], dim)
    got = TE.embed_values(VALUES[i], dim)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dim", [64, 256])
def test_embed_batch_bit_identical(dim):
    """The batched encoder equals the JAX per-record numpy path row for
    row, empty records included."""
    want = np.stack([JE.embed_values(v, dim) for v in VALUES])
    got = TE.embed_batch(VALUES, dim)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not TE.embed_batch([[], []], dim).any()


def test_field_salting_and_empty_records():
    a = TE.embed_values([("name", "oslo")], 256)
    b = TE.embed_values([("city", "oslo")], 256)
    assert float(a @ b) < 0.99
    assert not TE.embed_values([], 64).any()
    for prop in ("name", "city", "ÆØÅ"):
        assert TE._salt(prop) == JE._salt(prop)


CONFIG = """
<DukeMicroService>
  <Deduplication name="people" link-database-type="in-memory">
    <duke>
      <schema>
        <threshold>0.8</threshold>
        <property><name>NAME</name>
          <comparator>levenshtein</comparator><low>0.3</low><high>0.9</high>
        </property>
        <property><name>CITY</name>
          <comparator>exact</comparator><low>0.3</low><high>0.95</high>
        </property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="city" property="CITY"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""


def _records(parse):
    sc = parse(CONFIG)
    wc = sc.deduplications["people"]
    rng = np.random.default_rng(3)
    names = ["ole hansen", "Åse Ødegård", "😀 smiley", "", "kari"]
    entities = [{"_id": f"r{i}", "name": names[i % len(names)],
                 "city": str(rng.integers(0, 5)) if i % 4 else ""}
                for i in range(40)]
    ds_cls = JDS if parse is jparse else TDS
    return wc.duke, ds_cls(wc.duke.data_sources[0]).records_for_batch(
        entities)


@pytest.mark.parametrize("int8", ["0", "1"])
def test_record_encoder_bit_identical(int8, monkeypatch):
    monkeypatch.setenv("DUKE_EMB_INT8", int8)
    monkeypatch.setattr(JE, "_native_embed", lambda: None)
    monkeypatch.setattr(TH, "_native_embed", lambda: None)
    _record_encoders_agree(int8)


@pytest.mark.parametrize("int8", ["0", "1"])
def test_record_encoder_native_bit_identical_to_jax_native(int8,
                                                           monkeypatch):
    monkeypatch.setenv("DUKE_EMB_INT8", int8)
    assert JE._native_embed() is not None and TH._native_embed() is not None
    _record_encoders_agree(int8)


def _record_encoders_agree(int8):
    jschema, jrecs = _records(jparse)
    tschema, trecs = _records(tparse)
    jenc = JE.RecordEncoder(jschema, 128)
    tenc = TE.RecordEncoder(tschema, 128)
    assert tenc.props == jenc.props
    assert tenc.storage == JE.storage_name()
    want = jenc.encode_batch(jrecs)
    got = tenc.encode_batch(trecs)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[8].any()  # an empty record embeds to zeros
    jt = jenc.corpus_tensors(jrecs)
    tt = tenc.corpus_tensors(trecs)
    assert sorted(tt) == sorted(jt)
    if int8 == "1":
        np.testing.assert_array_equal(tt[TE.ANN_TENSOR], jt[JE.ANN_TENSOR])
        np.testing.assert_array_equal(tt[TE.ANN_SCALE], jt[JE.ANN_SCALE])
    else:
        np.testing.assert_array_equal(
            tt[TE.ANN_TENSOR], jt[JE.ANN_TENSOR].view(np.uint16))
    np.testing.assert_array_equal(TE.dequantize_rows(tt),
                                  JE.dequantize_rows(jt))


def test_bf16_bits_equal_ml_dtypes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    bits = x.view(np.uint32)
    # exact halfway cases (round to even both ways), subnormals, extremes
    halfway = ((bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)).view(
        np.float32)
    edge = np.array([0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38, np.inf,
                     -np.inf, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,
                     np.float32(3.3961776e38)], dtype=np.float32)
    for arr in (x, halfway, edge):
        want = arr.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(TE.bf16_bits(arr), want)
        np.testing.assert_array_equal(
            TE.bf16_to_f32(want),
            arr.astype(ml_dtypes.bfloat16).astype(np.float32))
    # the upload's reinterpretation is torch's own bf16 rounding
    t = torch.from_numpy(TE.bf16_bits(x).view(np.int16)).view(torch.bfloat16)
    assert torch.equal(t, torch.from_numpy(x).to(torch.bfloat16))


def test_quantize_rows_equal():
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((50, 96)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[7] = 0.0   # an empty record keeps scale 0
    rows[8] *= 1e-30
    codes, scale = TE.quantize_rows(rows)
    jcodes, jscale = JE.quantize_rows(rows)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(scale, jscale)
    assert scale[7] == 0.0 and not codes[7].any()


@pytest.mark.parametrize("dim", [64, 256, 1024])
def test_int8_cosine_bounds_equal(dim):
    assert TE.int8_cosine_eps(dim) == JE.int8_cosine_eps(dim)
    rng = np.random.default_rng(dim)
    rows = rng.standard_normal((40, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    codes, scale = JE.quantize_rows(rows)
    jq = {JE.ANN_TENSOR: jnp.asarray(codes[:8]),
          JE.ANN_SCALE: jnp.asarray(scale[:8])}
    jc = {JE.ANN_TENSOR: jnp.asarray(codes), JE.ANN_SCALE: jnp.asarray(scale)}
    tq = {TE.ANN_TENSOR: torch.from_numpy(codes[:8]),
          TE.ANN_SCALE: torch.from_numpy(scale[:8])}
    tc = {TE.ANN_TENSOR: torch.from_numpy(codes),
          TE.ANN_SCALE: torch.from_numpy(scale)}
    want = np.asarray(JE.int8_cosine_eps_dynamic(jq, jc))
    got = TE.int8_cosine_eps_dynamic(tq, tc)
    assert got.dtype == torch.float32
    assert got.numpy().view(np.uint32) == want.view(np.uint32)
    # the int8 chunk scores: the exact integer dot, rescaled alike
    np.testing.assert_array_equal(
        TE.chunk_sims(tq, tc[TE.ANN_TENSOR], tc[TE.ANN_SCALE]).numpy(),
        np.asarray(JE.chunk_sims(jq, jc[JE.ANN_TENSOR], jc[JE.ANN_SCALE])))
