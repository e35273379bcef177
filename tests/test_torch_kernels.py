"""The port's Myers tile kernels against the JAX package's Pallas kernels.

On the CPU ``cuda_kernels.myers_distance_tiles`` runs its plain PyTorch
version; it must equal the Pallas kernel (interpret mode, as
tests/test_pallas.py runs it) exactly, at one-word and N-word widths, with
empty patterns, full-width strings, and Q/C that are multiples of no tile.
The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesam_duke_microservice_tpu.ops import pallas_kernels as pk
from sesam_duke_microservice_tpu.ops import scoring as jax_scoring
from sesam_duke_microservice_tpu.ops.features import CHARS
from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

SIM_TOL = jax_scoring._SIM_ERROR_BOUND[CHARS]


def _inputs(seed: int, q: int, c: int, l: int):
    """Small-alphabet chars (real matches), random lengths with the edge
    cases forced in: empty patterns/texts and full-width strings."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(97, 101, size=(q, l)).astype(np.int32)
    cc = rng.integers(97, 101, size=(c, l)).astype(np.int32)
    ql = rng.integers(0, l + 1, size=q).astype(np.int32)
    cl = rng.integers(0, l + 1, size=c).astype(np.int32)
    ql[:3] = [0, l, 1]
    cl[:3] = [l, 0, l]
    # a full-width pair of identical strings
    cc[2] = qc[1]
    for chars, lens in ((qc, ql), (cc, cl)):
        for i, n in enumerate(lens):
            chars[i, n:] = 0
    return qc, ql, cc, cl


def _jax_distances(qc, ql, cc, cl):
    return np.asarray(pk.myers_distance_tiles(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        interpret=True))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("l", [8, 24, 32, 64, 256])
def test_plain_myers_equals_pallas_kernel(l):
    qc, ql, cc, cl = _inputs(l, 11, 19, l)
    want = _jax_distances(qc, ql, cc, cl)
    got = ck.myers_distance_tiles(*_torch(qc, ql, cc, cl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", [32, 64])
def test_levenshtein_sim_tiles_matches_pallas_path(l):
    qc, ql, cc, cl = _inputs(100 + l, 9, 14, l)
    rng = np.random.default_rng(l)
    equal = rng.random((9, 14)) < 0.1
    want = np.asarray(pk.levenshtein_sim_tiles(
        jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(cc), jnp.asarray(cl),
        jnp.asarray(equal), interpret=True))
    got = ck.levenshtein_sim_tiles(
        *_torch(qc, ql, cc, cl), torch.from_numpy(equal)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL)


def test_kernel_words_cover_widths():
    assert [ck.kernel_words(l) for l in (1, 24, 32, 33, 64, 96, 128, 192,
                                          256)] == [1, 1, 1, 2, 2, 4, 4, 8, 8]


def test_wrapper_rejects_bad_operands():
    qc, ql, cc, cl = _torch(*_inputs(0, 4, 4, 8))
    wide = torch.zeros((4, 257), dtype=torch.int32)
    with pytest.raises(ValueError, match="L <= 256"):
        ck.myers_distance_tiles(wide, ql, wide, cl)
    with pytest.raises(TypeError, match="int32"):
        ck.myers_distance_tiles(qc.long(), ql, cc, cl)
    with pytest.raises(ValueError, match="contiguous"):
        ck.myers_distance_tiles(qc.t().contiguous().t(), ql, cc, cl)
    with pytest.raises(ValueError, match="width"):
        ck.myers_distance_tiles(qc, ql, cc[:, :4].contiguous(), cl)


def test_cpu_path_counts_no_launch():
    ck.reset_launch_counts()
    ck.myers_distance_tiles(*_torch(*_inputs(1, 3, 5, 32)))
    assert ck.LAUNCHES == {"myers_tile": 0, "myersN_tile": 0}
