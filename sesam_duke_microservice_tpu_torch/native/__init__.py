"""ctypes bindings for the C++ host library (``duke_native.cpp``).

A copy of the JAX package's ``native/__init__.py`` with one change of
policy: the library is built with ``g++`` on first use into the package's
``_build/`` (named by a digest of the source, like the CUDA kernels of
``ops.cuda_kernels``), and a failed build or load RAISES while
``DUKE_TPU_NATIVE`` is on (the default).  ``DUKE_TPU_NATIVE=0`` is the one
way to run the pure-Python / numpy paths, which stay the parity oracle
(tests/test_torch_native.py).  The knob is read once per process, at the
first call.

Entry points: ``lev_sim``, ``jaro_winkler``, ``weighted_lev`` (scalar, the
comparators' per-pair dispatch, ``core.comparators``), their ``*_batch``
forms, ``fnv1a64_bytes_batch`` and ``gram_set_batch`` (``ops.features``)
and ``embed_batch`` (``ops.embedding``).  ctypes releases the GIL for the
duration of each foreign call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..env import env_flag
from ..telemetry import costs

_SRC = Path(__file__).resolve().parent / "duke_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CXX = "g++"
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_resolved = False
_error: Optional[RuntimeError] = None


def library_path() -> Path:
    """Where the build of the current source lives."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libduke_native-{tag}.so"


def build_library() -> Path:
    """Compile ``duke_native.cpp`` once per content of the source and
    return the library's path.  Safe against concurrent builds: it
    compiles to a private name and renames into place.  A build's wall
    time goes to the cost ledger as compile time
    (``costs.note_compile``)."""
    target = library_path()
    if target.exists():
        return target
    t0 = time.monotonic()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_CXX, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"building the C++ host library failed ({' '.join(cmd)}): {e}; "
            "set DUKE_TPU_NATIVE=0 to run the Python paths") from e
    if proc.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise RuntimeError(
            f"building the C++ host library failed ({' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stderr.strip()}\n"
            "set DUKE_TPU_NATIVE=0 to run the Python paths")
    os.replace(tmp, target)
    costs.note_compile(time.monotonic() - t0)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    dbl = ctypes.c_double
    lib.duke_lev_sim_batch.argtypes = [u32p, i64p, u32p, i64p, i64, f64p]
    lib.duke_lev_sim_batch.restype = None
    lib.duke_jaro_winkler_batch.argtypes = [
        u32p, i64p, u32p, i64p, i64, dbl, dbl, i64, f64p]
    lib.duke_jaro_winkler_batch.restype = None
    lib.duke_weighted_lev_batch.argtypes = [
        u32p, i64p, u32p, i64p, i64, dbl, dbl, dbl, f64p]
    lib.duke_weighted_lev_batch.restype = None
    lib.duke_lev_distance.argtypes = [u32p, i64, u32p, i64]
    lib.duke_lev_distance.restype = i64
    lib.duke_embed_batch.argtypes = [
        u32p, i64p, ctypes.POINTER(ctypes.c_uint64), i64p, i64, i64,
        ctypes.POINTER(ctypes.c_float)]
    lib.duke_embed_batch.restype = None
    lib.duke_fnv1a64_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64p, i64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.duke_fnv1a64_batch.restype = None
    lib.duke_gram_set_batch.argtypes = [u32p, i64p, i64, i64, i64, i32p,
                                        i32p]
    lib.duke_gram_set_batch.restype = None
    # the scalar entry points take the UTF-32 bytes object directly
    cc = ctypes.c_char_p
    lib.duke_lev_sim.argtypes = [cc, i64, cc, i64]
    lib.duke_lev_sim.restype = dbl
    lib.duke_jaro_winkler.argtypes = [cc, i64, cc, i64, dbl, dbl, i64]
    lib.duke_jaro_winkler.restype = dbl
    lib.duke_weighted_lev.argtypes = [cc, i64, cc, i64, dbl, dbl, dbl]
    lib.duke_weighted_lev.restype = dbl
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, or None when ``DUKE_TPU_NATIVE`` is off; raises
    (the same error on every call) when it cannot be built or loaded."""
    global _lib, _resolved, _error
    if _resolved:
        return _lib
    with _lock:
        if _error is not None:
            raise _error
        if not _resolved:
            if env_flag("DUKE_TPU_NATIVE", True):
                try:
                    path = build_library()
                    _lib = _bind(ctypes.CDLL(str(path)))
                except (OSError, RuntimeError) as e:
                    _error = (e if isinstance(e, RuntimeError) else
                              RuntimeError(f"loading the C++ host library "
                                           f"failed: {e}"))
                    raise _error from e
            _resolved = True
    return _lib


def available() -> bool:
    """True when the C++ paths are on (``DUKE_TPU_NATIVE``, default on)."""
    return _load() is not None


def reset() -> None:
    """Forget the resolution, so the next call reads the knob again
    (tests)."""
    global _lib, _resolved, _error
    with _lock:
        _lib, _resolved, _error = None, False, None


_U32P = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def _pack(strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """UTF-32 codepoint buffer + int64 offsets (len n+1)."""
    offsets = np.zeros(len(strings) + 1, dtype=np.int64)
    chunks = []
    total = 0
    for i, s in enumerate(strings):
        chunk = s.encode("utf-32-le", "surrogatepass")
        chunks.append(chunk)
        total += len(chunk) // 4
        offsets[i + 1] = total
    if total:
        buf = np.frombuffer(b"".join(chunks), dtype="<u4")
    else:
        buf = np.zeros(1, dtype=np.uint32)  # valid pointer for empty input
    return buf, offsets


def _ptrs(buf: np.ndarray, off: np.ndarray):
    return buf.ctypes.data_as(_U32P), off.ctypes.data_as(_I64P)


def fnv1a64_bytes_batch(bufs: Sequence[bytes]) -> np.ndarray:
    """Bulk FNV-1a64 over pre-encoded UTF-8 buffers -> (N,) uint64,
    bit-identical to ``ops.features.fnv1a64``."""
    lib = _load()
    assert lib is not None
    n = len(bufs)
    off = np.zeros(n + 1, dtype=np.int64)
    total = 0
    for i, b in enumerate(bufs):
        total += len(b)
        off[i + 1] = total
    buf = (np.frombuffer(b"".join(bufs), dtype=np.uint8) if total
           else np.zeros(1, dtype=np.uint8))
    out = np.empty((n,), dtype=np.uint64)
    lib.duke_fnv1a64_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        off.ctypes.data_as(_I64P), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def gram_set_batch(values: Sequence[str], q: int,
                   max_grams: int, set_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk q-gram set ids: ((N, max_grams) int32 sorted-distinct folded
    gram hashes padded with ``set_pad``, (N,) int32 counts), bit-identical
    to the Python path of ``ops.features`` (qgrams + hash + sorted(set))."""
    lib = _load()
    assert lib is not None
    buf, off = _pack(values)
    n = len(values)
    grams = np.full((n, max_grams), set_pad, dtype=np.int32)
    counts = np.zeros((n,), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.duke_gram_set_batch(
        *_ptrs(buf, off), n, q, max_grams,
        grams.ctypes.data_as(i32p), counts.ctypes.data_as(i32p),
    )
    return grams, counts


def lev_sim_batch(a: Sequence[str], b: Sequence[str]) -> np.ndarray:
    lib = _load()
    assert lib is not None and len(a) == len(b)
    abuf, aoff = _pack(a)
    bbuf, boff = _pack(b)
    out = np.empty(len(a), dtype=np.float64)
    lib.duke_lev_sim_batch(*_ptrs(abuf, aoff), *_ptrs(bbuf, boff),
                           len(a), out.ctypes.data_as(_F64P))
    return out


def jaro_winkler_batch(a: Sequence[str], b: Sequence[str], *,
                       prefix_scale: float = 0.1,
                       boost_threshold: float = 0.7,
                       max_prefix: int = 4) -> np.ndarray:
    lib = _load()
    assert lib is not None and len(a) == len(b)
    abuf, aoff = _pack(a)
    bbuf, boff = _pack(b)
    out = np.empty(len(a), dtype=np.float64)
    lib.duke_jaro_winkler_batch(*_ptrs(abuf, aoff), *_ptrs(bbuf, boff),
                                len(a), prefix_scale, boost_threshold,
                                max_prefix, out.ctypes.data_as(_F64P))
    return out


def weighted_lev_batch(a: Sequence[str], b: Sequence[str], *,
                       digit_weight: float = 2.0, letter_weight: float = 1.0,
                       other_weight: float = 1.0) -> np.ndarray:
    lib = _load()
    assert lib is not None and len(a) == len(b)
    abuf, aoff = _pack(a)
    bbuf, boff = _pack(b)
    out = np.empty(len(a), dtype=np.float64)
    lib.duke_weighted_lev_batch(*_ptrs(abuf, aoff), *_ptrs(bbuf, boff),
                                len(a), digit_weight, letter_weight,
                                other_weight, out.ctypes.data_as(_F64P))
    return out


def embed_batch(value_strings: Sequence[str], salts: np.ndarray,
                rec_off: np.ndarray, dim: int) -> np.ndarray:
    """Hashed-trigram record embeddings -> (n_rec, dim) f32, rows
    L2-normalized.  ``value_strings`` are the padded, lower-cased values of
    all records in order, ``salts`` their uint64 property salts,
    ``rec_off`` the int64 record -> value-range offsets (n_rec + 1).  The
    normalization rounds differently from the numpy path's in the last f32
    bits (``ops.embedding.NATIVE_EMBED_ATOL``)."""
    lib = _load()
    assert lib is not None
    buf, off = _pack(value_strings)
    salts = np.ascontiguousarray(salts, dtype=np.uint64)
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    n_rec = len(rec_off) - 1
    out = np.zeros((n_rec, dim), dtype=np.float32)
    lib.duke_embed_batch(
        *_ptrs(buf, off),
        salts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rec_off.ctypes.data_as(_I64P), n_rec, dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def lev_sim(a: str, b: str) -> float:
    lib = _load()
    return lib.duke_lev_sim(a.encode("utf-32-le", "surrogatepass"), len(a),
                            b.encode("utf-32-le", "surrogatepass"), len(b))


def jaro_winkler(a: str, b: str, prefix_scale: float = 0.1,
                 boost_threshold: float = 0.7, max_prefix: int = 4) -> float:
    lib = _load()
    return lib.duke_jaro_winkler(a.encode("utf-32-le", "surrogatepass"), len(a),
                                 b.encode("utf-32-le", "surrogatepass"), len(b),
                                 prefix_scale, boost_threshold, max_prefix)


def weighted_lev(a: str, b: str, digit_weight: float = 2.0,
                 letter_weight: float = 1.0,
                 other_weight: float = 1.0) -> float:
    lib = _load()
    return lib.duke_weighted_lev(a.encode("utf-32-le", "surrogatepass"), len(a),
                                 b.encode("utf-32-le", "surrogatepass"), len(b),
                                 digit_weight, letter_weight, other_weight)


def lev_distance(a: str, b: str) -> int:
    lib = _load()
    assert lib is not None
    abuf = (np.frombuffer(a.encode("utf-32-le", "surrogatepass"), dtype="<u4")
            if a else np.zeros(1, dtype=np.uint32))
    bbuf = (np.frombuffer(b.encode("utf-32-le", "surrogatepass"), dtype="<u4")
            if b else np.zeros(1, dtype=np.uint32))
    return int(lib.duke_lev_distance(
        abuf.ctypes.data_as(_U32P), len(a), bbuf.ctypes.data_as(_U32P), len(b)))
