"""Hand-written CUDA kernels for the pair-matrix hot op, and their wrappers.

Counterpart of the JAX package's ``ops/pallas_kernels.py`` for the two
kernels on the brute-force Levenshtein path:

  * ``_myers_tile_kernel`` (one uint32 word, patterns of at most 32 chars)
  * ``_myersN_tile_kernel`` (W = ceil(L/32) <= 8 words, carries through the
    add chain and the shifts)

both of which become one CUDA kernel templated on W in ``csrc/myers_tile.cu``.
It is compiled with ``nvcc`` for ``sm_90a`` on first use into ``_build/``
(beside this package's sources) and bound through ``ctypes``.

``myers_distance_tiles`` launches it for CUDA tensors and runs
``myers_distance_tiles_reference`` -- the same DP in plain PyTorch -- for
tensors on the CPU; there is no fallback from one to the other.  Launch
counts per kernel live in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .pairwise import MASK32, levenshtein_sim_from_distance

# Longest pattern the tiled Myers kernel covers (8 words); wider
# properties take the scan-DP path in ops.scoring.
MYERS_MAX_CHARS = 256

# Kernel launches since the last reset, by the TPU kernel each one ports.
LAUNCHES = {"myers_tile": 0, "myersN_tile": 0}

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "myers_tile.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LIB = None
_LIB_LOCK = threading.Lock()
# HTTP handler threads of different workloads launch concurrently
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def kernel_words(l: int) -> int:
    """Words of DP state the kernel instance for width ``l`` carries: the
    power of two covering ceil(l / 32) (char widths grow in powers of two,
    so this is exact for every width the device matcher produces)."""
    words = 1
    while 32 * words < l:
        words *= 2
    return words


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def build_library() -> Path:
    """Compile ``csrc/myers_tile.cu`` (once per source content) and return
    the shared library's path.  Safe against concurrent builds: each
    compiles to a private name and renames into place."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    target = _BUILD_DIR / f"libmyers_tile-{digest}.so"
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SOURCE.name}:\n"
            f"{proc.stderr}")
    os.replace(tmp, target)
    return target


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.myers_tiles
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check_operands(qchars, qlen, cchars, clen) -> None:
    tensors = (qchars, qlen, cchars, clen)
    if any(t.device != qchars.device for t in tensors):
        raise ValueError("myers_distance_tiles operands must share a device")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("myers_distance_tiles takes int32 chars and lengths, "
                        f"got {[str(t.dtype) for t in tensors]}")
    if qchars.dim() != 2 or cchars.dim() != 2:
        raise ValueError("chars must be (rows, L) matrices")
    l = qchars.shape[1]
    if cchars.shape[1] != l:
        raise ValueError(f"query width {l} != corpus width {cchars.shape[1]}")
    if qlen.shape != (qchars.shape[0],) or clen.shape != (cchars.shape[0],):
        raise ValueError("lengths must be (rows,) vectors")
    if l > MYERS_MAX_CHARS:
        raise ValueError(
            f"Myers tile kernels need L <= {MYERS_MAX_CHARS}, got {l}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("myers_distance_tiles operands must be contiguous")


def myers_distance_tiles(qchars, qlen, cchars, clen):
    """All-pairs Levenshtein distance d(query_i, corpus_j) -> (Q, C) int32.

    qchars: (Q, L) int32 UTF-16 units (0-padded), L <= MYERS_MAX_CHARS;
    qlen: (Q,) int32; cchars: (C, L) int32; clen: (C,) int32.  An empty
    pattern gives the text length.  Mirrors the JAX package's
    ``pallas_kernels.myers_distance_tiles``.
    """
    _check_operands(qchars, qlen, cchars, clen)
    if qchars.device.type == "cpu":
        return myers_distance_tiles_reference(qchars, qlen, cchars, clen)
    if qchars.device.type != "cuda":
        raise ValueError(f"no Myers kernel for device {qchars.device}")
    q, l = qchars.shape
    c = cchars.shape[0]
    out = torch.empty((q, c), dtype=torch.int32, device=qchars.device)
    if q == 0 or c == 0:
        return out
    words = kernel_words(l)
    err = _library().myers_tiles(
        qchars.data_ptr(), qlen.data_ptr(), cchars.data_ptr(),
        clen.data_ptr(), out.data_ptr(), q, c, l, words,
        torch.cuda.current_stream(qchars.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"myers_tiles launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES["myers_tile" if words == 1 else "myersN_tile"] += 1
    return out


def myers_distance_tiles_reference(qchars, qlen, cchars, clen):
    """The plain PyTorch version of ``myers_distance_tiles`` (any device).

    The same Myers/Hyyro DP over W 32-bit words held in int64, one text
    step per loop iteration over the whole (Q, C) pair matrix.  The
    per-step match words come from a (Q, A, W) table of pattern bit masks
    over the A distinct query chars, gathered by each corpus char (text
    chars absent from every pattern gather an all-zero row).
    """
    q, l = qchars.shape
    c = cchars.shape[0]
    device = qchars.device
    words = max(1, -(-l // 32))
    ql = qlen.long()
    cl = clen.long()
    qc = qchars.long()
    cc = cchars.long()
    if q == 0 or c == 0:
        return torch.zeros((q, c), dtype=torch.int32, device=device)

    # alphabet of the patterns, plus a final all-zero row for other chars
    alpha, qid = torch.unique(qc, return_inverse=True)
    a = alpha.numel()
    pos = torch.arange(l, device=device)
    peq = torch.zeros((q, (a + 1) * words), dtype=torch.int64, device=device)
    slot = qid * words + (pos // 32)[None, :]
    peq.scatter_add_(1, slot, (1 << (pos % 32)).expand(q, l).contiguous())
    peq = peq.view(q, a + 1, words)
    found = torch.searchsorted(alpha, cc).clamp_max(a - 1)
    cid = torch.where(alpha[found] == cc, found, torch.full_like(found, a))

    def bits_below(n):  # (1 << n) - 1 for n in [0, 32]
        return (1 << n.clamp(0, 32)) - 1

    pv = [bits_below(ql - 32 * w)[:, None].expand(q, c).clone()
          for w in range(words)]
    mv = [torch.zeros((q, c), dtype=torch.int64, device=device)
          for _ in range(words)]
    last = ql.clamp_min(1) - 1
    hi_sel = [(last // 32 == w)[:, None] for w in range(words)]
    hibit = (1 << (last % 32))[:, None]
    score = ql[:, None].expand(q, c).clone()

    for i in range(l):
        eqs = peq[:, cid[:, i], :]                        # (Q, C, W)
        active = (i < cl)[None, :]
        xv, xh = [], []
        carry = 0
        for w in range(words):
            eq = eqs[:, :, w]
            xv.append(eq | mv[w])
            s = (eq & pv[w]) + pv[w] + carry
            carry = s >> 32
            xh.append(((s & MASK32) ^ pv[w]) | eq)
        ph = [mv[w] | (~(xh[w] | pv[w]) & MASK32) for w in range(words)]
        mh = [pv[w] & xh[w] for w in range(words)]
        ph_hi = sum(torch.where(hi_sel[w], ph[w], 0) for w in range(words))
        mh_hi = sum(torch.where(hi_sel[w], mh[w], 0) for w in range(words))
        score = score + (active & ((ph_hi & hibit) != 0)).long()
        score = score - (active & ((mh_hi & hibit) != 0)).long()
        # horizontal shifts with cross-word carries
        nph = [((ph[w] << 1) & MASK32) | (ph[w - 1] >> 31 if w else 1)
               for w in range(words)]
        nmh = [((mh[w] << 1) & MASK32) | (mh[w - 1] >> 31 if w else 0)
               for w in range(words)]
        pv = [torch.where(active, nmh[w] | (~(xv[w] | nph[w]) & MASK32),
                          pv[w]) for w in range(words)]
        mv = [torch.where(active, nph[w] & xv[w], mv[w])
              for w in range(words)]
    # empty pattern: distance is the text length
    out = torch.where(ql[:, None] == 0, cl[None, :].expand(q, c), score)
    return out.to(torch.int32)


def levenshtein_sim_tiles(qchars, qlen, cchars, clen, equal):
    """Duke Levenshtein similarity over all query x corpus pairs: (Q, C)
    f32 (mirrors ``pallas_kernels.levenshtein_sim_tiles``); ``equal`` is the
    (Q, C) exact string-equality mask.  The similarity map stays in torch
    ops outside the kernel, as in the JAX package."""
    dist = myers_distance_tiles(qchars, qlen, cchars, clen)
    return levenshtein_sim_from_distance(dist, qlen[:, None], clen[None, :],
                                         equal)
