"""Hand-written CUDA kernels for the pair-matrix hot ops, and their wrappers.

Counterpart of the JAX package's ``ops/pallas_kernels.py``, all six of its
Pallas kernels:

  * ``_myers_tile_kernel`` and ``_myersN_tile_kernel`` -- all-pairs
    Levenshtein distance -- become one CUDA kernel templated on the word
    count, which looks each text unit's match words up in a per-warp
    table of its query's units, ``csrc/myers_tile.cu``
    (``myers_distance_tiles``);
  * ``_jw_tile_kernel`` -- all-pairs Jaro-Winkler similarity --
    ``csrc/jw_tile.cu`` (``jaro_winkler_sim_tiles``);
  * ``_myers_gathered_kernel`` -- Levenshtein distance of each query to
    its own gathered candidates, the dd rescorer's layout --
    ``csrc/myers_gathered.cu`` (``myers_distance_gathered``);
  * ``_intersect_tile_kernel`` -- all-pairs |A ∩ B| of hashed q-gram /
    token sets -- becomes per-query hash tables that each corpus id is
    looked up in, ``csrc/intersect_tile.cu`` (``set_intersection_tiles``);
  * ``_retrieval_segmax_kernel`` -- the ``ann`` backend's fused cosine
    product, candidate mask and strided segment max --
    ``csrc/retrieval_segmax.cu`` (``retrieval_segmax``).

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` on first use,
one process per source, all started together, into ``_build/`` (beside this
package's sources, keyed by a digest of all of them), and bound through
``ctypes``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_reference``, beside it) for tensors on the CPU; there
is no fallback from one to the other.  Launch counts per kernel live in
``LAUNCHES``, keyed by the TPU kernel each one ports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..telemetry import costs
from . import pairwise as pw
from .pairwise import MASK32, levenshtein_sim_from_distance

# Longest pattern the tiled Myers kernel covers (8 words); wider
# properties take the scan-DP path in ops.scoring.
MYERS_MAX_CHARS = 256
# The Jaro-Winkler tile and the gathered Myers kernels keep one uint32
# mask / DP word per pair.
JW_MAX_CHARS = 32
GATHERED_MAX_CHARS = 32
# Widest gram / token set the intersection kernel takes (the JAX package's
# tile-path guard).
SET_MAX_WIDTH = 256

# Kernel launches since the last reset, by the TPU kernel each one ports.
LAUNCHES = {"myers_tile": 0, "myersN_tile": 0, "jw_tile": 0,
            "myers_gathered": 0, "intersect_tile": 0, "retrieval_segmax": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the sources include their shared headers (csrc/*.cuh) from csrc/
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(_CSRC)]
# entry point of each source's library: (C function, argument types)
_ENTRY = {
    "myers_tile": ("myers_tiles",
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4),
    "jw_tile": ("jw_tiles",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2),
    "myers_gathered": ("myers_gathered",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3),
    "intersect_tile": ("intersect_tiles",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3),
    "retrieval_segmax": ("retrieval_segmax",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6),
}
# the plain versions here and the flat scoring paths (ops.scoring) work
# through row slices of at most this many pair elements (pairs x char or
# set width), so the main path's shapes fit on the card
BLOCK_ELEMENTS = 1 << 24
_LIBS = {}
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


def build_library() -> dict:
    """Compile every ``csrc/*.cu`` (once per content of all of them and of
    the headers ``csrc/*.cuh``) and return ``{source stem: shared library
    path}``.  One ``nvcc`` per source, all running at once.  Safe against
    concurrent builds: each compiles to a private name and renames into
    place.  A build's wall time goes to the cost ledger as compile time
    (``costs.note_compile``: the port's counterpart of an XLA compile)."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    targets = {src.stem: _BUILD_DIR / f"lib{src.stem}-{tag}.so"
               for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if todo:
        t0 = time.monotonic()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            target = targets[src.stem]
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, target, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for src, tmp, target, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed building " + "\n".join(failed))
        costs.note_compile(time.monotonic() - t0)
    return targets


def _kernel(stem: str):
    """The bound C entry point of ``csrc/<stem>.cu``."""
    with _LIB_LOCK:
        if stem not in _LIBS:
            paths = build_library()
            for name, path in paths.items():
                if name in _LIBS:
                    continue
                fname, argtypes = _ENTRY[name]
                fn = getattr(ctypes.CDLL(str(path)), fname)
                fn.argtypes = argtypes + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _LIBS[name] = fn
        return _LIBS[stem]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, err: int) -> None:
    """Raise on a refused launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _check_common(what: str, tensors) -> None:
    """Shared operand checks: one device, int32, contiguous, and a device
    this module has a path for."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what} operands must share a device")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{what} takes int32 operands, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {device}")


def _check_pair_operands(what, qchars, qlen, cchars, clen, max_chars):
    """(Q, L) x (C, L) chars with (Q,) / (C,) lengths, L <= max_chars."""
    _check_common(what, (qchars, qlen, cchars, clen))
    if qchars.dim() != 2 or cchars.dim() != 2:
        raise ValueError("chars must be (rows, L) matrices")
    l = qchars.shape[1]
    if cchars.shape[1] != l:
        raise ValueError(f"query width {l} != corpus width {cchars.shape[1]}")
    if qlen.shape != (qchars.shape[0],) or clen.shape != (cchars.shape[0],):
        raise ValueError("lengths must be (rows,) vectors")
    if l > max_chars:
        raise ValueError(f"{what} needs L <= {max_chars}, got {l}")


def myers_distance_tiles(qchars, qlen, cchars, clen):
    """All-pairs Levenshtein distance d(query_i, corpus_j) -> (Q, C) int32.

    qchars: (Q, L) int32 UTF-16 units (0-padded), L <= MYERS_MAX_CHARS;
    qlen: (Q,) int32; cchars: (C, L) int32; clen: (C,) int32.  An empty
    pattern gives the text length.  Mirrors the JAX package's
    ``pallas_kernels.myers_distance_tiles``.
    """
    _check_pair_operands("myers_distance_tiles", qchars, qlen, cchars, clen,
                         MYERS_MAX_CHARS)
    if qchars.device.type == "cpu":
        return myers_distance_tiles_reference(qchars, qlen, cchars, clen)
    q, l = qchars.shape
    c = cchars.shape[0]
    out = torch.empty((q, c), dtype=torch.int32, device=qchars.device)
    if q == 0 or c == 0:
        return out
    words = kernel_words(l)
    err = _kernel("myers_tile")(
        qchars.data_ptr(), qlen.data_ptr(), cchars.data_ptr(),
        clen.data_ptr(), out.data_ptr(), q, c, l, words, _stream(qchars))
    _launched("myers_tile" if words == 1 else "myersN_tile", err)
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


def row_blocks(rows: int, per_row: int):
    """Row ranges whose (rows x per_row) elements fit BLOCK_ELEMENTS."""
    step = max(1, BLOCK_ELEMENTS // max(1, per_row))
    return [(s, min(rows, s + step)) for s in range(0, rows, step)]


# -- Jaro-Winkler, all pairs ---------------------------------------------------


def jaro_winkler_sim_tiles(qchars, qlen, cchars, clen, equal, *,
                           prefix_scale=0.1, boost_threshold=0.7,
                           max_prefix=4):
    """All-pairs Jaro-Winkler similarity -> (Q, C) f32 (mirrors the JAX
    package's ``pallas_kernels.jaro_winkler_sim_tiles``).

    Same layout as ``myers_distance_tiles`` with L <= JW_MAX_CHARS;
    ``equal`` is the (Q, C) exact-equality mask, which gives 1.0 outside
    the kernel.
    """
    _check_pair_operands("jaro_winkler_sim_tiles", qchars, qlen, cchars,
                         clen, JW_MAX_CHARS)
    if qchars.device.type == "cpu":
        return jaro_winkler_sim_tiles_reference(
            qchars, qlen, cchars, clen, equal, prefix_scale=prefix_scale,
            boost_threshold=boost_threshold, max_prefix=max_prefix)
    q, l = qchars.shape
    c = cchars.shape[0]
    out = torch.empty((q, c), dtype=torch.float32, device=qchars.device)
    if q and c:
        err = _kernel("jw_tile")(
            qchars.data_ptr(), qlen.data_ptr(), cchars.data_ptr(),
            clen.data_ptr(), out.data_ptr(), q, c, l, int(max_prefix),
            float(prefix_scale), float(boost_threshold), _stream(qchars))
        _launched("jw_tile", err)
    return torch.where(equal, 1.0, out)


def jaro_winkler_sim_tiles_reference(qchars, qlen, cchars, clen, equal, *,
                                     prefix_scale=0.1, boost_threshold=0.7,
                                     max_prefix=4):
    """The plain PyTorch version of ``jaro_winkler_sim_tiles`` (any
    device): the flat ``pairwise.jaro_winkler_sim`` over the expanded pairs
    of each block of query rows; (Q, C) f32."""
    q, l = qchars.shape
    c = cchars.shape[0]
    parts = [torch.zeros((0, c), dtype=torch.float32, device=qchars.device)]
    for s, e in row_blocks(q, c * l):
        n = e - s
        parts.append(pw.jaro_winkler_sim(
            qchars[s:e, None].expand(n, c, l).reshape(-1, l),
            qlen[s:e, None].expand(n, c).reshape(-1),
            cchars[None].expand(n, c, l).reshape(-1, l),
            clen[None].expand(n, c).reshape(-1), equal[s:e].reshape(-1),
            prefix_scale=prefix_scale, boost_threshold=boost_threshold,
            max_prefix=max_prefix).reshape(n, c))
    return torch.cat(parts)


# -- Levenshtein for gathered candidates (the dd rescorer's layout) ------------


def myers_distance_gathered(qchars, qlen, cchars, clen):
    """Levenshtein distance of each query to its own candidates -> (Q, K)
    int32 (mirrors ``pallas_kernels.myers_distance_gathered``).

    qchars: (Q, L) int32, L <= GATHERED_MAX_CHARS; qlen: (Q,);
    cchars: (Q, K, L) int32, candidate k of query q; clen: (Q, K).  An
    empty pattern gives the text length.
    """
    _check_common("myers_distance_gathered", (qchars, qlen, cchars, clen))
    if qchars.dim() != 2 or cchars.dim() != 3:
        raise ValueError("chars must be (Q, L) and (Q, K, L)")
    q, l = qchars.shape
    k = cchars.shape[1]
    if cchars.shape != (q, k, l):
        raise ValueError(f"candidate chars {tuple(cchars.shape)} do not "
                         f"match queries {(q, l)}")
    if qlen.shape != (q,) or clen.shape != (q, k):
        raise ValueError("lengths must be (Q,) and (Q, K)")
    if l > GATHERED_MAX_CHARS:
        raise ValueError(f"myers_distance_gathered needs L <= "
                         f"{GATHERED_MAX_CHARS}, got {l}")
    if qchars.device.type == "cpu":
        return myers_distance_gathered_reference(qchars, qlen, cchars, clen)
    out = torch.empty((q, k), dtype=torch.int32, device=qchars.device)
    if q and k:
        err = _kernel("myers_gathered")(
            qchars.data_ptr(), qlen.data_ptr(), cchars.data_ptr(),
            clen.data_ptr(), out.data_ptr(), q, k, l, _stream(qchars))
        _launched("myers_gathered", err)
    return out


def myers_distance_gathered_reference(qchars, qlen, cchars, clen):
    """The plain PyTorch version of the gathered Myers kernel (any device):
    the flat one-word Myers DP over each query's (K, L) candidates."""
    q, l = qchars.shape
    k = cchars.shape[1]
    parts = [torch.zeros((0, k), dtype=torch.int32, device=qchars.device)]
    for s, e in row_blocks(q, k * l):
        n = e - s
        c1 = qchars[s:e, None].expand(n, k, l).reshape(-1, l)
        l1 = qlen[s:e, None].expand(n, k).reshape(-1)
        dist = pw.levenshtein_distance_myers(
            c1, l1, cchars[s:e].reshape(-1, l), clen[s:e].reshape(-1))
        parts.append(dist.reshape(n, k))
    return torch.cat(parts)


# -- set intersection (q-grams / token sets), all pairs -----------------------


def set_intersection_tiles(qgrams, qn, cgrams, cn):
    """All-pairs |set_i ∩ set_j| -> (Q, C) int32 (mirrors
    ``pallas_kernels.set_intersection_tiles``).

    qgrams: (Q, G) int32 hashed ids, distinct in the first qn entries
    (``ops.features`` GRAM_SET / TOKEN_SET sorts them and pads with
    SET_PAD; neither the kernel nor the plain version needs them sorted);
    qn: (Q,); cgrams: (C, G); cn: (C,); G <= SET_MAX_WIDTH.  Only the
    first n entries of a row count, whatever its padding holds.
    """
    _check_pair_operands("set_intersection_tiles", qgrams, qn, cgrams, cn,
                         SET_MAX_WIDTH)
    if qgrams.device.type == "cpu":
        return set_intersection_tiles_reference(qgrams, qn, cgrams, cn)
    q, g = qgrams.shape
    c = cgrams.shape[0]
    out = torch.empty((q, c), dtype=torch.int32, device=qgrams.device)
    if q and c:
        err = _kernel("intersect_tile")(
            qgrams.data_ptr(), qn.data_ptr(), cgrams.data_ptr(),
            cn.data_ptr(), out.data_ptr(), q, c, g, _stream(qgrams))
        _launched("intersect_tile", err)
    return out


def set_intersection_tiles_reference(qgrams, qn, cgrams, cn):
    """The plain PyTorch version of the intersection kernel (any device):
    the flat ``pairwise.set_intersection_count`` over the expanded pairs of
    each block of query rows; only the first n ids of a row count."""
    q, g = qgrams.shape
    c = cgrams.shape[0]
    parts = [torch.zeros((0, c), dtype=torch.int32, device=qgrams.device)]
    for s, e in row_blocks(q, c * g):
        n = e - s
        parts.append(pw.set_intersection_count(
            qgrams[s:e, None].expand(n, c, g).reshape(-1, g),
            qn[s:e, None].expand(n, c).reshape(-1),
            cgrams[None].expand(n, c, g).reshape(-1, g),
            cn[None].expand(n, c).reshape(-1)).reshape(n, c))
    return torch.cat(parts)


def set_sim_tiles(qids, qn, cids, cn, equal, *, formula):
    """Set-comparator similarity over all query x corpus pairs: (Q, C) f32
    for QGram (its formula), JaccardIndex ('jaccard') and DiceCoefficient
    ('dice'), through the shared ``pairwise.sim_from_set_intersection``."""
    common = set_intersection_tiles(qids, qn, cids, cn)
    return pw.sim_from_set_intersection(common, qn[:, None], cn[None, :],
                                        equal, formula=formula)


# -- the ann backend's fused retrieval: product + mask + strided segment max ---

# Masked score (the JAX kernel's ``neg``); a bin whose rows are all masked
# reports it with its smallest row.
SEGMAX_NEG = -3.0e38
# The retrieval mask compares groups clipped to this range, as the JAX
# package's int8 encoding of the mask does (``pallas_kernels.GROUP_OFFSET``).
GROUP_CLIP = (-1, 100)
# the plain version works through corpus blocks of at most this many
# (query x row) scores (256 MB of f32), in whole tiles
_SEGMAX_BLOCK = 1 << 26


def segmax_tolerance(d: int) -> float:
    """Bar between two f32 summation orders of D exact bf16 products of
    unit vectors: ``4 * D * 2^-24`` (6.1e-5 at D = 256)."""
    return 4.0 * d * 2.0 ** -24


def _check_segmax_operands(q_emb, corpus, valid, deleted, group, qrow, qgroup,
                           tc: int, seg: int) -> None:
    tensors = (q_emb, corpus, valid, deleted, group, qrow, qgroup)
    device = q_emb.device
    if any(t.device != device for t in tensors):
        raise ValueError("retrieval_segmax operands must share a device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no retrieval_segmax kernel for device {device}")
    if q_emb.dtype != torch.bfloat16 or corpus.dtype != torch.bfloat16:
        raise TypeError("retrieval_segmax takes bf16 embeddings, got "
                        f"{q_emb.dtype} and {corpus.dtype}")
    masks = (torch.bool, torch.int8, torch.uint8)
    if valid.dtype not in masks or deleted.dtype not in masks:
        raise TypeError("valid / deleted must be bool or int8 (0 / 1) rows")
    if any(t.dtype != torch.int32 for t in (group, qrow, qgroup)):
        raise TypeError("group, query rows and query groups must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("retrieval_segmax operands must be contiguous")
    if q_emb.dim() != 2 or corpus.dim() != 2:
        raise ValueError("embeddings must be (Q, D) and (N, D) matrices")
    q, d = q_emb.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d or d % 128:
        raise ValueError(f"embedding widths {d} / {corpus.shape[1]} must be "
                         "equal multiples of 128")
    if tuple(valid.shape) != (n,) or tuple(deleted.shape) != (n,) \
            or tuple(group.shape) != (n,):
        raise ValueError("valid / deleted / group must be (N,) rows")
    if tuple(qrow.shape) != (q,) or tuple(qgroup.shape) != (q,):
        raise ValueError("query rows / groups must be (Q,) vectors")
    if seg <= 0 or tc % seg or tc <= 0 or n % tc:
        raise ValueError(f"need seg | tc | N, got seg={seg} tc={tc} N={n}")


def retrieval_segmax(q_emb, corpus, valid, deleted, group, qrow, qgroup, *,
                     tc: int, seg: int, group_filtering: bool):
    """Per query and per strided bin: the largest masked cosine score and
    the smallest row reaching it -> ``(seg_max (Q, N/seg) f32, seg_arg
    (Q, N/seg) int32)`` (the JAX package's ``pallas_kernels.
    retrieval_segmax``, written query-major).

    q_emb: (Q, D) bf16; corpus: (N, D) bf16, D a multiple of 128, N of
    ``tc``; valid / deleted: (N,) bool; group: (N,) int32; qrow: (Q,) the
    query's own corpus row (-1 none); qgroup: (Q,).  A row is a candidate
    when valid and not deleted, not the query's own row and, with
    ``group_filtering``, of another group (both clipped to GROUP_CLIP);
    other scores are SEGMAX_NEG.  Bin ``i * (tc/seg) + j`` holds rows
    ``i * tc + j + k * (tc/seg)``, k < seg.
    """
    _check_segmax_operands(q_emb, corpus, valid, deleted, group, qrow,
                           qgroup, tc, seg)
    if q_emb.device.type == "cpu":
        return retrieval_segmax_reference(
            q_emb, corpus, valid, deleted, group, qrow, qgroup, tc=tc,
            seg=seg, group_filtering=group_filtering)
    q, d = q_emb.shape
    n = corpus.shape[0]
    seg_max = torch.empty((q, n // seg), dtype=torch.float32,
                          device=q_emb.device)
    seg_arg = torch.empty((q, n // seg), dtype=torch.int32,
                          device=q_emb.device)
    if any(t.data_ptr() % 16 for t in (q_emb, corpus)):
        raise ValueError("retrieval_segmax needs 16-byte aligned embeddings")
    # the kernel's bins, tc / seg, fill whole 8-column groups of its chunks;
    # the fused route's gate (encoder.fused_route) gives tc >= max(1024,
    # 8 seg), both powers of two (the plain version takes every seg | tc | N)
    if tc & (tc - 1) or seg & (seg - 1) or tc // seg < 8 or tc < 128:
        raise ValueError(f"the retrieval_segmax kernel takes tc and seg powers "
                         f"of two with tc / seg >= 8 and tc >= 128, got "
                         f"tc={tc} seg={seg}")
    if q:
        err = _kernel("retrieval_segmax")(
            q_emb.data_ptr(), corpus.data_ptr(), valid.data_ptr(),
            deleted.data_ptr(), group.data_ptr(), qrow.data_ptr(),
            qgroup.data_ptr(), seg_max.data_ptr(), seg_arg.data_ptr(), q, n,
            d, tc, seg, int(bool(group_filtering)), _stream(q_emb))
        _launched("retrieval_segmax", err)
    return seg_max, seg_arg


def retrieval_segmax_reference(q_emb, corpus, valid, deleted, group, qrow,
                               qgroup, *, tc: int, seg: int,
                               group_filtering: bool, runner_up: bool = False):
    """The plain PyTorch version of ``retrieval_segmax`` (any device).

    Scores are the f32 matrix product of the bf16 values (each product
    exact, summed in the matmul's own order), in corpus blocks of whole
    tiles; the mask, the max over each bin's seg rows and the smallest row
    at the max follow.  ``runner_up`` adds a third (Q, N/seg) output: the
    bin's second-best score (equal to the best on a tie; -inf when seg is
    1), which the kernel checks use to tell a decided argmax from one that
    rounding may move.
    """
    q, d = q_emb.shape
    n = corpus.shape[0]
    bins = tc // seg
    device = q_emb.device
    qf = q_emb.float()
    live = valid.bool() & ~deleted.bool()
    cgroup = group.clamp(*GROUP_CLIP)
    qg = qgroup.clamp(*GROUP_CLIP)
    seg_max = torch.empty((q, n // seg), dtype=torch.float32, device=device)
    seg_arg = torch.empty((q, n // seg), dtype=torch.int32, device=device)
    second = torch.empty_like(seg_max) if runner_up else None
    step = max(tc, _SEGMAX_BLOCK // max(q, 1) // tc * tc)
    for s in range(0, n, step):
        e = min(n, s + step)
        tiles = (e - s) // tc
        scores = qf @ corpus[s:e].float().T                     # (Q, R)
        rows = torch.arange(s, e, dtype=torch.int32, device=device)
        mask = live[None, s:e] & (rows[None, :] != qrow[:, None])
        if group_filtering:
            mask = mask & (cgroup[None, s:e] != qg[:, None])
        scores = torch.where(mask, scores, SEGMAX_NEG)
        s4 = scores.view(q, tiles, seg, bins)
        best = s4.amax(dim=2)                                   # (Q, T, B)
        rid = rows.view(1, tiles, seg, bins)
        top = s4 == best[:, :, None, :]
        arg = torch.where(top, rid, torch.iinfo(torch.int32).max).amin(dim=2)
        out = slice(s // seg, e // seg)
        seg_max[:, out] = best.reshape(q, -1)
        seg_arg[:, out] = arg.reshape(q, -1)
        if runner_up and seg > 1:
            second[:, out] = s4.topk(2, dim=2).values[:, :, 1].reshape(q, -1)
        elif runner_up:
            second[:, out] = float("-inf")
    if runner_up:
        return seg_max, seg_arg, second
    return seg_max, seg_arg


def segmax_disagreement(got_max, got_arg, want_max, want_arg, want_second,
                        d: int):
    """(max |seg_max error|, bins whose seg_arg differs although the bin's
    best leads its runner-up by more than ``segmax_tolerance(d)``) of a
    kernel result against the plain version's.  Ties of identical
    embeddings are equal in both and must resolve to the same smallest
    row; the tests check that on duplicate clusters."""
    err = float((got_max.double() - want_max.double()).abs().max()) \
        if got_max.numel() else 0.0
    lead = want_max.double() - want_second.double()
    decided = lead > segmax_tolerance(d)
    bad = int((decided & (got_arg != want_arg)).sum())
    return err, bad
