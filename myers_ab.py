#!/usr/bin/env python3
"""Time versions of one tile kernel side by side on one NVIDIA GPU.

    python3 myers_ab.py [--kernel myers_tile|jw_tile|retrieval_segmax|
                                  intersect_tile|myers_gathered]
                        [--sass PATH] [NAME=PATH.cu ...]

Builds ``csrc/<kernel>.cu`` as it stands ("kernel"; the default kernel is
``myers_tile``) and every further source given as NAME=PATH (another
version of the same file with the same C entry point, e.g. an earlier
commit's, staged with ``git show COMMIT:PATH > _checkout/NAME.cu``), one
nvcc each, all at once, with the package's nvcc flags and ``-Xptxas -v``
(printed for "kernel"; with ``--sass PATH`` its machine code, ``cuobjdump
-sass``, is written to PATH).  It also builds variants made from the
source by text edits; for ``myers_tile``:

  * "nosort": the rows of a block are staged in their order, not sorted
    by length;
  * "q1": one query per warp at every W (not two at W <= 2);
  * "tile1": one tile of 32 corpus rows per block at every W (not 4 at
    W = 1 and 2 at W = 2), so no sort either;

for ``retrieval_segmax``:

  * "stream": the query tile streams through the ring at every D (not
    only where, resident, it would leave the ring fewer than 4 stages);

for ``intersect_tile``:

  * "lowbits": an id's home slot is its low bits, not the top bits of
    id * 0x9E3779B1;
  * "nosort": the rows of a block are staged in their order, not sorted
    by set size;
  * "window0": every lookup window runs the loop whose slot count is
    known only at run time, not an unrolled one for windows of 1 to 4.

At each shape of ``chip_smoke.py``'s kernel phase for the kernel, every
build is held against the plain version on the same inputs (integer and
Jaro-Winkler results exactly, the segment max within ``4 D 2^-24`` with
its argmax equal where decided), then timed round robin: 3 rounds of the
median of 10 CUDA-event timings each (``chip_smoke.cuda_ms_back_to_back``:
a timing spans back-to-back launches filling ~1 ms, each launch's status
checked), the median of the rounds printed
beside the kernel's bound (``chip_smoke.py``'s) and the bound's earlier
count, for comparison with earlier times:

  * myers_tile: W = 1 at (2048, 8192, 32) and (4096, 8192, 32), on
    synthetic rows and on stresstest name rows; W = 2, 4, 8 at
    (2048, 8192, 32 W); the earlier count of 22 + 4 operations per word
    and text step;
  * jw_tile: (2048, 8192, 32) and (4096, 8192, 32) on synthetic rows and
    (2048, 8192, 32) on the wide UTF-16 alphabets of tests/wide_units.py;
    the earlier count of 8 operations per query char (l1 steps a pair);
  * retrieval_segmax: the ann ingest's (Q 2048, N 524,288, D 256, tc 1024,
    seg 64), the kernel phase's odd shape and a wide embedding (D 1024,
    where the query tile streams through the ring); beside it
    ``torch.matmul`` of the bare bf16 product;
  * intersect_tile: the mixed workload's q-gram (2048, 8192, 64) and
    token (2048, 8192, 16) widths on synthetic sets and on sets made from
    its own kind of rows (address 2-grams, employer tokens); the earlier
    count of 4 operations per merge step;
  * myers_gathered: (2048, 64, 32) (the mixed dd rescorer, the ann
    ingest) and (4096, 64, 32) (the ann query POST) on synthetic rows.

A build other than "kernel" whose entry point refuses a shape before
launching (status 1, cudaErrorInvalidValue) is reported and left out of
that shape.  Exits non-zero without a CUDA device or if a build disagrees
with the plain version.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke

REPO = Path(__file__).resolve().parent
CSRC = REPO / chip_smoke.PACKAGE / "csrc"
KERNELS = ("myers_tile", "jw_tile", "retrieval_segmax", "intersect_tile",
           "myers_gathered")
# kernel -> variant name -> (text in the source, its replacement); each
# text must occur exactly once
EDITS = {
    "myers_tile": {
        "nosort": [("if constexpr (tiles<W>() > 1) {",
                    "if constexpr (false) {")],
        "q1": [("return W <= 2 ? 2 : 1;", "return 1;")],
        "tile1": [("return W == 1 ? 4 : (W == 2 ? 2 : 1);", "return 1;")],
    },
    "jw_tile": {},
    "retrieval_segmax": {
        "stream": [("const bool resident = 1024",
                    "const bool resident = false && 1024")],
    },
    "intersect_tile": {
        "lowbits": [("return (id * kMul) >> shift;",
                     "return id & (0xFFFFFFFFu >> shift);"),
                    ("return (t << shift) * kMulInv;", "return t;")],
        "nosort": [("const int at = s_count[len] + pos;",
                    "const int at = tid;")],
        "window0": [("switch (window) {", "switch (0) {")],
    },
    "myers_gathered": {},
}
MYERS_SHAPES = [("synthetic", (2048, 8192, 32)), ("names", (2048, 8192, 32)),
                ("synthetic", (4096, 8192, 32)),
                ("synthetic", (2048, 8192, 64)),
                ("synthetic", (2048, 8192, 128)),
                ("synthetic", (2048, 8192, 256))]
JW_SHAPES = [("synthetic", (2048, 8192, 32)), ("synthetic", (4096, 8192, 32)),
             ("wide", (2048, 8192, 32))]
JW_KW = dict(prefix_scale=0.1, boost_threshold=0.7, max_prefix=4)
# (Q, C, G): the mixed workload's q-gram and token set widths, on synthetic
# sets and on sets of its own kind of rows
INTERSECT_SHAPES = [("synthetic", (2048, 8192, 64)),
                    ("synthetic", (2048, 8192, 16)),
                    ("mixed", (2048, 8192, 64)), ("mixed", (2048, 8192, 16))]
# (Q, K, L): the mixed dd rescorer's and the ann ingest's, the ann query's
GATHERED_SHAPES = [(2048, 64, 32), (4096, 64, 32)]
# (Q, N, D, tc, seg, group_filtering)
SEGMAX_SHAPES = [(2048, 524288, 256, 1024, 64, False), chip_smoke.SEGMAX_ODD,
                 (2048, 262144, 1024, 1024, 64, False)]
# an entry point's status when it refuses a shape before launching
REFUSED = 1
# the count chip_smoke.py's Myers bound used before its recount
OLD_OPS = (22, 4)
ROUNDS = 3
RUNS = 10


def variant_sources(kernel, extra, out_dir):
    """{name: path of its .cu}: the source, its edited variants, extras."""
    source = CSRC / f"{kernel}.cu"
    sources = {"kernel": source}
    text = source.read_text()
    for name, edits in EDITS[kernel].items():
        edited = text
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"myers_ab: '{old}' is not in "
                                 f"{source.name} exactly once")
            edited = edited.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(edited)
        sources[name] = path
    for arg in extra:
        name, _, path = arg.partition("=")
        if not path or name in sources:
            raise SystemExit(f"myers_ab: bad source argument '{arg}'")
        sources[name] = Path(path).resolve()
    return sources


def build(kernel, sources, out_dir):
    """{name: bound entry point}; nvcc's ptxas report of "kernel" printed."""
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [ck._nvcc(), *ck._NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"myers_ab: nvcc failed on {name}:\n{err}")
        if name == "kernel":
            for line in err.splitlines():
                if any(k in line for k in ("Compiling", "registers", "spill")):
                    print(f"ptxas: {line.strip()}", flush=True)
        fname, argtypes = ck._ENTRY[kernel]
        fn = getattr(ctypes.CDLL(str(lib)), fname)
        fn.argtypes = argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


# Each case generator yields (label, call, check, bounds): call(fn) launches
# one build's entry point on the case's inputs into its output, check()
# holds that output against the plain version, bounds is [(name, ms)].


def myers_cases(peak_ops):
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    for rows, (q, c, l) in MYERS_SHAPES:
        words = ck.kernel_words(l)
        if rows == "names":
            qc, ql, cc, cl = chip_smoke.name_inputs(q, c, l)
        else:
            qc, ql, cc, cl = chip_smoke.char_inputs(q, c, l, seed=q + l)
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((q, c), dtype=torch.int32, device="cuda")
        want = ck.myers_distance_tiles_reference(qc, ql, cc, cl)

        def call(fn):
            return fn(qc.data_ptr(), ql.data_ptr(), cc.data_ptr(),
                      cl.data_ptr(), out.data_ptr(), q, c, l, words, stream)

        bound_ms, _ = chip_smoke.myers_bound(qc, ql, cc, cl, peak_ops)
        old_ms, _ = chip_smoke.myers_bound(qc, ql, cc, cl, peak_ops, *OLD_OPS)
        yield (f"W={words} {(q, c, l)} {rows} rows", call,
               lambda: torch.equal(out, want),
               [("bound", bound_ms), (f"{OLD_OPS[0]}+{OLD_OPS[1]}-op bound",
                                      old_ms)])


def jw_cases(peak_ops):
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from wide_units import wide_unit_inputs

    for rows, (q, c, l) in JW_SHAPES:
        if rows == "wide":
            qc, ql, cc, cl = (torch.from_numpy(a).cuda() for a in
                              wide_unit_inputs("all", q + l, q, c, l))
        else:
            qc, ql, cc, cl = chip_smoke.char_inputs(q, c, l, seed=7 + l)
            cc[::3, :2] = qc[0, :2]           # shared prefixes: the boost
        none = torch.zeros((q, c), dtype=torch.bool, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((q, c), dtype=torch.float32, device="cuda")
        want = ck.jaro_winkler_sim_tiles_reference(qc, ql, cc, cl, none,
                                                   **JW_KW)

        def call(fn):
            return fn(qc.data_ptr(), ql.data_ptr(), cc.data_ptr(),
                      cl.data_ptr(), out.data_ptr(), q, c, l,
                      JW_KW["max_prefix"], JW_KW["prefix_scale"],
                      JW_KW["boost_threshold"], stream)

        args = (qc, ql, cc, cl, JW_KW["max_prefix"], peak_ops)
        yield (f"{(q, c, l)} {rows} rows", call,
               lambda: torch.equal(out, want),
               [("bound", chip_smoke.jw_bound(*args)[0]),
                ("query-char bound",
                 chip_smoke.jw_bound(*args, shorter=False)[0])])


def segmax_cases(peak_flops):
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    for q, n, d, tc, seg, gf in SEGMAX_SHAPES:
        args = chip_smoke.segmax_inputs(q, n, d, seed=q + seg)
        kw = dict(tc=tc, seg=seg, group_filtering=gf)
        stream = torch.cuda.current_stream().cuda_stream
        seg_max = torch.empty((q, n // seg), dtype=torch.float32,
                              device="cuda")
        seg_arg = torch.empty((q, n // seg), dtype=torch.int32, device="cuda")
        want = ck.retrieval_segmax_reference(*args, runner_up=True, **kw)

        def call(fn):
            return fn(*(t.data_ptr() for t in args), seg_max.data_ptr(),
                      seg_arg.data_ptr(), q, n, d, tc, seg, int(gf), stream)

        def check():
            err, bad = ck.segmax_disagreement(seg_max, seg_arg, *want, d)
            return err <= ck.segmax_tolerance(d) and bad == 0

        qe, ce = args[0], args[1]
        matmul_ms = chip_smoke.cuda_ms_back_to_back(
            lambda: torch.matmul(ce, qe.T), RUNS)
        yield ((q, n, d, tc, seg, gf), call, check,
               [("bound", chip_smoke.segmax_bound(q, n, d, seg,
                                                  peak_flops)[0]),
                ("torch.matmul of the bare product", matmul_ms)])


def mixed_set_inputs(q, c, g):
    """Id sets of the mixed workload's own kind of rows (chip_smoke's
    ``mixed_entities``, q query rows, then c corpus rows), as ops.features
    makes them: at g = 64 the address's 2-grams, at g = 16 the employer's
    tokens, each hashed (FNV-1a 64 folded to 32 bits), distinct and
    sorted in the first n of g slots, SET_PAD after."""
    import numpy as np
    import torch

    from sesam_duke_microservice_tpu_torch.core.comparators import qgrams
    from sesam_duke_microservice_tpu_torch.ops import features as F

    rows = chip_smoke.mixed_entities(q + c, 4321, "s")
    if g >= 64:
        parts = [sorted(qgrams(e["address"], 2)) for e in rows]
    else:
        parts = [e["employer"].split() for e in rows]
    hashed = F._fold32(F.fnv1a64_batch([t for p in parts for t in p]))
    ids = np.full((q + c, g), chip_smoke.SET_PAD, dtype=np.int32)
    n = np.zeros(q + c, dtype=np.int32)
    at = 0
    for i, part in enumerate(parts):
        row = sorted(set(hashed[at:at + len(part)].tolist()))[:g]
        at += len(part)
        ids[i, :len(row)] = row
        n[i] = len(row)
    ids, n = torch.from_numpy(ids).cuda(), torch.from_numpy(n).cuda()
    return (ids[:q].contiguous(), n[:q].contiguous(), ids[q:].contiguous(),
            n[q:].contiguous())


def intersect_cases(peak_ops):
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    for rows, (q, c, g) in INTERSECT_SHAPES:
        if rows == "mixed":
            qg, qn, cg, cn = mixed_set_inputs(q, c, g)
        else:
            qg, qn = chip_smoke.set_inputs(q, g, seed=g)
            cg, cn = chip_smoke.set_inputs(c, g, seed=g + 1)
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((q, c), dtype=torch.int32, device="cuda")
        want = ck.set_intersection_tiles_reference(qg, qn, cg, cn)

        def call(fn):
            return fn(qg.data_ptr(), qn.data_ptr(), cg.data_ptr(),
                      cn.data_ptr(), out.data_ptr(), q, c, g, stream)

        args = (qg, qn, cg, cn, want, peak_ops)
        yield (f"{(q, c, g)} {rows} sets", call,
               lambda: torch.equal(out, want),
               [("bound", chip_smoke.intersect_bound(*args)[0]),
                ("merge-count bound",
                 chip_smoke.intersect_bound(*args, merge=True)[0])])


def gathered_cases(peak_ops):
    import torch

    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    for q, k, l in GATHERED_SHAPES:
        qc, ql, cc, cl = chip_smoke.gathered_inputs(q, k, l)
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((q, k), dtype=torch.int32, device="cuda")
        want = ck.myers_distance_gathered_reference(qc, ql, cc, cl)

        def call(fn):
            return fn(qc.data_ptr(), ql.data_ptr(), cc.data_ptr(),
                      cl.data_ptr(), out.data_ptr(), q, k, l, stream)

        yield (f"{(q, k, l)} synthetic rows", call,
               lambda: torch.equal(out, want),
               [("bound", chip_smoke.gathered_bound(qc, ql, cc, cl,
                                                    peak_ops)[0])])


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("myers_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    kernel = "myers_tile"
    if argv[:1] == ["--kernel"] and len(argv) > 1:
        kernel, argv = argv[1], argv[2:]
    if kernel not in KERNELS:
        raise SystemExit(f"myers_ab: --kernel takes one of {KERNELS}")
    sass = None
    if argv[:1] == ["--sass"] and len(argv) > 1:
        sass, argv = Path(argv[1]), argv[2:]
    out_dir = ck._BUILD_DIR / "myers_ab" / kernel
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = build(kernel, variant_sources(kernel, argv, out_dir), out_dir)
    if sass is not None:
        sass.parent.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(ck._nvcc()).with_name("cuobjdump")
        with open(sass, "w") as f:
            subprocess.run([str(cuobjdump), "-sass",
                            str(out_dir / "libkernel.so")], stdout=f,
                           check=True)
    line = chip_smoke.card_line()
    if kernel == "retrieval_segmax":
        peak = chip_smoke.bf16_peak_flops_per_s()
        print(f"{line}; bf16 dense peak {peak / 1e12:.1f} TFLOP/s", flush=True)
        cases = segmax_cases(peak)
    else:
        peak = chip_smoke.int32_peak_ops_per_s()
        print(f"{line}; int32 peak {peak / 1e12:.3f} Top/s", flush=True)
        cases = {"myers_tile": myers_cases, "jw_tile": jw_cases,
                 "intersect_tile": intersect_cases,
                 "myers_gathered": gathered_cases}[kernel](peak)
    for label, call, check, bounds in cases:
        live = {}
        for name, fn in fns.items():
            err = call(fn)
            torch.cuda.synchronize()
            if err == REFUSED and name != "kernel":
                print(f"myers_ab: {name} refuses {label}", flush=True)
                continue
            if err != 0 or not check():
                print(f"myers_ab: {name} differs from the plain version at "
                      f"{label} (launch status {err})", file=sys.stderr)
                return 1
            live[name] = fn
        rounds = {name: [] for name in live}
        for _ in range(ROUNDS):
            for name, fn in live.items():
                rounds[name].append(chip_smoke.cuda_ms_back_to_back(
                    lambda: ck._launched(kernel, call(fn)), RUNS))
        ms = {name: statistics.median(t) for name, t in rounds.items()}
        times = ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
        shares = "; ".join(f"{what} {b:.4f} ms ({b / ms['kernel']:.1%} of "
                           "kernel)" for what, b in bounds)
        print(f"{kernel} {label}, agrees with plain: ms {times}; {shares} "
              f"[{line}]", flush=True)
        del call, check
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
