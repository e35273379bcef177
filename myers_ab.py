#!/usr/bin/env python3
"""Time variants of the Myers tile kernel side by side on one NVIDIA GPU.

    python3 myers_ab.py [--sass PATH] [NAME=PATH.cu ...]

Builds ``csrc/myers_tile.cu`` as it stands ("kernel"), three variants
made from it by text edits, and every further source given as NAME=PATH
(another version of the same file, with the same ``myers_tiles`` entry
point), one nvcc each, all at once, with the package's nvcc flags and
``-Xptxas -v`` (printed for "kernel"; with ``--sass PATH`` its machine
code, ``cuobjdump -sass``, is written to PATH):

  * "nosort": the rows of a block are staged in their order, not sorted
    by length;
  * "q1": one query per warp at every W (not two at W <= 2);
  * "tile1": one tile of 32 corpus rows per block at every W (not 4 at
    W = 1 and 2 at W = 2), so no sort either.

At each shape of ``chip_smoke.py``'s kernel phase for this kernel -- W = 1
at (2048, 8192, 32) and (4096, 8192, 32), on its synthetic rows and on
stresstest name rows; W = 2, 4, 8 at (2048, 8192, 32 W) -- every build is
held exactly against the plain version on the same inputs, then timed
round robin: 3 rounds of the median of 10 CUDA-event timings each, the
median of the rounds printed.  Beside the times, the bound of
``chip_smoke.myers_bound`` and the bound of the 22 + 4 operation count
that ``chip_smoke.py`` used before it was recounted (for comparison with
earlier times).  Exits non-zero without a CUDA device or if a build
disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke

REPO = Path(__file__).resolve().parent
SOURCE = REPO / chip_smoke.PACKAGE / "csrc" / "myers_tile.cu"
# variant name -> (text in the source, its replacement); each text must
# occur exactly once
EDITS = {
    "nosort": ("if constexpr (tiles<W>() > 1) {", "if constexpr (false) {"),
    "q1": ("return W <= 2 ? 2 : 1;", "return 1;"),
    "tile1": ("return W == 1 ? 4 : (W == 2 ? 2 : 1);", "return 1;"),
}
SHAPES = [("synthetic", (2048, 8192, 32)), ("names", (2048, 8192, 32)),
          ("synthetic", (4096, 8192, 32)), ("synthetic", (2048, 8192, 64)),
          ("synthetic", (2048, 8192, 128)), ("synthetic", (2048, 8192, 256))]
# the count chip_smoke.py's Myers bound used before its recount
OLD_OPS = (22, 4)
ROUNDS = 3
RUNS = 10


def variant_sources(extra, out_dir):
    """{name: path of its .cu}: the source, its edited variants, extras."""
    text = SOURCE.read_text()
    sources = {"kernel": SOURCE}
    for name, (old, new) in EDITS.items():
        if text.count(old) != 1:
            raise SystemExit(f"myers_ab: '{old}' is not in {SOURCE.name} "
                             "exactly once")
        path = out_dir / f"{name}.cu"
        path.write_text(text.replace(old, new))
        sources[name] = path
    for arg in extra:
        name, _, path = arg.partition("=")
        if not path or name in sources:
            raise SystemExit(f"myers_ab: bad source argument '{arg}'")
        sources[name] = Path(path).resolve()
    return sources


def build(sources, out_dir):
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
        fname, argtypes = ck._ENTRY["myers_tile"]
        fn = getattr(ctypes.CDLL(str(lib)), fname)
        fn.argtypes = argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("myers_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    out_dir = ck._BUILD_DIR / "myers_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    sass = None
    if argv[:1] == ["--sass"] and len(argv) > 1:
        sass, argv = Path(argv[1]), argv[2:]
    fns = build(variant_sources(argv, out_dir), out_dir)
    if sass is not None:
        sass.parent.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(ck._nvcc()).with_name("cuobjdump")
        with open(sass, "w") as f:
            subprocess.run([str(cuobjdump), "-sass",
                            str(out_dir / "libkernel.so")], stdout=f,
                           check=True)
    line = chip_smoke.card_line()
    peak_ops = chip_smoke.int32_peak_ops_per_s()
    print(f"{line}; int32 peak {peak_ops / 1e12:.3f} Top/s", flush=True)
    for rows, (q, c, l) in SHAPES:
        words = ck.kernel_words(l)
        if rows == "names":
            qc, ql, cc, cl = chip_smoke.name_inputs(q, c, l)
        else:
            qc, ql, cc, cl = chip_smoke.char_inputs(q, c, l, seed=q + l)
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((q, c), dtype=torch.int32, device="cuda")

        def run(fn):
            err = fn(qc.data_ptr(), ql.data_ptr(), cc.data_ptr(),
                     cl.data_ptr(), out.data_ptr(), q, c, l, words, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        want = ck.myers_distance_tiles_reference(qc, ql, cc, cl)
        for name, fn in fns.items():
            run(fn)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"myers_ab: {name} differs from the plain version at "
                      f"{(q, c, l)} ({rows} rows)", file=sys.stderr)
                return 1
        rounds = {name: [] for name in fns}
        for _ in range(ROUNDS):
            for name, fn in fns.items():
                rounds[name].append(chip_smoke.cuda_ms(lambda: run(fn), RUNS))
        ms = {name: statistics.median(t) for name, t in rounds.items()}
        bound_ms, _ = chip_smoke.myers_bound(qc, ql, cc, cl, peak_ops)
        old_ms, _ = chip_smoke.myers_bound(qc, ql, cc, cl, peak_ops, *OLD_OPS)
        times = ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
        print(f"W={words} {(q, c, l)} {rows} rows, exact: ms {times}; bound "
              f"{bound_ms:.4f} ms ({bound_ms / ms['kernel']:.1%} of kernel); "
              f"{OLD_OPS[0]}+{OLD_OPS[1]}-op bound {old_ms:.4f} ms "
              f"({old_ms / ms['kernel']:.1%}) [{line}]", flush=True)
        del qc, ql, cc, cl, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
