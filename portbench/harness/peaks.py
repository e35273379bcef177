"""The table of peaks and the least time of the Myers tile work.

One NVIDIA H100 SXM: 3.35 TB/s of HBM (NVIDIA's data sheet); int32 ALU
work at 64 lanes per SM (the H100 architecture whitepaper) times the SMs
times the card's maximum SM clock.  The op count per pair is
``chip_smoke.py``'s: a pair with a non-empty pattern needs one text step
per corpus char, and each step of each 32-bit word of DP state needs at
least OPS_PER_WORD_STEP int32 instructions; the inputs are read once and
the (Q, C) int32 distances written once.  The count is of the work these
inputs need, whatever kernel computes it.
"""

import subprocess
import threading

PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
OPS_PER_WORD_STEP = 10


def nvidia_smi(query, fmt="csv,noheader"):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, check=True,
                         timeout=30)
    return out.stdout.strip().splitlines()[0]


def int32_peak_ops_per_s():
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def kernel_words(l):
    words = 1
    while 32 * words < l:
        words *= 2
    return words


def myers_least_seconds(q, c, l, steps, peak_ops):
    """The larger of the ops bound and the bytes bound of one tile call;
    ``steps`` = text steps the call's pairs need."""
    nbytes = 4 * (q * l + q + c * l + c) + 4 * q * c
    ops = steps * OPS_PER_WORD_STEP * kernel_words(l)
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak_ops)


class MyersWork:
    """Records each CUDA call of the port's Myers tile wrapper: its
    (Q, C, L) and, as a device scalar (no sync on the scoring path), the
    text steps its inputs need."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()
        self.active = False

    def wrap(self, wrapper):
        def recording(qchars, qlen, cchars, clen, *args, **kwargs):
            if self.active and qchars.is_cuda:
                steps = clen.double().sum() * (qlen > 0).sum()
                with self.lock:
                    self.calls.append((qchars.shape[0], cchars.shape[0],
                                       qchars.shape[1], steps))
            return wrapper(qchars, qlen, cchars, clen, *args, **kwargs)
        return recording

    def least_seconds(self, peak_ops):
        with self.lock:
            calls = list(self.calls)
        if not calls:
            return None
        import torch

        steps = torch.stack([s for *_, s in calls]).cpu().tolist()
        return sum(myers_least_seconds(q, c, l, st, peak_ops)
                   for (q, c, l, _), st in zip(calls, steps))
