"""On the card: a short run of each cell is correct, and its control (the
reference in float32 in the program's place) is not.  Skips without a
CUDA device; run on the chip with ``python -m pytest -m cuda
portbench/tests``."""

import json
import os
import subprocess
import sys

import pytest

from .rehearsal import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dedup-stresstest.pipes",
                                      "linkage-stresstest.pipes"])
def test_a_short_card_run_is_correct_and_its_control_is_not(tmp_path,
                                                             workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    lines = {}
    for flags in ((), ("--control",)):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", workload,
             "--seed", "2147483999", "--seconds", "5", "--trace", "0",
             *flags], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=900)
        lines[flags] = (json.loads(out.stdout.strip().splitlines()[-1]),
                        out.stderr[-3000:])
    line, err = lines[()]
    assert line["correct"] is True, err
    control, err = lines[("--control",)]
    assert control["correct"] is False, err
    gap = control["checks"]["confidence_gap"]
    assert gap["value"] > gap["limit"]
