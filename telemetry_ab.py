#!/usr/bin/env python3
"""What the decision recorder and the streamed append cost ingest, on one
NVIDIA GPU.

    python3 telemetry_ab.py [--records N] [--mixed-records N]

For each of ``chip_smoke.py``'s stresstest, mixed and ``ann`` workloads
(the ``ann`` corpus pre-sized to 524,288 rows, the fused retrieval), four
fresh in-memory apps take the same POSTs in 2,048-record batches, in the
order on, off, off, on, with ``DUKE_DECISION_RECORD`` at its default (on)
and at 0; then four stresstest apps the same way with
``DUKE_STREAM_APPEND``.  Each run prints its records/s (host clock, the
POSTs' wall) and, for the decision runs, the recorder's outcome counts,
latched records and ring size; every run of a pair must write the same
link feed.  Request tracing has no off switch (the JAX package's
neither): every run traces at the default ``TRACE_SAMPLE_RATE``.  The
card's name and power limit close each line.  Without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from unittest import mock

import chip_smoke as cs


def run(label, schema, backend, entities, env, line):
    """One fresh app: the POSTs' records/s, its feed rows, the
    recorder's state."""
    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    extra = ({"DEVICE_INITIAL_CAPACITY": str(cs.ANN_CAPACITY)}
             if backend == "ann" else {})
    with mock.patch.dict(os.environ, dict(env, **extra)):
        app = DukeApp(parse_config(cs.config_xml({"w": schema})),
                      backend=backend, device=cs.DEVICE, persistent=False)
        with cs.serving(app) as port:
            t0 = time.perf_counter()
            cs.ingest(port, "/deduplication/w/crm", entities)
            rps = len(entities) / (time.perf_counter() - t0)
            rows = cs.feed(port, "/deduplication/w")
            rec = app.deduplications["w"].processor.decisions
            state = (dict(rec.outcomes), rec.latched, len(rec.ring)
                     if rec.enabled else "off")
    return rps, cs.link_set(rows), state


def ab(name, schema, backend, entities, knob, line):
    out = []
    for label in ("on", "off", "off", "on"):
        env = {} if label == "on" else {knob: "0"}
        out.append((label,) + run(label, schema, backend, entities, env,
                                  line))
    if any(links != out[0][2] for _, _, links, _ in out):
        raise AssertionError(f"{name} {knob}: the feeds differ")
    print(f"{name} ({len(entities)} records, {backend}), {knob} on / 0 / 0 "
          f"/ on: records/s {[r[1] for r in out]}; recorder (outcomes, "
          f"latched, ring) {[r[3] for r in out]}; feeds equal "
          f"({len(out[0][2])} links) [{line}]", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--records", type=int, default=65536)
    parser.add_argument("--mixed-records", type=int, default=32768)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("telemetry_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(cs.REPO), str(cs.REPO / "tests")]
    from sesam_duke_microservice_tpu_torch import native
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

    ck.build_library()
    native.build_library()
    line = cs.card_line()
    stress = cs.stresstest_entities(cs.INGEST_RECORDS, 1234, "p")[
        :args.records]
    mixed = cs.mixed_entities(args.mixed_records, 2024, "m")
    ab("stresstest", cs.STRESS_SCHEMA, "device", stress,
       "DUKE_DECISION_RECORD", line)
    ab("mixed", cs.MIXED_SCHEMA, "device", mixed, "DUKE_DECISION_RECORD",
       line)
    ab("ann", cs.STRESS_SCHEMA, "ann", stress, "DUKE_DECISION_RECORD", line)
    ab("stresstest", cs.STRESS_SCHEMA, "device", stress,
       "DUKE_STREAM_APPEND", line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
