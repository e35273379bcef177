"""One process of the port's two-process serving group.

Each child is one rank of a 2-process ``torch.distributed`` job with
``--shards`` shards of its own on ``--device`` (``set_serving_devices``),
so the global mesh has twice as many.  Both enter the real service entry
point (``service.__main__.main``): process 0 becomes the HTTP frontend
and op dispatcher, process 1 the follower replay loop.  Imports nothing
of the JAX package.

Usage: torch_multihost_serving_child.py <process_id> <coordinator>
       <http_port> <backend> [--shards N] [--device cpu|cuda]
       [--ephemeral] [--counter-clock] [--report PATH]

``--counter-clock`` makes the link clock a counter from 1.7e12 (as
chip_smoke.py's ``LinkClocks``), so a feed's bytes can be compared with
another app's on the same traffic; ``--report`` writes, when the process
leaves the group, its hand kernels' launch counts, the collectives it
entered and the job's collective backend as JSON.  The parent sets
CONFIG_STRING, identical DEVICE_* knobs in both children and
DUKE_DISPATCH_HOST=127.0.0.1 (tests/test_torch_multihost_serving.py,
chip_smoke.py's multihost phase).
"""

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("process_id")
    parser.add_argument("coordinator")
    parser.add_argument("http_port")
    parser.add_argument("backend")
    parser.add_argument("--shards", type=int, default=2)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--ephemeral", action="store_true")
    parser.add_argument("--counter-clock", action="store_true")
    parser.add_argument("--report")
    args = parser.parse_args()
    os.environ["JAX_COORDINATOR_ADDRESS"] = args.coordinator
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = args.process_id

    import torch

    from sesam_duke_microservice_tpu_torch.engine import sharded_matcher
    from sesam_duke_microservice_tpu_torch.links import base as linkbase
    from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
    from sesam_duke_microservice_tpu_torch.parallel import multihost
    from sesam_duke_microservice_tpu_torch.service.__main__ import (
        main as svc_main,
    )

    if args.counter_clock:
        ticks = itertools.count(1_700_000_000_000)
        linkbase.now_millis = lambda: next(ticks)
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    sharded_matcher.set_serving_devices([device] * args.shards)
    backend = multihost.job().backend
    sys.argv = ["duke-service", "--port", args.http_port, "--host",
                "127.0.0.1", "--backend", args.backend, "--device",
                args.device] + (["--ephemeral"] if args.ephemeral else [])
    svc_main()
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"rank": int(args.process_id), "backend": backend,
                       "launches": dict(ck.LAUNCHES),
                       "collectives": dict(multihost.COLLECTIVES)}, f)


if __name__ == "__main__":
    main()
