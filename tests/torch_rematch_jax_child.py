"""Child of tests/test_torch_rematch.py: the JAX package's ``ring_rematch``
on its 8-device CPU mesh, in an interpreter of its own (the JAX ring
aborts a process in which certain service tests ran before it).

    python tests/torch_rematch_jax_child.py

Prints one JSON object: per scenario the rematch stats and the live links
(entity pair and confidence as a float hex) after it.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
for key, value in (("DEVICE_CHUNK", "64"), ("DEVICE_QUERY_BUCKETS", "8,32"),
                   ("DEVICE_TOP_K", "16"), ("DEVICE_MAX_CHARS", "24"),
                   ("DEVICE_MAX_GRAMS", "24"), ("DEVICE_PREWARM", "0"),
                   ("DUKE_PROBE_INTERVAL_S", "3600")):
    os.environ.setdefault(key, value)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main() -> int:
    from sesam_duke_microservice_tpu.core.config import parse_config
    from sesam_duke_microservice_tpu.engine.rematch import ring_rematch
    from sesam_duke_microservice_tpu.engine.workload import build_workload
    from test_rematch import XML, _batch, _bulk_import

    from torch_rematch_scenarios import SCENARIOS, live_links

    sc = parse_config(XML, env={"MIN_RELEVANCE": "0.05"})
    out = {}
    for name, (backend, entities) in SCENARIOS.items():
        wl = build_workload(sc.deduplications["people"], sc,
                            backend=backend, persistent=False)
        try:
            with wl.lock:
                _bulk_import(wl, entities)
                stats = ring_rematch(wl)
                stats.pop("seconds")
                out[name] = {"stats": stats, "links": live_links(wl)}
        finally:
            wl.close()
    assert _batch  # the scenarios are built from test_rematch's batch
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
