"""Child of tests/test_torch_lockcheck.py: drives a CPU ``DukeApp`` of the
port through the paths whose locks nest, under the runtime lock-order
sanitizer, and prints its report as JSON on the last line of stdout.

    DUKE_LOCKCHECK=1 python tests/torch_lockcheck_child.py

The paths: persistent ingest (record store, SQLite links behind
write-behind and the journal) with the streamed append, the streamed
``?since=`` feed, a hot config reload, an arena spill and fault-in
between two tenants, a canary-prober cycle, then a ``sharded-brute`` app
on an 8-shard CPU mesh: ingest, feed and ``POST .../rematch``; then a
three-group federation of ``device`` groups behind its plane: a federated
ingest, a feed page, a range probe cycle and a live range migration.
Exits non-zero when the sanitizer is off or a step fails.
"""

import json
import os
import sys
import tempfile
import threading
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for key, value in (("DEVICE_CHUNK", "64"), ("DEVICE_QUERY_BUCKETS", "8,32"),
                   ("DEVICE_TOP_K", "16"), ("DEVICE_MAX_CHARS", "24"),
                   ("DEVICE_MAX_GRAMS", "24"), ("DEVICE_UPDATE_SLICE", "8"),
                   ("DUKE_PROBE_INTERVAL_S", "3600"), ("FEED_PAGE_SIZE", "4"),
                   ("DUKE_ARENA", "1"), ("MIN_RELEVANCE", "0.05")):
    os.environ.setdefault(key, value)
sys.path.insert(0, REPO)

from sesam_duke_microservice_tpu_torch.utils import lockcheck  # noqa: E402

WORKLOAD = """
  <Deduplication name="{name}" link-database-type="h2">
    <duke>
      <schema>
        <threshold>{threshold}</threshold>
        <property><name>NAME</name><comparator>levenshtein</comparator><low>0.1</low><high>0.95</high></property>
        <property><name>EMAIL</name><comparator>exact</comparator><low>0.2</low><high>0.95</high></property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="email" property="EMAIL"/>
      </data-source>
    </duke>
  </Deduplication>"""


def config(folder, names, threshold="0.8"):
    body = "".join(WORKLOAD.format(name=n, threshold=threshold)
                   for n in names)
    return (f'<DukeMicroService dataFolder="{folder}">{body}\n'
            "</DukeMicroService>")


def batch(n, prefix):
    rows = []
    for i in range(n):
        name = f"person number {i - 1 if i % 3 == 2 else i}"
        rows.append({"_id": f"{prefix}{i}", "name": name,
                     "email": f"{name.replace(' ', '.')}@x.no"})
    return rows


def request(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def served(app):
    from sesam_duke_microservice_tpu_torch.service.app import serve

    server = serve(app, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def post(base, path, payload):
    status, body = request(base + path, json.dumps(payload).encode(),
                           {"Content-Type": "application/json"})
    assert status == 200, (path, status, body)
    return json.loads(body)


def main() -> int:
    if not lockcheck.enabled():
        print("the sanitizer is off: run with DUKE_LOCKCHECK=1",
              file=sys.stderr)
        return 2
    import torch

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine import sharded_matcher
    from sesam_duke_microservice_tpu_torch.ops.arena import ARENA
    from sesam_duke_microservice_tpu_torch.service.app import DukeApp

    with tempfile.TemporaryDirectory() as folder:
        app = DukeApp(parse_config(config(folder, ["a", "b"])),
                      device="cpu")
        server, base = served(app)
        try:
            # ingest (slices of DEVICE_UPDATE_SLICE stream once the
            # corpus is on the device) and the streamed feed
            post(base, "/deduplication/a/crm", batch(24, "a"))
            post(base, "/deduplication/a/crm", batch(24, "a2-"))
            assert json.loads(request(base + "/deduplication/a?since=0")[1])
            # the arena: a budget of one and a half tenants, so the second
            # tenant spills the first and the first faults back in
            lease = app.deduplications["a"].index.corpus._device_nbytes()
            ARENA._budget_bytes = lambda: float(lease * 3 // 2)
            post(base, "/deduplication/b/crm", batch(24, "b"))
            post(base, "/deduplication/a/crm", batch(8, "a3-"))
            assert ARENA.spills >= 1, ARENA.spills
            ARENA._budget_bytes = type(ARENA)._budget_bytes.__get__(ARENA)
            # a canary-prober cycle
            app.prober.run_cycle()
            # a hot reload (snapshot save, rebuild, swap, close)
            status, _ = request(
                base + "/config",
                config(folder, ["a", "b"], threshold="0.85").encode(),
                {"Content-Type": "application/xml"})
            assert status in (200, 302), status
            post(base, "/deduplication/a/crm", batch(8, "a4-"))
            request(base + "/metrics")
        finally:
            server.shutdown()
            app.close()

    # the mesh: sharded-brute on 8 logical CPU shards, ingest and rematch
    sharded_matcher.set_serving_devices([torch.device("cpu")] * 8)
    app = DukeApp(parse_config(
        "<DukeMicroService>"
        + WORKLOAD.format(name="m", threshold="0.8").replace(
            'link-database-type="h2"', 'link-database-type="in-memory"')
        + "\n</DukeMicroService>"), backend="sharded-brute", device="cpu",
        persistent=False)
    server, base = served(app)
    try:
        post(base, "/deduplication/m/crm", batch(30, "m"))
        before = json.loads(request(base + "/deduplication/m?since=0")[1])
        stats = post(base, "/deduplication/m/rematch", [])
        assert stats["devices"] == 8 and stats["queries"] == 30, stats
        after = json.loads(request(base + "/deduplication/m?since=0")[1])
        assert before == after
    finally:
        server.shutdown()
        app.close()

    # the federation: scatter ingest, the merged feed, the range prober
    # and a live migration (freeze, snapshot, replay, cutover, drain)
    from sesam_duke_microservice_tpu_torch.federation import Federation
    from sesam_duke_microservice_tpu_torch.service.federation_plane import (
        serve_federation)

    with tempfile.TemporaryDirectory() as folder:
        fed = Federation(parse_config(config(folder, ["f"])), n_groups=3,
                         ranges_per_group=2, backend="device", device="cpu")
        server = serve_federation(fed)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            post(base, "/deduplication/f/crm", batch(36, "f"))
            status, body = request(base + "/deduplication/f?since=")
            assert status == 200 and json.loads(body)
            server.RequestHandlerClass.range_prober.run_cycle()
            moved = next(r for r in fed.map.ranges() if r.group == 0)
            result = post(base, "/federation/migrate",
                          {"range": moved.range_id, "target": 1})
            assert result["moved_records"] > 0, result
            post(base, "/deduplication/f/crm", batch(12, "f2-"))
            request(base + "/metrics")
        finally:
            server.shutdown()
            fed.close()

    rep = lockcheck.report()
    print(json.dumps(rep, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
