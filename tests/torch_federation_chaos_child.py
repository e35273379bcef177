"""Federation migration kill-differential child of the port
(tests/test_torch_federation_chaos.py): tests/federation_chaos_child.py
with the port in place of the JAX package.  It imports only the port.

    python tests/torch_federation_chaos_child.py --data DIR [--migrate]
        [--dump] [--start N] [--backend host|device]

One federation process the harness can SIGKILL at an exact migration
site (``DUKE_FAULTS=crash_at=<site>:<n>``) and restart:

  * builds a 2-group federation over ``--data`` (journal recovery, store
    replay, the partition map's load and the resume of an interrupted
    migration all run inside the ``Federation`` constructor), its groups
    on ``--backend`` (``device`` on the CPU);
  * ingests the deterministic duplicate-heavy corpus through the scatter
    router, printing ``ACK <i>`` per batch;
  * with ``--migrate`` moves the keyspace's first range to group 1;
  * ``--dump`` prints ``DUMP <json>``: the federated link rows (each
    group's link DB filtered by current range ownership), the drained
    federated feed without timestamps, the moved range's owner and the
    migration counters and timelines.

The same folder layout as the JAX package's child, so a folder one
leaves behind the other opens.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_batches(n_batches: int, per_batch: int, identities: int = 4):
    out = []
    for b in range(n_batches):
        rows = []
        for i in range(per_batch):
            ident = (b * per_batch + i) % identities
            name = f"person number {ident}"
            rows.append({
                "_id": f"r{b}_{i}",
                "name": name,
                "email": f"{name.replace(' ', '.')}@x.no",
            })
        out.append(rows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--per-batch", type=int, default=6)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--migrate", action="store_true")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--backend", default="host")
    args = ap.parse_args()

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.federation import Federation
    from sesam_duke_microservice_tpu_torch.federation.ranges import route_key

    xml = f"""
<DukeMicroService dataFolder="{args.data}">
  <Deduplication name="people">
    <duke>
      <schema>
        <threshold>0.8</threshold>
        <property><name>NAME</name><comparator>levenshtein</comparator><low>0.1</low><high>0.95</high></property>
        <property><name>EMAIL</name><comparator>exact</comparator><low>0.2</low><high>0.95</high></property>
      </schema>
      <data-source class="io.sesam.dukemicroservice.IncrementalDeduplicationDataSource">
        <param name="dataset-id" value="crm"/>
        <column name="name" property="NAME"/>
        <column name="email" property="EMAIL"/>
      </data-source>
    </duke>
  </Deduplication>
</DukeMicroService>
"""
    sc = parse_config(xml, env={"MIN_RELEVANCE": "0.05"})
    # the constructor resumes an interrupted migration BEFORE serving
    fed = Federation(sc, n_groups=2, ranges_per_group=2,
                     backend=args.backend, device="cpu")

    batches = make_batches(args.batches, args.per_batch)
    for i in range(args.start, args.batches):
        fed.router.submit("deduplication", "people", "crm", batches[i])
        print(f"ACK {i}", flush=True)

    # the moved range: the keyspace's first range, which the pristine
    # round-robin map assigns to group 0 -- deterministic across runs.
    # After a resumed/completed migration it is already owned by group 1
    # and migrate() reports already_owned instead of re-moving.
    moved_id = f"{0:016x}"
    if args.migrate:
        result = fed.migrator.migrate(moved_id, 1)
        print(f"MIGRATED {json.dumps(result)}", flush=True)

    if args.dump:
        links = []
        for g in fed.groups:
            for wl in g.workloads.values():
                for l in wl.link_database.get_all_links():
                    if fed.map.owner(route_key(l.id1)).group == g.idx:
                        links.append([l.id1, l.id2, l.status.value,
                                      l.kind.value,
                                      round(l.confidence, 12)])
        links.sort()
        feed, token = [], ""
        while True:
            page = fed.router.feed_page("deduplication", "people", token,
                                        5000)
            feed.extend(page["rows"])
            token = page["next_since"]
            if page["drained"]:
                break
        for row in feed:
            row.pop("_updated", None)
        feed.sort(key=lambda r: r["_id"])
        print("DUMP " + json.dumps({
            "links": links,
            "feed": feed,
            "owner": fed.map.find(moved_id).group,
            "frozen": fed.map.find(moved_id).frozen,
            "migrations": fed.migrator.outcomes,
            # phase-timeline ring: newest-first, so [0] is the run's
            # own (possibly resumed) migration
            "timelines": fed.migrator.timelines_snapshot(),
        }), flush=True)

    fed.close()
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
