"""Kill-differential child process for the port
(tests/test_torch_crash_recovery.py, and the crash case of chip_smoke.py).

One ingest process the harness can crash at an exact site and restart,
the port's counterpart of tests/crash_recovery_child.py:

  * builds ONE persistent dedup workload over ``--data`` with the port's
    ``device`` backend on ``--device`` -- journal recovery, snapshot load
    and store replay all run inside ``build_workload`` as in a real start;
  * ingests the deterministic duplicate-heavy corpus batch by batch,
    printing ``ACK <i>`` after each batch returns (the moment a client
    sees HTTP 200); the parent resumes a crashed run from the first
    unacked batch;
  * with ``DUKE_FAULTS=crash_at=<site>:<n>`` the process SIGKILLs itself
    at that site (utils.faults);
  * ``--dump`` prints ``DUMP <json>``: the link rows and the ``?since=``
    feed without timestamps (wall clocks differ across runs; everything
    else must be identical), the store's row count, the journal's pending
    batches, and the journal's torn-tail and replay counts.

Run as ``python tests/torch_crash_recovery_child.py --data DIR [--dump]``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_batches(n_batches: int, per_batch: int, identities: int = 4):
    """Record (b, i) carries identity ``(b*per_batch + i) % identities``,
    so every batch links internally and against earlier batches."""
    out = []
    for b in range(n_batches):
        rows = []
        for i in range(per_batch):
            ident = (b * per_batch + i) % identities
            name = f"person number {ident}"
            rows.append({"_id": f"r{b}_{i}", "name": name,
                         "email": f"{name.replace(' ', '.')}@x.no"})
        out.append(rows)
    return out


CONFIG = """
<DukeMicroService dataFolder="{data}">
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


def dump(wl) -> dict:
    links = sorted(
        (l.id1, l.id2, l.status.value, l.kind.value, round(l.confidence, 12))
        for l in wl.link_database.get_all_links())
    with wl.lock:
        feed = wl.links_since(0)
    for row in feed:
        row.pop("_updated", None)
    feed.sort(key=lambda r: r["_id"])
    db = wl.link_database
    journal = getattr(db, "journal", None)
    return {
        "links": links,
        "feed": feed,
        "store_rows": wl.record_store.count(),
        "journal_pending": (journal.pending_batches
                            if journal is not None else None),
        "torn": journal.torn_tails if journal is not None else 0,
        "replayed": getattr(db, "replayed", 0),
        "route": wl.restore_route,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--per-batch", type=int, default=6)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--close", action="store_true")
    # keep the process alive after the last ack so a crash site on the
    # background flusher thread is reached before exit reaps it
    ap.add_argument("--linger", type=float, default=0.0)
    args = ap.parse_args()

    from sesam_duke_microservice_tpu_torch.core.config import parse_config
    from sesam_duke_microservice_tpu_torch.engine.workload import (
        build_workload,
    )

    sc = parse_config(CONFIG.format(data=args.data),
                      env={"MIN_RELEVANCE": "0.05"})
    wl = build_workload(sc.deduplications["people"], sc, backend="device",
                        device=args.device, persistent=True)
    batches = make_batches(args.batches, args.per_batch)
    for i in range(args.start, args.batches):
        with wl.lock:
            wl.process_batch("crm", batches[i])
        print(f"ACK {i}", flush=True)
    if args.linger:
        import time

        time.sleep(args.linger)
    if args.dump:
        print("DUMP " + json.dumps(dump(wl)), flush=True)
    if args.close:
        with wl.lock:
            wl.close()
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
