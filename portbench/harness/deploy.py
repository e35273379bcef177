"""The system under test, built from a configuration file, and what the
harness reads of it: the order in which its workload processed records,
its counters, the Myers tile calls, and the links it leaves on disk.

Everything here reaches the port through its public entry points
(``parse_config``, ``DukeApp``, ``serve``, the scheduler's ``submit``) and
reads its counters (``ProfileStats``, the scheduler's queue counters, the
per-app HTTP request counters, the kernel launch counts).  The one wrapper
it installs, around the workload's ``processor.deduplicate``, records each
batch's record ids before the batch runs: the arrival order that the
reference needs.
"""

import os
import threading


class System:
    def __init__(self, config, data_folder, device):
        from sesam_duke_microservice_tpu_torch.core.config import parse_config
        from sesam_duke_microservice_tpu_torch.service.app import DukeApp

        self.xml = config["duke_xml"].replace("{data_folder}", data_folder)
        sc = parse_config(self.xml, env=os.environ)
        self.app = DukeApp(sc, backend=config["backend"], device=device,
                           persistent=config["persistent"])
        workloads = (list(self.app.deduplications.values())
                     + list(self.app.record_linkages.values()))
        if len(workloads) != 1:
            raise ValueError("a benchmark configuration serves one workload")
        self.workload = workloads[0]
        self.kind = self.workload.kind
        self.name = self.workload.name
        self.batches = []
        self._batch_lock = threading.Lock()
        proc = self.workload.processor
        original = proc.deduplicate

        def recording(records):
            with self._batch_lock:
                self.batches.append([r.record_id for r in records])
            return original(records)

        proc.deduplicate = recording
        self.server = None
        self.thread = None
        wc = self.workload.config
        self.durable = (config["persistent"]
                        and wc.link_database_type == "h2")

    def serve(self):
        """Serve on an ephemeral loopback port on a thread of this
        process; returns the port."""
        from sesam_duke_microservice_tpu_torch.service.app import serve

        self.server = serve(self.app, port=0, host="127.0.0.1")
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="portbench-server", daemon=True)
        self.thread.start()
        return self.server.server_address[1]

    def ingest(self, dataset, rows):
        """One batch through the workload's own ingest entry (the
        scheduler, as a POST would go), not over HTTP."""
        sched = self.app.scheduler
        if sched is not None:
            sched.submit(self.kind, self.name, dataset, rows)
        else:
            if self.workload.submit_batch(dataset, rows) is None:
                raise RuntimeError("the workload closed during the preload")

    def counters(self):
        """A snapshot of the counters the per-layer metrics read."""
        from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck

        st = self.workload.processor.stats
        out = {f"proc.{k}": getattr(st, k) for k in (
            "batches", "records_processed", "pairs_compared",
            "pairs_rescored", "pairs_device_certified")}
        out["kernel_launches"] = dict(ck.LAUNCHES)
        out["phase_s"] = dict(self.workload.processor.phases.phase_seconds())
        sched = self.app.scheduler
        if sched is not None:
            for q in sched.queues():
                if (q.kind, q.name) == (self.kind, self.name):
                    out["sched.microbatches"] = q.microbatches
                    out["sched.merged_requests"] = q.merged_requests
                    out["sched.records_dispatched"] = q.dispatched_records
                    out["sched.wait_total_s"] = q.wait_hist.total
                    out["sched.wait_count"] = q.wait_hist.count
        posts = {}
        for _, labels, value in self.app.http_metrics.requests.collect().samples:
            lab = dict(labels)
            if lab.get("method") == "POST":
                posts[lab.get("status")] = posts.get(lab.get("status"), 0) + value
        out["http.posts"] = posts
        return out

    def shutdown(self):
        """Stop serving, join the server thread, close the app."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=60)
            self.server = None
        self.app.close()

    def durable_links(self):
        """{(id1, id2): confidence} of the live links in the workload's
        data folder once the app has closed: its link database opened
        anew, the journal replayed before the first read.  None where
        the deployment keeps its links in memory."""
        if not self.durable:
            return None
        from sesam_duke_microservice_tpu_torch.links import (
            create_link_database)
        from sesam_duke_microservice_tpu_torch.links.base import LinkStatus

        wc = self.workload.config
        overlap = os.environ.get("DUKE_RECOVERY_OVERLAP")
        os.environ["DUKE_RECOVERY_OVERLAP"] = "0"
        try:
            db = create_link_database(wc.link_database_type, wc.data_folder,
                                      is_record_linkage=wc.is_record_linkage)
        finally:
            if overlap is None:
                os.environ.pop("DUKE_RECOVERY_OVERLAP")
            else:
                os.environ["DUKE_RECOVERY_OVERLAP"] = overlap
        try:
            return {link.key(): link.confidence
                    for link in db.get_all_links()
                    if link.status != LinkStatus.RETRACTED}
        finally:
            db.close()


def delta(after, before):
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            b = before.get(k, {})
            out[k] = {kk: vv - b.get(kk, 0) for kk, vv in v.items()}
        else:
            out[k] = v - before.get(k, 0)
    return out
