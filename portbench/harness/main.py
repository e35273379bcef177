"""One run of one cell: set-up, the measured window, the check, the line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``): import the port, build its kernels or
take them from its ``_build/``, make every entity and POST body from the
seed, build the app from the configuration file, preload the corpus in
2,048-record batches through the workload's ingest entry, serve the app on
an ephemeral loopback port on a thread of this process, warm it with
POSTs of the cell's own shape, and catch the poller up with the feed.
The window: the traffic file's closed-loop clients and the poller run for
``--seconds``; POSTs still in flight at the close are waited for (their
latency counts).  With ``--trace 1`` a ``torch.profiler`` trace covers the
window and the per-layer metrics are read.  After the window: the peak of
device memory, the whole link feed, the app shut down, a durable
deployment's links read back from its folder, the folder removed, the
run's own children listed (any one is killed and fails the run), then the
check against the plain reference and the last line.

Flags no check passes: ``--control`` judges the control (the reference in
float32 in the program's place) instead of the program's links, so such a
run comes out not correct; ``--rehearse`` runs on the CPU at a tiny size, with
``--rehearse-target-port``, ``--rehearse-watchdog``, ``--rehearse-fault``
and ``--rehearse-spawn-child`` for the tests of ``portbench/tests``.
"""

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time

from . import lifetime
from .spec import ROOT, Cell

# a run's budget: set-up when the kernels are already built, set-up when
# they are not (the first run in a checkout), and after the window
SETUP_LIMIT_S = 240.0
FIRST_SETUP_LIMIT_S = 900.0
AFTER_WINDOW_S = 150.0
RUN_LIMIT_S = 350.0
# a POST in flight at the close is waited for this long
STRAGGLER_S = 60.0
CACHE = ROOT / ".portbench_cache"
BUILD = ROOT / "sesam_duke_microservice_tpu_torch" / "_build"
REHEARSAL = {"preload_per_dataset": 512, "post_records": 64,
             "posts_per_client": 40, "pool_words": 300, "keys": 1500,
             "env": {"DEVICE_CHUNK": "256", "DEVICE_QUERY_BUCKETS": "16,64,256"}}
FORBIDDEN = ("jax", "jaxlib", "flax", "sesam_duke_microservice_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--rehearse-target-port", type=int)
    p.add_argument("--rehearse-watchdog", type=float)
    p.add_argument("--rehearse-fault", choices=("unchanged", "half", "alter",
                                                  "volatile"))
    p.add_argument("--rehearse-spawn-child", action="store_true")
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def note(msg):
    print(msg, file=sys.stderr, flush=True)


def set_environment(cell, args):
    env = dict(cell.config.get("env", {}))
    if args.rehearse:
        env.update(REHEARSAL["env"])
    if args.trace:
        # every request's spans retained: they name the idle gaps
        env.update(TRACE_SAMPLE_RATE="1", TRACE_RING_SIZE="1000000")
    env.update(TORCH_EXTENSIONS_DIR=str(CACHE / "torch_extensions"),
               TRITON_CACHE_DIR=str(CACHE / "triton"))
    os.environ.update(env)


def rehearsal_config(cell):
    config = json.loads(json.dumps(cell.config))
    traffic = dict(cell.traffic)
    config["preload_per_dataset"] = REHEARSAL["preload_per_dataset"]
    config["preload_batch"] = min(config["preload_batch"], 256)
    config["generator"]["pool_words"] = REHEARSAL["pool_words"]
    config["generator"]["key"] = [1, REHEARSAL["keys"]]
    traffic["post_records"] = min(traffic["post_records"],
                                  REHEARSAL["post_records"])
    traffic["posts_per_client"] = REHEARSAL["posts_per_client"]
    return config, traffic


class Run:
    def __init__(self, args, t0):
        self.args = args
        self.t0 = t0
        self.system = None
        self.data_folder = None
        self.torn_down = False
        self.children_found = []
        self.durable = None

    def teardown(self):
        if self.torn_down:
            return
        self.torn_down = True
        try:
            if self.system is not None:
                self.system.shutdown()
                try:
                    self.durable = self.system.durable_links()
                except Exception as e:
                    # what cannot be read back is not durable
                    note(f"reading the durable links failed: {e!r}")
                    self.durable = {}
        finally:
            if self.data_folder is not None:
                shutil.rmtree(self.data_folder, ignore_errors=True)
            self.children_found = lifetime.kill_children()

    def execute(self):
        args = self.args
        cell = Cell(args.workload)
        set_environment(cell, args)
        config, traffic = (rehearsal_config(cell) if args.rehearse
                           else (cell.config, cell.traffic))
        import torch

        cuda = not args.rehearse
        if cuda and (not torch.cuda.is_available()
                     or torch.cuda.device_count() < cell.chips):
            note(f"no CUDA device for a {cell.chips}-chip cell: "
                 f"available={torch.cuda.is_available()}")
            lifetime.leave(2)
        built = any(BUILD.glob("libmyers_tile-*.so"))
        if args.rehearse_watchdog is not None:
            deadline = self.t0 + args.rehearse_watchdog
        else:
            deadline = self.t0 + (SETUP_LIMIT_S if built
                                  else FIRST_SETUP_LIMIT_S)
        dog = lifetime.Watchdog(deadline).start()
        if args.rehearse_spawn_child:
            import subprocess

            subprocess.Popen(["sleep", "300"])
        device = "cuda" if cuda else "cpu"
        if cuda:
            from .peaks import nvidia_smi

            note(f"card: {nvidia_smi('name,power.limit')}")

        t_build = time.monotonic()
        from sesam_duke_microservice_tpu_torch import native
        from sesam_duke_microservice_tpu_torch.ops import cuda_kernels as ck
        if cuda:
            ck.build_library()
        native.build_library()
        note(f"kernel and host library build or load: "
             f"{time.monotonic() - t_build:.3f} s")

        from ..reference.schema import parse
        from .traffic import Plan

        datasets = [s.dataset for s in parse(config["duke_xml"]).sources]
        plan = Plan(config, traffic, datasets, args.seed)
        tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
        self.data_folder = tempfile.mkdtemp(prefix="portbench-", dir=tmp)

        from .deploy import System, delta
        from .peaks import MyersWork

        self.system = system = System(config, self.data_folder, device)
        if args.rehearse_fault:
            from .faults import plant

            plant(args.rehearse_fault, system)
        work = MyersWork()
        if args.trace:
            ck.myers_distance_tiles = work.wrap(ck.myers_distance_tiles)

        t_pre = time.monotonic()
        batch = config["preload_batch"]
        n = config["preload_per_dataset"]
        for lo in range(0, n, batch):
            for d in datasets:
                system.ingest(d, plan.preload[d].rows(lo, min(n, lo + batch)))
        note(f"preload of {n * len(datasets)} records: "
             f"{time.monotonic() - t_pre:.3f} s")

        port = system.serve()
        target = (args.rehearse_target_port
                  if args.rehearse_target_port is not None else port)
        from .clients import Poller, read_feed, run_clients

        kind, name = system.kind, system.name
        warm = plan.warm_posts
        threads, warm_sent = run_clients(target, kind, name, plan.clients,
                                         lambda c: range(warm))
        for t in threads:
            t.join(timeout=180)
        warm_ok = sum(p.ok for v in warm_sent.values() for _, p in v)
        note(f"warm-up: {warm_ok} of {warm * len(plan.clients)} POSTs "
             "answered 200")
        status, rows = read_feed(target, kind, name, 0)
        since = max((r["_updated"] for r in rows), default=0)
        poller = Poller(target, kind, name, since, traffic["poll_interval_s"])

        tracer = None
        if args.trace:
            from .devtrace import DeviceTracer

            tracer = DeviceTracer(cuda)
            tracer.start()
            work.active = True
        if cuda:
            torch.cuda.synchronize()
        before = system.counters()
        gate = threading.Event()
        t_start = time.perf_counter()
        t_end = t_start + args.seconds
        threads, sent = run_clients(
            target, kind, name, plan.clients,
            lambda c: range(warm, len(c.bodies)), until=t_end,
            start_gate=gate)
        setup_s = time.monotonic() - self.t0
        if args.rehearse_watchdog is None:
            dog.extend_to(min(time.monotonic() + args.seconds
                              + AFTER_WINDOW_S, self.t0 + RUN_LIMIT_S)
                          if built else
                          time.monotonic() + args.seconds + AFTER_WINDOW_S)
        gc_pauses = []
        gc_clock = {}

        def on_gc(phase, info):
            if phase == "start":
                gc_clock["t"] = time.perf_counter()
            elif "t" in gc_clock:
                gc_pauses.append((info["generation"],
                                  time.perf_counter() - gc_clock.pop("t")))

        gc.callbacks.append(on_gc)
        if tracer is not None:
            tracer.open_window()
        gate.set()
        poller.start()
        time.sleep(max(0.0, t_end - time.perf_counter()))
        if tracer is not None:
            tracer.close_window()
        gc.callbacks.remove(on_gc)
        poller.stop_event.set()
        for t in threads:
            t.join(timeout=max(0.1, t_end + STRAGGLER_S - time.perf_counter()))
        stragglers = sum(t.is_alive() for t in threads)
        poller.join(timeout=30)
        work.active = False
        after = system.counters()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        trace = tracer.stop() if tracer is not None else None

        exhausted = [c.number for c in plan.clients
                     if len(sent[c.number]) == len(c.bodies) - warm]
        from .stats import percentile, window_figures

        posts = [p for v in sent.values() for _, p in v]
        records_per_s, latencies = window_figures(posts, t_start, t_end)
        status, feed_rows = read_feed(target, kind, name, 0)
        spans = []
        if args.trace:
            from sesam_duke_microservice_tpu_torch.telemetry import tracing

            for summary in tracing.RECORDER.summaries():
                rec = tracing.RECORDER.get(summary["trace_id"])
                if rec is not None:
                    spans.extend((s.name, s.start_ns, s.end_ns)
                                 for s in rec.spans)
        peak_ops = None
        if trace is not None and cuda:
            from .peaks import int32_peak_ops_per_s

            peak_ops = int32_peak_ops_per_s()
        myers_least_s = (work.least_seconds(peak_ops)
                         if peak_ops is not None else None)
        window = delta(after, before)
        posts_seen = sum(window["http.posts"].values())
        kinds = dict(platform="gpu" if cuda else "cpu",
                     kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                     count=cell.chips if cuda else 1,
                     memory_peak_bytes=int(memory_peak))
        batches = list(system.batches)
        xml = system.xml

        self.teardown()
        dog.extend_to(max(dog.deadline, time.monotonic() + 30))

        from . import check

        t_check = time.monotonic()
        everything = {c: warm_sent[c] + sent[c] for c in sent}
        numbers, n_links = check.judge(
            xml, plan, everything, sum(len(v) for v in sent.values()),
            batches, feed_rows, posts_seen, config["limits"],
            durable=self.durable, control=args.control, device=device)
        note(f"reference and comparison: {time.monotonic() - t_check:.3f} s")
        numbers["feed_status"] = {"value": 0 if status == 200 else 1,
                                  "limit": 0}
        numbers["child_processes"] = {"value": len(self.children_found),
                                      "limit": 0}
        numbers["stragglers"] = {"value": stragglers, "limit": 0}
        numbers["traffic_exhausted"] = {"value": len(exhausted), "limit": 0}
        jax_loaded = forbidden_modules()
        numbers["jax_modules"] = {"value": len(jax_loaded), "limit": 0}
        if jax_loaded:
            note(f"forbidden modules loaded: {jax_loaded}")
            lifetime.leave(4)
        correct = check.passed(numbers)

        metrics = {}
        names = {m["name"]: m for m in cell.end_to_end}
        figures = {"records_per_s": records_per_s,
                   "post_p50_ms": percentile(latencies, 50),
                   "post_p95_ms": percentile(latencies, 95),
                   "setup_s": setup_s}
        run_data = RunData(trace, window, myers_least_s,
                           [ms for t, ms, st, _ in poller.reads
                            if st == 200 and t_start <= t < t_end])
        if not args.trace:
            for key, m in names.items():
                value = figures[key]
                if value is not None:
                    # a failed POST's infinite latency, as a JSON number
                    value = min(value, sys.float_info.max)
                    metrics[key] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell.per_layer:
                value = cell.readers[m["name"]].read(run_data)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if trace is not None:
                kinds["busy_s"] = trace.busy_s
                kinds["window_s"] = trace.window_s
        failed = sum(1 for p in posts if not p.ok
                     and t_start <= p.start < t_end)
        attempted = sum(1 for p in posts if t_start <= p.start < t_end)
        note(f"window: {attempted} POSTs, {failed} failed, "
             f"{records_per_s:.1f} records/s, {len(batches)} batches, "
             f"{n_links} reference links, {len(feed_rows)} feed rows; "
             f"figures {json.dumps(figures)}")
        note(f"counters over the window: {json.dumps(window)}")
        full = [t for g, t in gc_pauses if g == 2]
        note(f"garbage collector in the window: {len(gc_pauses)} "
             f"collections, {sum(t for _, t in gc_pauses):.3f} s; "
             f"{len(full)} full, {sum(full):.3f} s")
        step = max(1.0, args.seconds / 10)
        timeline = [0.0] * int(math.ceil(args.seconds / step))
        for p in posts:
            if p.ok and t_start <= p.end < t_end:
                timeline[int((p.end - t_start) / step)] += p.records
        note(f"records answered per {step:g} s of the window: "
             f"{[int(x) for x in timeline]}")
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": kinds}
        if trace is not None:
            result["breakdown"] = {"device_ops": trace.device_ops(),
                                   "idle_gaps": trace.idle_gaps(spans)}
        result["checks"] = numbers
        for key, n in numbers.items():
            note(f"check {key}: {n['value']!r} (limit {n['limit']!r})")
        print(json.dumps(result), flush=True)
        return 0


class RunData:
    """What a per-layer reader gets: the trace (or None), the counters'
    deltas over the window, the Myers tile work's least seconds, and the
    poller's read walls."""

    def __init__(self, trace, window, myers_least_s, polls_ms):
        self.trace = trace
        self.window = window
        self.myers_least_s = myers_least_s
        self.polls_ms = polls_ms


def main(argv, t0):
    args = parse_args(argv)
    run = Run(args, t0)
    code = 3
    try:
        code = run.execute()
    except Exception as e:
        # no result line: a run that could not finish has no numbers
        import traceback

        traceback.print_exc()
        note(f"the run failed: {e!r}")
        code = 3
    finally:
        run.teardown()
        lifetime.leave(code)
