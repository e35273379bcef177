"""CLI entrypoint: ``python -m sesam_duke_microservice_tpu_torch.service``.

Loads ``--config`` (an XML file), else ``CONFIG_STRING``, else the bundled
demo config, and serves the REST surface on ``--port`` (default ``PORT`` or
4567).  ``--backend device`` (the default) scores by brute force,
``--backend ann`` by embedding cosine retrieval + exact rescoring,
``--backend sharded-brute`` / ``--backend sharded`` the same two over a
corpus split across one shard per visible card (``engine.sharded_matcher``),
``--backend host`` by the Lucene-parity inverted index and the host
processor (no device code; ``--device`` is ignored).  ``--device cuda``
(the default) scores on the GPU and fails without one; ``--device cpu``
runs the plain PyTorch path.  POSTs go through the ingest scheduler
unless ``DUKE_SCHEDULER=0``.  State persists in each
workload's data folder (``dataFolder`` in the config, else ``./data``)
unless ``--ephemeral`` keeps it in memory; SIGTERM/SIGINT shut down
gracefully (drain, flush, snapshot).

A serving group (``parallel.dispatch``): with ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` set, every process joins the
``torch.distributed`` job first (``parallel.multihost``); process 0
serves HTTP and dispatches the mesh ops (``--backend sharded`` or
``sharded-brute``), every other process runs the follower replay loop
(no HTTP, unless ``DUKE_REPLICA_HTTP_PORT`` serves its read plane or
``DUKE_PROMOTE_PORT`` lets it take over on leader loss).

A federation (``federation.Federation``): ``--federation N`` (or
``DUKE_FED_GROUPS``) serves N serving groups in this process behind the
digest-range partition router (``service.federation_plane``: scatter-gather
ingest and feeds, live range migration by ``POST /federation/migrate``),
each group's workloads on ``--backend`` and ``--device`` over
``<dataFolder>/federation/g<i>``; SIGTERM/SIGINT stop the plane and close
the groups.
"""

import argparse
import logging
import signal
import threading

from ..core.config import load_default_config, parse_config
from ..engine.workload import BACKENDS
from ..env import env_int
from ..federation import Federation
from .app import DEFAULT_PORT, create_app, install_shutdown_handlers, serve
from .federation_plane import serve_federation


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Duke record-matching microservice (PyTorch/CUDA port)")
    parser.add_argument("--config", metavar="XML",
                        help="service config file (default: CONFIG_STRING, "
                             "else the bundled demo config)")
    parser.add_argument("--port", type=int,
                        default=env_int("PORT", DEFAULT_PORT))
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--backend", choices=BACKENDS, default="device")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--ephemeral", action="store_true",
                        help="keep all state in memory (no data folder writes)")
    parser.add_argument("--federation", type=int,
                        default=env_int("DUKE_FED_GROUPS", 0), metavar="N",
                        help="serve a digest-range partition federation of "
                             "N serving groups instead of one group")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)
    # every line carries the request and trace ids the HTTP handler
    # stamps (telemetry.logctx); engine lines on the request thread
    # inherit them through the context vars
    from ..telemetry.logctx import install as install_request_ids

    install_request_ids()
    log = logging.getLogger("duke-torch-service")
    if args.federation >= 1:
        _serve_federation(args, log)
        return
    # a serving group: join the job first; process 0 becomes the HTTP
    # frontend and op dispatcher, every other process the follower
    # replay loop
    from ..parallel import multihost

    multihost.initialize(
        devices=multihost.default_local_devices(args.device))
    dispatcher = None
    try:
        if multihost.process_count() > 1:
            from ..parallel.dispatch import follower_main, start_dispatcher

            if multihost.process_index() != 0:
                log.info(
                    "process %d/%d: follower mode (frontend is process "
                    "0%s%s)", multihost.process_index(),
                    multihost.process_count(),
                    "; replica read plane on :%s" % env_int(
                        "DUKE_REPLICA_HTTP_PORT", 0)
                    if env_int("DUKE_REPLICA_HTTP_PORT", 0) else "",
                    "; promotes on leader loss to :%s" % env_int(
                        "DUKE_PROMOTE_PORT", 0)
                    if env_int("DUKE_PROMOTE_PORT", 0) else "")
                follower_main(device=args.device)
                return
        app = create_app(_load_config(args), backend=args.backend,
                         device=args.device, persistent=not args.ephemeral)
        if multihost.process_count() > 1:
            dispatcher = start_dispatcher(app)
        server = serve(app, port=args.port, host=args.host)
        install_shutdown_handlers(app, server)
        log.info(
            "Serving on %s:%d (backend=%s, device=%s, %s%s)", args.host,
            server.server_address[1], app.backend, app.device,
            "ephemeral" if args.ephemeral else "persistent",
            f", {multihost.process_count()} processes" if dispatcher
            else "")
        try:
            server.serve_forever()
        finally:
            server.server_close()
            app.close()  # idempotent: waits when the signal handler closes
            if dispatcher is not None:
                dispatcher.close()
    finally:
        multihost.shutdown()


def _load_config(args):
    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            return parse_config(f.read())
    return load_default_config()


def _serve_federation(args, log) -> None:
    """N serving groups in this process behind the partition router.  N=1
    is a legitimate federation (one group, the federated data layout and
    the /federation/* surface): falling back to the standalone service
    would read a different data layout."""
    fed = Federation(_load_config(args), n_groups=args.federation,
                     backend=args.backend, device=args.device)
    try:
        server = serve_federation(fed, port=args.port, host=args.host)
        log.info("Federation of %d groups serving on %s:%d (backend=%s, "
                 "device=%s)", args.federation, args.host,
                 server.server_address[1], args.backend, fed.device)
        stop = threading.Event()

        def _stop(signum, frame):
            log.info("signal %d: federation shutdown", signum)
            stop.set()

        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
        stop.wait()
        server.shutdown()
        server.server_close()
    finally:
        fed.close()
    log.info("shutdown complete")


if __name__ == "__main__":
    main()
