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
"""

import argparse
import logging

from ..core.config import load_default_config, parse_config
from ..engine.workload import BACKENDS
from ..env import env_int
from .app import DEFAULT_PORT, create_app, install_shutdown_handlers, serve


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
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)
    # every line carries the request and trace ids the HTTP handler
    # stamps (telemetry.logctx); engine lines on the request thread
    # inherit them through the context vars
    from ..telemetry.logctx import install as install_request_ids

    install_request_ids()
    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            config = parse_config(f.read())
    else:
        config = load_default_config()
    app = create_app(config, backend=args.backend, device=args.device,
                     persistent=not args.ephemeral)
    server = serve(app, port=args.port, host=args.host)
    install_shutdown_handlers(app, server)
    logging.getLogger("duke-torch-service").info(
        "Serving on %s:%d (backend=%s, device=%s, %s)", args.host,
        server.server_address[1], app.backend, app.device,
        "ephemeral" if args.ephemeral else "persistent")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        app.close()  # idempotent: waits when the signal handler closes


if __name__ == "__main__":
    main()
