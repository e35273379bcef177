"""CLI entrypoint: ``python -m sesam_duke_microservice_tpu_torch.service``.

Loads ``--config`` (an XML file), else ``CONFIG_STRING``, else the bundled
demo config, and serves the REST surface on ``--port`` (default ``PORT`` or
4567).  ``--device cuda`` (the default) scores on the GPU and fails without
one; ``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import logging

from ..core.config import load_default_config, parse_config
from ..env import env_int
from .app import DEFAULT_PORT, create_app, serve


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Duke record-matching microservice (PyTorch/CUDA port)")
    parser.add_argument("--config", metavar="XML",
                        help="service config file (default: CONFIG_STRING, "
                             "else the bundled demo config)")
    parser.add_argument("--port", type=int,
                        default=env_int("PORT", DEFAULT_PORT))
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)
    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            config = parse_config(f.read())
    else:
        config = load_default_config()
    app = create_app(config, device=args.device)
    server = serve(app, port=args.port, host=args.host)
    logging.getLogger("duke-torch-service").info(
        "Serving on %s:%d (device=%s)", args.host,
        server.server_address[1], app.device)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        app.close()


if __name__ == "__main__":
    main()
