"""PyTorch/CUDA port of the Duke record-matching microservice.

Serves the reference REST surface for ``deduplication`` and
``recordlinkage`` workloads on the brute-force ``device`` backend (and
``ann``, ``sharded``, ``sharded-brute`` and ``host``), with the
pairwise Levenshtein kernels written by hand in CUDA for Hopper
(``csrc/myers_tile.cu``).  Module paths mirror the JAX package
``sesam_duke_microservice_tpu`` so each counterpart is easy to find; this
package imports nothing from it.
"""

__version__ = "0.1.0"

# DUKE_LOCKCHECK=1 runtime lock-order sanitizer: must install before any
# package module creates a lock, so it lives at the top of the package
# import (no-op -- not even a wrapper -- when the flag is unset)
from .utils import lockcheck as _lockcheck  # noqa: E402

_lockcheck.install_if_enabled()
