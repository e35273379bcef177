"""PyTorch/CUDA port of the Duke record-matching microservice.

Serves the reference REST surface for ``deduplication`` and
``recordlinkage`` workloads on the brute-force ``device`` backend, with the
pairwise Levenshtein kernels written by hand in CUDA for Hopper
(``csrc/myers_tile.cu``).  Module paths mirror the JAX package
``sesam_duke_microservice_tpu`` so each counterpart is easy to find; this
package imports nothing from it.
"""

__version__ = "0.1.0"
