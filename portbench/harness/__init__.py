"""The benchmark's harness: generic over cells, configurations, traffic
mixes and per-layer metrics, which it finds by name (``spec``)."""
