"""The ring re-match scenarios tests/test_torch_rematch.py runs on both
packages (the JAX side in tests/torch_rematch_jax_child.py)."""

from test_rematch import _batch

TOMBSTONED = [
    {"_id": "1", "name": "Alan Turing", "email": "a@x.no"},
    {"_id": "2", "name": "Alan Turing", "email": "a@x.no"},
    {"_id": "3", "name": "Alan Turing", "email": "a@x.no", "_deleted": True},
]

# name -> (backend, entities bulk-imported without scoring)
SCENARIOS = {
    "device": ("device", _batch(30)),
    "sharded-brute": ("sharded-brute", _batch(30)),
    "sharded": ("sharded", _batch(30)),
    "tombstones": ("device", TOMBSTONED),
}


def live_links(wl):
    return sorted([r["entity1"], r["entity2"], float(r["confidence"]).hex()]
                  for r in wl.links_since(0) if not r["_deleted"])
