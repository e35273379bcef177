"""Link model and the in-memory link database (the port keeps links in
memory only, as the JAX package does with ``persistent=False``)."""

from .base import Link, LinkDatabase, LinkKind, LinkStatus
from .memory import InMemoryLinkDatabase

__all__ = ["Link", "LinkDatabase", "LinkKind", "LinkStatus",
           "InMemoryLinkDatabase"]
