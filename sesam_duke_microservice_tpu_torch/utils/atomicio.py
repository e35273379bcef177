"""Crash-atomic small-file persistence (a copy of the JAX package's
``utils/atomicio.py``).

Beyond the classic tmp-write + fsync + ``os.replace`` sequence this also
fsyncs the parent DIRECTORY: ``os.replace`` is atomic against readers,
but the rename itself lives in the directory inode -- without the
directory sync a power cut can resurrect the OLD file even though
replace() returned.  The corpus snapshot's rename goes through
``replace_and_sync_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os


def atomic_write_json(path: str, doc) -> None:
    """Write ``doc`` as JSON at ``path`` such that every reader (and
    every restart) sees either the previous complete file or the new
    complete file -- never a torn intermediate."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    replace_and_sync_dir(tmp, path)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Binary flavor of the same dance."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    replace_and_sync_dir(tmp, path)


def replace_and_sync_dir(tmp: str, path: str) -> None:
    """``os.replace(tmp, path)`` and then fsync the directory holding
    ``path`` (best-effort where the platform can't open directories)."""
    os.replace(tmp, path)
    with contextlib.suppress(OSError):
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
