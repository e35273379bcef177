"""Thread-aware SQLite connection management shared by the durable stores
(a copy of the JAX package's ``utils/sqlite.py``).

Both durable backends (links.sqlite.SqliteLinkDatabase and
store.records.SqliteRecordStore) serve the HTTP layer's threading model:
one writer at a time per workload but many reader/writer *threads* over the
process lifetime (ThreadingHTTPServer spawns one per connection).  SQLite
connections are cheap but per-thread, so the pool hands out one connection
per thread, prunes connections whose owning thread has exited, and tracks
the rest so close() releases every handle — the reference leaks its
Lucene/H2 handles on hot reload (SURVEY.md quirk Q7) and this is half of
that fix.

``':memory:'`` gets a single shared serialized connection instead (a
per-thread ``:memory:`` connection would be a *different* empty database
per thread); the sqlite3 module serializes access when the underlying
library is built threadsafe, which CPython requires since 3.11.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import weakref
from typing import Dict, Optional, Tuple


class SqliteConnectionPool:
    def __init__(self, path: str,
                 pragmas: Tuple[str, ...] = ("journal_mode=WAL",
                                             "synchronous=NORMAL")):
        self.path = path
        self._pragmas = pragmas
        self._lock = threading.Lock()
        # thread ident -> (weakref to thread, connection); idents can be
        # reused after a thread dies, so entries are replaced (and their
        # connections closed) on collision
        self._conns: Dict[int, Tuple[weakref.ref, sqlite3.Connection]] = {}
        self._closed = False
        self._local = threading.local()
        self._shared: Optional[sqlite3.Connection] = None
        if path == ":memory:":
            self._shared = sqlite3.connect(path, check_same_thread=False)
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def conn(self) -> sqlite3.Connection:
        if self._closed:
            raise sqlite3.ProgrammingError(
                f"connection pool for {self.path!r} is closed"
            )
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False so close()/pruning can release a
            # connection from a different thread; usage stays per-thread
            conn = sqlite3.connect(self.path, check_same_thread=False)
            for pragma in self._pragmas:
                conn.execute("PRAGMA " + pragma)
            thread = threading.current_thread()
            with self._lock:
                if self._closed:
                    conn.close()
                    raise sqlite3.ProgrammingError(
                        f"connection pool for {self.path!r} is closed"
                    )
                self._prune_dead_locked()
                stale = self._conns.pop(thread.ident, None)
                self._conns[thread.ident] = (weakref.ref(thread), conn)
            if stale is not None:
                self._close_quietly(stale[1])
            self._local.conn = conn
        return conn

    def _prune_dead_locked(self) -> None:
        """Drop connections owned by exited threads (called with _lock)."""
        dead = [ident for ident, (ref, _) in self._conns.items()
                if (t := ref()) is None or not t.is_alive()]
        for ident in dead:
            _, conn = self._conns.pop(ident)
            self._close_quietly(conn)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for _, c in self._conns.values()]
            self._conns = {}
        if self._shared is not None:
            self._shared.close()
            self._shared = None
        for conn in conns:
            self._close_quietly(conn)

    @staticmethod
    def _close_quietly(conn: sqlite3.Connection) -> None:
        try:
            conn.close()
        except sqlite3.Error:
            pass
