"""Closed-loop client threads and the feed poller.

A client holds one keep-alive connection to the run's own server on the
loopback, sends POST bodies serialised in set-up, and sends the next only
when the reply has come, as a Sesam pipe does.  The poller reads the
workload's ``?since=`` feed once an interval from the last timestamp it
has seen, as a ``supports_since`` pipe does.
"""

import http.client
import json
import threading
import time

from .stats import Post

TIMEOUT_S = 300.0


class Connection:
    def __init__(self, port):
        self.port = port
        self.conn = None

    def request(self, method, path, body=None):
        """(status, body bytes); status -1 when the request failed.  A
        failed request is not sent again: a POST may have been applied."""
        if self.conn is None:
            self.conn = http.client.HTTPConnection(
                "127.0.0.1", self.port, timeout=TIMEOUT_S)
        try:
            headers = {"Content-Type": "application/json"} if body else {}
            self.conn.request(method, path, body=body, headers=headers)
            resp = self.conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            return -1, b""
        if resp.getheader("Connection", "").lower() == "close":
            self.close()
        return resp.status, data

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def send_posts(port, kind, name, client, numbers, until=None, out=None,
               start_gate=None):
    """Send ``client``'s bodies ``numbers`` in order, one at a time, until
    the ``perf_counter`` reading ``until``.  Appends a (number, Post) to
    ``out`` for each POST."""
    conn = Connection(port)
    path = f"/{kind}/{name}/{client.dataset}"
    if start_gate is not None:
        start_gate.wait()
    try:
        for m in numbers:
            t = time.perf_counter()
            if until is not None and t >= until:
                break
            status, _ = conn.request("POST", path, client.bodies[m])
            out.append((m, Post(client.number, client.post_records, t,
                                time.perf_counter(), status)))
    finally:
        conn.close()


def run_clients(port, kind, name, clients, numbers_of, until=None,
                start_gate=None):
    """Run one thread per client; returns {client number: [(m, Post)]}
    once every thread has ended (the caller bounds the wait)."""
    results = {c.number: [] for c in clients}
    threads = [threading.Thread(
        target=send_posts, name=f"portbench-client-{c.number}",
        args=(port, kind, name, c, numbers_of(c), until,
              results[c.number], start_gate), daemon=True)
        for c in clients]
    for t in threads:
        t.start()
    return threads, results


class Poller(threading.Thread):
    """Reads ``GET /{kind}/{name}?since=<last>`` every ``interval`` s."""

    def __init__(self, port, kind, name, since, interval):
        super().__init__(name="portbench-poller", daemon=True)
        self.conn = Connection(port)
        self.path = f"/{kind}/{name}"
        self.since = since
        self.interval = interval
        self.stop_event = threading.Event()
        self.reads = []          # (start, ms, status, rows)

    def read_once(self):
        t = time.perf_counter()
        status, body = self.conn.request("GET", f"{self.path}?since={self.since}")
        ms = (time.perf_counter() - t) * 1e3
        rows = json.loads(body) if status == 200 else []
        if rows:
            self.since = max(self.since, max(r["_updated"] for r in rows))
        self.reads.append((t, ms, status, len(rows)))

    def run(self):
        try:
            while not self.stop_event.wait(self.interval):
                self.read_once()
        finally:
            self.conn.close()


def read_feed(port, kind, name, since=0):
    """The whole feed after ``since`` (status, rows)."""
    conn = Connection(port)
    try:
        status, body = conn.request("GET", f"/{kind}/{name}?since={since}")
    finally:
        conn.close()
    return status, (json.loads(body) if status == 200 else [])
