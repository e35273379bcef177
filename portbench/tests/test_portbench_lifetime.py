"""A run's processes end with it: it serves in-process on an ephemeral
loopback port, its clients are threads, its watchdog ends an overrun, a
child it finds at the end is killed and fails the run, and a foreign
listener answering in its place fails it too."""

import http.server
import threading

from .rehearsal import rehearse


def test_a_rehearsal_run_is_correct_and_leaves_no_process(tmp_path):
    r = rehearse(tmp_path)
    assert r.code == 0, r.err[-3000:]
    assert r.line["correct"] is True, r.err[-3000:]
    assert r.check("child_processes") == 0
    assert r.check("requests_unseen") == 0
    assert r.leftovers == []
    assert list(tmp_path.glob("portbench-*")) == []


def test_the_watchdog_ends_an_overrunning_run(tmp_path):
    r = rehearse(tmp_path, "--rehearse-watchdog", "4")
    assert r.code == 3
    assert r.line["correct"] is False
    assert "watchdog" in r.line["error"]
    assert r.seconds < 30
    assert r.leftovers == []


def test_a_child_left_at_the_end_is_killed_and_fails_the_run(tmp_path):
    r = rehearse(tmp_path, "--rehearse-spawn-child")
    assert r.line["correct"] is False
    assert r.check("child_processes") == 1
    assert r.leftovers == []


class _Foreign(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _answer(self, body):
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self._answer(b'{"success": true}')

    def do_GET(self):
        self._answer(b"[]")

    def log_message(self, *args):
        pass


def test_a_run_pointed_at_a_foreign_listener_is_not_correct(tmp_path):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Foreign)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        r = rehearse(tmp_path, "--rehearse-target-port",
                     str(server.server_address[1]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert r.line["correct"] is False
    assert r.check("requests_unseen") > 0
    assert r.check("records_unprocessed") > 0
    assert r.leftovers == []
