"""Crash-consistent ingest in the port: the kill differential and the
overlapped-recovery write fence.

For every ingest crash site a child process (tests/torch_crash_recovery_child.py,
the port's ``device`` backend on the CPU) is SIGKILLed mid-ingest and
restarted; the unacked suffix is re-sent (the at-least-once contract every
Sesam client implements) and the recovered link rows and ``?since=`` feed
must equal an uncrashed control's, timestamps excluded.  With
``DUKE_JOURNAL=0`` the acked batch is lost, as in the JAX package
(tests/test_crash_recovery.py).  While a journal replays, a scoring POST
answers 503 with ``Retry-After`` and every response carries
``X-Recovering``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from sesam_duke_microservice_tpu_torch.core.config import parse_config
from sesam_duke_microservice_tpu_torch.links import SqliteLinkDatabase
from sesam_duke_microservice_tpu_torch.links.journal import LinkJournal
from sesam_duke_microservice_tpu_torch.service.app import DukeApp, serve
from sesam_duke_microservice_tpu_torch.utils import faults

import torch_crash_recovery_child as child

CHILD = child.__file__
N_BATCHES = 6


def _run_child(data, *, fault="", start=0, dump=False, close=False,
               journal="1", linger=0.0):
    env = dict(os.environ)
    env["DUKE_FAULTS"] = fault
    env["DUKE_JOURNAL"] = journal
    env.pop("DUKE_FLUSH_RETRIES", None)
    cmd = [sys.executable, CHILD, "--data", str(data), "--start", str(start),
           "--batches", str(N_BATCHES), "--linger", str(linger)]
    if dump:
        cmd.append("--dump")
    if close:
        cmd.append("--close")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env)
    acks = [int(line.split()[1]) for line in proc.stdout.splitlines()
            if line.startswith("ACK ")]
    dumps = [json.loads(line[5:]) for line in proc.stdout.splitlines()
             if line.startswith("DUMP ")]
    return proc, acks, (dumps[0] if dumps else None)


@pytest.fixture(scope="module")
def control_dump(tmp_path_factory):
    proc, acks, dump = _run_child(tmp_path_factory.mktemp("ctrl") / "w",
                                  dump=True, close=True)
    assert proc.returncode == 0, proc.stderr
    assert acks == list(range(N_BATCHES)) and dump["links"], proc.stdout
    return dump


def _assert_differential(dump, control):
    assert dump["links"] == control["links"]
    assert dump["feed"] == control["feed"]
    assert dump["store_rows"] == control["store_rows"]
    assert dump["journal_pending"] == 0


# (site, occurrence, counter minimums in the recovered dump); the 4th
# arrival lands mid-corpus for every site
CRASH_SITES = [
    ("post_store_put", 4, {}),
    ("post_journal_append", 4, {"replayed": 1}),
    ("pre_flush", 4, {"replayed": 1}),
    ("mid_flush", 4, {"replayed": 1}),
    ("post_flush_pre_truncate", 4, {"replayed": 1}),
    ("mid_journal_write", 4, {"torn": 1}),
]


@pytest.mark.parametrize("site,nth,minimums", CRASH_SITES,
                         ids=[s for s, _, _ in CRASH_SITES])
def test_kill_differential(site, nth, minimums, control_dump, tmp_path):
    data = tmp_path / "w"
    proc, acks, _ = _run_child(data, fault=f"crash_at={site}:{nth}")
    assert proc.returncode == -signal.SIGKILL, (
        f"child survived the {site} crash site: rc={proc.returncode}\n"
        f"{proc.stdout}\n{proc.stderr}")
    assert len(acks) < N_BATCHES  # it died mid-corpus
    resume = (max(acks) + 1) if acks else 0
    proc2, _, dump = _run_child(data, start=resume, dump=True, close=True)
    assert proc2.returncode == 0, proc2.stderr
    _assert_differential(dump, control_dump)
    for key, minimum in minimums.items():
        assert dump[key] >= minimum, (key, dump)


def test_kill_differential_mid_snapshot_save(control_dump, tmp_path):
    """A crash between the snapshot's tmp write and its rename (the
    shutdown save): the restart ignores the torn tmp, replays the store
    and serves the control's link state."""
    data = tmp_path / "w"
    proc, acks, _ = _run_child(data, fault="crash_at=mid_snapshot_save:1",
                               close=True)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert acks == list(range(N_BATCHES))  # died during close
    folder = os.path.join(data, "deduplication", "people")
    assert [f for f in os.listdir(folder) if ".tmp." in f]
    assert "corpus_snapshot.npz" not in os.listdir(folder)
    proc2, _, dump = _run_child(data, start=N_BATCHES, dump=True,
                                close=True)
    assert proc2.returncode == 0, proc2.stderr
    assert dump["route"] == "replay"
    _assert_differential(dump, control_dump)


def test_kill_differential_journal_off_loses_the_acked_batch(
        control_dump, tmp_path):
    """DUKE_JOURNAL=0: a crash between the ack and the flush loses the
    acked batch's links for good (store rows survive)."""
    data = tmp_path / "w"
    proc, _, _ = _run_child(data, fault=f"crash_at=pre_flush:{N_BATCHES}",
                            journal="0", linger=30)
    assert proc.returncode == -signal.SIGKILL
    proc2, _, dump = _run_child(data, start=N_BATCHES, dump=True,
                                close=True, journal="0")
    assert proc2.returncode == 0, proc2.stderr
    assert dump["store_rows"] == control_dump["store_rows"]
    control_links = {tuple(l) for l in control_dump["links"]}
    recovered = {tuple(l) for l in dump["links"]}
    assert recovered < control_links  # strictly lost links
    assert dump["replayed"] == 0 and dump["torn"] == 0


def test_scoring_post_is_fenced_while_the_journal_replays(tmp_path,
                                                          monkeypatch):
    """Overlapped recovery: while the journal replays, a scoring POST
    answers 503 with ``Retry-After: 1`` and the JAX package's body, every
    response carries ``X-Recovering: 1``, and the feed serves the
    committed prefix; once the replay ends the POST is accepted."""
    for knob in ("DUKE_JOURNAL", "DUKE_RECOVERY_OVERLAP", "DUKE_WRITE_BEHIND"):
        monkeypatch.delenv(knob, raising=False)
    faults.configure("")
    sc = parse_config(child.CONFIG.format(data=tmp_path),
                      env={"MIN_RELEVANCE": "0.05"})
    folder = sc.deduplications["people"].data_folder
    app = DukeApp(sc, device="cpu", persistent=True)
    app.close()
    journal = LinkJournal(os.path.join(folder, "linkdatabase.journal"))
    journal.append_batch([("crm__x", "crm__y", "inferred", "duplicate",
                           0.9, 6)])
    journal.close()
    gate = threading.Event()
    real = SqliteLinkDatabase.assert_links

    def held(self, links):
        gate.wait(30)
        return real(self, links)

    monkeypatch.setattr(SqliteLinkDatabase, "assert_links", held)
    app = DukeApp(sc, device="cpu", persistent=True)
    server = serve(app, port=0, host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    body = json.dumps(child.make_batches(1, 4)[0]).encode()

    def post():
        req = urllib.request.Request(f"{base}/deduplication/people/crm",
                                     data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    try:
        assert app.recovering()
        status, headers, text = post()
        assert status == 503
        assert headers.get("Retry-After") == "1"
        assert headers.get("X-Recovering") == "1"
        assert text.decode() == (
            "The deduplication 'people' is replaying its link journal; "
            "writes resume when recovery completes.")
        with urllib.request.urlopen(
                f"{base}/deduplication/people?since=0", timeout=60) as resp:
            assert resp.status == 200
            assert resp.headers.get("X-Recovering") == "1"
            assert json.loads(resp.read()) == []
        gate.set()
        app.deduplications["people"].link_database._recovery_thread.join(30)
        assert not app.recovering()
        status, headers, _ = post()
        assert status == 200 and "X-Recovering" not in headers
        wl = app.deduplications["people"]
        assert wl.link_database.replayed == 1
        with wl.lock:
            ids = {(r["entity1"], r["entity2"]) for r in wl.links_since(0)}
        assert (None, None) in ids  # the replayed link (no such records)
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
        app.close()
        faults.configure(None)


def _serve_cli(config_path, *extra):
    """The port's CLI on a free port; returns (process, port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "sesam_duke_microservice_tpu_torch.service",
         "--config", str(config_path), "--port", "0", "--host", "127.0.0.1",
         "--device", "cpu", *extra],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, DUKE_FAULTS=""))
    for line in proc.stderr:
        if "Serving on" in line:
            return proc, int(line.split(":")[-1].split()[0])
    proc.kill()
    raise AssertionError(f"the service did not start (rc {proc.wait()})")


@pytest.mark.parametrize("ephemeral", [False, True],
                         ids=["persistent", "ephemeral"])
def test_cli_sigterm_closes_gracefully(tmp_path, ephemeral):
    """SIGTERM on the CLI drains the link flush and saves the snapshot:
    the journal is left empty beside the snapshot, and the next start
    takes the snapshot route.  ``--ephemeral`` writes nothing."""
    config = tmp_path / "duke.xml"
    config.write_text(child.CONFIG.format(data=tmp_path / "data"))
    proc, port = _serve_cli(config, *(["--ephemeral"] if ephemeral else []))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/deduplication/people/crm",
            data=json.dumps(child.make_batches(1, 8)[0]).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()
    folder = tmp_path / "data" / "deduplication" / "people"
    if ephemeral:
        assert not (tmp_path / "data").exists()
        return
    assert sorted(os.listdir(folder)) == [
        "corpus_snapshot.npz", "linkdatabase.journal", "linkdatabase.sqlite",
        "records.sqlite"]
    assert os.path.getsize(folder / "linkdatabase.journal") == 0
    sc = parse_config(config.read_text(), env={})
    app = DukeApp(sc, device="cpu", persistent=True)
    try:
        wl = app.deduplications["people"]
        assert wl.restore_route == "snapshot"
        with wl.lock:
            assert wl.links_since(0)
    finally:
        app.close()
        app.close()  # idempotent
