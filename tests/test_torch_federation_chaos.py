"""The port's kill-at-every-migration-site chaos differential (the
counterpart of tests/test_federation_chaos.py).

For each ``crash_at`` site of the live range migration, a port federation
process (tests/torch_federation_chaos_child.py, which imports only the
port) is SIGKILLed mid-migration and restarted; the restarted process
resumes the migration in the ``Federation`` constructor and must converge
to federated link rows and a drained ``?since=`` feed (timestamps
dropped) equal to an unmigrated control's -- no lost and no duplicated
link -- with the moved range owned by the target and thawed.  The port's
control equals the JAX package's (tests/federation_chaos_child.py on the
same corpus), and a folder either package's process was killed in at
``post_snapshot`` is resumed by the other package's process to the same
dump.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORT_CHILD = os.path.join(HERE, "torch_federation_chaos_child.py")
JAX_CHILD = os.path.join(HERE, "federation_chaos_child.py")
N_BATCHES = 6
MIGRATION_SITES = ["pre_freeze", "post_snapshot", "mid_replay",
                   "pre_cutover", "post_cutover"]


def _run_child(data, *, child=PORT_CHILD, fault="", migrate=False,
               dump=False, start=0):
    env = dict(os.environ)
    env["DUKE_FAULTS"] = fault
    env["DUKE_JOURNAL"] = "1"
    env.pop("DUKE_FLUSH_RETRIES", None)
    cmd = [sys.executable, child, "--data", str(data),
           "--batches", str(N_BATCHES), "--start", str(start)]
    if migrate:
        cmd.append("--migrate")
    if dump:
        cmd.append("--dump")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          env=env)
    acks = [int(line.split()[1]) for line in proc.stdout.splitlines()
            if line.startswith("ACK ")]
    dumps = [json.loads(line[5:]) for line in proc.stdout.splitlines()
             if line.startswith("DUMP ")]
    return proc, acks, (dumps[0] if dumps else None)


@pytest.fixture(scope="module")
def control_dump(tmp_path_factory):
    """The port's unmigrated control: same ingest, no migration."""
    proc, acks, dump = _run_child(tmp_path_factory.mktemp("ctrl") / "f",
                                  dump=True)
    assert proc.returncode == 0, proc.stderr
    assert acks == list(range(N_BATCHES)) and dump["links"], proc.stdout
    assert dump["owner"] == 0
    return dump


def _assert_differential(dump, control):
    assert dump["links"] == control["links"]
    assert dump["feed"] == control["feed"]
    assert dump["owner"] == 1  # the resumed migration really completed
    assert dump["frozen"] is False
    assert dump["migrations"]["resumed"] >= 1


def _assert_timeline(dump, *, resumed, full=True):
    """The newest retained timeline is the run's own ``_drive`` pass: every
    phase in order with non-negative durations; a crash after the
    persisted cutover leaves only the drain to redo."""
    tl = dump["timelines"][0]
    assert tl["resumed"] is resumed
    assert tl["outcome"] == "completed"
    phases = [p["phase"] for p in tl["phases"]]
    if full:
        assert phases == ["freeze", "snapshot", "replay", "cutover",
                          "drain"]
        snap = tl["phases"][1]
        assert snap["records"] >= 1 and snap["record_bytes"] > 0
        assert tl["phases"][0]["epoch"] < tl["phases"][3]["epoch"]
    else:
        assert phases == ["drain"]
    for p in tl["phases"]:
        assert p["duration_ms"] >= 0 and p["start_unix"] > 0


def test_port_control_equals_the_jax_control(control_dump, tmp_path):
    proc, acks, dump = _run_child(tmp_path / "f", child=JAX_CHILD,
                                  dump=True)
    assert proc.returncode == 0, proc.stderr
    assert acks == list(range(N_BATCHES))
    assert {k: dump[k] for k in ("links", "feed", "owner", "frozen",
                                 "migrations")} == \
        {k: control_dump[k] for k in ("links", "feed", "owner", "frozen",
                                      "migrations")}


@pytest.mark.parametrize("site", MIGRATION_SITES)
def test_migration_kill_differential(site, control_dump, tmp_path):
    """SIGKILL at the site mid-migration; the restarted federation
    resumes and converges to the unmigrated control's rows and feed."""
    data = tmp_path / "f"
    proc, acks, _ = _run_child(data, fault=f"crash_at={site}:1",
                               migrate=True)
    assert proc.returncode == -signal.SIGKILL, (
        f"child survived the {site} kill site: rc={proc.returncode}\n"
        f"{proc.stdout}\n{proc.stderr}")
    assert acks == list(range(N_BATCHES))  # died migrating, post-ingest
    proc2, _, dump = _run_child(data, migrate=True, dump=True,
                                start=N_BATCHES)
    assert proc2.returncode == 0, proc2.stderr
    _assert_differential(dump, control_dump)
    # the restarted process's ring holds exactly the constructor's resume
    # pass (the explicit re-migrate reports already_owned)
    assert len(dump["timelines"]) == 1
    _assert_timeline(dump, resumed=True, full=(site != "post_cutover"))


def test_clean_migration_matches_control(control_dump, tmp_path):
    data = tmp_path / "f"
    proc, acks, dump = _run_child(data, migrate=True, dump=True)
    assert proc.returncode == 0, proc.stderr
    assert acks == list(range(N_BATCHES))
    assert dump["links"] == control_dump["links"]
    assert dump["feed"] == control_dump["feed"]
    assert dump["owner"] == 1 and dump["frozen"] is False
    assert dump["migrations"]["completed"] == 1
    assert dump["migrations"]["resumed"] == 0
    assert len(dump["timelines"]) == 1
    _assert_timeline(dump, resumed=False)


def test_double_kill_still_converges(control_dump, tmp_path):
    """A kill mid-copy, then the resume itself killed at its cutover
    boundary: the third start still converges."""
    data = tmp_path / "f"
    proc, _, _ = _run_child(data, fault="crash_at=post_snapshot:1",
                            migrate=True)
    assert proc.returncode == -signal.SIGKILL
    proc2, _, _ = _run_child(data, fault="crash_at=pre_cutover:1",
                             migrate=True, start=N_BATCHES)
    assert proc2.returncode == -signal.SIGKILL, proc2.stdout + proc2.stderr
    proc3, _, dump = _run_child(data, migrate=True, dump=True,
                                start=N_BATCHES)
    assert proc3.returncode == 0, proc3.stderr
    _assert_differential(dump, control_dump)


@pytest.mark.parametrize("killed, resumed", [
    (JAX_CHILD, PORT_CHILD), (PORT_CHILD, JAX_CHILD)],
    ids=["jax-killed-port-resumes", "port-killed-jax-resumes"])
def test_killed_folder_resumes_in_the_other_package(killed, resumed,
                                                    control_dump, tmp_path):
    """A folder whose process was SIGKILLed at ``post_snapshot`` (the
    migration state file, the frozen map, unflushed journals) is resumed
    by the other package's process to the control's rows and feed."""
    data = tmp_path / "f"
    proc, acks, _ = _run_child(data, child=killed,
                               fault="crash_at=post_snapshot:1",
                               migrate=True)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert acks == list(range(N_BATCHES))
    assert os.path.exists(data / "federation" / "migration.json")
    proc2, _, dump = _run_child(data, child=resumed, migrate=True,
                                dump=True, start=N_BATCHES)
    assert proc2.returncode == 0, proc2.stderr
    _assert_differential(dump, control_dump)
    _assert_timeline(dump, resumed=True)
