"""The port's runtime lock-order sanitizer and its lock hierarchy.

* ``docs/LOCK_HIERARCHY_TORCH.md`` against the code: an AST scan of the
  port finds every ``threading.Lock`` / ``RLock`` / ``Condition`` it
  creates, and the doc's Locks table must name exactly those sites, by the
  names the sanitizer reports (``Class.attr`` for an instance lock,
  ``module.NAME`` for a module-level one);
* the doc's edge table has no cycle and names only listed locks;
* ``utils/lockcheck.py`` against the JAX package's module on the same
  synthetic nestings (an inversion of the static order, a dynamic
  inversion, an unknown edge): each recorded the same way;
* the gate: a child interpreter with ``DUKE_LOCKCHECK=1`` drives
  a CPU ``DukeApp`` through ingest and the streamed feed, a hot reload, an
  arena spill and fault-in, a prober cycle, and a ``sharded-brute``
  ingest and rematch (tests/torch_lockcheck_child.py); it must record no
  inversion and no edge the doc lacks.  ``tests/conftest.py`` gates only
  the JAX sanitizer, so the port's gate is this test.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from sesam_duke_microservice_tpu.utils import lockcheck as jlockcheck
from sesam_duke_microservice_tpu_torch.utils import lockcheck as tlockcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "sesam_duke_microservice_tpu_torch"
DOC = os.path.join(REPO, "docs", "LOCK_HIERARCHY_TORCH.md")
CHILD = os.path.join(REPO, "tests", "torch_lockcheck_child.py")
KINDS = ("Lock", "RLock", "Condition")


def lock_sites():
    """{(rel path, line): (name, kind)} of every lock the port creates."""
    out = {}
    root = os.path.join(REPO, PACKAGE)
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, REPO).replace(os.sep, "/")
            if rel == f"{PACKAGE}/utils/lockcheck.py":
                continue
            mod = rel[len(PACKAGE) + 1:-3].replace("/", ".")
            mod = mod[:-len(".__init__")] if mod.endswith(".__init__") else mod
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            _visit(tree, rel, mod, None, None, out)
    return out


def _lock_calls(node):
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "threading" and n.func.attr in KINDS
            and not n.args and not n.keywords]


def _visit(node, rel, mod, cls, func, out):
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.ClassDef):
            _visit(child, rel, mod, child.name, None, out)
            continue
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _visit(child, rel, mod, cls, func or child.name, out)
            continue
        if (isinstance(child, (ast.Assign, ast.AnnAssign))
                and child.value is not None):
            target = (child.targets[0] if isinstance(child, ast.Assign)
                      else child.target)
            for call in _lock_calls(child.value):
                if (isinstance(target, ast.Attribute) and cls
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    name = f"{cls}.{target.attr}"
                elif isinstance(target, ast.Name) and func is None:
                    name = f"{mod}.{target.id}"
                elif isinstance(target, ast.Name):
                    name = f"{mod}.{func}.{target.id}"
                else:
                    name = f"{rel}:{call.lineno}"
                out[(rel, call.lineno)] = (name, call.func.attr)
        _visit(child, rel, mod, cls, func, out)


def doc_tables():
    """({(rel, line): (name, kind)}, [(held, acquired)]) of the doc."""
    sites, edges, section = {}, [], ""
    with open(DOC, encoding="utf-8") as f:
        for line in f:
            if line.startswith("## "):
                section = line[3:].strip()
                continue
            if not (line.startswith("|") and "`" in line):
                continue
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if section == "Locks":
                rel, _, lineno = cells[2].rpartition(":")
                sites[(rel, int(lineno))] = (cells[0].strip("`"), cells[1])
            elif section.startswith("Acquisition-order"):
                edges.append((cells[0].strip("`"), cells[1].strip("`")))
    return sites, edges


def test_doc_lists_every_lock_site_of_the_port():
    code = lock_sites()
    doc, _ = doc_tables()
    assert len(code) >= 40
    missing = sorted(set(code) - set(doc))
    stale = sorted(set(doc) - set(code))
    assert not missing, f"lock sites missing from {DOC}: {missing}"
    assert not stale, f"{DOC} names sites with no lock: {stale}"
    for site, (name, kind) in code.items():
        assert doc[site] == (name, kind), (site, doc[site], (name, kind))
    # the sanitizer resolves each site to the same name
    for (rel, line), (name, _) in code.items():
        assert tlockcheck._site_name(os.path.join(REPO, rel), line) == name


def test_doc_edge_table_is_acyclic_over_listed_locks():
    sites, edges = doc_tables()
    names = {name for name, _ in sites.values()}
    assert edges
    for a, b in edges:
        assert a in names and b in names, (a, b)
        assert a != b
    succ = {}
    for a, b in edges:
        succ.setdefault(a, set()).add(b)
    done, active = set(), []

    def visit(node):
        assert node not in active, f"cycle: {active[active.index(node):]}"
        if node in done:
            return
        active.append(node)
        for nxt in sorted(succ.get(node, ())):
            visit(nxt)
        active.pop()
        done.add(node)

    for node in sorted(succ):
        visit(node)
    # the arena's lock is outer to every corpus's upload lock
    _, reach = tlockcheck._parse_doc(open(DOC, encoding="utf-8").read())
    assert "DeviceCorpus._upload_lock" in reach["DeviceArena._lock"]
    assert "DeviceArena._lock" not in reach.get(
        "DeviceCorpus._upload_lock", set())


SYNTHETIC = """
def run(lock):
    a, b, c, d, x, y = (lock(n) for n in "ABCDXY")
    with b:            # the static order puts A before B: an inversion
        with a:
            pass
    with c:            # C -> D and D -> C: a dynamic inversion
        with d:
            pass
    with d:
        with c:
            pass
    with x:            # X -> Y: an edge the hierarchy lacks
        with y:
            pass
"""


def _synthetic_report(mod, package, monkeypatch):
    """Run the synthetic nestings through ``mod``'s proxies as if from a
    module of ``package``; the report with the package name abstracted."""
    monkeypatch.setattr(mod, "_static_names", {})
    monkeypatch.setattr(mod, "_static_reach", {"A": {"B"}})
    mod.reset()
    path = os.path.join(mod._REPO_ROOT, package, "_synthetic_nesting.py")
    scope = {}
    exec(compile(SYNTHETIC, path, "exec"), scope)
    scope["run"](lambda n: mod._LockProxy(mod._REAL_LOCK(), n, n))
    try:
        text = json.dumps(mod.report(), sort_keys=True)
    finally:
        mod.reset()
    return json.loads(text.replace(package + "/", "PKG/"))


def test_lockcheck_records_like_the_jax_module(monkeypatch):
    jrep = _synthetic_report(jlockcheck, "sesam_duke_microservice_tpu",
                             monkeypatch)
    trep = _synthetic_report(tlockcheck, PACKAGE, monkeypatch)
    assert trep == jrep
    assert trep["static_inversions"] == [
        "acquired `A` while holding `B` at PKG/_synthetic_nesting.py:5 — "
        "the static hierarchy orders A before B"]
    assert len(trep["dynamic_inversions"]) == 1
    assert "`C` and `D`" in trep["dynamic_inversions"][0]
    assert trep["unknown_edges"] == [
        "C -> D @ PKG/_synthetic_nesting.py:8",
        "D -> C @ PKG/_synthetic_nesting.py:11",
        "X -> Y @ PKG/_synthetic_nesting.py:14"]
    assert trep["edges_observed"] == 4


BOTH_PACKAGES = r"""
import importlib, json, os, sys, threading
order = sys.argv[1].split(",")
checks = {p: importlib.import_module(p + ".utils.lockcheck") for p in order}

def made_in(package, kind):
    path = os.path.join(sys.argv[2], package, "_made_here.py")
    code = compile("threading.%s()" % kind, path, "eval")
    return eval(code, {"threading": threading})

out = {}
for package, check in checks.items():
    for kind in ("Lock", "RLock", "Condition"):
        lock = made_in(package, kind)
        with lock:
            pass
        out["%s %s" % (package, kind)] = [
            type(lock).__name__,
            isinstance(lock, (check._LockProxy, check._ConditionProxy)),
            check.enabled()]
print(json.dumps(out))
"""


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_lockcheck_leaves_the_jax_sanitizer_whole_in_one_process(first,
                                                                 tmp_path):
    """``DUKE_LOCKCHECK=1`` with both packages imported, in either
    order: a lock made in a JAX module is still the JAX sanitizer's
    proxy.  Imported first, the port's sanitizer checks its own locks
    too; imported second, it stands aside."""
    jax_pkg, torch_pkg = "sesam_duke_microservice_tpu", PACKAGE
    order = [jax_pkg, torch_pkg] if first == "jax" else [torch_pkg, jax_pkg]
    env = dict(os.environ, DUKE_LOCKCHECK="1", HOME=str(tmp_path),
               TMPDIR=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BOTH_PACKAGES, ",".join(order), REPO],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for kind in KINDS:
        name, checked, enabled = got[f"{jax_pkg} {kind}"]
        assert checked and enabled, (kind, name)
        name, checked, enabled = got[f"{torch_pkg} {kind}"]
        assert checked is enabled is (first == "torch"), (kind, name)


def test_lockcheck_child_records_no_inversion_and_no_unknown_edge(tmp_path):
    """The port's gate: DUKE_LOCKCHECK=1 installs at the port's
    import, and a run through the nesting paths is clean."""
    env = dict(os.environ, DUKE_LOCKCHECK="1", HOME=str(tmp_path),
               TMPDIR=str(tmp_path))
    for key in ("DEVICE_CHUNK", "DEVICE_QUERY_BUCKETS", "DEVICE_TOP_K",
                "DEVICE_MAX_CHARS", "DEVICE_MAX_GRAMS"):
        env.pop(key, None)  # the child pins its own small shapes
    try:
        proc = subprocess.run([sys.executable, CHILD], cwd=str(tmp_path),
                              env=env, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the lockcheck child ran past its timeout: {e}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["enabled"] is True
    assert rep["edges_observed"] >= 20
    assert rep["static_inversions"] == []
    assert rep["dynamic_inversions"] == []
    assert rep["unknown_edges"] == []
    assert rep["unmapped_lock_edges"] == []
