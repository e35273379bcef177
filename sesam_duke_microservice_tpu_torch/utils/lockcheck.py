"""Runtime lock-order sanitizer (``DUKE_LOCKCHECK=1``).

The JAX package's module, for this package.  The static half of this
contract is ``docs/LOCK_HIERARCHY_TORCH.md``: the port's locks by
creation site and its inter-lock acquisition graph, written by hand in
the tables of the JAX package's generated ``docs/LOCK_HIERARCHY.md`` and
held to the code by ``tests/test_torch_lockcheck.py``.  This module is
the dynamic half: when
``DUKE_LOCKCHECK=1`` is set *before the package imports*, the
``threading.Lock``/``RLock``/``Condition`` factories are wrapped so that
every lock **created inside this package** becomes a thin recording
proxy.  Each proxy is named by its creation site, which the committed
hierarchy doc maps back to the static lock identity
(``Workload.lock``, ``WriteBehindBuffer._cv``, ...) — the same names the
static graph uses, so the two halves talk about the same objects.

What it checks, per acquisition, per thread:

  * **inversions against the static hierarchy** — acquiring ``B`` while
    holding ``A`` when the static graph orders ``B`` (transitively)
    before ``A``.  This is the would-be-deadlock class the hierarchy
    rules out; observing one at runtime means the code or the doc
    drifted, and the port's gate (tests/test_torch_lockcheck.py) fails.
  * **dynamic inversions** — ``(A, B)`` and ``(B, A)`` both observed at
    runtime, regardless of what the static graph knows.  Catches orders
    the static analyzer cannot see (callbacks, getattr dispatch).
  * **unknown edges** — observed nestings absent from the static graph.
    Reported (not fatal): each one is analyzer drift to triage, exactly
    the "dynamic validates static" loop the suite is built around.
  * **held-across-dispatch** — which locks were held while a blocking
    multi-host broadcast ran (``note_blocking``; its caller, the
    multi-host dispatch, is not part of this package yet).

Zero overhead when disabled: the factories are only patched when the
flag is set at import, and ``note_blocking`` no-ops.  The JAX package's
sanitizer reads the same flag: in a process that imports both, the first
to import patches the factories and keeps checking its own locks.  When
the JAX package's came first, this one stands aside (``enabled()`` is
false), so the JAX locks stay checked; when this one came first, each
factory looks past the other's frame to the real creator, and both
packages' locks are checked.

Usage::

    DUKE_LOCKCHECK=1 python tests/torch_lockcheck_child.py  # the port's
                                                   # gate (a test runs it)
    # or, in-process:
    from sesam_duke_microservice_tpu_torch.utils import lockcheck
    lockcheck.assert_clean()      # raises on recorded inversions
    lockcheck.report()            # full dict for tooling
"""

from __future__ import annotations

import _thread
import atexit
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

# Read raw: this runs from the package __init__ BEFORE telemetry (or any
# other module) imports, so that their module-level locks get wrapped
# too; importing telemetry.env here would create its locks unwrapped.
_ENABLED = os.environ.get(  # dukecheck: ignore[DK301] must run before telemetry.env can import
    "DUKE_LOCKCHECK", ""
).strip().lower() in ("1", "true", "yes", "on")

# originals, saved before any patching
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_THIS_FILE = os.path.abspath(__file__)
_PACKAGE_NAME = "sesam_duke_microservice_tpu_torch"
_PACKAGE_DIR = os.path.dirname(os.path.dirname(_THIS_FILE))
_REPO_ROOT = os.path.dirname(_PACKAGE_DIR)
DOC_RELPATH = os.path.join("docs", "LOCK_HIERARCHY_TORCH.md")

_state_lock = _REAL_LOCK()
_installed = False

# (site-name A, site-name B) -> witness "file:line" of B's acquisition:
# B was acquired while A was held
_observed_edges: Dict[Tuple[str, str], str] = {}
# static-order violations found live: (held, acquired, witness)
_inversions: List[Tuple[str, str, str]] = []
# blocking-region name -> set of held lock names observed
_blocking_holds: Dict[str, Set[str]] = {}

_tls = threading.local()

# static hierarchy, parsed lazily from the committed doc
_static_names: Optional[Dict[Tuple[str, int], str]] = None
_static_reach: Optional[Dict[str, Set[str]]] = None


def enabled() -> bool:
    return _ENABLED and _installed


# -- static hierarchy doc ------------------------------------------------------


def _parse_doc(text: str):
    """``(site -> name, name -> transitive successors)`` from the
    ``docs/LOCK_HIERARCHY_TORCH.md`` tables."""
    names: Dict[Tuple[str, int], str] = {}
    succ: Dict[str, Set[str]] = {}
    section = ""
    for line in text.splitlines():
        if line.startswith("## "):
            section = line[3:].strip()
            continue
        if not (line.startswith("|") and "`" in line):
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if section == "Locks" and len(cells) >= 3:
            name = cells[0].strip("`")
            rel, _, lineno = cells[2].rpartition(":")
            if rel and lineno.isdigit():
                names[(rel, int(lineno))] = name
        elif section.startswith("Acquisition-order") and len(cells) >= 2:
            a, b = cells[0].strip("`"), cells[1].strip("`")
            succ.setdefault(a, set()).add(b)
    # transitive closure (the graph is acyclic by DK101, but guard anyway)
    reach: Dict[str, Set[str]] = {}

    def visit(node: str) -> Set[str]:
        if node in reach:
            return reach[node]
        reach[node] = set()
        acc: Set[str] = set()
        for nxt in succ.get(node, ()):
            acc.add(nxt)
            acc |= visit(nxt)
        reach[node] = acc
        return acc

    for node in list(succ):
        visit(node)
    return names, reach


def _load_static() -> None:
    global _static_names, _static_reach
    if _static_names is not None:
        return
    try:
        with open(os.path.join(_REPO_ROOT, DOC_RELPATH),
                  encoding="utf-8") as f:
            _static_names, _static_reach = _parse_doc(f.read())
    except OSError:
        # no committed hierarchy (e.g. installed package): dynamic-only
        _static_names, _static_reach = {}, {}


def _site_name(filename: str, lineno: int) -> str:
    """Static lock identity for a creation site, else ``rel:line``."""
    _load_static()
    rel = os.path.relpath(filename, _REPO_ROOT).replace(os.sep, "/")
    return _static_names.get((rel, lineno), f"{rel}:{lineno}")


# -- per-thread bookkeeping ----------------------------------------------------


def _held() -> List[List]:
    # [[proxy, count, acquire-witness], ...] — acquisition order,
    # reentrancy-counted; the witness tells package-driven holds apart
    # from foreign (test-harness) holds
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _note_acquire(proxy: "_LockProxy") -> None:
    stack = _held()
    for entry in stack:
        if entry[0] is proxy:
            entry[1] += 1  # reentrant re-acquire: no new edge
            return
    caller = sys._getframe(1)
    while (caller is not None
           and caller.f_code.co_filename.endswith("lockcheck.py")):
        caller = caller.f_back
    if caller is None:  # pragma: no cover - interpreter teardown
        witness = "?"
    else:
        witness = "%s:%d" % (
            os.path.relpath(caller.f_code.co_filename,
                            _REPO_ROOT).replace(os.sep, "/"),
            caller.f_lineno,
        )
    _load_static()
    new_edges = []
    violations = []
    for entry in stack:
        held_name = entry[0].name
        if held_name == proxy.name:
            continue  # distinct instances of one class: ordered elsewhere
        if not entry[2].startswith(_PACKAGE_NAME + "/"):
            # the hold was taken by foreign code (a test pinning a
            # workload lock, a bench harness): not package nesting
            continue
        edge = (held_name, proxy.name)
        new_edges.append((edge, witness))
        # static contradiction: the hierarchy orders proxy.name before
        # held_name, so this acquisition closes a cycle
        if held_name in _static_reach.get(proxy.name, ()):
            violations.append((held_name, proxy.name, witness))
    if new_edges or violations:
        # only nested acquisitions pay for the global state lock — the
        # common flat-acquire case must not serialize every package lock
        # in the sanitizer leg through one process-wide mutex
        with _state_lock:
            for edge, wit in new_edges:
                _observed_edges.setdefault(edge, wit)
            for v in violations:
                _inversions.append(v)
    stack.append([proxy, 1, witness])


def _note_release(proxy: "_LockProxy") -> None:
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] is proxy:
            stack[i][1] -= 1
            if stack[i][1] <= 0:
                del stack[i]
            return


def note_blocking(region: str) -> None:
    """Record which instrumented locks the calling thread holds while
    entering a blocking region (multi-host broadcast).  No-op unless the
    sanitizer is installed."""
    if not enabled():
        return
    names = {entry[0].name for entry in _held()}
    if not names:
        return
    with _state_lock:
        _blocking_holds.setdefault(region, set()).update(names)


# -- proxies -------------------------------------------------------------------


class _LockProxy:
    """Recording wrapper over a real Lock/RLock."""

    __slots__ = ("_inner", "name", "site")

    def __init__(self, inner, name: str, site: str):
        self._inner = inner
        self.name = name
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<lockcheck {self.name} over {self._inner!r}>"


class _ConditionProxy:
    """Recording wrapper over a real Condition (own internal RLock).

    ``wait()`` releases the underlying lock, so the held-stack entry is
    popped for the duration — a lock acquired by ANOTHER thread while
    this one waits must not appear nested under the condition."""

    __slots__ = ("_inner", "name", "site")

    def __init__(self, inner, name: str, site: str):
        self._inner = inner
        self.name = name
        self.site = site

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            _note_acquire(self)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    def __enter__(self):
        self._inner.__enter__()
        _note_acquire(self)
        return self

    def __exit__(self, *exc):
        result = self._inner.__exit__(*exc)
        _note_release(self)
        return result

    def wait(self, timeout: Optional[float] = None) -> bool:
        _note_release(self)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquire(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _note_release(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquire(self)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<lockcheck {self.name} over {self._inner!r}>"


def _from_package(frame) -> bool:
    filename = frame.f_code.co_filename
    try:
        return os.path.abspath(filename).startswith(_PACKAGE_DIR + os.sep)
    except (TypeError, ValueError):  # pragma: no cover - exotic frames
        return False


def _creator(frame):
    """The frame that asked for the lock: past every sanitizer's factory
    (another package's sanitizer installed after this one calls this
    factory from its own ``utils/lockcheck.py``)."""
    while (frame is not None and frame.f_code.co_filename.endswith(
            os.path.join("utils", "lockcheck.py"))):
        frame = frame.f_back
    return frame


def _make_factory(real, kind: str):
    def factory(*args, **kwargs):
        frame = _creator(sys._getframe(1))
        if args or kwargs or frame is None or not _from_package(frame):
            # foreign creation site, or a Condition over an explicit
            # lock: hand back the real object untouched
            return real(*args, **kwargs)
        name = _site_name(frame.f_code.co_filename, frame.f_lineno)
        site = f"{frame.f_code.co_filename}:{frame.f_lineno}"
        if kind == "Condition":
            return _ConditionProxy(real(), name, site)
        return _LockProxy(real(), name, site)

    factory.__name__ = kind
    return factory


# -- lifecycle / reporting -----------------------------------------------------


def install_if_enabled() -> bool:
    """Patch the ``threading`` factories when ``DUKE_LOCKCHECK=1``.
    Called from the package ``__init__`` so every later module-level and
    instance lock in the package is wrapped.  Idempotent."""
    global _installed
    if not _ENABLED or _installed:
        return _installed
    if threading.Lock not in (_thread.allocate_lock, _thread.LockType):
        # another sanitizer (the JAX package's, on the same flag) already
        # patched the factories: wrapping its factory would hand it this
        # module's frame as the creator, and its locks would come back
        # unchecked.  Stand aside; this package's gate is a process that
        # imports only this package (tests/torch_lockcheck_child.py)
        return False
    threading.Lock = _make_factory(_REAL_LOCK, "Lock")
    threading.RLock = _make_factory(_REAL_RLOCK, "RLock")
    threading.Condition = _make_factory(_REAL_CONDITION, "Condition")
    _installed = True
    atexit.register(_atexit_report)
    return True


def reset() -> None:
    """Clear recorded state (tests)."""
    with _state_lock:
        _observed_edges.clear()
        _inversions.clear()
        _blocking_holds.clear()


def report() -> dict:
    with _state_lock:
        edges = dict(_observed_edges)
        inversions = list(_inversions)
        blocking = {k: sorted(v) for k, v in _blocking_holds.items()}
    # dynamic inversions: both orders of one pair observed at runtime
    dynamic = sorted(
        {tuple(sorted((a, b))) for (a, b) in edges if (b, a) in edges}
    )
    _load_static()
    # an edge whose REVERSE is statically ordered is an inversion, already
    # reported above — listing it under unknown_edges too would steer the
    # triager toward MANUAL_EDGES, which would just close a DK101 cycle
    unknown = sorted(
        f"{a} -> {b} @ {wit}" for (a, b), wit in edges.items()
        if b not in _static_reach.get(a, ())
        and a not in _static_reach.get(b, ())
        and ":" not in a + b
    )
    # edges involving a lock the hierarchy doc could not name (its
    # creation site has only the `rel:line` fallback identity): the
    # static graph cannot order these AT ALL, which is analyzer-naming
    # drift, not config drift — report them separately, never drop them
    unmapped = sorted(
        f"{a} -> {b} @ {wit}" for (a, b), wit in edges.items()
        if ":" in a or ":" in b
    )
    return {
        "enabled": enabled(),
        "edges_observed": len(edges),
        "static_inversions": [
            f"acquired `{b}` while holding `{a}` at {wit} — the static "
            f"hierarchy orders {b} before {a}"
            for (a, b, wit) in inversions
        ],
        "dynamic_inversions": [
            f"`{a}` and `{b}` acquired in both orders "
            f"({edges.get((a, b))} vs {edges.get((b, a))})"
            for (a, b) in dynamic
        ],
        "unknown_edges": unknown,
        "unmapped_lock_edges": unmapped,
        "held_across_dispatch": blocking,
    }


def inversions() -> List[str]:
    rep = report()
    return rep["static_inversions"] + rep["dynamic_inversions"]


def assert_clean() -> None:
    """Raise if any lock-order inversion was recorded (the tier-1
    ``DUKE_LOCKCHECK=1`` leg's acceptance gate)."""
    found = inversions()
    if found:
        raise AssertionError(
            "lockcheck recorded lock-order inversions:\n  "
            + "\n  ".join(found)
        )


def _atexit_report() -> None:  # pragma: no cover - process teardown
    rep = report()
    found = rep["static_inversions"] + rep["dynamic_inversions"]
    if found:
        print("lockcheck: LOCK-ORDER INVERSIONS RECORDED:",
              file=sys.stderr)
        for line in found:
            print("  " + line, file=sys.stderr)
    if rep["unknown_edges"]:
        print(
            "lockcheck: %d observed edge(s) missing from the static "
            "graph (add them to docs/LOCK_HIERARCHY_TORCH.md):"
            % len(rep["unknown_edges"]),
            file=sys.stderr,
        )
        for line in rep["unknown_edges"]:
            print("  " + line, file=sys.stderr)
