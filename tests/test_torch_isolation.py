"""The PyTorch port stands alone: it imports neither ``jax``, nor the JAX
package, nor ``ml_dtypes`` (absent where the card is), and its entry
points refuse to run silently on the CPU."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sesam_duke_microservice_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sesam_duke_microservice_tpu", "ml_dtypes")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import sesam_duke_microservice_tpu_torch\n"
        "import sesam_duke_microservice_tpu_torch.service.app\n"
        "import sesam_duke_microservice_tpu_torch.service.__main__\n"
        "import sesam_duke_microservice_tpu_torch.ops.cuda_kernels\n"
        "import sesam_duke_microservice_tpu_torch.engine.workload\n"
        "import sesam_duke_microservice_tpu_torch.engine.scheduler\n"
        "import sesam_duke_microservice_tpu_torch.index.inverted\n"
        "import sesam_duke_microservice_tpu_torch.engine.ann_matcher\n"
        "import sesam_duke_microservice_tpu_torch.native\n"
        "import sesam_duke_microservice_tpu_torch.ops.parallel_extract\n"
        "import sesam_duke_microservice_tpu_torch.ops.feature_cache\n"
        "import sesam_duke_microservice_tpu_torch.ops.embedding\n"
        "import sesam_duke_microservice_tpu_torch.utils.profiling\n"
        "import sesam_duke_microservice_tpu_torch.utils.faults\n"
        "import sesam_duke_microservice_tpu_torch.utils.atomicio\n"
        "import sesam_duke_microservice_tpu_torch.utils.backoff\n"
        "import sesam_duke_microservice_tpu_torch.utils.sqlite\n"
        "import sesam_duke_microservice_tpu_torch.store.records\n"
        "import sesam_duke_microservice_tpu_torch.links.sqlite\n"
        "import sesam_duke_microservice_tpu_torch.links.journal\n"
        "import sesam_duke_microservice_tpu_torch.links.write_behind\n"
        "import sesam_duke_microservice_tpu_torch.links.replica\n"
        "import sesam_duke_microservice_tpu_torch.service.metrics\n"
        "import sesam_duke_microservice_tpu_torch.service.homepage\n"
        "import sesam_duke_microservice_tpu_torch.telemetry.logctx\n"
        "import sesam_duke_microservice_tpu_torch.telemetry.tracing\n"
        "import sesam_duke_microservice_tpu_torch.telemetry.decisions\n"
        "import sesam_duke_microservice_tpu_torch.telemetry.rings\n"
        "import sesam_duke_microservice_tpu_torch.telemetry.env\n"
        "import sesam_duke_microservice_tpu_torch.engine.explain\n"
        "import sesam_duke_microservice_tpu_torch.service.debug\n"
        "import sesam_duke_microservice_tpu_torch.service.prober\n"
        "import sesam_duke_microservice_tpu_torch.ops.arena\n"
        "import sesam_duke_microservice_tpu_torch.ops.ivf\n"
        "import sesam_duke_microservice_tpu_torch.telemetry.probes\n"
        "import sesam_duke_microservice_tpu_torch.utils.numcheck\n"
        "import sesam_duke_microservice_tpu_torch.utils.lockcheck\n"
        "import sesam_duke_microservice_tpu_torch.parallel\n"
        "import sesam_duke_microservice_tpu_torch.parallel.sharded\n"
        "import sesam_duke_microservice_tpu_torch.parallel.ann_sharded\n"
        "import sesam_duke_microservice_tpu_torch.parallel.ring\n"
        "import sesam_duke_microservice_tpu_torch.engine.sharded_matcher\n"
        "import sesam_duke_microservice_tpu_torch.engine.rematch\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "sesam_duke_microservice_tpu_torch.ops.scoring" in loaded
    assert "sesam_duke_microservice_tpu_torch.ops.encoder" in loaded
    assert "sesam_duke_microservice_tpu_torch.native" in loaded
    # the durable-state modules, the scheduler and the host backend load
    # with the workload
    for mod in ("store.records", "links.write_behind", "links.journal",
                "utils.faults", "utils.atomicio", "utils.backoff",
                "engine.scheduler", "engine.processor", "index.inverted"):
        assert f"sesam_duke_microservice_tpu_torch.{mod}" in loaded
    # the control and read surface: the telemetry modules load with the
    # app, the feed materialization with the workload
    for mod in ("telemetry", "telemetry.registry", "telemetry.costs",
                "telemetry.slo", "telemetry.memory", "telemetry.logctx",
                "links.replica", "service.metrics", "service.homepage"):
        assert f"sesam_duke_microservice_tpu_torch.{mod}" in loaded
    # tracing, decisions, explain and the /debug surface load with the app
    for mod in ("telemetry.tracing", "telemetry.decisions",
                "telemetry.rings", "engine.explain", "service.debug"):
        assert f"sesam_duke_microservice_tpu_torch.{mod}" in loaded
    # the arena, the canary probe plane, numcheck and IVF load with the
    # app and the ann backend
    for mod in ("ops.arena", "telemetry.probes", "service.prober",
                "utils.numcheck", "ops.ivf"):
        assert f"sesam_duke_microservice_tpu_torch.{mod}" in loaded
    # the lock sanitizer loads with the package; the mesh and the ring
    # re-match with their modules
    for mod in ("utils.lockcheck", "parallel.sharded", "parallel.ann_sharded",
                "parallel.ring", "engine.sharded_matcher", "engine.rematch"):
        assert f"sesam_duke_microservice_tpu_torch.{mod}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_parallel_extract_worker_loads_no_jax_and_sees_no_card(monkeypatch):
    """A spawned extraction worker, after extracting an ``ann`` slab (it
    unpickles the encoder), holds no JAX module and no torch, and has the
    card hidden from it."""
    from sesam_duke_microservice_tpu_torch.core import comparators as C
    from sesam_duke_microservice_tpu_torch.core.config import DukeSchema
    from sesam_duke_microservice_tpu_torch.core.records import (
        ID_PROPERTY_NAME,
        Property,
        Record,
    )
    from sesam_duke_microservice_tpu_torch.ops import embedding as E
    from sesam_duke_microservice_tpu_torch.ops import features as F
    from sesam_duke_microservice_tpu_torch.ops import parallel_extract as PX

    monkeypatch.setenv("DEVICE_EXTRACT_WORKERS", "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    schema = DukeSchema(
        threshold=0.8, maybe_threshold=None, data_sources=[],
        properties=[Property(ID_PROPERTY_NAME, id_property=True),
                    Property("name", C.Levenshtein(), 0.3, 0.9),
                    Property("city", C.QGram(), 0.3, 0.9)])
    records = []
    for i in range(64):
        r = Record()
        r.add_value(ID_PROPERTY_NAME, f"r{i}")
        r.add_value("name", f"acme {i}")
        r.add_value("city", "oslo")
        records.append(r)
    try:
        out = PX.extract_batch_parallel(
            F.SchemaFeatures.plan(schema), records,
            encoder=E.RecordEncoder(schema, 32))
        assert out is not None and E.ANN_PROP in out
        with PX._POOL_LOCK:
            pool = PX._pool()
            # whichever worker answers has imported what a slab needs
            loaded = pool.submit(eval, (
                "[__import__(m) for m in ('sesam_duke_microservice_tpu_torch"
                ".ops.features', 'sesam_duke_microservice_tpu_torch.ops"
                ".embedding')] and sorted(__import__('sys').modules)"))
            visible = pool.submit(eval, "__import__('os').environ"
                                  ".get('CUDA_VISIBLE_DEVICES')")
            loaded, visible = loaded.result(60), visible.result(60)
    finally:
        PX._shutdown()
    assert "sesam_duke_microservice_tpu_torch.ops.embedding" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert "torch" not in loaded
    assert visible == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_file_imports_jax_or_the_jax_package():
    # chip_smoke.py imports tests/wide_units.py and tests/torch_longhand.py
    # and runs tests/torch_crash_recovery_child.py; myers_ab.py and
    # telemetry_ab.py import chip_smoke.py
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "myers_ab.py", REPO / "telemetry_ab.py",
        REPO / "tests" / "wide_units.py", REPO / "tests" / "torch_longhand.py",
        REPO / "tests" / "torch_crash_recovery_child.py"]
    assert len(files) > 15
    for mod in ("store/records.py", "links/journal.py",
                "links/write_behind.py", "links/sqlite.py", "utils/faults.py",
                "utils/sqlite.py", "utils/atomicio.py", "utils/backoff.py",
                "telemetry/__init__.py", "telemetry/registry.py",
                "telemetry/costs.py", "telemetry/slo.py",
                "telemetry/memory.py", "telemetry/logctx.py",
                "links/replica.py", "service/metrics.py",
                "service/homepage.py"):
        assert PORT / mod in files
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert bad == []


def _config():
    from sesam_duke_microservice_tpu_torch.core.config import (
        load_default_config,
    )

    return load_default_config(env={})


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from sesam_duke_microservice_tpu_torch.engine.workload import (
        build_workload,
    )
    from sesam_duke_microservice_tpu_torch.service.app import (
        DukeApp,
        create_app,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DukeApp(sc)
    # the default is persistent: it still refuses before touching a file
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DukeApp(sc, persistent=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_app(sc)
    wc = next(iter(sc.deduplications.values()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_workload(wc, sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DukeApp(sc, backend="ann")
    for backend in ("sharded", "sharded-brute"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DukeApp(sc, backend=backend)
    with pytest.raises(ValueError, match="'device', 'ann' and 'host'"):
        build_workload(wc, sc, backend="lucene", device="cpu")
    # the host backend runs no device code: it serves without a card
    app = DukeApp(sc, backend="host", persistent=False)
    assert app.device is None
    assert {type(wl.index).__name__ for wl in
            app.deduplications.values()} == {"InvertedIndex"}
    app.close()
    app = DukeApp(sc, device="cpu", persistent=False)
    assert app.device.type == "cpu"
    app.close()
    app = create_app(sc, backend="ann", device="cpu", persistent=False)
    assert {type(wl.processor).__name__ for wl in
            app.deduplications.values()} == {"AnnProcessor"}
    app.close()


def test_service_cli_without_a_gpu_exits_with_an_error():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("CONFIG_STRING", None)
    proc = subprocess.run(
        [sys.executable, "-m", "sesam_duke_microservice_tpu_torch.service",
         "--port", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
