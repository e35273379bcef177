"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, and its entry points refuse to run silently on the CPU."""

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
FORBIDDEN = ("jax", "jaxlib", "sesam_duke_microservice_tpu")


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
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "sesam_duke_microservice_tpu_torch.ops.scoring" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_app(sc)
    wc = next(iter(sc.deduplications.values()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_workload(wc, sc)
    with pytest.raises(ValueError, match="only the 'device' backend"):
        build_workload(wc, sc, backend="host", device="cpu")
    app = DukeApp(sc, device="cpu")
    assert app.device.type == "cpu"
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
