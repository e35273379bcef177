"""What the benchmark may import: no file of ``portbench/`` imports JAX,
jaxlib, flax or the JAX package (top-level module names compared whole:
the port's name begins with the JAX package's), the reference imports
nothing of the port and nothing beyond NumPy, plain PyTorch and the
standard library, and nothing reads the JAX package's old benchmarks."""

import ast
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sesam_duke_microservice_tpu"}
PORT = "sesam_duke_microservice_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def python_files():
    return sorted(BENCH.rglob("*.py"))


def test_every_file_imports_nothing_of_jax_by_whole_top_level_name():
    assert len(python_files()) > 10
    for path in python_files():
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


def test_the_port_name_is_not_mistaken_for_the_jax_package():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("sesam_duke_microservice_tpu")


def test_the_reference_imports_only_numpy_torch_and_the_standard_library():
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        names = top_level_imports(path)
        assert PORT not in names
        assert names <= allowed, f"{path.name}: {names - allowed}"


def test_nothing_reads_the_old_benchmarks():
    old = ("bench" + ".py", "benchmarks" + "/", "BENCH_" + "r0")
    for path in python_files():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in old:
            assert word not in text, f"{path.name} names {word}"
