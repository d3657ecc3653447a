"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port, ``repro_torch``, starts with ``repro``);
the reference imports nothing of the program either; nothing reads the
JAX package's benchmark folder."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p.name: imported(p) & JAX for p in sources()}
    assert not any(found.values()), found
    assert "repro_torch" in imported(HERE / "harness.py")  # whole names: the port is not the JAX package


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "workcount.py", "generator.py", "datagen.py", "devtrace.py"):
        assert imported(HERE / name) <= {"__future__", "torch", "numpy", "joinbench", "typing", "re", "bisect",
                                         "dataclasses", "statistics"}, name


def test_nothing_reads_the_jax_benchmark_folder():
    for p in sources():
        if not p.name.startswith("test_"):
            assert "benchmarks" not in p.read_text(), p
