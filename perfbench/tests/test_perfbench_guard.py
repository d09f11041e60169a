"""The import guard: no module of the benchmark imports JAX or the JAX
package, the reference imports nothing of the program, nothing reads the
JAX package's benchmark; and the run-time check compares whole top-level
names."""
import ast
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in SOURCES:
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        names = set(_imports(path))
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "contextlib", "typing", "torch",
                         "numpy", "math"}, (path, names)


def test_nothing_opens_the_jax_benchmark():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value, path
                assert "BENCH_pipeline" not in node.value, path
                assert "src/repro/" not in node.value, path


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.serving": 1, "jaxtyping": 1,
            "repro": 1, "repro.kernels": 1, "jaxlib.xla": 1, "flax": 1,
            "numpy": 1}
    assert harness.forbidden_modules(mods) == sorted(
        ["repro", "repro.kernels", "jaxlib.xla", "flax"])
