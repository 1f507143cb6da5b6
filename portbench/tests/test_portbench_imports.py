"""What the benchmark imports: no module of portbench imports JAX or the JAX
package (whole top-level names compared: the port's name begins with the
JAX package's), and the reference imports nothing of the program."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "walk_these_ways_tpu"}
PROGRAM = "walk_these_ways_tpu_torch"


def modules(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        if ".cache" in d.split(os.sep) or "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every import in the file, those given to
    importlib.import_module or __import__ as a constant among them."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_jax_anywhere(path):
    assert not (imported(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", sorted(modules("reference")))
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert PROGRAM not in names and not (names & FORBIDDEN), path
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            # relative imports stay inside portbench.reference
            depth = os.path.relpath(path, os.path.join(HERE, "reference"))
            assert node.level <= len(depth.split(os.sep)), path


def test_the_yardstick_takes_nothing_of_the_program():
    """Only the set-up of the system under test names the program; the
    comparison, the arithmetic and the readers do not."""
    for name in ("check.py", "work.py", "trace.py", "capture.py",
                 "spec.py"):
        assert PROGRAM not in imported(os.path.join(HERE, name)), name
    for path in modules("metrics"):
        assert PROGRAM not in imported(path), path


def test_whole_name_compared():
    assert "walk_these_ways_tpu_torch".split(".")[0] not in FORBIDDEN
