"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole: eogs2_tpu_torch begins with eogs2_tpu), and nothing under
benchmark/reference/ imports the program."""

import ast
import os

from tiny import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def imported(path):
    """The top-level names a module imports (relative imports left out)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: imported(p) & {"jax", "jaxlib", "flax", "eogs2_tpu"}
             for p in modules(BENCH)}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    found = {p: imported(p) & {"eogs2_tpu_torch", "eogs2_tpu", "jax"}
             for p in modules(ref)}
    assert not {p: n for p, n in found.items() if n}
    # nor any module of the benchmark outside the reference
    for p in modules(ref):
        assert imported(p) <= {"math", "typing", "numpy", "torch",
                               "benchmark", "__future__"}, p
        with open(p) as f:
            tree = ast.parse(f.read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), p


def test_whole_names_compared():
    assert "eogs2_tpu" not in {"eogs2_tpu_torch"}
    assert imported(os.path.join(BENCH, "kinds", "train.py")) & {"eogs2_tpu"} == set()
