"""No module of the benchmark imports jax or the JAX package, and the
plain reference imports nothing of the program: every import statement,
read by its syntax tree, compared by whole top-level name."""

import ast
import os

import pytest

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "mfcd_tpu"}


def _modules():
    for dirpath, dirs, files in os.walk(spec.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_imported(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "mfcd_tpu_torch" not in names
        assert names <= {"__future__", "math", "dataclasses", "typing",
                         "numpy", "torch", "portbench"}


def test_a_whole_name_compare():
    assert run.forbidden_modules({"mfcd_tpu_torch": 1, "mfcd_tpu_torch.x": 1,
                                  "numpy": 1}) == []
    assert run.forbidden_modules({"mfcd_tpu.cache": 1, "jax": 1,
                                  "jaxlib.xla": 1}) == ["jax", "jaxlib",
                                                        "mfcd_tpu"]
