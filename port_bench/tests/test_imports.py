"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either (top-level names compared
whole: the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = {"jax", "jaxlib", "flax", "sycl_points_tpu"}


def modules(root: str):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(modules(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not imported(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted(modules(os.path.join(HERE, "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_is_independent_of_the_program(path):
    assert not imported(path) & (JAX_SIDE | {"sycl_points_tpu_torch"})


def test_the_check_sees_whole_names():
    from port_bench import harness

    assert "sycl_points_tpu" in harness.FORBIDDEN and "sycl_points_tpu_torch" not in harness.FORBIDDEN
    assert not [n for n in ("sycl_points_tpu_torch.ops", "jaxtyping") if n.split(".")[0] in harness.FORBIDDEN]
