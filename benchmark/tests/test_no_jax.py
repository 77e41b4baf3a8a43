"""Nothing under ``benchmark/`` imports JAX, flax or the JAX package, and
nothing under ``benchmark/reference/`` imports the measured program: each
imported module's top-level name compared whole (the program's name
begins with the JAX package's)."""

import ast
import os
import sys

import pytest

import core
from conftest import BENCH


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources(BENCH) for m in _imports(p)
             if m in core.FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    found = {(p, m) for p in _sources(os.path.join(BENCH, "reference"))
             for m in _imports(p) if m in core.FORBIDDEN + (core.PROGRAM,)}
    assert not found


def test_the_look_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "situation_recognition_tpu_torch_x",
                        object())
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert core.forbidden_loaded() == ["jaxlib"]


@pytest.mark.parametrize("cell", ["tiny-r"])
def test_a_run_refuses_to_print_a_result_after_loading_jax(checkout, cell,
                                                           tmp_path):
    # a module named like the JAX package, found first on the path
    fake = tmp_path / "situation_recognition_tpu"
    fake.mkdir()
    (fake / "__init__.py").write_text("")
    import subprocess

    from conftest import REPO
    code = ("import runpy, sys; import situation_recognition_tpu; "
            "sys.argv = ['benchmark/run.py', '--workload', 'tiny-r', "
            "'--seed', '1', '--seconds', '0.5', '--device', 'cpu']; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                       env={**os.environ,
                            "PYTHONPATH": f"{tmp_path}:{REPO}"},
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert "situation_recognition_tpu" in p.stderr
    assert not p.stdout.strip().endswith("}")
