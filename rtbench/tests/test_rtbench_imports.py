"""No module of the benchmark or of the port imports JAX or the JAX
package (top-level names compared whole); the reference imports nothing
of the port."""

import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "raytracer_tpu"}


def imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("package", ("rtbench", "raytracer_tpu_torch"))
def test_no_jax_imports(package):
    bad = [(str(p.relative_to(ROOT)), m)
           for p in sorted((ROOT / package).rglob("*.py"))
           for m in imports(p) if m in FORBIDDEN]
    assert not bad, bad


def test_reference_imports_nothing_of_the_port():
    bad = [(str(p.relative_to(ROOT)), m)
           for p in sorted((ROOT / "rtbench" / "reference").rglob("*.py"))
           for m in imports(p) if m == "raytracer_tpu_torch"]
    assert not bad, bad


def test_runner_flags_forbidden_modules_by_top_level_name(monkeypatch):
    import sys

    from rtbench import run
    assert "raytracer_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_runner_without_a_card_prints_no_result(capsys):
    import torch

    from rtbench import run
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "scene1.fly", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "needs 1 CUDA card" in out.err


def test_runner_checks_modules_after_the_metric_readers(tmp_path,
                                                        monkeypatch, capsys):
    """A reader that loads JAX while the result is built leaves the run
    with no result."""
    import sys

    from conftest import small_cell
    from rtbench import run
    (tmp_path / "sneaky.py").write_text(
        "import sys, types\n\n\ndef read(ctx):\n"
        "    sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
        "    return 1.0\n")
    monkeypatch.setattr(run, "METRICS", tmp_path)
    had = "jax" in sys.modules
    cell = small_cell("scene1.fly", 3)
    cell.bench = dict(cell.bench, per_layer=[
        {"name": "sneaky", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "frame entry",
         "moves": "frame_ms", "workloads": [cell.name]}])
    out = {"setup_s": 1.0, "res": {"units": 3, "seconds": 1.0},
           "spans": {}, "red": None, "peak": 0, "numbers": {},
           "work": None, "failed": 0}
    try:
        rc = run.emit(cell, out, True, "cpu")
    finally:
        if not had:
            sys.modules.pop("jax", None)
    got = capsys.readouterr()
    assert rc != 0 and got.out == "" and "jax" in got.err
