"""CPU tests of the benchmark's harness: ``python -m pytest -q
rtbench/tests``. Tests marked ``card`` run only where a CUDA card is
present; the fixture decides, never the module's import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


def small_cell(workload, seed, width=32, height=24):
    """The cell at a frame small enough for the CPU, with its check's
    samples cut to match."""
    from rtbench import run
    cell = run.load_cell(workload, seed, {"width": width, "height": height,
                                          "warmup_frames": 1})
    if cell.mix["kind"] == "fly":
        cell.mix["check"] = dict(cell.mix["check"], frames=2,
                                 pixels=min(256, width * height),
                                 count_frames=2, count_pixels=64)
    return cell
