#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``raytracer_tpu_torch``).

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, on
the card it is started on: set-up (scene, tables, warm-up), a window of
``--seconds``, then the check of what the window produced against the
plain reference (``rtbench/reference``). Its last line on standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, read from a profiler trace of the window), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
with its limit, also printed as the last lines of standard error.

Everything that belongs to one cell is found by name: the configuration
``rtbench/configs/<config>.json``, the traffic mix
``rtbench/traffic/<traffic>.json`` (its ``kind`` names the loop, the
module ``rtbench/<kind>.py``: its ``Loop(cell, device, fault)`` with
``window(seconds, spans, traced)`` and ``numbers(result, device,
traced)``), the limits ``rtbench/limits/<workload>.json`` and each
per-layer metric's reader ``rtbench/metrics/<metric>.py``.

It exits non-zero, and prints no result, without a CUDA card (or with
fewer than the cell asks for), and when ``jax``, ``jaxlib``, ``flax``,
``optax`` or the JAX package ``raytracer_tpu`` has been imported by the
time the result is ready to print.
"""

import time

_T0 = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "raytracer_tpu")
METRICS = HERE / "metrics"


def cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout, unless set."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(HERE / ".cache" / sub))


cache_env()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from rtbench import trace  # noqa: E402
from rtbench.spans import Spans  # noqa: E402


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    bench: dict
    entry: dict
    config: dict
    mix: dict
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, seed: int, overrides=None) -> Cell:
    """The cell's entry and its files; ``overrides`` replaces keys of
    the traffic mix (the CPU tests' small frames)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"rtbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    mix.update(overrides or {})
    limits_path = HERE / "limits" / f"{workload}.json"
    return Cell(workload, int(seed), bench, entry,
                load_json(HERE / "configs" / f"{entry['config']}.json"),
                mix, load_json(limits_path) if limits_path.exists() else {})


def load_kind(kind: str):
    """The loop module of a traffic kind, ``rtbench/<kind>.py``."""
    return importlib.import_module(f"rtbench.{kind}")


def metric_entries(cell: Cell, section: str) -> list:
    return [m for m in cell.bench[section]
            if cell.name in m.get("workloads", [cell.name])]


def read_metric(name: str, ctx: dict):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(cell: Cell, seconds: float, traced: bool, device,
             fault=None) -> dict:
    """Set-up, window and check of one run; the result's fields. The CPU
    tests call this with ``device="cpu"``; the command line never does."""
    loop = load_kind(cell.mix["kind"]).Loop(cell, device, fault)
    loop.clock.sync()
    setup_s = time.monotonic() - _T0
    spans = Spans(traced)
    prof = None
    if traced and torch.device(device).type == "cuda":
        # the device's activity alone: a host trace of every operation
        # would slow the window it measures
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    res = loop.window(seconds, spans, traced)
    if prof is not None:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    red = trace.reduce(prof, spans.intervals) if prof is not None else None
    t_check = time.monotonic()
    nums, work, failed = loop.numbers(res, device, traced)
    per = {k: round(v / max(res["units"], 1) * 1e3, 4)
           for k, v in spans.total.items()}
    print(f"rtbench: set-up {setup_s:.1f} s, window {res['seconds']:.1f} s,"
          f" check {time.monotonic() - t_check:.1f} s; host ms a unit by "
          f"span {per}; frame gaps ms p5/50/90/99 {res.get('gap_ms')}; "
          f"trace aligned {red and red['aligned']}; work {work}",
          file=sys.stderr)
    return {"setup_s": setup_s, "res": res, "spans": dict(spans.total),
            "red": red, "peak": peak, "numbers": nums, "work": work,
            "failed": failed}


def result_line(cell: Cell, out: dict, traced: bool, device) -> dict:
    res, nums = out["res"], out["numbers"]
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in nums.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(out["peak"])}
    line = {"correct": correct, "attempted": int(res["units"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if not traced:
        vals = dict(res, setup_s=out["setup_s"])
        for m in metric_entries(cell, "end_to_end"):
            if vals.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    else:
        red = out["red"]
        ctx = {"kind": cell.mix["kind"], "res": res, "spans": out["spans"],
               "trace": red, "work": out["work"],
               "window_s": res["seconds"]}
        for m in metric_entries(cell, "per_layer"):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if red is not None and red["busy_s"]:
            dev["busy_s"] = red["busy_s"]
            dev["window_s"] = res["seconds"]
            line["breakdown"] = trace.breakdown(red)
    line["checks"] = checks
    return line


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(cell: Cell, out: dict, traced: bool, device) -> int:
    """Print the run's result: each number compared with its limit on
    standard error, then the result's line, last on standard output;
    nothing, and a non-zero code, where a forbidden module has been
    imported (the metric readers too have run by then)."""
    line = result_line(cell, out, traced, device)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, args.seed)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seconds, bool(args.trace), device)
    return emit(cell, out, bool(args.trace), device)


if __name__ == "__main__":
    sys.exit(main())
