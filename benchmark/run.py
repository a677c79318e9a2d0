"""Run one cell of the benchmark of ``mermaid_classifier_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout. One
process per run: it makes its weights and inputs from ``--seed``, warms
the cell's own shapes (set-up), measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output::

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from the window's host spans and
from a stretch run under ``torch.profiler`` after the window. ``checks``
holds each number compared with its limit; they are also the last lines
on standard error.

A run needs as many CUDA cards as its cell asks for; without them it
exits 2 and prints no result. It exits 1, with no result, if the JAX
package or JAX itself was loaded in the process.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mermaid_classifier_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since this
    module was loaded."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def _finite(value):
    return value if isinstance(value, (int, float)) and math.isfinite(value) else None


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def profile_stretch(runner, span_names) -> dict:
    """Run the cell's stretch under the profiler and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace

    torch.cuda.synchronize()
    runner.spans.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.STRETCH):
                runner.stretch()
                torch.cuda.synchronize()
    finally:
        runner.spans.profiling = False
    return trace.summarize(prof.events(), span_names)


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, measure and check one cell on ``device``; the result's
    fields (``device`` without the card's name). The caller has checked
    for the card."""
    return measure(cell, seed, seconds, trace, device)[1]


def measure(cell, seed: int, seconds: float, trace: bool, device):
    """``run``, returning the cell's runner beside the result."""
    import torch

    from benchmark import compare

    driver = cell.driver()
    runner = driver.Cell(cell.config, cell.traffic, seed, device, trace)
    runner.setup()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    out = runner.window(seconds)
    info = {}
    if on_card:
        torch.cuda.synchronize()
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    result = {"attempted": int(out["attempted"]), "failed": int(out["failed"])}
    if trace:
        summary = profile_stretch(runner, driver.SPAN_NAMES) if on_card else {}
        record = {**runner.record, "trace": summary, "work": runner.stretch_work()}
        info["busy_s"] = summary.get("busy_s", 0.0)
        info["window_s"] = summary.get("window_s", 0.0)
        metrics = {}
        for metric in cell.per_layer:
            value = _finite(cell.reader(metric).read(record))
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    else:
        values = {"setup_s": setup_s, **out["metrics"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    runner.release()
    numbers = runner.check()
    limits = {name: entry["limit"] for name, entry in cell.limits.items()}
    if set(numbers) != set(limits):
        raise KeyError(f"the check's numbers {sorted(numbers)} and the limits"
                       f" {sorted(limits)} differ")
    correct, checks = compare.judge(numbers, limits)
    result["correct"] = bool(correct and result["failed"] == 0)
    result["metrics"] = metrics
    result["device"] = info
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return runner, result


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.manifest import Manifest

    cell = Manifest().cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    seed = int(args.seed) % (1 << 63)
    result = run(cell, seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 1
    line = result_line(result, torch.cuda.get_device_name(0), cell.chips)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(result: dict, kind: str, chips: int) -> dict:
    """The printed line: the contract's keys in order, ``breakdown`` only
    from a traced run, and the compared numbers last."""
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": {"platform": "gpu", "kind": kind, "count": chips, **result["device"]}}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
