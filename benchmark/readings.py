"""The readings a cell's limits are set from, at the cell's own size on
the card: the program's numbers over many seeds (the lower readings), and
the control's and each fault's over the same seeds (the upper readings).

    python3 benchmark/readings.py --workload <cell> --seeds <n> [--first <seed>] [--seconds <s>]

For each seed it runs the cell as ``benchmark/run.py`` does, with a short
window, and reads the program's compared numbers. From the same run it
reads, against the same reference:

- bulk cells: the control, the reference computed in fp8 (e4m3, per-tensor
  scales) in the program's place; half of each trunk chunk left out, the
  mean of the other half in its place; one image's first two points'
  features swapped (an answer altered);
- the training cell: the control, the reference with TF32 matmuls in the
  program's place; and each of ``reference.mlp.FAULTS`` planted in the
  reference: half of each batch left out, the mean taken over the rest;
  every step of a call on its first batch (a step counter that never
  advances); the bias correction of step 1 at every step. A state left
  unchanged reads 1 on ``change_gap`` by definition.

Prints one JSON line per seed and a summary line. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import compare  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from benchmark.reference import efficientnet as ref_en  # noqa: E402
from benchmark.reference import mlp as ref_mlp  # noqa: E402
from benchmark.run import measure  # noqa: E402


def bulk_readings(runner) -> dict:
    c = runner.compared
    backbone = runner.config["backbone"]
    chunk = int(runner.config["extractor"]["backbone_batch"])
    fp8 = ref_en.EfficientNet(runner.variables, backbone, runner.device, precision="fp8")
    control = [fp8.features(runner.patches(img)).numpy() for img in c["images"]]
    half = []
    for want in c["want"]:
        out = want.copy()
        for s in range(0, len(want), chunk):
            n = min(chunk, len(want) - s)
            keep = max(1, n // 2)
            out[s + keep:s + n] = want[s:s + keep].mean(0)
        half.append(out)
    altered = [w[::-1].copy() for w in c["want"]]
    return {name: {"feature_gap": compare.feature_gap(rows, c["want"])}
            for name, rows in (("control_fp8", control), ("half_batch_mean", half),
                               ("answer_altered", altered))}


def train_readings(runner) -> dict:
    ref = runner.reference()
    out = {"control_tf32": runner.gaps(runner.as_program(*runner.reference(tf32=True)), ref)}
    for fault in ref_mlp.FAULTS:
        out[fault] = runner.gaps(runner.as_program(*runner.reference(fault=fault)), ref)
    return {**out, "counted_leaves": int(sum(compare.moving_leaves(ref[1]["grads"]))),
            "leaves": len(ref[1]["grads"])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first", type=int, default=3_000_000_001)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    cell = Manifest().cell(args.workload)
    rows = []
    for seed in range(args.first, args.first + args.seeds):
        runner, result = measure(cell, seed, args.seconds, False, "cuda:0")
        program = {k: v["value"] for k, v in result["checks"].items()}
        others = (bulk_readings(runner) if cell.traffic["kind"] == "bulk"
                  else train_readings(runner))
        row = {"seed": seed, "correct": result["correct"], "program": program, **others}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del runner
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": len(rows),
               "card": torch.cuda.get_device_name(0)}
    for name in rows[0]["program"]:
        values = [r["program"][name] for r in rows]
        summary[f"program.{name}.max"] = max(values)
        for kind, entry in rows[0].items():
            if isinstance(entry, dict) and name in entry and kind != "program":
                summary[f"{kind}.{name}.min"] = min(r[kind][name] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
