"""The port's run report (``tracking/report.py``) and its pandas-free CSV
table (``common/html_table.py``) against the JAX package.

- One run directory, logged by the port's tracker with params, metric
  histories, CSV tables, a PNG figure (matplotlib imports on the CPU),
  JSON, YAML, text, a CSV past 200 rows and one that does not parse, is
  rendered by the JAX ``generate_report`` and by the port's: the HTML is
  byte-equal.
- A case table of CSV columns, one per trap (dtype inference, blanks in an
  int column, pandas' NA strings, per-column float formatting, escaping,
  bool columns, short rows, an implicit index, duplicate names), and
  seeded random tables: the port's reader and writer give the bytes of
  ``pd.read_csv`` + ``to_html(index=False, border=0)``; pandas is used
  here only, never in the port.
- A file that does not parse gives the JAX block's prefix
  ``<pre>failed to read <name>: `` (pandas' exception text is its own).
- The report renders in a fresh interpreter without importing pandas or
  matplotlib, and the ``generate_report`` CLI writes the same bytes.
"""

import csv
import io
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from mermaid_classifier_tpu.tracking import report as jreport  # noqa: E402
from mermaid_classifier_tpu.tracking.local_tracker import LocalTracker as JTracker  # noqa: E402
from mermaid_classifier_tpu_torch.common.html_table import (  # noqa: E402
    CsvParseError,
    parse_csv_text,
)
from mermaid_classifier_tpu_torch.tracking import report as treport  # noqa: E402
from mermaid_classifier_tpu_torch.tracking.local_tracker import (  # noqa: E402
    LocalTracker as TTracker,
)

REPO = Path(__file__).resolve().parents[1]


def pandas_html(text: str) -> str:
    return pd.read_csv(io.StringIO(text)).to_html(index=False, border=0)


CASES = {
    "int": "a\n1\n2\n-3\n",
    "int_with_blank_is_float": "a,b\n3,x\n,y\n",
    "float_precision": "a\n0.5\n0.123456789\n",
    "float_trim_to_one": "a\n0.5\n2\n",
    "float_small_keeps_digits": "a\n0.00001\n0.5\n",
    "float_tiny_goes_exponent": "a\n0.5\n0.123456789\n1e-9\n",
    "float_large_short": "a\n10000000\n2.5\n",
    "float_large_long": "a\n10000000.123\n2.123456\n",
    "float_negative_zero": "a\n-0.0\n1.25\n",
    "float_inf": "a\ninf\n-Infinity\n2.5\n",
    "na_strings": "a,b\nNA,1\nN/A,2\nNone,3\nnull,4\nnan,5\n#N/A,6\n<NA>,7\n,8\n",
    "class_named_NA": "class,n\nNA,3\nAcropora,4\n",
    "bool": "a\nTrue\nFalse\ntrue\nFALSE\n",
    "bool_with_blank": "a,b\nTrue,1\n,2\nFalse,3\n",
    "bool_mixed_with_int_is_str": "a\nTrue\n1\n",
    "escape": "a,b\nx<y,a&b\n<b>bold</b>,1 > 0\n",
    "spaces_and_controls": 'a\n"  two  spaces  "\n"tab\there"\n"new\nline"\n',
    "quoted_numbers": 'a,b\n"3","x,y"\n"4","z"\n',
    "short_rows": "a,b,c\n1,2\n3,4,5\n",
    "implicit_index": "a,b\nx,1,2\ny,3,4\n",
    "duplicate_and_empty_names": "a,a,,b\n1,2,3,4\n",
    "header_only": "a,b\n",
    "blank_lines": "\na,b\n1,2\n\n   \n3,4\n",
    "all_missing_column": "a,b\n,1\n,2\n",
    "numeric_looking_ids": "id,v\n007,1\n+3,2\n 4 ,3\n",
    "hex_and_underscore_are_str": "a\n0x10\n1_000\n",
    "mixed_float_int": "a\n1\n1.0\n1e3\n.5\n",
    "unicode": "name,v\ncafé,1\nрифы,2\n",
    "leading_bom": "﻿a,b\n1,2\n",
    "crlf": "a,b\r\n1,2\r\n3,4\r\n",
    "quote_closed_mid_field": 'a,b\n"x"y,1\nx"y,2\n"p""q",3\n',
    "field_past_the_csv_module_limit": "a,b\n" + "y" * 200_000 + ",1\n",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_csv_table_matches_pandas(name):
    text = CASES[name]
    assert parse_csv_text(text).to_html() == pandas_html(text)


TOKENS = ["", "NA", "None", "nan", "null", "N/A", "True", "False", "true", "TRUE",
          "x<y", "a&b", "  two  spaces", "tab\there", "new\nline", "'q'", "é",
          "ba-12", "007", "-0", " 3", "1e3", "inf", "-inf", "Infinity", "1.", ".5",
          "+2"]


def _value(kind, rng):
    if kind == "int":
        return str(rng.randint(-10 ** rng.randint(0, 12), 10 ** rng.randint(0, 12)))
    if kind == "float":
        v = rng.uniform(-1, 1) * 10 ** rng.choice([-12, -7, -6, -5, -1, 0, 3, 6, 7, 12])
        return rng.choice([repr(v), f"{v:.3f}", str(round(v, rng.randint(0, 8)))])
    if kind == "bool":
        return rng.choice(["True", "False"])
    return rng.choice(["x", "ba-1", "Acropora"] + TOKENS)


def _random_csv(rng):
    kinds = [rng.choice(["int", "float", "bool", "str"]) for _ in range(rng.randint(1, 5))]
    p_blank = rng.choice([0, 0, 0.05, 0.3])
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow([f"c{i}" for i in range(len(kinds))])
    for _ in range(rng.randint(0, 30)):
        writer.writerow(["" if rng.random() < p_blank else _value(k, rng) for k in kinds])
    return buf.getvalue()


@pytest.mark.parametrize("seed", range(6))
def test_random_csv_tables_match_pandas(seed):
    rng = random.Random(seed)
    for _ in range(150):
        text = _random_csv(rng)
        assert parse_csv_text(text).to_html() == pandas_html(text), text


@pytest.mark.parametrize("text", ["", "\n\n", "a,b\n1,2\n3,4,5\n", 'a\n"open quote\n'])
def test_unparseable_csv_gives_the_jax_prefix(tmp_path, text):
    path = tmp_path / "broken.csv"
    path.write_text(text)
    with pytest.raises(Exception):
        pd.read_csv(path)
    with pytest.raises(CsvParseError):
        parse_csv_text(text)
    prefix = "<pre>failed to read broken.csv: "
    assert jreport._render_csv(path).startswith(prefix)
    assert treport._render_csv(path).startswith(prefix)


def test_truncation_note_and_whole_file_types(tmp_path):
    """Past 200 rows the note names both counts; the types come from the
    whole file (a blank in row 250 makes the int column float in the first
    200 rows too)."""
    rows = [f"{i},{i * 0.5},c{i}" for i in range(260)]
    rows[250] = ",1.5,x"
    path = tmp_path / "long.csv"
    path.write_text("n,half,name\n" + "\n".join(rows) + "\n")
    got = treport._render_csv(path)
    assert got == jreport._render_csv(path)
    assert got.startswith("<p class='truncated'>showing first 200 of 260 rows</p>")
    assert "<td>3.0</td>" in got


def make_run(root: Path):
    """A finished port run with every kind of artifact the report renders."""
    tracker = TTracker(root)
    run = tracker.start_run("exp", "run-one")
    run.log_params({"training/epochs": 10, "dataset/subsample": "balanced",
                    "lr": 1e-4, "note": "x<y & z"})
    run.log_metric("accuracy", 0.81)
    run.log_metric("log_loss", 0.123456789)
    for step, loss in enumerate([0.9, 0.5, 0.3]):
        run.log_metric("epoch/val_loss", loss, step=step)
    run.log_metric("epoch/val_loss", 0.25)
    for i, v in enumerate([3.0, 2.0, 1.0]):
        run.log_metric("positional", v + i * 0.01)
    run.log_dataframe({"ba_id": ["a", "NA", "x<y"], "count": [10, 20, None],
                       "share": [0.5, 0.123456789, 1e-9]}, "dataset/ba_counts.csv")
    run.log_dataframe({"source": [f"s{i}" for i in range(230)],
                       "accuracy": [i / 229 for i in range(230)]},
                      "metrics/per_source/metrics.csv")
    run.log_dataframe({"flag": [True, False], "n": [1, 2]},
                      "metrics/ranking/per_category_topk.csv")
    run.log_text("a,b\n1,2\n3,4,5\n", "metrics/cover/broken.csv")
    run.log_dict({"best_epoch": 1, "patience": 2}, "early_stop_info.json")
    run.log_dict({"strategy": "balanced", "total": 100}, "subsample/options.yaml")
    run.log_text("free text\nwith <markup>", "notes.txt")
    run.log_text("binary-ish", "model/weights.bin")
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    run.log_figure(fig, "metrics/calibration/reliability.png")
    plt.close(fig)
    run.end()
    return tracker, run


def test_report_byte_equal_to_jax(tmp_path):
    tracker, run = make_run(tmp_path / "tracking")
    jrun = JTracker(tmp_path / "tracking").get_run(run.run_id)
    want = jreport.generate_report(jrun, tmp_path / "jax.html").read_bytes()
    got = treport.generate_report(run, tmp_path / "port.html").read_bytes()
    assert got == want
    html = got.decode()
    for needle in ("data:image/png;base64,", "Per-step metric histories",
                   "showing first 200 of 230 rows", "failed to read broken.csv",
                   "<td>NaN</td>", "x&lt;y"):
        assert needle in html


def test_history_chart_equal_to_jax():
    history = [{"step": 500, "value": 0.5}, {"step": 1000, "value": 0.4},
               {"step": None, "value": 0.35}, {"step": 750, "value": 0.45},
               {"step": 20, "value": float("nan")}]
    for h in (history, [{"step": None, "value": v} for v in (3.0, 2.0, 1.0)],
              [{"step": 1, "value": 2.0}, {"step": 2, "value": 2.0}], history[:1]):
        assert treport._render_history_chart("m", h) == \
            jreport._render_history_chart("m", h)


def test_report_imports_neither_pandas_nor_matplotlib(tmp_path):
    _, run = make_run(tmp_path / "tracking")
    code = (
        "import sys\n"
        "from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker\n"
        "from mermaid_classifier_tpu_torch.tracking.report import generate_report\n"
        f"run = LocalTracker({str(tmp_path / 'tracking')!r}).get_run({run.run_id!r})\n"
        f"generate_report(run, {str(tmp_path / 'fresh.html')!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('pandas', 'matplotlib', 'pyarrow', 'jax')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    jrun = JTracker(tmp_path / "tracking").get_run(run.run_id)
    assert (tmp_path / "fresh.html").read_bytes() == \
        jreport.generate_report(jrun, tmp_path / "jax.html").read_bytes()


def test_generate_report_cli(tmp_path):
    from mermaid_classifier_tpu_torch.scripts import generate_report as cli

    _, run = make_run(tmp_path / "tracking")
    out = tmp_path / "cli.html"
    assert cli.main(["--run-id", run.run_id, "--tracking-root",
                     str(tmp_path / "tracking"), "--output", str(out)]) == 0
    assert out.read_bytes() == treport.generate_report(
        run, tmp_path / "direct.html").read_bytes()
    assert cli.main(["--run-id", "nope", "--tracking-root",
                     str(tmp_path / "tracking")]) == 1
    assert json.loads((run.run_dir / "meta.json").read_text())["status"] == "FINISHED"
