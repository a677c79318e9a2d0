"""Self-contained HTML report for a tracked training run.

The port's own copy of ``mermaid_classifier_tpu/tracking/report.py``,
without pandas or matplotlib: one HTML file, no external assets. PNG
artifacts are inlined base64 (a run logged where matplotlib does not
import has none), CSV artifacts rendered as the tables pandas' ``to_html``
writes (``common.html_table``), JSON artifacts pretty-printed, scalar
metrics and params grouped by their '/'-prefix, per-step metric histories
as inline-SVG charts with a table view. Sections are driven by a
declarative artifact manifest, so adding a section is data, not code. The
same run gives the same bytes as the JAX report.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from html import escape
from pathlib import Path

from mermaid_classifier_tpu_torch.common.html_table import CsvParseError, read_csv
from mermaid_classifier_tpu_torch.tracking.local_tracker import Run

# Declarative section manifest: (title, [artifact path prefixes]).
# Artifacts not matched by any section land in "Other artifacts".
REPORT_SECTIONS: list[tuple[str, list[str]]] = [
    ("Model artifact", ["model/", "export_manifest", "valresult"]),
    ("Dataset", ["dataset/"]),
    ("Subsample audit", ["subsample/"]),
    ("Class weighting", ["weighting/"]),
    ("Confusion matrices", ["metrics/confusion"]),
    ("Precision / recall / F1", ["metrics/precision_recall"]),
    ("Calibration", ["metrics/calibration"]),
    ("Cover", ["metrics/cover"]),
    ("Taxonomic", ["metrics/taxonomic"]),
    ("Ranking", ["metrics/ranking"]),
    ("Probability", ["metrics/probability"]),
    ("Per-source", ["metrics/per_source"]),
    ("Early stopping", ["early_stop"]),
    ("Profiling", ["profiled_sections"]),
]

_MAX_TABLE_ROWS = 200

_CSS = """
body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 1100px;
       color: #1a202c; }
h1 { border-bottom: 2px solid #2b6cb0; padding-bottom: .3rem; }
h2 { color: #2b6cb0; margin-top: 2rem; border-bottom: 1px solid #cbd5e0;
     padding-bottom: .2rem; }
table { border-collapse: collapse; font-size: .85rem; margin: .5rem 0; }
th, td { border: 1px solid #cbd5e0; padding: .25rem .6rem; text-align: left; }
th { background: #edf2f7; }
img { max-width: 100%; border: 1px solid #cbd5e0; margin: .5rem 0; }
pre { background: #f7fafc; border: 1px solid #cbd5e0; padding: .6rem;
      overflow-x: auto; font-size: .8rem; }
.meta { color: #4a5568; font-size: .9rem; }
.truncated { color: #718096; font-style: italic; }
"""


@dataclass
class _Section:
    title: str
    parts: list[str] = field(default_factory=list)


def _render_csv(path: Path) -> str:
    try:
        frame = read_csv(path)
    except (CsvParseError, OSError) as exc:  # the report must not die on one file
        return f"<pre>failed to read {escape(path.name)}: {escape(str(exc))}</pre>"
    note = ""
    if len(frame) > _MAX_TABLE_ROWS:
        note = (
            f"<p class='truncated'>showing first {_MAX_TABLE_ROWS} of"
            f" {len(frame)} rows</p>"
        )
        frame = frame.head(_MAX_TABLE_ROWS)
    return note + frame.to_html()


def _render_png(path: Path) -> str:
    data = base64.b64encode(path.read_bytes()).decode()
    return f'<img alt="{escape(path.name)}" src="data:image/png;base64,{data}"/>'


def _render_json(path: Path) -> str:
    try:
        data = json.loads(path.read_text())
        text = json.dumps(data, indent=2, default=str)
    except Exception:  # noqa: BLE001
        text = path.read_text()
    return f"<pre>{escape(text)}</pre>"


def _render_artifact(path: Path) -> str:
    suffix = path.suffix.lower()
    if suffix == ".csv":
        return _render_csv(path)
    if suffix == ".png":
        return _render_png(path)
    if suffix in (".json", ".yaml", ".yml", ".txt"):
        return _render_json(path)
    return f"<p class='meta'>{escape(path.name)} ({path.stat().st_size} bytes)</p>"


def _render_history_chart(name: str, history: list[dict]) -> str:
    """One per-metric line chart as self-contained inline SVG.

    Single series per chart (the title names it — no legend needed): a 2px
    line in the report accent (#2b6cb0, 5.4:1 contrast on the white
    surface), recessive gridlines, muted-ink min/max ticks, the last value
    direct-labeled, and native hover tooltips via per-point <title> on
    enlarged hit circles. The full table stays available under <details>
    (the accessible table view).
    """
    finite = [
        h for h in history
        if h.get("value") is not None
        and float(h["value"]) == float(h["value"])
        and abs(float(h["value"])) != float("inf")
    ]
    # Step semantics: when ANY entry carries a real step, the stepped
    # entries ARE the series and step-less entries (summary re-logs) are
    # excluded from the chart — a positional x would render a final
    # summary at the far left with a bogus step label. Only a history
    # with NO steps at all falls back to positional x.
    stepped = [h for h in finite if h.get("step") is not None]
    if stepped:
        pts = sorted((h["step"], float(h["value"])) for h in stepped)
        x_label = "step"
    else:
        # Positional fallback: x is just the log-entry index, NOT a
        # training step — label it as such.
        pts = [(i, float(h["value"])) for i, h in enumerate(finite)]
        x_label = "entry"
    if len(pts) < 2:
        return ""
    w_px, h_px, pad_l, pad_r, pad_t, pad_b = 560, 140, 58, 16, 12, 22
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if y0 == y1:
        y0, y1 = y0 - 0.5, y1 + 0.5
    span_x = (x1 - x0) or 1
    span_y = y1 - y0

    def sx(x):
        return pad_l + (x - x0) / span_x * (w_px - pad_l - pad_r)

    def sy(y):
        return pad_t + (y1 - y) / span_y * (h_px - pad_t - pad_b)

    path = " ".join(
        f"{'M' if i == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
        for i, (x, y) in enumerate(pts)
    )
    grid = "".join(
        f'<line x1="{pad_l}" y1="{sy(y):.1f}" x2="{w_px - pad_r}"'
        f' y2="{sy(y):.1f}" stroke="#e2e8f0" stroke-width="1"/>'
        f'<text x="{pad_l - 6}" y="{sy(y) + 3:.1f}" text-anchor="end"'
        f' font-size="10" fill="#718096">{y:.4g}</text>'
        for y in (y0, y1)
    )
    hovers = "".join(
        f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="7"'
        f' fill="transparent"><title>{x_label} {x}: {y:.6g}</title></circle>'
        for x, y in pts
    )
    lx, ly = sx(pts[-1][0]), sy(pts[-1][1])
    anchor = "end" if lx > w_px - 70 else "start"
    ldx = -8 if anchor == "end" else 8
    return (
        f'<svg viewBox="0 0 {w_px} {h_px}" width="{w_px}" height="{h_px}"'
        f' role="img" aria-label="{escape(name)} history">'
        f"{grid}"
        f'<path d="{path}" fill="none" stroke="#2b6cb0" stroke-width="2"'
        ' stroke-linejoin="round" stroke-linecap="round"/>'
        f'<circle cx="{lx:.1f}" cy="{ly:.1f}" r="3" fill="#2b6cb0"/>'
        f'<text x="{lx + ldx:.1f}" y="{ly + 4:.1f}" text-anchor="{anchor}"'
        f' font-size="11" fill="#1a202c">{pts[-1][1]:.5g}</text>'
        f'<text x="{pad_l}" y="{h_px - 6}" font-size="10" fill="#718096">'
        f"{x_label} {x0}</text>"
        f'<text x="{w_px - pad_r}" y="{h_px - 6}" text-anchor="end"'
        f' font-size="10" fill="#718096">{x_label} {x1}</text>'
        f"{hovers}</svg>"
    )


def _grouped_table(items: dict, title_key: str = "name") -> str:
    """Group a flat {'a/b': v} dict by first path segment into tables."""
    groups: dict[str, list[tuple[str, object]]] = {}
    for key, value in sorted(items.items()):
        prefix, _, rest = key.partition("/")
        groups.setdefault(prefix if rest else "", []).append(
            (rest or key, value)
        )
    out = []
    for prefix in sorted(groups):
        rows = "".join(
            f"<tr><td>{escape(str(k))}</td><td>{escape(str(v))}</td></tr>"
            for k, v in groups[prefix]
        )
        heading = f"<h3>{escape(prefix)}</h3>" if prefix else ""
        out.append(f"{heading}<table><tbody>{rows}</tbody></table>")
    return "".join(out)


def generate_report(run: Run, output_html: str | Path) -> Path:
    """Render the run's params, metrics, histories, and artifacts into ONE
    self-contained HTML file. Returns the output path."""
    meta = json.loads((run.run_dir / "meta.json").read_text()) if (
        run.run_dir / "meta.json"
    ).exists() else {}
    params = run.params()
    metrics = run.latest_metrics()
    artifacts = run.list_artifacts()

    # Per-epoch histories: every metric with >1 logged step.
    histories = {}
    for name in sorted(metrics):
        history = run.metric_history(name)
        if len(history) > 1:
            histories[name] = history

    assigned: set[str] = set()
    sections: list[_Section] = []
    for title, prefixes in REPORT_SECTIONS:
        section = _Section(title=title)
        for artifact in artifacts:
            if artifact in assigned:
                continue
            if any(artifact.startswith(p) for p in prefixes):
                section.parts.append(artifact)
                assigned.add(artifact)
        if section.parts:
            sections.append(section)
    leftover = [a for a in artifacts if a not in assigned]
    if leftover:
        sections.append(_Section(title="Other artifacts", parts=leftover))

    html: list[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>Run report: {escape(run.run_name)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>Run report: {escape(run.run_name)}</h1>",
        "<p class='meta'>"
        + " · ".join(
            escape(f"{k}: {v}")
            for k, v in meta.items()
            if k in ("experiment", "run_id", "status", "start_time", "end_time")
        )
        + "</p>",
    ]

    if params:
        html.append("<h2>Parameters</h2>")
        html.append(_grouped_table(params))
    if metrics:
        html.append("<h2>Metrics (latest)</h2>")
        html.append(
            _grouped_table({k: f"{v:.6g}" for k, v in metrics.items()})
        )
    if histories:
        html.append("<h2>Per-step metric histories</h2>")
        for name, history in histories.items():
            rows = "".join(
                f"<tr><td>{h.get('step')}</td><td>{h['value']:.6g}</td></tr>"
                for h in history
            )
            table = (
                "<details><summary class='meta'>table view"
                f" ({len(history)} steps)</summary>"
                f"<table><thead><tr><th>step</th>"
                f"<th>value</th></tr></thead><tbody>{rows}</tbody></table>"
                "</details>"
            )
            html.append(
                f"<h3>{escape(name)}</h3>"
                + _render_history_chart(name, history)
                + table
            )

    for section in sections:
        html.append(f"<h2>{escape(section.title)}</h2>")
        for part in section.parts:
            html.append(f"<h3>{escape(part)}</h3>")
            html.append(_render_artifact(run.artifact(part)))

    html.append("</body></html>")
    output_html = Path(output_html)
    output_html.parent.mkdir(parents=True, exist_ok=True)
    output_html.write_text("\n".join(html))
    return output_html
