"""The readers of the program's own spans: nothing from nothing, only the
window's unprofiled spans, and every one of them finite in a traced tiny
run of its cell."""

import math

import pytest

from benchmark import run as bench_run
from benchmark.manifest import Manifest
from benchmark.tests.conftest import tiny_cell
from mermaid_classifier_tpu_torch.utils import profiling
from mermaid_classifier_tpu_torch.utils.profiling import Span

READERS = {
    "bulk_upload_ms": "b2_bulk_200pt", "bulk_enqueue_ms": "b2_bulk_200pt",
    "bulk_decode_wait_ms": "b2_bulk_200pt", "bulk_handoff_wait_ms": "b2_bulk_200pt",
    "bulk_readback_wait_ms": "b2_bulk_200pt", "bulk_write_ms": "b2_bulk_200pt",
    "bulk_source_edge_ms": "b2_bulk_200pt", "train_prepare_ms": "b0_head_train_c2",
    "train_window_captures": "b0_head_train_c2",
}
SPAN_OF = {
    "bulk_upload_ms": "extract.upload",
    "bulk_decode_wait_ms": "bucket.decode_wait", "bulk_handoff_wait_ms": "bucket.handoff",
    "bulk_readback_wait_ms": "bucket.readback_wait", "bulk_write_ms": "bucket.write",
    "train_prepare_ms": "train.prepare",
}
MS = 1_000_000


def reader(name):
    cell = Manifest().cell(READERS[name])
    (metric,) = [m for m in cell.per_layer if m["name"] == name]
    return cell.reader(metric)


def span(name, start_ms, length_ms, profiled=False, key=None):
    return Span(name, key, int(start_ms * MS), int((start_ms + length_ms) * MS), 1, None,
                profiled)


def test_each_new_metric_is_declared_for_its_cell_only():
    for cell in ("b2_bulk_200pt", "b0_head_train_c2"):
        names = {m["name"] for m in Manifest().cell(cell).per_layer}
        assert {n for n, c in READERS.items() if c == cell} <= names
        assert not {n for n, c in READERS.items() if c != cell} & names


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_gives_none(name, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: [])
    assert reader(name).read({"window_s": 1.0}) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: [span("x", 0, 1)])
    assert reader(name).read({}) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without spans
    assert reader(name).read({"window_s": 1.0}) is None


def _snapshot():
    """Set-up's spans (before the window, 1 s long from 1,000 ms to 2,000
    ms), the window's, and the profiled stretch's after it, each name's
    window spans 1 and 3 ms long; the dispatches 2 and 6 ms, around the
    uploads."""
    spans = []
    for name in (*SPAN_OF.values(), "bucket.open", "bucket.drain", "train.capture"):
        spans += [span(name, 100, 500), span(name, 995, 4)]  # set-up
        spans += [span(name, 1200, 1), span(name, 1500, 3)]  # the window
        spans += [span(name, 2500, 700, profiled=True)]  # the stretch
    spans += [span("extract.dispatch", 100, 501), span("extract.dispatch", 994, 6),
              span("extract.dispatch", 1200, 2), span("extract.dispatch", 1500, 6),
              span("extract.dispatch", 2500, 701, profiled=True)]
    spans.append(span("train.call", 1100, 899))
    return sorted(spans, key=lambda s: s.start_ns)


@pytest.mark.parametrize("name", sorted(READERS))
def test_only_the_windows_unprofiled_spans_are_read(name, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", _snapshot)
    got = reader(name).read({"window_s": 1.0})
    want = {"bulk_source_edge_ms": (1 + 3) * 2 / 2, "train_window_captures": 2}
    assert got == pytest.approx(want.get(name, 2.0))


def test_the_enqueue_leaves_out_an_upload_whose_dispatch_began_before_the_window(
        monkeypatch):
    """A dispatch that began before the window is out of it; its upload,
    begun inside, is out too."""
    spans = [span("extract.dispatch", 990, 12), span("extract.upload", 1001, 1),
             span("extract.dispatch", 1200, 5), span("extract.upload", 1200, 2),
             span("train.call", 1100, 900)]
    monkeypatch.setattr(profiling, "snapshot", lambda: spans)
    assert reader("bulk_enqueue_ms").read({"window_s": 1.0}) == pytest.approx(3.0)


@pytest.mark.parametrize("cell", ["b2_bulk_200pt", "b0_head_train_c2"])
def test_a_traced_tiny_run_reads_every_new_metric_finite(cell):
    result = bench_run.run(tiny_cell(cell), 2**33 + 5, 0.3, True, "cpu")
    assert result["correct"], result["checks"]
    names = [n for n, c in READERS.items() if c == cell]
    values = {n: result["metrics"].get(n, {}).get("value") for n in names}
    assert all(isinstance(v, (int, float)) and math.isfinite(v) for v in values.values()), values
    if cell == "b0_head_train_c2":
        assert values.pop("train_window_captures") == 0
    assert all(v > 0 for v in values.values()), values
