"""The port's host spans (``utils/profiling.py``): the recorder itself, its
place on ``torch.profiler``'s clock, and the spans the bulk builder, the
extractor and the resident training call record, on the CPU at tiny
sizes."""

import io
import threading
import time
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from mermaid_classifier_tpu_torch.data import feature_bucket as tfb
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
from mermaid_classifier_tpu_torch.models.extractor import build_extractor
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier
from mermaid_classifier_tpu_torch.utils import profiling
from mermaid_classifier_tpu_torch.utils.profiling import SpanRecorder
from tests.torch_store_env import store_root_env  # noqa: F401

PER_IMAGE = ("bucket.decode", "bucket.decode_wait", "extract.dispatch", "extract.upload",
             "bucket.handoff", "bucket.readback_wait", "bucket.write")
PER_SOURCE = ("bucket.open", "bucket.prefetch", "bucket.drain")


def since(t0: int) -> list:
    return [s for s in profiling.snapshot() if s.start_ns >= t0]


# --- the recorder -------------------------------------------------------------


def test_nesting_gives_the_parent_and_the_key():
    rec = SpanRecorder()
    with rec.span("outer", key="img-1"):
        with rec.span("inner"):
            pass
        with rec.span("other", key="img-2"):
            pass
    with rec.keyed(7):
        with rec.span("free"):
            pass
    got = {s.name: s for s in rec.snapshot()}
    assert got["outer"].parent is None and got["outer"].key == "img-1"
    assert got["inner"].parent == "outer" and got["inner"].key == "img-1"
    assert got["other"].parent == "outer" and got["other"].key == "img-2"
    assert got["free"].parent is None and got["free"].key == 7
    assert got["outer"].start_ns <= got["inner"].start_ns <= got["inner"].end_ns
    assert got["inner"].end_ns <= got["other"].start_ns <= got["outer"].end_ns
    assert not any(s.profiled for s in got.values())


def test_a_span_is_recorded_when_its_block_raises():
    rec = SpanRecorder()
    with pytest.raises(ValueError):
        with rec.span("fails", key=3):
            raise ValueError("x")
    with rec.span("after"):
        pass
    got = {s.name: s for s in rec.snapshot()}
    assert got["fails"].key == 3 and got["after"].parent is None


def test_threads_are_kept_apart():
    rec = SpanRecorder()
    go = threading.Barrier(2, timeout=30)

    def work(name):
        with rec.span(name, key=name):
            go.wait()
            with rec.span(name + ".child"):
                pass

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in rec.snapshot()}
    assert got["a.child"].parent == "a" and got["a.child"].key == "a"
    assert got["b.child"].parent == "b" and got["b.child"].key == "b"
    assert got["a"].thread == got["a.child"].thread != got["b"].thread


def test_each_name_keeps_a_bounded_ring():
    rec = SpanRecorder(capacity=4)
    for i in range(10):
        with rec.span("many", key=i):
            pass
    with rec.span("one"):
        pass
    spans = rec.snapshot()
    assert [s.key for s in spans if s.name == "many"] == [6, 7, 8, 9]
    assert [s.name for s in spans].count("one") == 1
    assert profiling.SPAN_CAPACITY == 65536


def test_summary_counts_totals_and_means():
    rec = SpanRecorder()
    for _ in range(3):
        with rec.span("sleep"):
            time.sleep(0.002)
    got = rec.summary()["sleep"]
    assert got["count"] == 3
    assert got["total_s"] >= 0.006
    assert got["mean_ms"] == pytest.approx(got["total_s"] * 1e3 / 3)


def test_summary_counts_the_spans_the_ring_has_dropped():
    rec = SpanRecorder(capacity=4)
    for _ in range(10):
        with rec.span("many"):
            time.sleep(0.001)
    assert len(rec.snapshot()) == 4
    got = rec.summary()["many"]
    assert got["count"] == 10
    assert got["total_s"] >= 0.010


# --- on the profiler's clock --------------------------------------------------


def _worker_span():
    with profiling.span("test.worker"):
        pass


def test_under_the_profiler_spans_are_ranges_on_one_offset():
    """The main thread's spans are profiler ranges, marked ``profiled``, and
    one constant offset maps each in-memory start onto its range's start
    within 0.1 ms; a worker thread's span is marked but is no range (the
    profiler keeps the ranges of its own thread). A profile's first range
    (key 0) is left out of the offset: it may pay the profiler's lazy
    start, up to milliseconds, between its timestamp and the span's."""
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(8):
            with profiling.span("test.clock", key=i):
                time.sleep(0.001)
            time.sleep(0.002)
        worker = threading.Thread(target=_worker_span)
        worker.start()
        worker.join(timeout=30)
    with profiling.span("test.clock", key="after"):
        pass
    spans = [s for s in since(t0) if s.name == "test.clock"]
    assert [s.profiled for s in spans] == [True] * 8 + [False]
    ranges = sorted(e.time_range.start for e in prof.events() if e.name == "test.clock")
    assert len(ranges) == 8
    offsets = [r * 1e3 - s.start_ns for r, s in zip(ranges, spans)][1:]
    assert max(offsets) - min(offsets) < 1e5
    assert not [e for e in prof.events() if e.name == "test.worker"]


def test_the_worker_spans_are_marked_while_the_profiler_records():
    t0 = time.perf_counter_ns()
    done = []

    def worker():
        with profiling.span("test.marked"):
            done.append(True)

    with profile(activities=[ProfilerActivity.CPU]):
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(timeout=30)
    assert done == [True]
    (marked,) = [s for s in since(t0) if s.name == "test.marked"]
    assert marked.profiled


# --- the program's spans ------------------------------------------------------

TINY = EfficientNetConfig(
    stem_channels=8, stages=((1, 8, 1, 1, 3), (6, 12, 2, 2, 3)), head_channels=16,
    feature_dim=8, patch_size=16)
IMAGES = {"a1": 3, "a2": 5, "a3": 2}


class HarnessExtractor:
    """The extractor as the benchmark hands it to the builder: these two
    methods and nothing else."""

    def __init__(self, extractor):
        self._extractor = extractor

    def extract_features_async(self, image, rowcols):
        return self._extractor.extract_features_async(image, rowcols)

    def verify_device_numerics(self, *args, **kwargs):
        return self._extractor.verify_device_numerics(*args, **kwargs)


def _npy(image) -> bytes:
    buf = io.BytesIO()
    np.save(buf, image)
    return buf.getvalue()


def test_the_builder_records_every_span_once_per_image_and_source(tmp_path):
    rng = np.random.default_rng(0)
    store = LocalFSObjectStore(tmp_path / "store")
    rows = []
    for image_id, n in IMAGES.items():
        key = f"s7/{image_id}.npy"
        store.put_bytes("src", key, _npy(rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)))
        rows += [(image_id, key, int(rng.integers(0, 24)), int(rng.integers(0, 30)))
                 for _ in range(n)]
    buf = io.StringIO()
    buf.write("image_id,image_key,row,col\n")
    buf.writelines(f"{a},{b},{c},{d}\n" for a, b, c, d in rows)
    store.put_bytes("src", tfb.annotations_key("7"), buf.getvalue().encode())
    decoded = []

    def decode(data):
        decoded.append(len(data))
        return np.load(io.BytesIO(data))

    extractor = build_extractor(None, TINY, device="cpu", backbone_batch=4, point_bucket=4)
    builder = tfb.FeatureBucketBuilder(store, "src", "dst", HarnessExtractor(extractor),
                                       decode_image=decode, decode_workers=2, prefetch=2)
    t0 = time.perf_counter_ns()
    result = builder.run(["7"], verify_numerics=True)
    assert result.sources[0].images_done == 3 and len(decoded) == 3
    spans = since(t0)
    counts = Counter((s.name, s.key) for s in spans)
    for name in PER_IMAGE:
        assert {k: c for (n, k), c in counts.items() if n == name} == dict.fromkeys(IMAGES, 1)
    assert [counts[(name, "7")] for name in PER_SOURCE] == [1, 1, 1]
    by = {(s.name, s.key): s for s in spans}
    main = threading.get_ident()
    for image_id in IMAGES:
        dispatch, upload = by[("extract.dispatch", image_id)], by[("extract.upload", image_id)]
        assert upload.parent == "extract.dispatch"
        assert dispatch.start_ns <= upload.start_ns <= upload.end_ns <= dispatch.end_ns
        assert by[("bucket.decode", image_id)].thread != main
        assert by[("bucket.readback_wait", image_id)].thread not in (main, by[
            ("bucket.decode", image_id)].thread)
        assert by[("bucket.write", image_id)].thread == by[
            ("bucket.readback_wait", image_id)].thread
        for name in ("bucket.decode_wait", "extract.dispatch", "bucket.handoff"):
            assert by[(name, image_id)].thread == main
    assert by[("bucket.open", "7")].end_ns <= by[("bucket.prefetch", "7")].start_ns
    assert by[("bucket.prefetch", "7")].end_ns <= min(by[("bucket.decode_wait", i)].start_ns
                                                      for i in IMAGES)
    assert by[("bucket.drain", "7")].start_ns >= max(by[("bucket.handoff", i)].end_ns
                                                     for i in IMAGES)


def test_a_failed_image_records_its_spans_and_the_run_goes_on(tmp_path):
    store = LocalFSObjectStore(tmp_path / "store")
    store.put_bytes("src", "s8/ok.npy", _npy(np.zeros((20, 20, 3), np.uint8)))
    store.put_bytes("src", "s8/bad.npy", b"broken")
    store.put_bytes("src", tfb.annotations_key("8"),
                    b"image_id,image_key,row,col\nbad,s8/bad.npy,1,1\nok,s8/ok.npy,2,2\n")
    extractor = build_extractor(None, TINY, device="cpu", backbone_batch=4, point_bucket=4)
    builder = tfb.FeatureBucketBuilder(store, "src", "dst", HarnessExtractor(extractor),
                                       decode_image=lambda data: np.load(io.BytesIO(data)))
    t0 = time.perf_counter_ns()
    result = builder.run(["8"])
    assert (result.sources[0].images_done, result.sources[0].images_failed) == (1, 1)
    counts = Counter((s.name, s.key) for s in since(t0))
    assert counts[("bucket.decode", "bad")] == counts[("bucket.decode_wait", "bad")] == 1
    assert counts[("extract.dispatch", "bad")] == counts[("bucket.write", "bad")] == 0
    assert all(counts[(name, "ok")] == 1 for name in PER_IMAGE)


def test_partial_fit_resident_records_one_call_and_one_prepare_per_call():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((300, 12)).astype(np.float32)
    y = rng.integers(0, 4, 300)
    clf = MLPClassifier((8,), random_state=0, device="cpu").set_resident_features(X)
    t0 = time.perf_counter_ns()
    for _ in range(3):
        idx = rng.permutation(300)[:250]
        clf.partial_fit_resident(idx, y[idx], classes=np.arange(4))
    spans = since(t0)
    calls = [s for s in spans if s.name == "train.call"]
    prepares = [s for s in spans if s.name == "train.prepare"]
    assert [s.key for s in calls] == [s.key for s in prepares] == [0, 1, 2]
    assert all(p.parent == "train.call" for p in prepares)
    for call, prep in zip(calls, prepares):
        assert call.start_ns <= prep.start_ns <= prep.end_ns < call.end_ns
    assert not [s for s in spans if s.name == "train.capture"]  # eager on the CPU
    assert len(clf.loss_curve_) == 3 and np.isfinite(clf.loss_curve_).all()


def test_the_bulk_cli_logs_the_span_summary(tmp_path, store_root_env, caplog):
    """The operator's view: the CLI's last lines give each span's count,
    total and mean, beside its kernel-launch line."""
    import json
    import logging

    from PIL import Image

    from mermaid_classifier_tpu_torch.scripts import build_feature_bucket

    store = LocalFSObjectStore(tmp_path / "store")
    rows = ["image_id,image_key,row,col"]
    for image_id in ("p", "q"):
        buf = io.BytesIO()
        Image.fromarray(np.full((20, 28, 3), 90, np.uint8)).save(buf, format="PNG")
        store.put_bytes("src", f"s5/{image_id}.png", buf.getvalue())
        rows += [f"{image_id},s5/{image_id}.png,{r},{c}" for r, c in ((0, 0), (9, 20))]
    store.put_bytes("src", tfb.annotations_key("5"), ("\n".join(rows) + "\n").encode())
    (tmp_path / "tiny.json").write_text(json.dumps(TINY.to_dict()))
    store_root_env(tmp_path / "store")
    with caplog.at_level(logging.INFO):
        rc = build_feature_bucket.main([
            "--source-ids", "5", "--source-bucket", "src", "--target-bucket", "dst",
            "--backbone-config-json", str(tmp_path / "tiny.json"), "--device", "cpu"])
    assert rc == 0
    messages = [r.getMessage() for r in caplog.records]
    at = next(i for i, m in enumerate(messages) if m.startswith("kernel launches in this"))
    logged = {m.split()[1].rstrip(":"): m for m in messages[at + 1:] if m.startswith("span ")}
    assert set(PER_IMAGE) | set(PER_SOURCE) <= set(logged)
    assert logged["extract.dispatch"].startswith("span extract.dispatch: ")
