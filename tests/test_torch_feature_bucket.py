"""The port's feature-bucket builder against the JAX package's.

The same populated source bucket (a canonical source with ragged point
counts, points at the image edges and one corrupt image, and a
CoralNet-export source) goes through the JAX ``FeatureBucketBuilder`` (JAX
extractor, f32) and the port's (port extractor on the CPU, the kernels'
plain versions), each on its own package's ``LocalFSObjectStore``. They
agree on the target keys, every file's ``rowcols`` (equal) and features
(MAE < 1e-4, the fidelity gate of tests/models/test_efficientnet.py), the
``RunResult`` counters and exit code, and the progress and error-log
records with the time column dropped (and the object address in a decode
error's message masked). Then the cases of tests/data/test_feature_bucket.py
on the port: resume, no-skip, a failing progress log, per-image isolation,
missing columns, the source filter and the CoralNet layout, with
``_name_to_image_id`` and ``read_annotations`` held to the JAX ones."""

import csv
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest

from mermaid_classifier_tpu.data import feature_bucket as jfb
from mermaid_classifier_tpu.data.features_io import read_feature_file
from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
from mermaid_classifier_tpu.models import extractor as jext
from mermaid_classifier_tpu_torch.data import feature_bucket as tfb
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore as TStore
from mermaid_classifier_tpu_torch.models import extractor as text
from tests.models.test_efficientnet import TINY
from tests.torch_store_env import store_root_env  # noqa: F401
from tests.test_torch_efficientnet import (
    jax_variables_numpy,
    perturbed,
    port_config,
)

SRC, DST = "src-bucket", "dst-bucket"
OPTS = dict(backbone_batch=8, point_bucket=4, image_bucket=64)
# Canonical source "1": image id -> (height, width, points). 9 and 17
# points make ragged last chunks of 8-patch backbone batches.
IMAGES = {"10": (40, 56, 3), "11": (48, 40, 9), "12": (40, 56, 17),
          "13": (36, 44, 1)}
CORRUPT = "12"


def png_bytes(rng, h, w) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def csv_bytes(header, rows) -> bytes:
    buf = io.StringIO()
    writer = csv.writer(buf)
    writer.writerow(header)
    writer.writerows(rows)
    return buf.getvalue().encode()


def populate(store, corrupt=False):
    """Source "1" (canonical, the image ids listed out of order in the
    CSV), source "2" (one image) and source "9" (CoralNet export)."""
    rng = np.random.default_rng(0)
    rows = []
    for image_id in ("12", "10", "13", "11"):
        h, w, n = IMAGES[image_id]
        key = f"s1/images/{image_id}.png"
        data = b"not a png" if corrupt and image_id == CORRUPT else png_bytes(rng, h, w)
        store.put_bytes(SRC, key, data)
        pts = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
        pts[0] = (0, w - 1)  # an edge point: the folded zero pad
        rows += [(image_id, key, int(r), int(c)) for r, c in pts]
    store.put_bytes(SRC, tfb.annotations_key("1"),
                    csv_bytes(("image_id", "image_key", "row", "col"), rows))
    store.put_bytes(SRC, "s2/images/20.png", png_bytes(rng, 32, 32))
    store.put_bytes(SRC, tfb.annotations_key("2"), csv_bytes(
        ("image_id", "image_key", "row", "col", "note"),
        [("20", "s2/images/20.png", 31, 0, "NA"), ("20", "s2/images/20.png", 5, 6, "")]))
    for image_id in ("100", "200"):
        store.put_bytes(SRC, f"s9/images/{image_id}.jpg", png_bytes(rng, 40, 40))
    store.put_bytes(SRC, tfb.annotations_key("9"), csv_bytes(
        ("Name", "Row", "Column"),
        [("a.JPG", 5, 6), ("b.JPG", 9, 10), ("a.JPG", 39, 0), ("ghost.JPG", 3, 4)]))
    store.put_bytes(SRC, "s9/image_list.csv", csv_bytes(
        ("Name", "Image Page", "Image URL"),
        [("a.JPG - Confirmed", "/image/100/view/", ""),
         ("b.JPG - Unconfirmed", "/image/200/view/", "")]))
    return store


@pytest.fixture(scope="module")
def variables():
    return perturbed(jax_variables_numpy(TINY), seed=21)


@pytest.fixture(scope="module")
def port_extractor(variables):
    return text.build_extractor(variables, port_config(TINY), device="cpu", **OPTS)


def port_builder(store, tmp_path, extractor, **kwargs):
    return tfb.FeatureBucketBuilder(
        store, SRC, DST, extractor,
        progress_log=tmp_path / "progress.jsonl",
        error_log=tmp_path / "errors.csv", **kwargs)


def read_features(store, source_id, image_id):
    return read_feature_file(io.BytesIO(
        store.get_bytes(DST, tfb.feature_key(source_id, image_id))))


def _mask(message: str) -> str:
    return re.sub(r" at 0x[0-9a-f]+", "", message)


def counters(result):
    return [{**vars(s), "failures": [(i, _mask(e)) for i, e in s.failures]}
            for s in result.sources]


def log_records(tmp_path):
    progress = [
        {k: v for k, v in json.loads(line).items() if k != "time"}
        for line in (tmp_path / "progress.jsonl").read_text().splitlines()]
    errors = []
    if (tmp_path / "errors.csv").exists():
        with open(tmp_path / "errors.csv", newline="") as fh:
            for row in csv.DictReader(fh):
                del row["time"]
                row["error"] = _mask(row["error"])
                errors.append(row)
    return progress, errors


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory, variables, port_extractor):
    """(JAX (store, result, logs), port (store, result, logs))."""
    out = []
    for store_cls, builder_mod, extractor in (
        (JStore, jfb, jext.build_extractor(variables, TINY, **OPTS)),
        (TStore, tfb, port_extractor),
    ):
        tmp = tmp_path_factory.mktemp(builder_mod.__name__.split(".")[0])
        store = populate(store_cls(tmp / "store"), corrupt=True)
        builder = builder_mod.FeatureBucketBuilder(
            store, SRC, DST, extractor, progress_log=tmp / "progress.jsonl",
            error_log=tmp / "errors.csv", decode_workers=2, prefetch=2)
        result = builder.run(["1", "2", "9"])
        out.append((store, result, log_records(tmp)))
    return out


def test_same_keys_rowcols_and_features(both_runs):
    (jstore, *_), (tstore, *_) = both_runs
    keys = sorted(jstore.list_keys(DST))
    assert sorted(tstore.list_keys(DST)) == keys
    features = [k for k in keys if k.endswith(".features.npz")]
    assert len(features) == 6
    for key in features:
        m = tfb._FEATURE_KEY_RE.match(key)
        j_rc, j_f = read_features(jstore, m["source"], m["image"])
        t_rc, t_f = read_features(tstore, m["source"], m["image"])
        np.testing.assert_array_equal(t_rc, j_rc)
        assert t_f.shape == j_f.shape == (len(j_rc), TINY.feature_dim)
        assert float(np.mean(np.abs(t_f - j_f))) < 1e-4, key
    for source in ("1", "2", "9"):
        key = tfb.annotations_key(source)
        assert tstore.get_bytes(DST, key) == jstore.get_bytes(DST, key)


def test_same_results_and_logs(both_runs):
    (_, jres, jlogs), (_, tres, tlogs) = both_runs
    assert counters(tres) == counters(jres)
    assert tres.exit_code == jres.exit_code == 1
    assert tres.describe() == jres.describe()
    assert tres.sources[0].failures[0][0] == CORRUPT
    assert tlogs == jlogs
    assert len(tlogs[0]) == 6 and len(tlogs[1]) == 1


def test_rowcols_in_file_order(both_runs):
    """Each image's rows keep the CSV's order."""
    _, (tstore, *_) = both_runs
    rows = list(csv.DictReader(io.StringIO(
        tstore.get_bytes(SRC, tfb.annotations_key("1")).decode())))
    for image_id in ("10", "11", "13"):
        want = [(int(r["row"]), int(r["col"])) for r in rows
                if r["image_id"] == image_id]
        rowcols, _ = read_features(tstore, "1", image_id)
        assert [tuple(rc) for rc in rowcols] == want


def test_written_features_equal_per_image_extraction(both_runs, port_extractor):
    _, (tstore, *_) = both_runs
    image = tfb.decode_image_bytes(tstore.get_bytes(SRC, "s1/images/11.png"))
    rowcols, features = read_features(tstore, "1", "11")
    np.testing.assert_array_equal(
        features, port_extractor.extract_features(image, rowcols))


def test_end_to_end(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"))
    result = port_builder(store, tmp_path, port_extractor).run(["1", "2"])
    assert result.exit_code == 0
    assert result.describe().startswith("2 sources: 5 images extracted")
    rowcols, feats = read_features(store, "2", "20")
    assert rowcols.tolist() == [[31, 0], [5, 6]]
    assert feats.shape == (2, TINY.feature_dim)
    assert store.exists(DST, tfb.annotations_key("1"))
    lines = (tmp_path / "progress.jsonl").read_text().splitlines()
    assert [json.loads(line)["image_id"] for line in lines] == [
        "10", "11", "12", "13", "20"]


def test_resume_skips_existing(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"))
    port_builder(store, tmp_path, port_extractor).process_source("1")
    store.delete(DST, tfb.feature_key("1", "11"))
    before = {k: store._path(DST, k).stat().st_mtime_ns
              for k in store.list_keys(DST)}
    result = port_builder(store, tmp_path, port_extractor).process_source("1")
    assert (result.images_skipped, result.images_done) == (3, 1)
    for key, mtime in before.items():
        assert store._path(DST, key).stat().st_mtime_ns == mtime


def test_no_skip_existing_redoes_everything(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"))
    port_builder(store, tmp_path, port_extractor).process_source("1")
    result = port_builder(store, tmp_path, port_extractor,
                          skip_existing=False).process_source("1")
    assert (result.images_done, result.images_skipped) == (4, 0)


def test_progress_log_failure_does_not_fail_images(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"))
    builder = port_builder(store, tmp_path, port_extractor)

    def broken_progress(record):
        raise OSError("disk full")

    builder._record_progress = broken_progress
    result = builder.process_source("1")
    assert (result.images_done, result.images_failed) == (4, 0)
    rowcols, _ = read_features(store, "1", "10")
    assert rowcols.shape == (3, 2)


def test_per_image_failure_isolation(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"), corrupt=True)
    result = port_builder(store, tmp_path, port_extractor).run(["1"])
    assert result.exit_code == 1
    source = result.sources[0]
    assert (source.images_done, source.images_failed) == (3, 1)
    assert source.failures[0][0] == CORRUPT
    assert source.points_done == 3 + 9 + 1
    assert "12" in (tmp_path / "errors.csv").read_text()


def test_failing_write_and_dispatch_are_isolated(tmp_path, port_extractor):
    """A failure in the writer thread (the store write) and one in the
    dispatch (a point outside the image) each fail only their image."""
    store = populate(TStore(tmp_path / "store"))
    rows = list(csv.reader(io.StringIO(
        store.get_bytes(SRC, tfb.annotations_key("1")).decode())))
    rows.append(["13", "s1/images/13.png", "500", "0"])
    store.put_bytes(SRC, tfb.annotations_key("1"), csv_bytes(rows[0], rows[1:]))
    builder = port_builder(store, tmp_path, port_extractor)
    real_write = builder._write_features

    def write(source_id, image_id, rowcols, features):
        if image_id == "10":
            raise OSError("bucket unavailable")
        return real_write(source_id, image_id, rowcols, features)

    builder._write_features = write
    result = builder.process_source("1")
    assert (result.images_done, result.images_failed) == (2, 2)
    assert sorted(f[0] for f in result.failures) == ["10", "13"]


def test_injected_decoder(tmp_path, port_extractor):
    """``decode_image=`` replaces the default decoder (here: .npy bytes)."""
    store = TStore(tmp_path / "store")
    image = np.random.default_rng(4).integers(0, 256, (30, 20, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.save(buf, image)
    store.put_bytes(SRC, "s5/a.raw", buf.getvalue())
    store.put_bytes(SRC, tfb.annotations_key("5"), csv_bytes(
        ("image_id", "image_key", "row", "col"), [("a", "s5/a.raw", 1, 2)]))
    seen = []

    def decode(data):
        seen.append(len(data))
        return np.load(io.BytesIO(data))

    result = port_builder(store, tmp_path, port_extractor,
                          decode_image=decode).process_source("5")
    assert result.images_done == 1 and seen == [len(buf.getvalue())]
    _, feats = read_features(store, "5", "a")
    np.testing.assert_array_equal(
        feats, port_extractor.extract_features(image, [[1, 2]]))


def test_missing_annotation_column_raises(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"))
    store.put_bytes(SRC, tfb.annotations_key("1"), b"image_id,row,col\n10,1,2\n")
    with pytest.raises(ValueError, match="missing columns.*image_key"):
        port_builder(store, tmp_path, port_extractor).read_annotations("1")


def test_filter_to_available_sources(tmp_path, port_extractor):
    store = populate(TStore(tmp_path / "store"))
    builder = port_builder(store, tmp_path, port_extractor)
    assert builder.filter_to_available_sources(["1", "2", "7", 9]) == (
        ["1", "2", "9"], ["7"])


ANNOTATION_CSVS = [
    b"image_id,image_key,row,col\nb,k1,1,2\na,k2,3.0,4\nb,k1,5,6\n",
    b"image_id,image_key,row,col,extra\nNA,k,1,2,\nnull,k2,3,4,x\n",
    b"\xef\xbb\xbfimage_id,image_key,row,col\n10,k,1,2\n\n11,k,2,3\n",
    b"Name,Row,Column\na.JPG,5,6\nb.JPG,9,10\nghost.JPG,1,1\nNA,2,3\n",
]


@pytest.mark.parametrize("raw", ANNOTATION_CSVS)
def test_read_annotations_matches_jax(tmp_path, port_extractor, raw):
    image_list = csv_bytes(("Name", "Image Page"), [
        ("a.JPG - Confirmed", "/image/100/view/"),
        ("b.JPG - Unclassified", "https://x/image/200/view/"),
        ("NA", "/image/300/view/")])
    got = []
    for store_cls, mod, ext in ((JStore, jfb, None), (TStore, tfb, port_extractor)):
        store = store_cls(tmp_path / mod.__name__.split(".")[0])
        store.put_bytes(SRC, mod.annotations_key("4"), raw)
        store.put_bytes(SRC, "s4/image_list.csv", image_list)
        got.append(mod.FeatureBucketBuilder(store, SRC, DST, ext).read_annotations("4"))
    jdf, annotations = got
    want = list(zip(jdf["image_id"], jdf["image_key"], jdf["row"], jdf["col"]))
    assert [(a.image_id, a.image_key, a.row, a.col) for a in annotations] == want
    assert all(isinstance(a.row, int) and isinstance(a.col, int)
               for a in annotations)


IMAGE_LISTS = [
    [("a.JPG - Confirmed", "/image/100/view/"), ("b.JPG - Unconfirmed", "/image/200/view/")],
    [("NA - Confirmed", "/image/1/view/"), ("null", "/image/2/view/"),
     ("None  -  Unclassified ", "/image/3/view/"), ("", "/image/4/view/"),
     ("c.JPG", "no page"), ("d.JPG - Confirmed - Confirmed", "/image/5/view/")],
    [("a.JPG - Confirmed", "/image/1/view/"), ("a.JPG", "/image/1/view/")],
    [("a.JPG - Confirmed", "/image/1/view/"), ("a.JPG - Unconfirmed", "/image/2/view/")],
]


@pytest.mark.parametrize("entries", IMAGE_LISTS)
def test_name_to_image_id_matches_jax(tmp_path, entries):
    raw = csv_bytes(("Name", "Image Page", "Image URL"),
                    [(n, p, "") for n, p in entries])
    got = []
    for store_cls, mod in ((JStore, jfb), (TStore, tfb)):
        store = store_cls(tmp_path / mod.__name__.split(".")[0])
        store.put_bytes(SRC, "s3/image_list.csv", raw)
        builder = mod.FeatureBucketBuilder(store, SRC, DST, None)
        try:
            got.append(("ok", builder._name_to_image_id("3")))
        except ValueError as exc:
            got.append(("raised", str(exc)))
    assert got[1] == got[0]


class TestCoralNetLayout:
    def test_names_map_through_image_list(self, tmp_path, port_extractor):
        store = populate(TStore(tmp_path / "store"))
        annotations = port_builder(store, tmp_path, port_extractor).read_annotations("9")
        assert [(a.image_id, a.image_key, a.row, a.col) for a in annotations] == [
            ("100", "s9/images/100.jpg", 5, 6), ("200", "s9/images/200.jpg", 9, 10),
            ("100", "s9/images/100.jpg", 39, 0)]

    def test_end_to_end_extraction(self, tmp_path, port_extractor):
        store = populate(TStore(tmp_path / "store"))
        result = port_builder(store, tmp_path, port_extractor).process_source("9")
        assert (result.images_failed, result.images_done, result.points_done) == (0, 2, 3)
        rowcols, feats = read_features(store, "9", "100")
        assert rowcols.tolist() == [[5, 6], [39, 0]]
        assert feats.shape == (2, TINY.feature_dim)

    def test_missing_image_list_is_loud(self, tmp_path, port_extractor):
        store = TStore(tmp_path / "store")
        store.put_bytes(SRC, tfb.annotations_key("7"), b"Name,Row,Column\na.JPG,1,2\n")
        with pytest.raises(ValueError, match="image_list.csv"):
            port_builder(store, tmp_path, port_extractor).read_annotations("7")

    def test_malformed_image_list_is_loud(self, tmp_path, port_extractor):
        store = TStore(tmp_path / "store")
        store.put_bytes(SRC, tfb.annotations_key("8"), b"Name,Row,Column\na.JPG,1,2\n")
        store.put_bytes(SRC, "s8/image_list.csv", b"foo,bar\n1,2\n")
        with pytest.raises(ValueError, match="required columns"):
            port_builder(store, tmp_path, port_extractor).read_annotations("8")


def test_readback_hand_off_on_cpu(port_extractor):
    image = np.random.default_rng(2).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    rowcols = np.array([[0, 0], [39, 49], [20, 25]], np.int32)
    readback = port_extractor.extract_features_async(image, rowcols)
    np.testing.assert_array_equal(
        readback.wait(), port_extractor.extract_features(image, rowcols))
    empty = port_extractor.extract_features_async(image, np.zeros((0, 2), np.int32))
    assert empty.wait().shape == (0, TINY.feature_dim)


class TestCLI:
    """``python -m mermaid_classifier_tpu_torch.scripts.build_feature_bucket``
    on the CPU, from a weights bundle with its config sidecar."""

    @pytest.fixture()
    def cli_env(self, tmp_path, store_root_env, variables):
        from mermaid_classifier_tpu_torch.models.convert import save_backbone_npz

        store = populate(TStore(tmp_path / "store"), corrupt=True)
        store_root_env(tmp_path / "store")
        weights = tmp_path / "weights.npz"
        save_backbone_npz(str(weights), variables, port_config(TINY))
        return store, weights

    def _argv(self, tmp_path, weights, *extra):
        return ["--source-ids", "1,2,7", "--source-bucket", SRC,
                "--target-bucket", DST, "--backbone-weights", str(weights),
                "--device", "cpu", "--backbone-batch", "8",
                "--progress-log", str(tmp_path / "progress.jsonl"),
                "--error-log", str(tmp_path / "errors.csv"), *extra]

    def test_cli_matches_builder(self, tmp_path, cli_env, port_extractor):
        from mermaid_classifier_tpu_torch.scripts import build_feature_bucket as cli

        store, weights = cli_env
        assert cli.main(self._argv(tmp_path, weights)) == 1  # the corrupt image
        assert len(log_records(tmp_path)[1]) == 1
        ref = populate(TStore(tmp_path / "ref"), corrupt=True)
        port_builder(ref, tmp_path / "ref_logs", text.build_extractor(
            *_bundle(weights), device="cpu", backbone_batch=8)).run(["1", "2"])
        assert sorted(store.list_keys(DST)) == sorted(ref.list_keys(DST))
        for image_id in ("10", "11", "13"):
            np.testing.assert_array_equal(read_features(store, "1", image_id)[1],
                                          read_features(ref, "1", image_id)[1])
        # Resume: nothing is rewritten; the corrupt image fails again.
        mtimes = {k: store._path(DST, k).stat().st_mtime_ns
                  for k in store.list_keys(DST)}
        assert cli.main(self._argv(tmp_path, weights)) == 1
        assert {k: store._path(DST, k).stat().st_mtime_ns
                for k in store.list_keys(DST)} == mtimes
        assert len(log_records(tmp_path)[0]) == 4

    def test_bf16_runs_the_gate(self, tmp_path, cli_env, monkeypatch):
        from mermaid_classifier_tpu_torch.scripts import build_feature_bucket as cli

        store, weights = cli_env
        calls = []
        real = text.FeatureExtractor.verify_device_numerics

        def spy(self, *args, **kwargs):
            calls.append(self.config.compute_dtype)
            return real(self, *args, **kwargs)

        monkeypatch.setattr(text.FeatureExtractor, "verify_device_numerics", spy)
        argv = self._argv(tmp_path, weights, "--source-ids", "2", "--no-skip-existing")
        assert cli.main(argv) == 0
        assert calls == []
        assert cli.main(argv + ["--compute-dtype", "bfloat16"]) == 0
        assert calls == ["bfloat16"]

    def test_no_available_source_exits_1(self, tmp_path, cli_env):
        from mermaid_classifier_tpu_torch.scripts import build_feature_bucket as cli

        _, weights = cli_env
        assert cli.main(self._argv(tmp_path, weights, "--source-ids", "7")) == 1

    def test_default_device_is_cuda(self):
        from mermaid_classifier_tpu_torch.scripts import build_feature_bucket as cli

        argv = ["--source-ids", "1", "--source-bucket", "a", "--target-bucket", "b"]
        args = cli.build_parser().parse_args(argv)
        assert (args.device, cli.backbone_impl_for(args)) == ("cuda", "fused")
        # A mesh defaults to the sharded trunk, "folded", as the JAX CLI does.
        meshed = cli.build_parser().parse_args(argv + ["--mesh-devices", "2"])
        assert cli.backbone_impl_for(meshed) == "folded"


def _bundle(path: Path):
    from mermaid_classifier_tpu_torch.models.convert import load_backbone_bundle

    return load_backbone_bundle(str(path))


def test_counters_and_logs_survive_thread_switching(tmp_path):
    """Stress: 60 images through 16 decode threads with a 1 µs switch
    interval, some failing in the main thread (decode) and some in the
    writer thread (the store write): the counters and logs, shared by
    both threads under one lock, account for every image exactly once."""
    import sys

    import torch

    from mermaid_classifier_tpu_torch.models.extractor import FeatureReadback

    class StubExtractor:
        def extract_features_async(self, image, rowcols):
            return FeatureReadback(torch.full((len(rowcols), 4), float(image[0, 0, 0])))

    store = TStore(tmp_path / "store")
    rows = []
    for i in range(60):
        buf = io.BytesIO()
        np.save(buf, np.full((4, 4, 3), i, np.uint8))
        data = b"broken" if i % 7 == 0 else buf.getvalue()
        store.put_bytes(SRC, f"s6/{i}.npy", data)
        rows += [(f"{i:02d}", f"s6/{i}.npy", r, 0) for r in range(i % 3 + 1)]
    store.put_bytes(SRC, tfb.annotations_key("6"),
                    csv_bytes(("image_id", "image_key", "row", "col"), rows))
    builder = port_builder(store, tmp_path, StubExtractor(), decode_workers=16,
                           prefetch=5)
    real_write = builder._write_features

    def write(source_id, image_id, rowcols, features):
        if int(image_id) % 5 == 0:
            raise OSError("bucket unavailable")
        return real_write(source_id, image_id, rowcols, features)

    builder._write_features = write
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        result = builder.process_source("6")
    finally:
        sys.setswitchinterval(interval)
    failed = {f"{i:02d}" for i in range(60) if i % 7 == 0 or i % 5 == 0}
    assert result.images_failed == len(failed)
    assert sorted(f[0] for f in result.failures) == sorted(failed)
    assert result.images_done == 60 - len(failed)
    assert result.points_done == sum(i % 3 + 1 for i in range(60)
                                     if f"{i:02d}" not in failed)
    progress, errors = log_records(tmp_path)
    assert sorted(r["image_id"] for r in progress) == sorted(
        f"{i:02d}" for i in range(60) if f"{i:02d}" not in failed)
    assert sorted(e["image_id"] for e in errors) == sorted(failed)
