"""The port's fidelity runbook on the CPU, held against the JAX scripts:
``mermaid_classifier_tpu_torch.scripts.diff_backbone`` (self-test and a
pyspacer-lineage ``efficientnet.pt``), its record and bundle as the port's
``release_artifact`` takes them, and ``extract_reference_features``.

The JAX CLIs run in this process (``scripts/diff_backbone.py``,
``scripts/extract_reference_features.py``): the port's record must carry
the JAX record's keys and layer count, its bundle must be the JAX
conversion bit for bit, and its stacked ``.npy`` the JAX script's bytes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.models import convert as jconv
from mermaid_classifier_tpu.models import efficientnet as jeff
from mermaid_classifier_tpu.models import remap as jremap
from mermaid_classifier_tpu_torch.data.features_io import write_feature_file
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
from mermaid_classifier_tpu_torch.models import canonical_mirror as tmirror
from mermaid_classifier_tpu_torch.models import convert as tconv
from mermaid_classifier_tpu_torch.models import efficientnet as teff
from mermaid_classifier_tpu_torch.scripts import diff_backbone as tdiff
from mermaid_classifier_tpu_torch.scripts import extract_reference_features as textract
from mermaid_classifier_tpu_torch.serve.release import ReleaseError, release_artifact
from tests.parity import foreign_checkpoints as fc
from tests.test_torch_release import artifact_dir  # noqa: F401 (fixture)
from tests.test_torch_remap import _assert_same_tree

REPO = Path(__file__).resolve().parents[1]
TINY = {
    "stem_channels": 8,
    "stages": [[1, 8, 1, 1, 3], [6, 16, 2, 2, 5]],
    "head_channels": 32,
    "se_ratio": 0.25,
    "feature_dim": 64,
    "patch_size": 32,
}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture(scope="module")
def jax_record(tmp_path_factory, tiny_json):
    out = tmp_path_factory.mktemp("jrec") / "record.json"
    assert _jax_script("diff_backbone").main(
        ["--self-test", "--config-json", tiny_json, "--record", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def lukemelas_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "efficientnet.pt"
    fc.save_pyspacer_efficientnet_pt(fc.build_lukemelas_b0(seed=4), path)
    return path


@pytest.fixture(scope="module")
def lukemelas_run(tmp_path_factory, lukemelas_pt):
    """The runbook's first step on the pyspacer-lineage checkpoint."""
    out = tmp_path_factory.mktemp("lm_out")
    argv = [str(lukemelas_pt), "--device", "cpu", "--probe-batch", "2",
            "--save-npz", str(out / "backbone.npz"),
            "--record", str(out / "fidelity.json"),
            "--dump-remap", str(out / "remap.csv")]
    return tdiff.main(argv), out


@pytest.mark.parametrize("padding", ["symmetric", "tf_same"])
def test_self_test_green_in_both_padding_modes(tiny_json, padding, capsys):
    rc = tdiff.main(["--self-test", "--device", "cpu", "--config-json",
                     tiny_json, "--padding", padding])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ALL GREEN" in out and f"padding={padding}" in out


def test_self_test_record_has_jax_keys(tmp_path, tiny_json, jax_record):
    record_path = tmp_path / "record.json"
    assert tdiff.main(["--self-test", "--device", "cpu", "--config-json",
                       tiny_json, "--record", str(record_path)]) == 0
    record = json.loads(record_path.read_text())
    assert list(record) == list(jax_record)
    for key in ("all_green", "n_layers_compared", "n_layers_failed",
                "feature_tol", "layer_tol", "padding", "bn_eps",
                "naming_scheme", "weights_file", "weights_sha256",
                "probe_batch", "seed"):
        assert record[key] == jax_record[key], key
    assert record["feature_mae"] < 1e-6 and jax_record["feature_mae"] < 1e-6
    assert record["command"].startswith(
        "python -m mermaid_classifier_tpu_torch.scripts.diff_backbone --self-test")


def test_lukemelas_checkpoint_all_green(lukemelas_run):
    rc, out = lukemelas_run
    assert rc == 0
    record = json.loads((out / "fidelity.json").read_text())
    assert record["all_green"] and record["naming_scheme"] == "lukemelas"
    assert record["padding"] == "tf_same" and record["bn_eps"] == 1e-3
    assert record["feature_mae"] < 1e-4
    assert record["worst_layer_max_abs"] <= record["layer_tol"]
    # B0: stem and head 3 rows each, 15 blocks with an expand (13 rows), one
    # without (10), and the projection.
    assert record["n_layers_compared"] == 3 + 15 * 13 + 10 + 3 + 1
    assert record["weights_sha256"] == hashlib.sha256(
        (out / "backbone.npz").read_bytes()).hexdigest()


def test_saved_bundle_is_the_jax_conversion(lukemelas_run, lukemelas_pt):
    _, out = lukemelas_run
    payload = torch.load(lukemelas_pt, map_location="cpu", weights_only=True)
    jcfg = jeff.EfficientNetConfig(padding="tf_same")
    sd = jremap.strip_module_prefix(payload["net"])
    canonical, _, _ = jremap.remap_state_dict(sd, jcfg)
    want = jconv.torch_state_dict_to_variables(canonical, jcfg)
    got, config = tconv.load_backbone_bundle(str(out / "backbone.npz"))
    _assert_same_tree(got, want)
    assert config.to_dict() == jcfg.to_dict()
    _, jconfig = jconv.load_backbone_bundle(str(out / "backbone.npz"))
    assert jconfig == jcfg


def test_remap_dump_is_the_jax_table(lukemelas_run, lukemelas_pt):
    _, out = lukemelas_run
    payload = torch.load(lukemelas_pt, map_location="cpu", weights_only=True)
    _, applied, _ = jremap.remap_state_dict(
        jremap.strip_module_prefix(payload["net"]),
        jeff.EfficientNetConfig(padding="tf_same"))
    lines = (out / "remap.csv").read_text().splitlines()
    assert lines[0] == "source_key,canonical_key"
    assert lines[1:] == [f"{k},{v}" for k, v in sorted(applied.items())]


def test_failed_diff_saves_nothing_and_records_the_failure(tmp_path, lukemelas_pt,
                                                           capsys):
    # A layer gate no f32 run can meet: the rows fail, so no bundle is
    # written and the record, all_green false, hashes the input checkpoint.
    rc = tdiff.main([str(lukemelas_pt), "--device", "cpu", "--probe-batch", "2",
                     "--layer-tol", "1e-12",
                     "--save-npz", str(tmp_path / "b.npz"),
                     "--record", str(tmp_path / "r.json")])
    assert rc == 1
    assert "FAIL" in capsys.readouterr().out
    record = json.loads((tmp_path / "r.json").read_text())
    assert record["all_green"] is False and record["n_layers_failed"] > 0
    assert not (tmp_path / "b.npz").exists()
    assert record["weights_file"] == str(lukemelas_pt)
    assert record["weights_sha256"] == hashlib.sha256(
        lukemelas_pt.read_bytes()).hexdigest()


def test_unpaired_layer_fails(tiny_json, monkeypatch, capsys):
    pairs = tdiff.layer_pairs
    monkeypatch.setattr(tdiff, "layer_pairs", lambda config: pairs(config)[:-2])
    rc = tdiff.main(["--self-test", "--device", "cpu", "--config-json", tiny_json])
    assert rc == 1
    assert "unpaired" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["b0", "tiny", "no_projection"])
def test_pairing_table_covers_both_networks(name):
    config = {
        "b0": teff.EfficientNetConfig(),
        "tiny": teff.EfficientNetConfig.from_dict(TINY),
        "no_projection": teff.EfficientNetConfig.from_dict(
            {**TINY, "feature_dim": TINY["head_channels"]}),
    }[name]
    pairs = tdiff.layer_pairs(config)
    mirror = {n for n, _ in tmirror.CanonicalMirror(config).named_modules() if n}
    port = {n for n, _ in teff.EfficientNetBackbone(config).named_modules() if n}
    assert [m for m, _ in pairs] == sorted(mirror, key=[m for m, _ in pairs].index)
    assert {m for m, _ in pairs} == mirror
    assert {p for _, p in pairs} - {""} == port - {"feature_projection"}
    assert ("feature_projection", "") in pairs or "feature_projection" not in port


def test_cuda_device_raises_without_a_card(tiny_json):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdiff.main(["--self-test", "--config-json", tiny_json])


@pytest.mark.parametrize("layout", ["plain", "net", "state_dict", "npz", "scripted"])
def test_load_state_dict_equals_jax(tmp_path, layout):
    jdiff = _jax_script("diff_backbone")
    config = teff.EfficientNetConfig.from_dict(TINY)
    torch.manual_seed(1)
    model = tmirror.CanonicalMirror(config).eval()
    sd = model.state_dict()
    path = tmp_path / ("w.npz" if layout == "npz" else "w.pt")
    if layout == "plain":
        torch.save(sd, path)
    elif layout == "net":
        torch.save({"net": {f"module.{k}": v for k, v in sd.items()}}, path)
    elif layout == "state_dict":
        torch.save({"state_dict": sd}, path)
    elif layout == "npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.jit.save(torch.jit.trace(model, torch.zeros(1, 3, 32, 32)), path)
    got, want = tdiff.load_state_dict(str(path)), jdiff.load_state_dict(str(path))
    assert list(got) == list(want)
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key


class TestRelease:
    """The runbook's second step: ``release_artifact`` with the bundle, its
    sidecar and the record."""

    def test_record_accepted_and_tampered_bundle_refused(
            self, tmp_path, lukemelas_run, artifact_dir):  # noqa: F811
        _, out = lukemelas_run
        npz, sidecar = out / "backbone.npz", out / "backbone.config.json"
        store = LocalFSObjectStore(tmp_path / "store")
        written = release_artifact(
            store, "releases", "v1", artifact_dir, extra_files=[npz, sidecar],
            fidelity_record=out / "fidelity.json", device="cpu")
        assert "classifier/v1/backbone.npz" in written
        assert store.get_bytes("releases", "classifier/v1/backbone.npz") == \
            npz.read_bytes()
        tampered = tmp_path / "backbone.npz"
        data = bytearray(npz.read_bytes())
        data[len(data) // 2] ^= 1
        tampered.write_bytes(bytes(data))
        shutil.copy(sidecar, tmp_path / "backbone.config.json")
        with pytest.raises(ReleaseError, match="sha256 mismatch"):
            release_artifact(
                store, "releases", "v2", artifact_dir,
                extra_files=[tampered, tmp_path / "backbone.config.json"],
                fidelity_record=out / "fidelity.json", device="cpu")
        assert list(store.list_keys("releases", prefix="classifier/v2/")) == []

    def test_record_with_changed_hash_refused(self, tmp_path, lukemelas_run,
                                              artifact_dir):  # noqa: F811
        _, out = lukemelas_run
        record = json.loads((out / "fidelity.json").read_text())
        record["weights_sha256"] = "0" * 64
        bad = tmp_path / "fidelity.json"
        bad.write_text(json.dumps(record))
        with pytest.raises(ReleaseError, match="sha256 mismatch"):
            release_artifact(
                LocalFSObjectStore(tmp_path / "store"), "releases", "v1",
                artifact_dir, extra_files=[out / "backbone.npz"],
                fidelity_record=bad, device="cpu")

    def test_missing_record_names_the_port_script(self, tmp_path, lukemelas_run,
                                                  artifact_dir):  # noqa: F811
        _, out = lukemelas_run
        with pytest.raises(ReleaseError,
                           match="mermaid_classifier_tpu_torch.scripts.diff_backbone"):
            release_artifact(
                LocalFSObjectStore(tmp_path / "store"), "releases", "v1",
                artifact_dir, extra_files=[out / "backbone.npz"], device="cpu")


class TestExtractReferenceFeatures:
    @staticmethod
    def _inputs(tmp):
        rng = np.random.default_rng(3)
        files = []
        for i, n in enumerate((3, 5)):
            path = tmp / f"i{i}.features.npz"
            write_feature_file(path, rng.integers(0, 500, (n, 2)).astype(np.int32),
                               rng.normal(size=(n, 16)).astype(np.float32))
            files.append(path)
        legacy = tmp / "legacy.featurevector"
        feats = rng.normal(size=(2, 16)).astype(np.float32)
        legacy.write_text(json.dumps({"point_features": [
            {"row": i, "col": 2 * i, "data": feats[i].tolist()} for i in range(2)]}))
        return [*files, legacy]

    @pytest.mark.parametrize("extra", [[], ["--max-rows", "6"]])
    def test_same_npy_bytes_as_jax(self, tmp_path, extra):
        inputs = [str(p) for p in self._inputs(tmp_path)]
        jmain = _jax_script("extract_reference_features").main
        assert textract.main(["--output", str(tmp_path / "t" / "ref.npy"),
                              *inputs, *extra]) == 0
        assert jmain(["--output", str(tmp_path / "j" / "ref.npy"),
                      *inputs, *extra]) == 0
        got = (tmp_path / "t" / "ref.npy").read_bytes()
        assert got == (tmp_path / "j" / "ref.npy").read_bytes()
        assert np.load(tmp_path / "t" / "ref.npy").shape == (6 if extra else 10, 16)

    def test_missing_and_empty_refused(self, tmp_path):
        assert textract.main(["--output", str(tmp_path / "o.npy"),
                              str(tmp_path / "absent.features.npz")]) == 1
        empty = tmp_path / "e.features.npz"
        write_feature_file(empty, np.zeros((0, 2), np.int32),
                           np.zeros((0, 16), np.float32))
        assert textract.main(["--output", str(tmp_path / "o.npy"), str(empty)]) == 1
        assert not (tmp_path / "o.npy").exists()
