"""The port's settings (a plain dataclass) against the JAX package's
pydantic settings: the same fields and defaults (the JAX-only fields
aside, which the port does not read), the same values from the same
environment and ``.env`` file, invalid values refused by both, the same
override / restore and env forwarding, and ``training_batch_size`` equal
for a given available-memory reading (JAX reads psutil's ``available``,
the port ``/proc/meminfo`` ``MemAvailable``, the same number on Linux).
Every comparison is exact, except the live memory readings against
psutil, which are bracketed by two psutil readings."""

import os
from types import SimpleNamespace

import psutil
import pytest

from mermaid_classifier_tpu.config import settings as jset
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.utils import system_metrics as tsys

# Fields nothing in the port reads; an environment that sets them changes
# nothing in the port.
JAX_ONLY = {
    "jax_compilation_cache_dir",
    "extractor_backbone_batch",
    "extractor_point_bucket",
    "extractor_image_bucket",
    "weights_location",
    "coralnet_annotations_csv_pattern",
}


def _values(s, names):
    return {n: getattr(s, n) for n in names}


def test_fields_and_defaults_match_jax():
    names = tset.Settings.field_names()
    assert names == [n for n in jset.Settings.model_fields if n not in JAX_ONLY]
    assert _values(tset.Settings(), names) == _values(jset.Settings(), names)
    assert tset.FEATURE_DIM == jset.FEATURE_DIM


ENV_CASES = {
    "file_only": ({}, "DOWNLOAD_MAX_WORKERS=7\nFEATURE_CACHE_DIR=/tmp/cache\n"
                  "# comment\nTRAINING_INPUTS_PERCENT_MISSING_ALLOWED=5\n"),
    "env_beats_file": ({"DOWNLOAD_MAX_WORKERS": "9", "BATCH_SIZE": "200"},
                       "DOWNLOAD_MAX_WORKERS=7\nBATCH_SIZE=100\n"),
    "quoted_and_optional": ({"TRACKING_DIR": "/runs"},
                            "TAXONOMY_FIXTURE_DIR='/tax dir'\n"
                            'OBJECT_STORE_ROOT="/store"\nTRAIN_MESH_DEVICES=4\n'),
    "packed_cache_off": ({"USE_PACKED_FEATURE_CACHE": "0"}, ""),
    "packed_cache_words": ({"USE_PACKED_FEATURE_CACHE": "Off"},
                           "USE_PACKED_FEATURE_CACHE=yes\n"),
    "packed_cache_file": ({}, "USE_PACKED_FEATURE_CACHE=TRUE\n"),
    "jax_only_names": ({},
                       "NOT_A_FIELD=1\nEXTRACTOR_BACKBONE_BATCH=64\n"
                       "WEIGHTS_LOCATION=/w.npz\n"),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_from_env_matches_jax(tmp_path, monkeypatch, case):
    env, text = ENV_CASES[case]
    for name in tset.Settings.field_names():
        monkeypatch.delenv(name.upper(), raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    env_file = tmp_path / ".env"
    env_file.write_text(text)
    names = tset.Settings.field_names()
    assert _values(tset.Settings.from_env(env_file), names) == \
        _values(jset.Settings.from_env(env_file), names)


@pytest.mark.parametrize("text", ["BATCH_SIZE=not_a_number\n",
                                  "DOWNLOAD_MAX_WORKERS=1.5\n",
                                  "USE_PACKED_FEATURE_CACHE=maybe\n"])
def test_invalid_values_refused_by_both(tmp_path, text):
    env_file = tmp_path / ".env"
    env_file.write_text(text)
    with pytest.raises(Exception):
        jset.Settings.from_env(env_file)
    with pytest.raises(ValueError):
        tset.Settings.from_env(env_file)


def test_override_restores_and_validates():
    original = tset.settings.download_max_workers
    with pytest.raises(RuntimeError):
        with tset.override_settings(download_max_workers="3"):
            assert tset.settings.download_max_workers == 3
            raise RuntimeError("boom")
    assert tset.settings.download_max_workers == original


def test_apply_settings_to_env(monkeypatch):
    monkeypatch.delenv("MERMAID_TAXONOMY_FIXTURE_DIR", raising=False)
    with tset.override_settings(taxonomy_fixture_dir="/tmp/tax"):
        tset.apply_settings_to_env()
        assert os.environ["MERMAID_TAXONOMY_FIXTURE_DIR"] == "/tmp/tax"


def test_reload_settings_in_place(monkeypatch):
    obj = tset.settings
    monkeypatch.setenv("DOWNLOAD_MAX_WORKERS", "11")
    try:
        assert tset.reload_settings_from_env("/nonexistent/.env") is obj
        assert obj.download_max_workers == 11
    finally:
        monkeypatch.delenv("DOWNLOAD_MAX_WORKERS")
        tset.reload_settings_from_env("/nonexistent/.env")


@pytest.mark.parametrize("available", [0, 10**9, 37 * 10**9 + 12345, 10**12])
@pytest.mark.parametrize("num_classes", [3, 80, 300, 5000])
def test_training_batch_size_matches_jax(monkeypatch, available, num_classes):
    monkeypatch.setattr(jset.psutil, "virtual_memory",
                        lambda: SimpleNamespace(available=available))
    monkeypatch.setattr(tset, "meminfo_bytes",
                        lambda field: {"MemAvailable": available}[field])
    assert tset.training_batch_size(num_classes) == \
        jset.training_batch_size(num_classes)


def test_meminfo_reads_what_psutil_reads():
    """MemAvailable against psutil on this host. The readings are live, so
    the port's lies between two psutil readings taken around it (within
    1 MiB), on one of five tries."""
    assert tset.meminfo_bytes("MemTotal") == psutil.virtual_memory().total
    for _ in range(5):
        before = psutil.virtual_memory().available
        got = tset.meminfo_bytes("MemAvailable")
        after = psutil.virtual_memory().available
        if min(before, after) - 2**20 <= got <= max(before, after) + 2**20:
            break
    else:
        pytest.fail(f"MemAvailable {got} outside psutil's {before}..{after}")
    for _ in range(5):
        before = psutil.virtual_memory().percent
        got = tsys.memory_used_percent()
        after = psutil.virtual_memory().percent
        if min(before, after) - 0.1 <= got <= max(before, after) + 0.1:
            break
    else:
        pytest.fail(f"memory used {got}% outside psutil's {before}..{after}")
    assert tsys.swap_used_percent() == pytest.approx(psutil.swap_memory().percent,
                                                     abs=0.1)
