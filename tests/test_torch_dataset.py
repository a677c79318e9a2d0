"""The port's ``TrainingDataset`` against the JAX one on the same seeded
environment (``tests/data/dataset_fixtures.build_environment``, real
parquet tables, the taxonomy getters patched to the same records).

For each option set the two ETLs must leave equal ``annotations`` tables
(the same columns with the same declared types, the same rows in the same
order, ``training_set`` included), equal split ``annotation_items`` (paths
taken relative to each package's feature cache), equal artifact tables as
CSV text (unmapped labels, label mapping, project stats, BA and BA-GF
counts, the subsample audit), equal summary stats, source ids and profiled
section names. A missing-feature case under the tolerance drops the same
rows; over it, both raise with the same text. Every comparison is exact.

``pandas_str`` is pinned against pandas' own ``Series.astype(str)`` on
integer ids, string ids, nulls and an integer column holding a null."""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from mermaid_classifier_tpu.config.options import DatasetOptions as JOptions
from mermaid_classifier_tpu.data.dataset import TrainingDataset as JDataset
from mermaid_classifier_tpu.data.subsample import SubsampleOptions as JSub
from mermaid_classifier_tpu_torch.common.relational import (
    pandas_str,
    read_parquet_columns,
)
from mermaid_classifier_tpu_torch.common.table import to_csv_text
from mermaid_classifier_tpu_torch.config.options import DatasetOptions as TOptions
from mermaid_classifier_tpu_torch.data.dataset import TrainingDataset as TDataset
from mermaid_classifier_tpu_torch.data.subsample import SubsampleOptions as TSub

from tests.data.dataset_fixtures import patch_taxonomy
from tests.torch_recipe_env import both_settings, build_both, patch_port_taxonomy


def _csv_files(tmp_path):
    rollup = tmp_path / "rollups.csv"
    rollup.write_text("from_ba_id,from_gf_id,to_ba_id,to_gf_id\n"
                      "ba-acro,gf-br,ba-hard,\nba-porites,gf-ma,ba-hard,\n")
    include = tmp_path / "included.csv"
    include.write_text("ba_id,gf_id\nba-acro,gf-br\nba-algae,\n")
    exclude = tmp_path / "excluded.csv"
    exclude.write_text("ba_id,gf_id\nba-algae,\n")
    return {"rollup": str(rollup), "include": str(include), "exclude": str(exclude)}


OPTION_SETS = {
    "none": lambda f: {},
    "rollup": lambda f: {"label_rollup_spec_csv": f["rollup"]},
    "include": lambda f: {"included_labels_csv": f["include"]},
    "exclude": lambda f: {"excluded_labels_csv": f["exclude"]},
    "drop_growthforms": lambda f: {"drop_growthforms": True},
    "stratified": lambda f: {"subsample": ("stratified", 90, 3)},
    "balanced": lambda f: {"subsample": ("balanced", 60, 5)},
    "mermaid_only": lambda f: {"coralnet_manifest_uri": None},
    "coralnet_only": lambda f: {"include_mermaid": False},
}


def _options(cls, sub_cls, manifest_path, kw):
    kw = dict(kw)
    kw.setdefault("coralnet_manifest_uri", manifest_path)
    if "subsample" in kw:
        strategy, total, floor = kw["subsample"]
        kw["subsample"] = sub_cls(strategy=strategy, total_annotations=total,
                                  min_per_class=floor)
    return cls(**kw)


def _both_datasets(tmp_path, monkeypatch, kw, settings=None, **env_kw):
    jstore, tstore, manifest_path, mermaid_path = build_both(tmp_path, **env_kw)
    patch_taxonomy(monkeypatch)
    patch_port_taxonomy(monkeypatch)
    with both_settings(tmp_path, mermaid_path, **(settings or {})):
        jds = JDataset(_options(JOptions, JSub, manifest_path, kw), store=jstore)
        tds = TDataset(_options(TOptions, TSub, manifest_path, kw), store=tstore)
    return jds, tds


def _rel_items(split, root):
    return [(os.path.relpath(p, root), r, c, lab)
            for p, r, c, lab in split.annotation_items()]


def _jtable(df):
    return df.to_csv(index=False)


def assert_same(jds, tds, tmp_path):
    jcur = jds.db.conn.execute("SELECT * FROM annotations")
    tcur = tds.db.conn.execute("SELECT * FROM annotations")
    assert [d[0] for d in tcur.description] == [d[0] for d in jcur.description]
    assert tcur.fetchall() == jcur.fetchall()
    assert [(r[1], r[2]) for r in
                                        tds.db.conn.execute("PRAGMA table_info(annotations)")] == [
        (r[1], r[2]) for r in jds.db.conn.execute("PRAGMA table_info(annotations)")
    ]
    for split in ("train", "ref", "val"):
        assert _rel_items(getattr(tds.labels, split), tmp_path / "cache_port") == \
            _rel_items(getattr(jds.labels, split), tmp_path / "cache_jax")
    ja, ta = jds.artifacts, tds.artifacts
    assert ta.train_summary_stats == ja.train_summary_stats
    for name in ("ba_counts", "bagf_counts", "coralnet_project_stats",
                 "mermaid_project_stats"):
        assert to_csv_text(getattr(ta, name)) == _jtable(getattr(ja, name)), name
    assert hasattr(ta, "unmapped_labels") == hasattr(ja, "unmapped_labels")
    if hasattr(ja, "unmapped_labels"):
        assert to_csv_text(ta.unmapped_labels) == _jtable(ja.unmapped_labels)
        assert to_csv_text(ta.coralnet_label_mapping) == \
            _jtable(ja.coralnet_label_mapping)
    if jds._subsample_audit_df is None:
        assert tds._subsample_audit_df is None
    else:
        assert to_csv_text(tds._subsample_audit_df) == \
            _jtable(jds._subsample_audit_df)
        assert tds._subsample_realized_total == jds._subsample_realized_total
    assert tds.coralnet_source_ids == jds.coralnet_source_ids
    assert [s["name"] for s in tds.profiled_sections] == \
        [s["name"] for s in jds.profiled_sections]
    assert tds.describe_train_summary_stats() == jds.describe_train_summary_stats()
    for spec in ("all", "s1", "i1000"):
        assert to_csv_text(tds.get_annotations(spec)) == \
            _jtable(jds.get_annotations(spec))
    assert to_csv_text(tds.compute_project_stats(has_training_sets=True)) == \
        _jtable(jds.compute_project_stats(has_training_sets=True))


@pytest.mark.parametrize("case", list(OPTION_SETS))
def test_dataset_matches_jax(tmp_path, monkeypatch, case):
    kw = OPTION_SETS[case](_csv_files(tmp_path))
    jds, tds = _both_datasets(tmp_path, monkeypatch, kw)
    try:
        assert_same(jds, tds, tmp_path)
        assert tds.db.row_count("annotations") > 0
    finally:
        jds.cleanup()
        tds.cleanup()


def test_missing_features_under_tolerance(tmp_path, monkeypatch):
    skip = ("s1/features/i1000.features.npz", "mermaid/m002.features.npz")
    jds, tds = _both_datasets(
        tmp_path, monkeypatch, {},
        settings={"training_inputs_percent_missing_allowed": 20},
        skip_feature_files=skip)
    assert_same(jds, tds, tmp_path)
    assert tds.db.scalar(
        "SELECT count(*) FROM annotations WHERE image_id IN ('1000', 'm002')") == 0


def test_missing_features_over_tolerance(tmp_path, monkeypatch):
    skip = ("s1/features/i1000.features.npz", "s2/features/i2001.features.npz")
    errors = []
    for cls, opt_cls in ((JDataset, JOptions), (TDataset, TOptions)):
        jstore, tstore, manifest_path, mermaid_path = build_both(
            tmp_path / cls.__module__, skip_feature_files=skip)
        patch_taxonomy(monkeypatch)
        patch_port_taxonomy(monkeypatch)
        store = jstore if cls is JDataset else tstore
        with both_settings(tmp_path / cls.__module__, mermaid_path,
                           training_inputs_percent_missing_allowed=5):
            with pytest.raises(RuntimeError, match="Too many feature vectors") as e:
                cls(opt_cls(coralnet_manifest_uri=manifest_path), store=store)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_bad_manifest_raises_like_jax(tmp_path, monkeypatch):
    jstore, tstore, _, mermaid_path = build_both(tmp_path)
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"not a parquet")
    errors = []
    with both_settings(tmp_path, mermaid_path):
        for cls, opt_cls, store in ((JDataset, JOptions, jstore),
                                    (TDataset, TOptions, tstore)):
            with pytest.raises(RuntimeError, match="manifest parquet") as e:
                cls(opt_cls(coralnet_manifest_uri=str(bad)), store=store)
            errors.append(str(e.value).split(" Underlying error")[0])
    assert errors[1] == errors[0]


def test_no_data_raises(tmp_path):
    _, tstore, _, mermaid_path = build_both(tmp_path)
    with both_settings(tmp_path, mermaid_path):
        with pytest.raises(ValueError, match="No annotations"):
            TDataset(TOptions(coralnet_manifest_uri=None, include_mermaid=False),
                     store=tstore)


@pytest.mark.parametrize("column", ["int", "str", "int_with_null", "str_with_null",
                                    "all_null", "float"])
def test_pandas_str_matches_astype_str(tmp_path, column):
    """The id conversion the port applies equals what the JAX package gets
    from ``pq.read_table(...).to_pandas()[c].astype(str)`` here."""
    values = {
        "int": pa.array([1001, 7, 0], pa.int64()),
        "str": pa.array(["007", "m001", ""], pa.string()),
        "int_with_null": pa.array([1001, None, 3], pa.int64()),
        "str_with_null": pa.array(["a", None, "None"], pa.string()),
        "all_null": pa.array([None, None, None], pa.null()),
        "float": pa.array([1.5, 2.0, float("nan")], pa.float64()),
    }[column]
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"c": values}), path)
    want = [None if not isinstance(v, str) and pd.isna(v) else v
            for v in pq.read_table(path).to_pandas()["c"].astype(str)]
    assert pandas_str(read_parquet_columns(path)["c"]) == want


def _null_id_env(tmp_path, int_ids: bool):
    """The fixture environment with a null image id and a null label in the
    manifest (image ids kept as integers, so pyarrow stores an integer
    column with a null, or written as strings) and nulls among the MERMAID
    growth forms."""
    jstore, tstore, manifest_path, mermaid_path = build_both(tmp_path)
    manifest = pq.read_table(manifest_path).to_pandas()
    if not int_ids:
        manifest["image_id"] = manifest["image_id"].astype(str)
    manifest["image_id"] = manifest["image_id"].astype(object)
    manifest.loc[3, "image_id"] = None
    manifest.loc[5, "coralnet_id"] = None
    pq.write_table(pa.Table.from_pandas(manifest), manifest_path)
    mermaid = pq.read_table(mermaid_path).to_pandas()
    rows = np.random.default_rng(3).integers(0, len(mermaid), 4)
    mermaid.loc[rows, "growth_form_id"] = None
    pq.write_table(pa.Table.from_pandas(mermaid), mermaid_path)
    return jstore, tstore, manifest_path, mermaid_path


def test_null_and_string_ids_flow_like_jax(tmp_path, monkeypatch):
    """String image ids with a null, a null label, null growth forms: both
    ETLs keep and drop the same rows with the same ids."""
    jstore, tstore, manifest_path, mermaid_path = _null_id_env(tmp_path, False)
    patch_taxonomy(monkeypatch)
    patch_port_taxonomy(monkeypatch)
    with both_settings(tmp_path, mermaid_path):
        jds = JDataset(JOptions(coralnet_manifest_uri=manifest_path), store=jstore)
        tds = TDataset(TOptions(coralnet_manifest_uri=manifest_path), store=tstore)
    assert_same(jds, tds, tmp_path)


def test_integer_ids_with_a_null_fail_like_jax(tmp_path, monkeypatch):
    """Integer image ids with a null are read as floats, so the ids become
    "1000.0" and name no feature file: both ETLs abort with the same text."""
    jstore, tstore, manifest_path, mermaid_path = _null_id_env(tmp_path, True)
    patch_taxonomy(monkeypatch)
    patch_port_taxonomy(monkeypatch)
    errors = []
    with both_settings(tmp_path, mermaid_path):
        for cls, opt_cls, store in ((JDataset, JOptions, jstore),
                                    (TDataset, TOptions, tstore)):
            with pytest.raises(RuntimeError, match="i1000.0.features") as e:
                cls(opt_cls(coralnet_manifest_uri=manifest_path), store=store)
            errors.append(str(e.value))
    assert errors[1] == errors[0]
