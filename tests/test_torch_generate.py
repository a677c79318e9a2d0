"""The port's training-config generator (``config/generate.py``) against
the JAX package's on the same seeded taxonomy and counts: the selected
labels, the rollups and the excluded BAs equal, and every file of the
written config directory byte-equal. The cases include a tie at the top-N
cut among more than 16 BAs (pandas' quicksort decides which are selected,
so Python's stable sort would not do), growth-form buckets, excluded names,
blank growth forms and numeric-looking ids. The ``generate_training_config``
CLI writes the JAX CLI's bytes from the same counts CSV."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from mermaid_classifier_tpu.common import taxonomy as jtax
from mermaid_classifier_tpu.config import generate as jgen
from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.common.table import Table
from mermaid_classifier_tpu_torch.config import generate as tgen

from tests.torch_recipe_env import clear_taxonomy_caches

REPO = Path(__file__).resolve().parents[1]
GFS = {"gf-br": "branching", "gf-ma": "massive", "12": "encrusting"}


def taxonomy_records():
    """3 roots x 12 genera, 2 species under each genus of root 0."""
    records = []
    for r in range(3):
        records.append({"id": f"ba-r{r}", "name": f"Root {r}", "parent": None})
        for g in range(12):
            genus = f"ba-r{r}-g{g}"
            records.append({"id": genus, "name": f"Genus {r}.{g}", "parent": f"ba-r{r}"})
            if r == 0:
                records += [{"id": f"{genus}-s{s}", "name": f"Species {g}.{s}",
                             "parent": genus} for s in range(2)]
    return records


def seeded_counts(seed, tie=True, numeric_gf=False, blank_gf=True):
    """(ba_id, gf_id, count) rows: every genus and species annotated with
    one to three growth forms (or none); with ``tie``, about two thirds of
    the genera share one total (6000), above every other BA's."""
    rng = np.random.default_rng(seed)
    gf_choices = ["gf-br", "gf-ma", "12" if numeric_gf else "gf-br"]
    rows = []
    for rec in taxonomy_records():
        if rec["parent"] is None:
            continue
        gfs = list(rng.choice(gf_choices, rng.integers(1, 4), replace=False))
        if blank_gf and rng.random() < 0.5:
            gfs.append("")
        total = int(rng.integers(50, 5000))
        if tie and rec["id"].count("-") == 2 and len(rows) % 3 != 2:
            total = 6000
        shares = rng.multinomial(total, np.ones(len(gfs)) / len(gfs))
        rows += [(rec["id"], gf, int(n)) for gf, n in zip(gfs, shares)]
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def libraries():
    records = taxonomy_records()
    return (jtax.BenthicAttributeLibrary(records), jtax.GrowthFormLibrary(GFS),
            ttax.BenthicAttributeLibrary(records), ttax.GrowthFormLibrary(GFS))


CASES = {
    "tie_at_cut": dict(seed=0, top_n=14),
    "tie_inside_selection": dict(seed=1, top_n=30),
    "no_tie": dict(seed=2, top_n=10, tie=False),
    "buckets_and_excluded": dict(seed=3, top_n=40, excluded_names={"Genus 1.3", "Root 2"},
                                 gf_buckets={"Genus 0.0": ["branching", "massive"]}),
    "numeric_gf_ids": dict(seed=4, top_n=16, numeric_gf=True),
    "numeric_gf_ids_no_blank": dict(seed=5, top_n=16, numeric_gf=True, blank_gf=False),
    "everything_selected": dict(seed=6, top_n=500),
}


def run_both(case):
    case = dict(case)
    seed, top_n = case.pop("seed"), case.pop("top_n")
    counts = seeded_counts(seed, tie=case.pop("tie", True),
                           numeric_gf=case.pop("numeric_gf", False),
                           blank_gf=case.pop("blank_gf", True))
    jba, jgf, tba, tgf = libraries()
    jout = jgen.select_labels(jba, pd.DataFrame(counts, columns=["ba_id", "gf_id", "count"]),
                              top_n=top_n, gf_library=jgf, **case)
    tout = tgen.select_labels(tba, Table(["ba_id", "gf_id", "count"], counts),
                              top_n=top_n, gf_library=tgf, **case)
    return jout, tout, jba, tba


def frame_rows(df):
    return [tuple(v.item() if hasattr(v, "item") else v for v in r)
            for r in df.itertuples(index=False)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_labels_equal_jax(name):
    jout, tout, _, _ = run_both(CASES[name])
    assert tout.included.columns == list(jout.included.columns)
    assert tout.included.rows == frame_rows(jout.included)
    assert tout.rollups.columns == list(jout.rollups.columns)
    assert tout.rollups.rows == frame_rows(jout.rollups)
    assert tout.excluded == jout.excluded
    assert tout.n_labels == jout.n_labels


def test_tie_needs_pandas_order():
    """The tie case really is one: more than 16 BAs share the total at the
    cut, and a stable sort would select other BAs than pandas does."""
    counts = seeded_counts(0)
    sums = pd.DataFrame(counts, columns=["ba_id", "gf_id", "count"]).groupby(
        "ba_id")["count"].sum()
    assert (sums == 6000).sum() > 16
    _, tout, _, _ = run_both(CASES["tie_at_cut"])
    stable = sorted(sums.index, key=lambda b: -sums[b])[:14]
    assert [r[0] for r in tout.included.rows] != stable


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_dir_files_byte_equal(tmp_path, name):
    jout, tout, jba, tba = run_both(CASES[name])
    kw = dict(sources=["12", "7", "3001"], total_annotations=31_410, min_per_class=12,
              epochs=5, experiment_name="lifecycle")
    jgen.write_config_dir(tmp_path / "jax", jout, jba, **kw)
    tgen.write_config_dir(tmp_path / "port", tout, tba, **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["README.md", "included_labels.csv", "rollups.csv", "sources.csv",
                     "training_config.yaml"]
    for fname in names:
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes(), fname


def test_empty_selection_and_errors_equal_jax(tmp_path):
    jba, jgf, tba, tgf = libraries()
    counts = [("ba-r0-g0", "", 5)]
    jout = jgen.select_labels(jba, pd.DataFrame(counts, columns=["ba_id", "gf_id", "count"]),
                              top_n=0)
    tout = tgen.select_labels(tba, Table(["ba_id", "gf_id", "count"], counts), top_n=0)
    jgen.write_config_dir(tmp_path / "jax", jout, jba)
    tgen.write_config_dir(tmp_path / "port", tout, tba)
    for fname in ("README.md", "included_labels.csv", "rollups.csv"):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes()
    bad = [(jgen, jba, jgf, pd.DataFrame), (tgen, tba, tgf, None)]
    for case, match in (
        (dict(counts=[("ba-nope", "", 3)]), "unknown ba_ids"),
        (dict(counts=[("ba-r0-g0", "", 3)], gf_buckets={"Genus 0.1": ["branching"]}),
         "not a selected label"),
        (dict(counts=[("ba-r0-g0", "", 3)], gf_buckets={"Genus 0.0": ["zigzag"]}),
         "unknown growth form"),
        (dict(counts=[("ba-r0-g0", "", 3)], gf_buckets={"Genus 0.0": ["branching"]},
              no_gf=True), "requires gf_library"),
    ):
        for mod, ba, gf, frame in bad:
            counts = case["counts"]
            data = (frame(counts, columns=["ba_id", "gf_id", "count"]) if frame
                    else Table(["ba_id", "gf_id", "count"], counts))
            with pytest.raises(ValueError, match=match):
                mod.select_labels(ba, data, top_n=5, gf_buckets=case.get("gf_buckets"),
                                  gf_library=None if case.get("no_gf") else gf)
    with pytest.raises(ValueError, match="missing columns"):
        tgen.select_labels(tba, Table(["ba_id", "count"], []))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_training_config", REPO / "scripts" / "generate_training_config.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def write_fixture(directory):
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "benthic_attributes.json").write_text(json.dumps(taxonomy_records()))
    (directory / "growth_forms.json").write_text(json.dumps(GFS))
    (directory / "label_mappings.json").write_text("[]")
    return directory


@pytest.mark.parametrize("numeric_gf", [False, True])
def test_generate_training_config_cli(tmp_path, monkeypatch, numeric_gf):
    from mermaid_classifier_tpu_torch.scripts import generate_training_config as cli

    fixture = write_fixture(tmp_path / "taxonomy")
    monkeypatch.setenv(ttax.TAXONOMY_FIXTURE_ENV, str(fixture))
    counts = seeded_counts(7, numeric_gf=numeric_gf, blank_gf=not numeric_gf)
    (tmp_path / "counts.csv").write_text(
        "ba_id,gf_id,count\n" + "".join(f"{b},{g},{n}\n" for b, g, n in counts))
    (tmp_path / "sources.csv").write_text("source_id\n12\n\n7\nNA\n3001\n")
    argv = ["--counts-csv", str(tmp_path / "counts.csv"), "--top-n", "15",
            "--exclude", "Genus 2.4", "--sources-csv", str(tmp_path / "sources.csv"),
            "--taxonomy-fixture-dir", str(fixture), "--total-annotations", "4000",
            "--min-per-class", "10", "--epochs", "5"]
    clear_taxonomy_caches()
    try:
        assert cli.main([*argv, "--output-dir", str(tmp_path / "port")]) == 0
        assert _jax_cli().main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    finally:
        clear_taxonomy_caches()
    for fname in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes(), fname
    assert (tmp_path / "port" / "sources.csv").read_text() == \
        "source_id\n12.0\n7.0\nnan\n3001.0\n"


def test_numeric_looking_ba_ids_are_ints_and_unknown(tmp_path, monkeypatch):
    """A counts CSV of numeric-looking BA ids reads them as ints, which the
    taxonomy's str ids do not hold: both CLIs refuse with the same error."""
    from mermaid_classifier_tpu_torch.scripts import generate_training_config as cli

    records = [{"id": "101", "name": "Root", "parent": None},
               {"id": "102", "name": "Genus", "parent": "101"}]
    fixture = tmp_path / "taxonomy"
    fixture.mkdir()
    (fixture / "benthic_attributes.json").write_text(json.dumps(records))
    (fixture / "growth_forms.json").write_text(json.dumps(GFS))
    monkeypatch.setenv(ttax.TAXONOMY_FIXTURE_ENV, str(fixture))
    (tmp_path / "counts.csv").write_text("ba_id,gf_id,count\n102,,5\n101,gf-br,3\n")
    argv = ["--counts-csv", str(tmp_path / "counts.csv"), "--taxonomy-fixture-dir",
            str(fixture)]
    clear_taxonomy_caches()
    try:
        with pytest.raises(ValueError, match=r"unknown ba_ids: \[102, 101\]"):
            cli.main([*argv, "--output-dir", str(tmp_path / "port")])
        with pytest.raises(ValueError, match=r"unknown ba_ids: \[102, 101\]"):
            _jax_cli().main([*argv, "--output-dir", str(tmp_path / "jax")])
    finally:
        clear_taxonomy_caches()
