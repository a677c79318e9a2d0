"""The port's ``parse_source_ids`` (stdlib csv) against the JAX script's
(pandas, ``dtype=str``, ``keep_default_na=False``) on the CSVs and lists of
tests/data/test_source_ids_csv.py, and a few more: the same IDs in the same
order, or the same error."""

import argparse
import importlib.util
from pathlib import Path

import pytest

from mermaid_classifier_tpu_torch.scripts import build_feature_bucket as tcli

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jcli():
    """The JAX package's CLI module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "_jax_build_feature_bucket", REPO / "scripts" / "build_feature_bucket.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _parse(cli, args):
    try:
        return ("ok", cli.parse_source_ids(args))
    except ValueError as exc:
        return ("raised", str(exc).split(";")[0].split(" in ")[0])


CSVS = [
    ("source_id,n\n3,9\n1,2\n", None),
    ("source id,n\n7,0\n", None),
    ("whatever\n12\n8\n", None),
    ("a,b\n1,2\n", None),
    ("a,b\n1,2\n", "b"),
    ("a,b\n1,2\n", "c"),
    ("id\n123.0\n45\n", None),
    ("id\n5\n\n  \n6\n", None),
    ("id\nNA\nnull\nNone\n", None),
    ("id\n007\n5e2\n123.5\ninf\n", None),
    ("id\n4\n2\n4\n2\n9\n", None),
    ("id\nreef-a\nreef-b\n", None),
    # Beyond the JAX tests: a short row, quoting, a BOM, the column
    # preference order, float artifacts that are not "<digits>.0".
    ("source,id\n1\n2,3\n", None),
    ('id,n\n"12",x\n" 13 ",y\n"1,4",z\n', None),
    ("\ufeffsource_id\n9\n", None),
    ("id,source,source id\n1,2,3\n", None),
    ("id\n12.00\n-3.0\n1.0e2\n 44.0 \n", None),
]


@pytest.mark.parametrize("text,column", CSVS)
def test_csv_matches_jax(tmp_path, jcli, text, column):
    path = tmp_path / "sources.csv"
    path.write_text(text, encoding="utf-8")
    args = argparse.Namespace(source_ids=None, source_ids_csv=str(path),
                              source_id_column=column)
    assert _parse(tcli, args) == _parse(jcli, args)


@pytest.mark.parametrize("ids", [
    "123.0,123, 123 ,007", "1,,2, ,1", "NA,null", "a.0,10.0,0.0",
])
def test_comma_list_matches_jax(jcli, ids):
    args = argparse.Namespace(source_ids=ids, source_ids_csv=None,
                              source_id_column=None)
    assert _parse(tcli, args) == _parse(jcli, args)


def test_expected_ids():
    args = argparse.Namespace(source_ids="123.0,123, 123 ,007",
                              source_ids_csv=None, source_id_column=None)
    assert tcli.parse_source_ids(args) == ["123", "007"]
