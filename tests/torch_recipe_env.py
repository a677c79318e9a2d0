"""Shared fixtures of the port's recipe tests: one seeded ETL environment
(``tests/data/dataset_fixtures.build_environment``: a local store of
CoralNet- and MERMAID-layout feature files and the two parquet tables)
read by both packages, with both packages' settings pointed at it and
their taxonomy getters at the same in-memory records."""

from __future__ import annotations

import json
from contextlib import ExitStack, contextmanager

from mermaid_classifier_tpu.common import taxonomy as jtax
from mermaid_classifier_tpu.config import settings as jset
from mermaid_classifier_tpu_torch.common import taxonomy as ttax
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore

from tests.common.taxonomy_fixtures import BA_RECORDS, GF_BY_ID, MAPPING_RECORDS
from tests.data.dataset_fixtures import BUCKET, build_environment


def port_ba_library():
    return ttax.BenthicAttributeLibrary(BA_RECORDS)


def port_gf_library():
    return ttax.GrowthFormLibrary(GF_BY_ID)


def port_mapping():
    return ttax.CoralNetMermaidMapping.from_records(MAPPING_RECORDS)


def patch_port_taxonomy(monkeypatch):
    """The port's ``data.dataset`` taxonomy getters on the fixture records
    (the port's side of ``dataset_fixtures.patch_taxonomy``)."""
    import mermaid_classifier_tpu_torch.data.dataset as dataset_mod

    monkeypatch.setattr(dataset_mod, "get_coralnet_mapping", port_mapping)
    monkeypatch.setattr(dataset_mod, "get_benthic_attribute_library",
                        port_ba_library)
    monkeypatch.setattr(dataset_mod, "get_growth_form_library", port_gf_library)


def write_taxonomy_fixture(directory):
    """The fixture-file route (``TAXONOMY_FIXTURE_ENV``) over the same
    records."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "benthic_attributes.json").write_text(json.dumps(BA_RECORDS))
    (directory / "growth_forms.json").write_text(json.dumps(GF_BY_ID))
    (directory / "label_mappings.json").write_text(json.dumps(MAPPING_RECORDS))
    return directory


def clear_taxonomy_caches():
    for mod in (jtax, ttax):
        mod.get_benthic_attribute_library.cache_clear()
        mod.get_growth_form_library.cache_clear()
        mod.get_coralnet_mapping.cache_clear()


@contextmanager
def both_settings(tmp_path, mermaid_path, jax=None, port=None, **common):
    """Both packages' settings on the fixture buckets and parquet, each
    with its own feature cache; ``jax`` / ``port`` add per-package
    overrides."""
    base = dict(
        coralnet_train_data_bucket=BUCKET,
        mermaid_train_data_bucket=BUCKET,
        mermaid_annotations_parquet_pattern=mermaid_path,
        **common,
    )
    with ExitStack() as stack:
        stack.enter_context(jset.override_settings(
            feature_cache_dir=str(tmp_path / "cache_jax"), **base, **(jax or {})))
        stack.enter_context(tset.override_settings(
            feature_cache_dir=str(tmp_path / "cache_port"), **base, **(port or {})))
        yield


def build_both(tmp_path, **kw):
    """(JAX store, port store, manifest path, mermaid path) over one
    ``build_environment`` directory."""
    jstore, manifest_path, mermaid_path = build_environment(tmp_path, **kw)
    return jstore, LocalFSObjectStore(jstore.root), manifest_path, mermaid_path
