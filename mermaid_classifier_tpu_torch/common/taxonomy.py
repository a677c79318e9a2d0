"""MERMAID benthic-attribute / growth-form taxonomy utilities.

The port's own copy of ``mermaid_classifier_tpu/common/taxonomy.py``: every
library is constructed from plain records and loads from the live MERMAID
API or from local fixture files (``TAXONOMY_FIXTURE_ENV``), which is how a
run without network gets its taxonomy. ``CoralNetMermaidMapping.get_dataframe``
returns the mapping as records (one dict per mapping row, the fields in
``LabelMappingEntry`` order), not a DataFrame.

Contracts preserved:
- BA+GF combo codec: ``<ba>::<gf>``; a missing growth form keeps the trailing
  separator in ID space (``<ba>::``), while readable names drop it.
- Ancestor walks return root-first; descendant walks are depth-first with
  children ordered by name.
- The CoralNet->MERMAID label mapping is lazy (nothing hits the network at
  import or construction) and cached after first load.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import urllib.request
from collections import defaultdict
from collections.abc import Callable, Iterable
from typing import Any

# MERMAID's BA-GF separator (reference: benthic_attributes.py:13).
BAGF_SEP = "::"

MERMAID_API_BASE = "https://api.datamermaid.org/v1"
# Env var pointing at a directory of fixture JSONs (benthic_attributes.json,
# growth_forms.json, label_mappings.json) for fully offline operation.
TAXONOMY_FIXTURE_ENV = "MERMAID_TAXONOMY_FIXTURE_DIR"


def combine_ba_gf(benthic_attribute: str, growth_form: str) -> str:
    """Encode a BA+GF pair as one combo string. A BA with no GF encodes as
    ``<ba>::`` — the separator is always present."""
    return f"{benthic_attribute}{BAGF_SEP}{growth_form}"


def split_ba_gf(bagf: str) -> tuple[str, str]:
    """Decode a combo string into (ba, gf). The separator must appear exactly
    once and the BA part must be non-empty."""
    parts = bagf.split(BAGF_SEP)
    if len(parts) != 2:
        raise ValueError(
            f"'{bagf}' is not a valid BA-GF combo string."
            f" The separator {BAGF_SEP} should appear exactly once."
        )
    ba, gf = parts
    if not ba:
        raise ValueError(
            f"'{bagf}' is not a valid BA-GF combo string."
            f" There should be characters to the left of the separator {BAGF_SEP}."
        )
    return ba, gf


def _fetch_json(url: str) -> Any:
    with urllib.request.urlopen(url) as response:
        return json.loads(response.read())


def _fetch_paginated_results(url: str) -> list[dict]:
    payload = _fetch_json(url)
    results = list(payload["results"])
    while payload.get("next"):
        payload = _fetch_json(payload["next"])
        results.extend(payload["results"])
    return results


class BenthicAttributeLibrary:
    """The BA tree: id/name lookups plus ancestor/descendant walks.

    Records are dicts with at least ``id``, ``name``, ``parent`` (parent None
    at roots), matching the MERMAID /benthicattributes/ schema.
    """

    def __init__(self, records: Iterable[dict]):
        self.raw_results = list(records)
        self.by_id: dict[str, dict] = {}
        self.by_name: dict[str, dict] = {}
        self.by_parent: dict[str | None, list[dict]] = defaultdict(list)
        for record in self.raw_results:
            self.by_id[record["id"]] = record
            self.by_name[record["name"]] = record
            self.by_parent[record["parent"]].append(record)

    @classmethod
    def from_api(cls, base_url: str = MERMAID_API_BASE) -> "BenthicAttributeLibrary":
        payload = _fetch_json(f"{base_url}/benthicattributes/?limit=5000")
        return cls(payload["results"])

    @classmethod
    def from_json_file(cls, path: str) -> "BenthicAttributeLibrary":
        with open(path) as f:
            payload = json.load(f)
        records = payload["results"] if isinstance(payload, dict) else payload
        return cls(records)

    def id_to_name(self, ba_id: str) -> str:
        if ba_id == "":
            return ""
        return self.by_id[ba_id]["name"]

    def name_to_id(self, ba_name: str) -> str:
        if ba_name == "":
            return ""
        return self.by_name[ba_name]["id"]

    def bagf_id_to_name(self, bagf_id: str, gf_library: "GrowthFormLibrary") -> str:
        """Readable name for a BA+GF ID combo; BA-only combos render without
        a separator (reference: benthic_attributes.py:87-94)."""
        ba_id, gf_id = split_ba_gf(bagf_id)
        ba_name = self.by_id[ba_id]["name"]
        if gf_id == "":
            return ba_name
        return combine_ba_gf(ba_name, gf_library.id_to_name(gf_id))

    def get_ancestor_ids(self, ba_id: str) -> list[str]:
        """Ancestor IDs ordered root-first (an iterative walk — the reference
        recursed; same output order)."""
        chain: list[str] = []
        parent = self.by_id[ba_id]["parent"]
        while parent is not None:
            chain.append(parent)
            parent = self.by_id[parent]["parent"]
        chain.reverse()
        return chain

    def get_descendants(self, ba_id: str | None) -> list[dict]:
        """All descendants: each node's children sorted by name, parents
        preceding their subtrees, subtrees in DFS order
        (reference: benthic_attributes.py:105-120)."""
        children = sorted(self.by_parent.get(ba_id, []), key=lambda r: r["name"])
        out = list(children)
        for child in children:
            out.extend(self.get_descendants(child["id"]))
        return out

    def top_level_ancestor(self, ba_id: str) -> str:
        """The root-most ancestor (the BA itself when it is a root) — used by
        the taxonomic metrics."""
        ancestors = self.get_ancestor_ids(ba_id)
        return ancestors[0] if ancestors else ba_id


class GrowthFormLibrary:
    """GF id<->name lookup (reference: benthic_attributes.py:123-144)."""

    def __init__(self, by_id: dict[str, str]):
        self.by_id = dict(by_id)

    @classmethod
    def from_api(cls, base_url: str = MERMAID_API_BASE) -> "GrowthFormLibrary":
        payload = _fetch_json(f"{base_url}/choices/")
        for item in payload:
            if item["name"] == "growthforms":
                return cls({gf["id"]: gf["name"] for gf in item["data"]})
        raise ValueError("'growthforms' not found in /v1/choices/ response")

    @classmethod
    def from_json_file(cls, path: str) -> "GrowthFormLibrary":
        with open(path) as f:
            payload = json.load(f)
        if isinstance(payload, dict):
            return cls(payload)
        return cls({gf["id"]: gf["name"] for gf in payload})

    def id_to_name(self, gf_id: str) -> str:
        if gf_id == "":
            return ""
        return self.by_id[gf_id]


@dataclasses.dataclass
class LabelMappingEntry:
    """One provider-label -> MERMAID BA/GF mapping row. Field order is the
    column order of the logged mapping artifact. Empty-string means no GF."""

    provider_label: str
    benthic_attribute_name: str
    growth_form_name: str
    provider_id: str
    benthic_attribute_id: str
    growth_form_id: str


class CoralNetMermaidMapping:
    """CoralNet label ID -> MERMAID BA/GF mapping, lazy-loaded and cached
    (reference: benthic_attributes.py:189-254). The loader is pluggable:
    API-paginated by default, fixture-file or in-memory for offline use."""

    def __init__(
        self,
        loader: Callable[[], list[dict]] | None = None,
        mapping_endpoint: str = (
            f"{MERMAID_API_BASE}/classification/labelmappings/?provider=CoralNet"
        ),
    ):
        self._mapping: dict[str, LabelMappingEntry] | None = None
        self._endpoint = mapping_endpoint
        self._loader = loader

    @classmethod
    def from_json_file(cls, path: str) -> "CoralNetMermaidMapping":
        def load() -> list[dict]:
            with open(path) as f:
                payload = json.load(f)
            return payload["results"] if isinstance(payload, dict) else payload

        return cls(loader=load)

    @classmethod
    def from_records(cls, records: list[dict]) -> "CoralNetMermaidMapping":
        return cls(loader=lambda: list(records))

    def __contains__(self, cn_label_id: str) -> bool:
        return cn_label_id in self.mapping

    def __getitem__(self, cn_label_id: str) -> LabelMappingEntry:
        try:
            return self.mapping[cn_label_id]
        except KeyError as e:
            raise KeyError(
                f"{e} - Make sure you're passing the CoralNet label ID"
                f" (not name), as a string (not int)."
            ) from e

    def get_dataframe(self) -> list[dict]:
        """The mapping as records, one per provider label, in load order."""
        return [dataclasses.asdict(entry) for entry in self.mapping.values()]

    @property
    def mapping(self) -> dict[str, LabelMappingEntry]:
        if self._mapping is None:
            records = (
                self._loader()
                if self._loader is not None
                else _fetch_paginated_results(self._endpoint)
            )
            self._mapping = {
                rec["provider_id"]: LabelMappingEntry(
                    provider_label=rec["provider_label"],
                    benthic_attribute_name=rec["benthic_attribute_name"],
                    # '' (not None) is the empty GF value everywhere.
                    growth_form_name=rec["growth_form_name"] or "",
                    provider_id=rec["provider_id"],
                    benthic_attribute_id=rec["benthic_attribute_id"],
                    growth_form_id=rec["growth_form_id"] or "",
                )
                for rec in records
            }
        return self._mapping


def _fixture_dir() -> str | None:
    return os.environ.get(TAXONOMY_FIXTURE_ENV) or None


@functools.cache
def get_benthic_attribute_library() -> BenthicAttributeLibrary:
    """Cached singleton; fixture-backed when TAXONOMY_FIXTURE_ENV is set,
    live API otherwise. Never constructed at import time."""
    fixture = _fixture_dir()
    if fixture:
        return BenthicAttributeLibrary.from_json_file(
            os.path.join(fixture, "benthic_attributes.json")
        )
    return BenthicAttributeLibrary.from_api()


@functools.cache
def get_growth_form_library() -> GrowthFormLibrary:
    fixture = _fixture_dir()
    if fixture:
        return GrowthFormLibrary.from_json_file(
            os.path.join(fixture, "growth_forms.json")
        )
    return GrowthFormLibrary.from_api()


@functools.cache
def get_coralnet_mapping() -> CoralNetMermaidMapping:
    fixture = _fixture_dir()
    if fixture:
        return CoralNetMermaidMapping.from_json_file(
            os.path.join(fixture, "label_mappings.json")
        )
    return CoralNetMermaidMapping()
