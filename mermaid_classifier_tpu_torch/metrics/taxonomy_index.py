"""Taxonomy lookups shared by the metric groups.

Everything works off root-to-leaf *paths*: each BA that appears in the
class list maps to the tuple (root, ..., parent, self), built once by the
coordinator. LCA, similarity, and top-level grouping are then pure prefix
arithmetic over those paths — no further tree walks.
The port's own copy of ``mermaid_classifier_tpu/metrics/taxonomy_index.py``.
"""

from __future__ import annotations

import typing
from collections import defaultdict

from mermaid_classifier_tpu_torch.common.taxonomy import split_ba_gf

if typing.TYPE_CHECKING:
    from mermaid_classifier_tpu_torch.common.taxonomy import BenthicAttributeLibrary


def _class_bas(classes: list[str]) -> set[str]:
    return {split_ba_gf(bagf_id)[0] for bagf_id in classes}


def build_ba_paths(
    classes: list[str], ba_library: "BenthicAttributeLibrary"
) -> dict[str, list[str]]:
    """Root-to-leaf path per BA appearing in the class list."""
    return {
        ba_id: [*ba_library.get_ancestor_ids(ba_id), ba_id]
        for ba_id in _class_bas(classes)
    }


def build_ba_to_top(
    classes: list[str], ba_library: "BenthicAttributeLibrary"
) -> dict[str, str]:
    """BA -> its root (path[0]); a root maps to itself."""
    return {
        ba_id: path[0] for ba_id, path in build_ba_paths(classes, ba_library).items()
    }


def _shared_prefix_len(path_a: list[str], path_b: list[str]) -> int:
    k = 0
    for a, b in zip(path_a, path_b):
        if a != b:
            break
        k += 1
    return k


def find_lca(ba_a: str, ba_b: str, ba_paths: dict[str, list[str]]) -> str | None:
    """Deepest node on both paths; None when even the roots differ."""
    path_a = ba_paths[ba_a]
    k = _shared_prefix_len(path_a, ba_paths[ba_b])
    return path_a[k - 1] if k else None


def taxonomic_similarity(
    ba_a: str, ba_b: str, ba_paths: dict[str, list[str]]
) -> float:
    """Shared-path fraction: shared prefix length over the deeper path's
    length. 1.0 identical, ~0.75 siblings, 0.0 across top-level branches."""
    path_a, path_b = ba_paths[ba_a], ba_paths[ba_b]
    k = _shared_prefix_len(path_a, path_b)
    return k / max(len(path_a), len(path_b)) if k else 0.0


def group_by_top_level(
    sample_indices: list[int],
    gt_indices: list[int],
    classes: list[str],
    ba_to_top: dict[str, str],
    ba_library: "BenthicAttributeLibrary",
    min_samples: int = 30,
) -> list[dict]:
    """Bucket samples by their ground truth's top-level BA, dropping
    buckets thinner than ``min_samples`` (small-category metrics are
    noise). Each bucket: {top_ba_id, name, indices, n_samples}."""
    buckets: dict[str, list[int]] = defaultdict(list)
    for i in sample_indices:
        buckets[ba_to_top[split_ba_gf(classes[gt_indices[i]])[0]]].append(i)
    return [
        {
            "top_ba_id": top_id,
            "name": ba_library.id_to_name(top_id),
            "indices": members,
            "n_samples": len(members),
        }
        for top_id, members in buckets.items()
        if len(members) >= min_samples
    ]
