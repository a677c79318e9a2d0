"""What a metric group hands back to the coordinator.

A group produces two things: named scalar values, and a flat list of
artifacts to persist. Artifacts carry a ``kind`` tag ("table", "mapping")
instead of living in per-type lists, so logging sinks dispatch on one field
and a new artifact kind never grows the container type.

``GroupOutput`` is a builder — groups chain ``.scalar(...)``,
``.table(...)``, ``.mapping(...)`` as they compute. The port's own copy of
``mermaid_classifier_tpu/metrics/outputs.py`` without figures: no ported
group draws one (a table is a ``common.table.Table``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

TABLE = "table"
MAPPING = "mapping"


class Artifact(NamedTuple):
    """One thing to persist: a table or a plain dict, with the artifact
    path it should land at."""

    kind: str
    payload: Any
    path: str


class GroupOutput:
    """Accumulates one metric group's scalars and artifacts."""

    def __init__(self) -> None:
        self.scalars: dict[str, float] = {}
        self.artifacts: list[Artifact] = []

    def scalar(self, name: str, value: float) -> "GroupOutput":
        self.scalars[name] = float(value)
        return self

    def table(self, frame: Any, path: str) -> "GroupOutput":
        self.artifacts.append(Artifact(TABLE, frame, path))
        return self

    def mapping(self, data: dict[str, Any], path: str) -> "GroupOutput":
        self.artifacts.append(Artifact(MAPPING, data, path))
        return self

    def merge(self, other: "GroupOutput") -> "GroupOutput":
        """Fold a sub-computation's output into this one (used by groups
        assembled from several passes, e.g. taxonomic)."""
        self.scalars.update(other.scalars)
        self.artifacts.extend(other.artifacts)
        return self

    def tables(self) -> list[Artifact]:
        return [a for a in self.artifacts if a.kind == TABLE]

    def mappings(self) -> list[Artifact]:
        return [a for a in self.artifacts if a.kind == MAPPING]
