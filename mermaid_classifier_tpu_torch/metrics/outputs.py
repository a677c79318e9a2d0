"""What a metric group hands back to the coordinator.

A group produces two things: named scalar values, and a flat list of
artifacts to persist. Artifacts carry a ``kind`` tag ("figure", "table",
"mapping") instead of living in per-type lists, so logging sinks dispatch
on one field and a new artifact kind never grows the container type.

``GroupOutput`` is a builder — groups chain ``.scalar(...)``,
``.figure(...)``, ``.table(...)``, ``.mapping(...)`` as they compute. The
port's own copy of ``mermaid_classifier_tpu/metrics/outputs.py`` (a table
is a ``common.table.Table``) with one difference: a figure is recorded as
a ``Drawing``, a function plus the plain data it plots, and drawn only
when the coordinator logs it. So a group computes its numbers and tables
where matplotlib does not import, and the coordinator names the figures it
could not draw instead of losing the group.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

FIGURE = "figure"
TABLE = "table"
MAPPING = "mapping"


class Drawing(NamedTuple):
    """A figure not drawn yet: ``draw(data)`` returns a matplotlib Figure.
    ``data`` holds plain Python and numpy values only."""

    draw: Callable[[Any], Any]
    data: Any

    def render(self) -> Any:
        return self.draw(self.data)


class Artifact(NamedTuple):
    """One thing to persist: a ``Drawing``, a table or a plain dict, with
    the artifact path it should land at.

    ``save_kwargs`` (figures only) forwards to ``fig.savefig`` and wins over
    the sink's defaults: the confusion-matrix group caps the raster size and
    skips the tight-bbox measuring pass with it."""

    kind: str
    payload: Any
    path: str
    save_kwargs: dict | None = None


class GroupOutput:
    """Accumulates one metric group's scalars and artifacts."""

    def __init__(self) -> None:
        self.scalars: dict[str, float] = {}
        self.artifacts: list[Artifact] = []

    def scalar(self, name: str, value: float) -> "GroupOutput":
        self.scalars[name] = float(value)
        return self

    def figure(
        self, draw: Callable[[Any], Any], data: Any, path: str, **save_kwargs: Any
    ) -> "GroupOutput":
        self.artifacts.append(
            Artifact(FIGURE, Drawing(draw, data), path, save_kwargs or None)
        )
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

    def figures(self) -> list[Artifact]:
        return [a for a in self.artifacts if a.kind == FIGURE]

    def mappings(self) -> list[Artifact]:
        return [a for a in self.artifacts if a.kind == MAPPING]
