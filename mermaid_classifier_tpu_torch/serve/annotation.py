"""Single-image classify: the serve-shape forward pass.

Port of ``mermaid_classifier_tpu/serve/annotation.py``: resolve a classifier
artifact from a local directory or an object-store prefix, extract features
for the image's annotated points through the cached backbone, classify every
point in ONE batched predict_proba call, rank top-N and write them back to
the points CSV.

The points file is read with the stdlib ``csv`` module. The image is a
decoded (H, W, 3) uint8 array or a spec resolved by the injectable
``ImageFetcher`` (``serve/image_sources.py``): a local path, a
``store://`` URI or a CoralNet image ID. The registry spec (``models:/``)
needs the tracker (``tracking/``), which this package does not have yet;
the marker overlay (``show()``) is not ported.
"""

from __future__ import annotations

import csv
import json
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from mermaid_classifier_tpu_torch.inference.loader import Predictor, load_predictor
from mermaid_classifier_tpu_torch.serve.image_sources import ImageFetcher

_ROW_ALIASES = ("row", "Row", "ROW")
_COL_ALIASES = ("col", "Col", "COL", "column", "Column")


def resolve_classifier_artifact(
    spec: str | Path,
    *,
    store=None,
    cache_dir: str | Path | None = None,
) -> Path:
    """Resolve a classifier spec to a local artifact directory holding
    ``model.npz`` + ``model.json``.

    Accepted forms:
    - a local directory path;
    - ``store://<bucket>/<prefix>``: an object-store directory, downloaded
      into ``cache_dir`` (a new temporary directory when None).
    ``models:/`` raises: the registry needs ``tracking/``.
    """
    spec = str(spec)
    if spec.startswith("models:/"):
        raise ValueError(
            f"classifier spec {spec!r}: the model registry (models:/) needs"
            " tracking/, which this package does not have yet; give a local"
            " artifact directory or a store://bucket/prefix"
        )
    if spec.startswith("store://"):
        if store is None:
            from mermaid_classifier_tpu_torch.data.store import get_default_store

            store = get_default_store()
        rest = spec[len("store://"):]
        bucket, _, prefix = rest.partition("/")
        prefix = prefix.rstrip("/")
        cache_dir = (
            Path(cache_dir) if cache_dir
            else Path(tempfile.mkdtemp(prefix="artifact_"))
        )
        for fname in ("model.npz", "model.json"):
            store.download(bucket, f"{prefix}/{fname}", cache_dir / fname)
        return _validated_artifact_dir(cache_dir)
    return _validated_artifact_dir(Path(spec))


def _validated_artifact_dir(path: Path) -> Path:
    if not path.is_dir():
        raise FileNotFoundError(f"artifact directory {path} does not exist.")
    for fname in ("model.npz", "model.json"):
        if not (path / fname).is_file():
            raise FileNotFoundError(
                f"artifact directory {path} is missing {fname}."
            )
    return path


@dataclass
class PointsTable:
    """A points CSV: its columns in file order (``row``/``col`` under their
    canonical names) and one dict per point, ``row``/``col`` as ints and
    every other value as the string read."""

    columns: list[str]
    records: list[dict]

    def rowcols(self) -> np.ndarray:
        return np.asarray(
            [[r["row"], r["col"]] for r in self.records], dtype=np.int32
        ).reshape(-1, 2)


def read_points_csv(path: str | Path) -> PointsTable:
    """Read a points CSV with (row, col) columns under common aliases."""
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        columns = list(reader.fieldnames or [])
        rows = list(reader)
    renames = {}
    for canonical, aliases in (("row", _ROW_ALIASES), ("col", _COL_ALIASES)):
        present = [a for a in aliases if a in columns]
        if not present:
            raise ValueError(
                f"points CSV {path} has no {canonical} column (aliases:"
                f" {aliases}); has {columns}."
            )
        renames[present[0]] = canonical
    records = []
    for raw in rows:
        rec = {renames.get(k, k): v for k, v in raw.items()}
        rec["row"] = int(rec["row"])
        rec["col"] = int(rec["col"])
        records.append(rec)
    return PointsTable([renames.get(c, c) for c in columns], records)


@dataclass
class PointPrediction:
    row: int
    col: int
    labels: list[str]
    scores: list[float]


class AnnotationRun:
    """Classify every annotated point of one image through the shipped
    artifact, as production serving does. The predictor runs on the
    extractor's device. ``image`` is a decoded array or a spec for
    ``fetcher`` (default: an ``ImageFetcher()``)."""

    def __init__(
        self,
        image,
        points_csv: str | Path,
        classifier: str | Path | Predictor,
        *,
        extractor,
        top_n: int = 3,
        fetcher=None,
    ) -> None:
        self.image_spec = image
        self.points_csv = Path(points_csv)
        self.top_n = int(top_n)
        self.fetcher = fetcher or ImageFetcher()
        if isinstance(classifier, Predictor):
            self.predictor = classifier
        else:
            self.predictor = load_predictor(
                resolve_classifier_artifact(classifier),
                device=extractor.device,
            )
        self.extractor = extractor
        self.points = read_points_csv(points_csv)
        self.predictions: list[PointPrediction] | None = None
        # (P, K) float64 probabilities of the last run().
        self.proba: np.ndarray | None = None

    def load_image(self) -> np.ndarray:
        if isinstance(self.image_spec, np.ndarray):
            return self.image_spec
        return self.fetcher.fetch(self.image_spec)

    def run(self) -> list[PointPrediction]:
        """Feature-extract all points, classify them in one batch, rank
        top-N per point."""
        image = self.load_image()
        rowcols = self.points.rowcols()
        features = self.extractor.extract_features_device(image, rowcols)
        if features.shape[1] != self.predictor.input_dim:
            raise ValueError(
                f"extractor produced {features.shape[1]}-dim features but the"
                f" classifier expects {self.predictor.input_dim}."
            )
        proba = self.proba = self.predictor.predict_proba(features)
        classes = np.asarray(self.predictor.classes_)
        order = np.argsort(-proba, axis=1, kind="stable")[:, : self.top_n]
        self.predictions = [
            PointPrediction(
                row=int(r),
                col=int(c),
                labels=[str(classes[j]) for j in order[i]],
                scores=[float(proba[i, j]) for j in order[i]],
            )
            for i, (r, c) in enumerate(rowcols)
        ]
        return self.predictions

    def write_predictions(self, output_csv: str | Path | None = None) -> Path:
        """Write the points CSV back with pred_i/score_i columns appended."""
        if self.predictions is None:
            self.run()
        columns = list(self.points.columns)
        for i in range(self.top_n):
            columns += [f"pred_{i + 1}", f"score_{i + 1}"]
        output_csv = Path(output_csv) if output_csv else self.points_csv
        with open(output_csv, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=columns)
            writer.writeheader()
            for rec, pred in zip(self.points.records, self.predictions):
                row = dict(rec)
                for i in range(self.top_n):
                    has = i < len(pred.labels)
                    row[f"pred_{i + 1}"] = pred.labels[i] if has else ""
                    row[f"score_{i + 1}"] = round(pred.scores[i], 6) if has else ""
                writer.writerow(row)
        return output_csv

    def summary(self) -> dict:
        if self.predictions is None:
            self.run()
        top1 = [p.labels[0] for p in self.predictions if p.labels]
        unique, counts = np.unique(top1, return_counts=True)
        return {
            "image": str(self.image_spec) if not isinstance(
                self.image_spec, np.ndarray) else "<array>",
            "n_points": len(self.predictions),
            "label_counts": dict(
                sorted(zip(unique.tolist(), counts.tolist()),
                       key=lambda kv: -kv[1])
            ),
        }


def write_run_report(run: AnnotationRun, output_dir: str | Path) -> Path:
    """Predictions CSV + JSON summary in one directory (the JAX report's
    overlay PNG is not written: ``show()`` is not ported)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    run.write_predictions(output_dir / "predictions.csv")
    (output_dir / "summary.json").write_text(json.dumps(run.summary(), indent=2))
    return output_dir
