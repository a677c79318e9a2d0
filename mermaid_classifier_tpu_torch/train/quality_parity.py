"""End-to-end quality parity: the port's whole training chain against the
sklearn equivalent on one structured synthetic dataset.

The port's own copy of ``mermaid_classifier_tpu/train/quality_parity.py``.
Every link of the chain is held to its reference on its own (the
classifier, the calibration, the 1e-6 export gate); this module composes
them into one measured quality number: balanced subsample -> train -> Platt
calibration -> export -> load -> metrics on the SHIPPED artifact's
probabilities, the ordering of the reference's quality evidence.

Both pipelines take the same subsampled train/ref/val split:

- repo:    MLPClassifier (torch, on ``device``) ->
           CalibratedClassifier.fit_from_scores -> export_artifact ->
           load_predictor -> metrics on the artifact
- sklearn: sklearn.neural_network.MLPClassifier (same architecture, lr and
           batch, driven through the same partial_fit stream) ->
           CalibratedClassifierCV(method="sigmoid") on the frozen model ->
           metrics on predict_proba

sklearn is imported inside ``run_sklearn_pipeline`` only; the scores are
the port's own numpy scorers with sklearn's semantics. Where sklearn is
missing (the card machine), ``run_repo_pipeline`` runs alone and
``run_sklearn_pipeline`` raises its ImportError. Entry points take
``device=`` ("cuda" unless the caller passes another). Run through
``scripts/quality_parity_bench.py`` or the CPU tests.
"""

from __future__ import annotations

import contextlib
import logging
import tempfile
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class QualityRunSpec:
    """One parity run's knobs (defaults = CI scale; the bench CLI scales
    everything up)."""

    n_samples: int = 9000
    n_features: int = 96
    n_classes: int = 15
    cluster_std: float = 6.0
    imbalance_exponent: float = 1.3
    seed: int = 0
    hidden: tuple[int, ...] = (64, 32)
    learning_rate: float = 1e-3
    # Near-convergence budget: the two stacks start from DIFFERENT random
    # init draws (this repo reproduces the reference's Xavier-weights +
    # zero-bias init, reference: torch_classifier.py:64-74; sklearn draws
    # its own uniform weights AND intercepts), and at a short budget the
    # draw dominates the comparison (~3-9 points of balanced accuracy at
    # 8 epochs on this spec). Given IDENTICAL init the two stacks track
    # each other exactly (pinned by
    # tests/train/test_mlp_battery.py::TestIdenticalInitTracksSklearn), so
    # the composed benchmark trains near convergence where the init wash
    # is over and residual deltas reflect real pipeline differences.
    epochs: int = 24
    batch_size: int = 256
    subsample_total: int = 6000
    min_per_class: int = 40
    ref_ratio: float = 0.1
    val_ratio: float = 0.2
    # MLPClassifier init mode: "reference" (the production default) or
    # "sklearn" (replicates sklearn's init stream — with it, residual
    # deltas measure the PIPELINE, with init-draw noise removed).
    init: str = "reference"
    # Init RNG stream for BOTH stacks (matched per run; the multi-seed
    # aggregate varies it with the data seed so the CI band samples init
    # draws as well as data draws).
    random_state: int = 0


@dataclass
class PipelineMetrics:
    accuracy: float
    balanced_accuracy: float
    log_loss: float
    extra: dict = field(default_factory=dict)


def make_imbalanced_clusters(spec: QualityRunSpec):
    """Gaussian class clusters with a Zipf class-size profile — the shape
    of real reef data (a few dominant benthic attributes, a long tail).
    cluster_std is tuned so accuracy lands well below 1.0 and the
    comparison has room to detect regressions in either direction."""
    rng = np.random.default_rng(spec.seed)
    weights = 1.0 / np.arange(1, spec.n_classes + 1) ** spec.imbalance_exponent
    weights /= weights.sum()
    counts = np.maximum((weights * spec.n_samples).astype(int), 25)
    centroids = rng.normal(size=(spec.n_classes, spec.n_features)) * 3.0
    X_parts, y_parts = [], []
    for k, n_k in enumerate(counts):
        X_parts.append(
            centroids[k]
            + rng.normal(size=(n_k, spec.n_features)) * spec.cluster_std
        )
        y_parts.append(np.full(n_k, f"class_{k:02d}", dtype=object))
    X = np.concatenate(X_parts).astype(np.float32)
    y = np.concatenate(y_parts)
    order = rng.permutation(len(X))
    return X[order], y[order]


def split_stratified(X, y, spec: QualityRunSpec):
    """Deterministic per-class train/ref/val split (every class lands in
    every split — Platt OvR calibration needs positives in ref)."""
    rng = np.random.default_rng(spec.seed + 1)
    train_idx, ref_idx, val_idx = [], [], []
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        n_val = max(2, int(len(idx) * spec.val_ratio))
        n_ref = max(2, int(len(idx) * spec.ref_ratio))
        val_idx.append(idx[:n_val])
        ref_idx.append(idx[n_val:n_val + n_ref])
        train_idx.append(idx[n_val + n_ref:])
    train_idx = np.sort(np.concatenate(train_idx))
    ref_idx = np.sort(np.concatenate(ref_idx))
    val_idx = np.sort(np.concatenate(val_idx))
    return (
        (X[train_idx], y[train_idx]),
        (X[ref_idx], y[ref_idx]),
        (X[val_idx], y[val_idx]),
    )


def subsample_train(train, spec: QualityRunSpec):
    """Balanced per-class subsample through the repo's allocator, applied
    with the deterministic first-N-in-index-order rule (the in-memory
    analog of the ROW_NUMBER-over-ordered-pk SQL apply,
    data/dataset.py)."""
    from mermaid_classifier_tpu_torch.data.subsample import (
        SubsampleOptions,
        compute_per_class_targets,
    )

    X_tr, y_tr = train
    counts = {cls: int(np.sum(y_tr == cls)) for cls in np.unique(y_tr)}
    targets = compute_per_class_targets(
        SubsampleOptions(
            strategy="balanced",
            total_annotations=spec.subsample_total,
            min_per_class=spec.min_per_class,
        ),
        counts,
    )
    keep = []
    for cls, target in targets.items():
        keep.append(np.flatnonzero(y_tr == cls)[:target])
    keep = np.sort(np.concatenate(keep))
    return X_tr[keep], y_tr[keep]


def _epoch_stream(n, epochs, chunk, seed):
    """The MermaidTrainer interaction pattern: seeded shuffled epochs of
    partial_fit chunks — the exact surface both classifiers are driven
    through (same order stream for both, so data presentation is not a
    variable)."""
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for start in range(0, n, chunk):
            yield order[start:start + chunk]


def run_repo_pipeline(train_sub, ref, val, spec: QualityRunSpec,
                      workdir: str | None = None, *, device="cuda",
                      enforce_torch_pin: bool = True) -> PipelineMetrics:
    """subsampled train -> MLPClassifier -> fit_from_scores calibration ->
    export_artifact -> load_predictor -> metrics computed on the SHIPPED
    artifact's probabilities (the eval-the-artifact ordering). The
    classifier trains, and the artifact serves, on ``device``;
    ``enforce_torch_pin`` is the export gate's torch-version pin."""
    from mermaid_classifier_tpu_torch.inference.export import export_artifact
    from mermaid_classifier_tpu_torch.inference.loader import load_predictor
    from mermaid_classifier_tpu_torch.train.calibration import (
        CalibratedClassifier,
    )
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    X_tr, y_tr = train_sub
    X_ref, y_ref = ref
    X_val, y_val = val
    classes = sorted(np.unique(np.concatenate([y_tr, y_ref])).tolist())

    clf = MLPClassifier(
        spec.hidden,
        learning_rate_init=spec.learning_rate,
        batch_size=spec.batch_size,
        random_state=spec.random_state,
        init=spec.init,
        device=device,
    )
    for idx in _epoch_stream(len(X_tr), spec.epochs, spec.batch_size * 4,
                             spec.seed + 2):
        clf.partial_fit(X_tr[idx], y_tr[idx], classes=classes)

    uncal = clf.predict_proba(X_ref)
    cal = CalibratedClassifier.fit_from_scores(clf, uncal, y_ref, device=device)

    ctx = (
        contextlib.nullcontext(workdir)
        if workdir is not None
        else tempfile.TemporaryDirectory(prefix="quality_parity_")
    )
    with ctx as out:
        export_artifact(cal, out, X_val[: min(len(X_val), 256)],
                        enforce_torch_pin=enforce_torch_pin)
        predictor = load_predictor(out, device=device)
        proba = predictor.predict_proba(X_val.astype(np.float32))
    return _score(y_val, proba, classes, extra={"loss_curve_len": clf.n_iter_})


def run_sklearn_pipeline(train_sub, ref, val,
                         spec: QualityRunSpec) -> PipelineMetrics:
    """The same chain through sklearn: MLPClassifier (identical arch/lr/
    batch, driven through the same partial_fit stream) + prefit sigmoid
    CalibratedClassifierCV — the reference's quality baseline
    (reference: trainer.py:344-396 hand-assembles exactly this)."""
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.neural_network import MLPClassifier as SklearnMLP

    X_tr, y_tr = train_sub
    X_ref, y_ref = ref
    X_val, y_val = val
    classes = sorted(np.unique(np.concatenate([y_tr, y_ref])).tolist())

    clf = SklearnMLP(
        hidden_layer_sizes=spec.hidden,
        learning_rate_init=spec.learning_rate,
        batch_size=spec.batch_size,
        random_state=spec.random_state,
        max_iter=max(spec.epochs, 1),
    )
    for idx in _epoch_stream(len(X_tr), spec.epochs, spec.batch_size * 4,
                             spec.seed + 2):
        clf.partial_fit(X_tr[idx], y_tr[idx], classes=classes)

    try:
        # sklearn >= 1.8: prefit calibration goes through FrozenEstimator.
        from sklearn.frozen import FrozenEstimator

        cal = CalibratedClassifierCV(FrozenEstimator(clf), method="sigmoid")
    except ImportError:  # older sklearn (the reference pins 1.5.2)
        cal = CalibratedClassifierCV(clf, cv="prefit", method="sigmoid")
    cal.fit(X_ref, y_ref)
    proba = cal.predict_proba(X_val)
    return _score(y_val, proba, classes)


def _score(y_true, proba, classes, extra=None) -> PipelineMetrics:
    """Accuracy, balanced accuracy and log loss by the port's numpy scorers
    (sklearn's formulas, held to ``sklearn.metrics`` in the CPU tests)."""
    from mermaid_classifier_tpu_torch.metrics.classification import (
        balanced_accuracy_score,
    )
    from mermaid_classifier_tpu_torch.train.trainer import (
        accuracy_score,
        log_loss,
    )

    classes = list(classes)
    pred = np.asarray(classes, dtype=object)[np.argmax(proba, axis=1)]
    return PipelineMetrics(
        accuracy=float(accuracy_score(y_true, pred)),
        balanced_accuracy=float(balanced_accuracy_score(y_true, pred)),
        log_loss=float(log_loss(y_true, proba, labels=classes)),
        extra=extra or {},
    )


#: The delta metrics the multi-seed aggregate summarizes (repo − sklearn).
DELTA_KEYS = ("accuracy_delta", "balanced_accuracy_delta", "log_loss_delta")


def run_quality_parity_multiseed(
    spec: QualityRunSpec | None = None, seeds: tuple[int, ...] = (0, 1, 2, 3, 4),
    *, device="cuda", enforce_torch_pin: bool = True,
) -> dict:
    """The composed benchmark over several seeds, with a 95% t-CI on each
    delta. One seed's draw (data, splits, shuffle stream, AND the matched
    init) dominates a single composed run — the reference's own quality
    tables average repeated runs for the same reason (reference:
    docs/research/hidden-layer-experiments.md:62-73). Each seed re-draws
    the dataset, the split, the epoch stream, and the shared init stream
    (``random_state = seed``); both stacks see identical data and, under
    ``init='sklearn'``, identical initial weights, so the CI band is over
    *pipeline residuals*, not draw noise. Returns per-seed rows plus
    ``{mean, std, ci95_low, ci95_high}`` per delta."""
    from scipy import stats

    base = spec or QualityRunSpec()
    if len(seeds) < 2:
        raise ValueError("multiseed needs >= 2 seeds for a CI")
    runs = []
    for s in seeds:
        run_spec = QualityRunSpec(
            **{
                **base.__dict__,
                "seed": int(s),
                "random_state": int(s),
            }
        )
        runs.append(run_quality_parity(run_spec, device=device,
                                       enforce_torch_pin=enforce_torch_pin))
    n = len(runs)
    tcrit = float(stats.t.ppf(0.975, n - 1))
    aggregate = {}
    for key in DELTA_KEYS:
        vals = np.array([r[key] for r in runs], dtype=np.float64)
        mean = float(vals.mean())
        std = float(vals.std(ddof=1))
        half = tcrit * std / np.sqrt(n)
        aggregate[key] = {
            "mean": round(mean, 4),
            "std": round(std, 4),
            "ci95_low": round(mean - half, 4),
            "ci95_high": round(mean + half, 4),
            "ci_contains_zero": bool(mean - half <= 0.0 <= mean + half),
        }
    return {
        "seeds": [int(s) for s in seeds],
        "init": base.init,
        "per_seed": runs,
        "deltas": aggregate,
        "n_train": runs[0]["n_train"],
        "n_val": runs[0]["n_val"],
        "n_classes": runs[0]["n_classes"],
    }


def run_quality_parity(spec: QualityRunSpec | None = None, *, device="cuda",
                       enforce_torch_pin: bool = True) -> dict:
    """The full comparison. Returns a flat dict ready for JSON."""
    spec = spec or QualityRunSpec()
    X, y = make_imbalanced_clusters(spec)
    train, ref, val = split_stratified(X, y, spec)
    train_sub = subsample_train(train, spec)
    logger.info(
        "quality parity: %d train (subsampled from %d), %d ref, %d val,"
        " %d classes",
        len(train_sub[0]), len(train[0]), len(ref[0]), len(val[0]),
        len(np.unique(y)),
    )
    repo = run_repo_pipeline(train_sub, ref, val, spec, device=device,
                             enforce_torch_pin=enforce_torch_pin)
    skl = run_sklearn_pipeline(train_sub, ref, val, spec)
    return {
        "repo_accuracy": round(repo.accuracy, 4),
        "repo_balanced_accuracy": round(repo.balanced_accuracy, 4),
        "repo_log_loss": round(repo.log_loss, 4),
        "sklearn_accuracy": round(skl.accuracy, 4),
        "sklearn_balanced_accuracy": round(skl.balanced_accuracy, 4),
        "sklearn_log_loss": round(skl.log_loss, 4),
        "accuracy_delta": round(repo.accuracy - skl.accuracy, 4),
        "balanced_accuracy_delta": round(
            repo.balanced_accuracy - skl.balanced_accuracy, 4
        ),
        "log_loss_delta": round(repo.log_loss - skl.log_loss, 4),
        "n_train": len(train_sub[0]),
        "n_val": len(val[0]),
        "n_classes": int(len(np.unique(y))),
    }
