"""Same-corpus reference-recipe baseline: the sklearn pipeline on the C2
drive's exact corpus, subsample and splits. It runs on the host only.

    python -m mermaid_classifier_tpu_torch.scripts.sklearn_reference_baseline \\
        --workdir <the full_recipe_drive workdir> [--output-json record.json] \\
        [--repo-record docs/torch_runs/<the drive's record>.json]

The port's C2 drive (``full_recipe_drive``) trains on a synthesized corpus,
so its quality is compared with the reference-semantics pipeline on the
same corpus: sklearn ``MLPClassifier`` (the estimator the reference's
``TorchMLPClassifier`` clones, (500, 300, 100) @ 1e-4, auto minibatch)
driven through the reference trainer's epoch loop (streamed
``partial_fit`` chunks with ``random_seed=epoch``, per-epoch streamed val
log_loss, patience early stopping with best-snapshot restore -- reference:
pyspacer/trainer.py:113-260) and prefit-sigmoid ``CalibratedClassifierCV``
(reference: pyspacer/trainer.py:344-396). The corpus comes from the drive's
own synthesizer (reused from ``--workdir`` when present), the manifest from
the port's ``build_coralnet_manifest``, and the subsample and splits from
the port's ``TrainingDataset``, which gives the drive's rows exactly.

Known recipe delta: the C2 row trains with effective-number class weights;
sklearn's MLP takes no class weights, so this baseline is unweighted.

sklearn is imported inside the functions that use it: the card's machine
has none, and this script runs on the host.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from pathlib import Path

import numpy as np

from mermaid_classifier_tpu_torch.scripts.full_recipe_drive import (
    build_taxonomy,
    drive_env,
    run_cli,
    synthesize_corpus,
)

REPO = Path(__file__).resolve().parents[2]
DEFAULT_REPO_RECORD = REPO / "docs" / "torch_runs" / "full_recipe_int8_2026-10-18.json"


def log(msg: str) -> None:
    print(f"[sklearn-baseline] {msg}", flush=True)


def _materialize(labels, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """One split's (X, y), preallocated and filled in place from the
    deterministic batches (no multi-GB vstack)."""
    n = labels.label_count
    X = np.empty((n, dim), dtype=np.float32)
    X.fill(0.0)  # one sequential pre-touch pass
    y = np.empty(n, dtype=object)
    at = 0
    for xb, yb in labels.load_data_in_batches(batch_size=16384):
        X[at: at + len(yb)] = xb
        y[at: at + len(yb)] = yb
        at += len(yb)
    if at != n:
        raise RuntimeError(f"split streamed {at} rows, counts {n}")
    return X, y


def _val_acc_and_loss(clf, labels, classes_list, chunk: int):
    """Streamed val accuracy + log_loss against the full class set -- the
    reference's per-epoch overfitting signal (reference:
    pyspacer/trainer.py:309-342)."""
    from sklearn.metrics import accuracy_score, log_loss

    gt, probas = [], []
    for x, yb in labels.load_data_in_batches(batch_size=chunk):
        probas.append(clf.predict_proba(x))
        gt.extend(yb)
    proba = np.vstack(probas)
    pred = [classes_list[i] for i in proba.argmax(axis=1)]
    return (
        float(accuracy_score(gt, pred)),
        float(log_loss(gt, proba, labels=classes_list)),
    )


def train_reference_loop(labels, classes_list, epochs, patience, chunk):
    """The reference trainer's epoch loop around the sklearn estimator:
    streamed partial_fit chunks shuffled per epoch, per-epoch val log_loss,
    patience early stopping, best-snapshot restore (unconditional -- a
    budget-exhausted run also ships the best epoch). Reference:
    pyspacer/trainer.py:113-260."""
    from sklearn.neural_network import MLPClassifier as SklearnMLP

    clf = SklearnMLP(
        hidden_layer_sizes=(500, 300, 100),
        learning_rate_init=1e-4,
        random_state=0,
        max_iter=1,  # partial_fit-driven; the constructor arg is unused
    )
    best_val_loss = float("inf")
    best_snapshot = None
    best_epoch_idx = None
    epochs_since_best = 0
    stop_reason = "budget_exhausted"
    history = []
    epoch = 0
    for epoch in range(epochs):
        t0 = time.time()
        for x, yb in labels.train.load_data_in_batches(
            batch_size=chunk, random_seed=epoch
        ):
            clf.partial_fit(x, yb, classes=classes_list)
        val_acc, val_loss = _val_acc_and_loss(
            clf, labels.val, classes_list, chunk
        )
        history.append(
            {"epoch": epoch + 1, "val_acc": round(val_acc, 4),
             "val_loss": round(val_loss, 4),
             "seconds": round(time.time() - t0, 1)}
        )
        log(f"epoch {epoch + 1}/{epochs}: val_acc {val_acc:.4f}"
            f" val_loss {val_loss:.4f} ({history[-1]['seconds']}s)")
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            best_epoch_idx = epoch
            best_snapshot = copy.deepcopy(clf)
            epochs_since_best = 0
        else:
            epochs_since_best += 1
        if epochs_since_best >= patience:
            stop_reason = "early_stopping"
            break
    if best_snapshot is not None and best_epoch_idx != epoch:
        clf = best_snapshot
    return clf, {
        "stop_reason": stop_reason,
        "final_epoch": epoch + 1,
        "best_val_epoch": (best_epoch_idx + 1) if best_epoch_idx is not None
        else None,
        "best_val_loss": round(best_val_loss, 4),
        "epoch_history": history,
    }


def calibrate_prefit_sigmoid(clf, X_ref, y_ref):
    """Prefit sigmoid calibration with the reference's semantics: one
    sigmoid per class fit on all ref scores through sklearn's
    ``_fit_calibrator`` on precomputed predictions, wrapped without calling
    ``.fit()`` (reference: pyspacer/trainer.py:344-396). The
    FrozenEstimator route is the fallback only: under default cv it fits a
    5-fold ensemble of calibrators, which is not prefit semantics."""
    import sklearn.calibration as skcal

    preds = clf.predict_proba(X_ref)
    if len(clf.classes_) == 2:
        preds = preds[:, 1:]
    try:
        try:
            calibrated_inner = skcal._fit_calibrator(
                clf, preds, np.asarray(y_ref), clf.classes_,
                method="sigmoid", xp=np,
            )
        except TypeError:  # older sklearn: no xp (array-api) parameter
            calibrated_inner = skcal._fit_calibrator(
                clf, preds, np.asarray(y_ref), clf.classes_, method="sigmoid"
            )
        wrapper = skcal.CalibratedClassifierCV(clf, method="sigmoid")
        wrapper.calibrated_classifiers_ = [calibrated_inner]
        wrapper.classes_ = clf.classes_
        return wrapper
    except Exception as exc:  # noqa: BLE001 -- private-API drift
        log(f"_fit_calibrator path unavailable ({exc!r}); falling back to"
            " FrozenEstimator (5-fold ensemble, NOT strict prefit)")
        from sklearn.calibration import CalibratedClassifierCV
        from sklearn.frozen import FrozenEstimator

        cal = CalibratedClassifierCV(FrozenEstimator(clf), method="sigmoid")
        cal.fit(X_ref, y_ref)
        return cal


def score_pipeline(y_true, proba, classes_list) -> dict:
    from sklearn.metrics import (
        accuracy_score,
        balanced_accuracy_score,
        f1_score,
        log_loss,
        matthews_corrcoef,
    )

    pred = [classes_list[i] for i in np.asarray(proba).argmax(axis=1)]
    return {
        "accuracy": round(float(accuracy_score(y_true, pred)), 4),
        "balanced_accuracy": round(
            float(balanced_accuracy_score(y_true, pred)), 4
        ),
        "log_loss": round(float(log_loss(y_true, proba, labels=classes_list)), 4),
        "f1_macro": round(
            float(f1_score(y_true, pred, average="macro", zero_division=0)), 4
        ),
        "mcc": round(float(matthews_corrcoef(y_true, pred)), 4),
    }


def same_corpus_dataset(manifest: Path, pool_rows: int):
    """The drive's dataset: ETL -> balanced subsample -> splits, through the
    port's ``TrainingDataset`` with the drive's options. The settings must
    already read the drive's environment (``drive_env``)."""
    from mermaid_classifier_tpu_torch.config.options import DatasetOptions
    from mermaid_classifier_tpu_torch.config.settings import apply_settings_to_env
    from mermaid_classifier_tpu_torch.data.dataset import TrainingDataset
    from mermaid_classifier_tpu_torch.data.subsample import SubsampleOptions

    apply_settings_to_env()
    return TrainingDataset(
        DatasetOptions(
            include_mermaid=False,
            coralnet_manifest_uri=str(manifest),
            ref_val_ratios=(0.1, 0.1),
            subsample=SubsampleOptions(
                strategy="balanced",
                total_annotations=pool_rows,
                min_per_class=200,
            ),
        )
    )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", required=True,
                        help="the C2 drive workspace (reuses its corpus when"
                        " present; synthesizes one otherwise)")
    parser.add_argument("--pool-rows", type=int, default=620_000)
    parser.add_argument("--classes", type=int, default=80)
    parser.add_argument("--dim", type=int, default=4096)
    parser.add_argument("--points-per-image", type=int, default=100)
    parser.add_argument("--sources", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--patience", type=int, default=3)
    parser.add_argument("--stream-chunk", type=int, default=None,
                        help="disk-streaming chunk for partial_fit; default"
                        " = the runner's RAM-derived training_batch_size,"
                        " what the C2 drive used")
    parser.add_argument("--repo-record", default=str(DEFAULT_REPO_RECORD),
                        help="the port's C2 drive record to diff against"
                        " (default: its committed int8 record on the H100)")
    parser.add_argument("--output-json", default=None)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    workspace = Path(args.workdir).resolve()
    workspace.mkdir(parents=True, exist_ok=True)

    # The data stack pointed at the drive's corpus, as the drive's
    # subprocesses see it.
    os.environ.update(drive_env(workspace))
    from mermaid_classifier_tpu_torch.config.settings import (
        reload_settings_from_env,
        training_batch_size,
    )

    reload_settings_from_env()
    t_total = time.time()
    stages: dict[str, float] = {}

    # --- corpus (reused from the drive whenever present) ---------------------
    t0 = time.time()
    if not (workspace / "etl_annotations.parquet").is_file():
        log("no corpus in workdir; synthesizing (same generator + seed as"
            " the drive)")
        build_taxonomy(args.classes, workspace / "taxonomy")
        synthesize_corpus(
            workspace, args.pool_rows, args.classes, args.dim,
            args.points_per_image, args.sources, args.seed,
        )
    manifest = workspace / "manifest.parquet"
    if not manifest.is_file():
        run_cli("build_coralnet_manifest", [
            "--annotations-parquet", str(workspace / "etl_annotations.parquet"),
            "--images-parquet", str(workspace / "etl_images.parquet"),
            "--output", str(manifest),
        ], workspace, dict(os.environ))
    stages["corpus"] = round(time.time() - t0, 1)

    # --- the drive's exact dataset: ETL -> subsample -> splits ---------------
    t0 = time.time()
    dataset = same_corpus_dataset(manifest, args.pool_rows)
    labels = dataset.labels
    classes_list = sorted(labels.ref.classes_set)
    stages["etl"] = round(time.time() - t0, 1)
    log(
        f"dataset: train {labels.train.label_count} / ref"
        f" {labels.ref.label_count} / val {labels.val.label_count} points,"
        f" {len(classes_list)} classes ({stages['etl']}s)"
    )

    chunk = args.stream_chunk or training_batch_size(
        num_classes=len(classes_list)
    )[0]

    # --- the reference trainer loop around sklearn ---------------------------
    t0 = time.time()
    clf, early_stop = train_reference_loop(
        labels, classes_list, args.epochs, args.patience, chunk
    )
    stages["train"] = round(time.time() - t0, 1)

    # --- prefit sigmoid calibration on ref, metrics on val -------------------
    t0 = time.time()
    X_ref, y_ref = _materialize(labels.ref, args.dim)
    cal = calibrate_prefit_sigmoid(clf, X_ref, y_ref)
    del X_ref
    X_val, y_val = _materialize(labels.val, args.dim)
    proba = cal.predict_proba(X_val)
    sk_metrics = score_pipeline(y_val, proba, classes_list)
    # The uncalibrated head's row too: it separates "the head is badly
    # calibrated" from "the corpus's Bayes log-loss is just higher".
    raw_metrics = score_pipeline(y_val, clf.predict_proba(X_val), classes_list)
    stages["calibrate_eval"] = round(time.time() - t0, 1)
    dataset.cleanup()

    repo_record_path = Path(args.repo_record).resolve()
    repo_record = json.loads(repo_record_path.read_text())
    repo_row = {
        k: repo_record.get(k)
        for k in ("accuracy", "balanced_accuracy", "log_loss", "f1_macro", "mcc")
    }

    record = {
        "what": (
            "reference-semantics sklearn pipeline (MLPClassifier"
            " (500,300,100)@1e-4 + reference trainer epoch loop + prefit"
            " sigmoid CalibratedClassifierCV) on the same corpus, realized"
            " subsample and splits as the port's C2 drive, on the host"
        ),
        "corpus": {
            "pool_rows": args.pool_rows,
            "classes": len(classes_list),
            "dim": args.dim,
            "train_points": labels.train.label_count,
            "ref_points": labels.ref.label_count,
            "val_points": labels.val.label_count,
            "subsample_realized": dataset._subsample_realized_total,
        },
        "recipe": {
            "subsample": f"balanced(total={args.pool_rows},"
            " min_per_class=200)",
            "arch": "(500, 300, 100) @ lr 1e-4, sklearn auto minibatch",
            "epochs": args.epochs,
            "patience": args.patience,
            "stream_chunk": int(chunk),
            "weighting": (
                "none for the sklearn baseline (sklearn's MLP takes no class"
                " weights; the C2 row trains with effective_number(cap=5000),"
                " which moves balanced accuracy, not calibrated log_loss)"
            ),
        },
        "early_stop": early_stop,
        "sklearn": sk_metrics,
        "sklearn_uncalibrated": raw_metrics,
        "repo_c2_record": repo_row,
        "repo_c2_record_path": str(
            repo_record_path.relative_to(REPO)
            if repo_record_path.is_relative_to(REPO) else repo_record_path
        ),
        "delta_repo_minus_sklearn": {
            k: round(repo_row[k] - sk_metrics[k], 4)
            for k in sk_metrics
            if repo_row.get(k) is not None
        },
        "stage_seconds": stages,
        "total_minutes": round((time.time() - t_total) / 60.0, 2),
        "reference_note": (
            "reference C2 real-data row: acc 0.812 / bal 0.774 / log_loss"
            " 0.598 (docs/research/balancing-experiments.md:49-84); this"
            " record supplies the same-corpus baseline those numbers could"
            " not provide"
        ),
    }
    line = json.dumps(record)
    print(line)
    if args.output_json:
        Path(args.output_json).write_text(json.dumps(record, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
