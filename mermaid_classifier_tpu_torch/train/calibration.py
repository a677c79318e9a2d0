"""Platt sigmoid and temperature calibration: the port's own copy of
``mermaid_classifier_tpu/train/calibration.py``.

The host fits (``fit_sigmoid_calibration``, ``fit_temperature`` and the two
calibrated-classifier wrappers) are that module's numpy code, unchanged,
with scipy imported at call time:

  - Platt's Bayesian target priors: T[y>0] = (prior1+1)/(prior1+2),
    T[y<=0] = 1/(prior0+2).
  - Feature rescale when max|F| >= 30 (invariance trick), rescaling ``a``
    back afterwards.
  - Half-binomial loss minimized with L-BFGS-B, analytic gradient,
    gtol=1e-6, ftol=64*eps, init AB0 = [0, log((prior0+1)/(prior1+1))].
  - Per-class one-vs-rest calibrators for K > 2; a single positive-column
    calibrator for K == 2.
  - predict_proba: c_k = sigmoid(-(a_k p_k + b_k)); multiclass rows
    normalized with a uniform fallback when the row sums to zero; values
    that overshoot 1.0 by <= 1e-5 clipped to exactly 1.0.

``fit_sigmoid_calibration_batch`` is the batched solve in torch, float32 on
``device``: every one-vs-rest fit at once by damped Newton.
"""

from __future__ import annotations

from math import log
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.models.extractor import _resolve_device


# scipy resolves at call time: importing its optimize tree costs seconds,
# and only the host fits need it.
def expit(x):
    from scipy.special import expit as _expit

    return _expit(x)


def minimize(*args, **kwargs):
    from scipy.optimize import minimize as _minimize

    return _minimize(*args, **kwargs)


def fit_sigmoid_calibration(
    predictions: np.ndarray,
    y: np.ndarray,
    sample_weight: np.ndarray | None = None,
    max_abs_prediction_threshold: float = 30.0,
) -> tuple[float, float]:
    """Fit Platt's sigmoid: P(y=1|F) = sigmoid(-(a*F + b)).

    ``predictions`` are the uncalibrated scores for one class column;
    ``y`` is binary (1 = positive class, 0/-1 = negative). Returns (a, b).
    """
    F = np.asarray(predictions, dtype=np.float64).ravel()
    y = np.asarray(y).ravel()
    if F.shape[0] != y.shape[0]:
        raise ValueError(
            f"predictions and y must have the same length; got {F.shape[0]} vs {y.shape[0]}."
        )

    scale_constant = 1.0
    max_prediction = float(np.max(np.abs(F))) if F.size else 0.0
    # Large raw scores are rescaled into a stable range; a linear model
    # without penalty is invariant to this, and ``a`` is scaled back below.
    if max_prediction >= max_abs_prediction_threshold:
        scale_constant = max_prediction
        F = F / scale_constant

    mask_negative = y <= 0
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64).ravel()
        prior0 = float(sample_weight[mask_negative].sum())
        prior1 = float(sample_weight[~mask_negative].sum())
    else:
        prior0 = float(np.sum(mask_negative))
        prior1 = float(y.shape[0] - prior0)
    T = np.zeros_like(F)
    T[y > 0] = (prior1 + 1.0) / (prior1 + 2.0)
    T[y <= 0] = 1.0 / (prior0 + 2.0)

    def loss_grad(AB: np.ndarray) -> tuple[float, np.ndarray]:
        raw = -(AB[0] * F + AB[1])
        # Half-binomial loss per sample: log(1 + exp(raw)) - T * raw,
        # computed stably; gradient wrt raw is sigmoid(raw) - T.
        losses = np.logaddexp(0.0, raw) - T * raw
        g = expit(raw) - T
        if sample_weight is not None:
            losses = losses * sample_weight
            g = g * sample_weight
        grad = np.asarray([-(g @ F), -g.sum()], dtype=np.float64)
        return float(losses.sum()), grad

    AB0 = np.array([0.0, log((prior0 + 1.0) / (prior1 + 1.0))])
    opt_result = minimize(
        loss_grad,
        AB0,
        method="L-BFGS-B",
        jac=True,
        options={"gtol": 1e-6, "ftol": 64 * np.finfo(float).eps},
    )
    a, b = opt_result.x
    return float(a / scale_constant), float(b)


def fit_sigmoid_calibration_batch(
    predictions: np.ndarray,
    targets: np.ndarray,
    sample_weight: np.ndarray | None = None,
    max_abs_prediction_threshold: float = 30.0,
    iters: int = 30,
    backtracks: int = 12,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """All K one-vs-rest Platt fits as one batched solve on ``device``.

    The same half-binomial objective as ``fit_sigmoid_calibration``, with
    Platt's Bayesian targets and the max|F| >= 30 rescale, minimized per
    class by damped Newton with backtracking, vectorized over classes, in
    float32. The problem is 2-parameter convex, so Newton lands at machine
    precision in under 10 iterations. The loop runs a fixed count of
    iterations and backtracks with no host sync; only (a, b) are read back.

    ``predictions`` is (N, K) score columns; ``targets`` is (N, K) binary
    one-vs-rest labels (targets[:, k] = 1 where y == classes[k]).
    Returns (a, b), each (K,) float64, in the same orientation as the
    scalar fitter: P(y=1|F) = sigmoid(-(a*F + b)).
    """
    device = _resolve_device(device)
    F_host = np.asarray(predictions, dtype=np.float32)
    Y_host = np.asarray(targets, dtype=np.float32)
    if F_host.ndim != 2 or F_host.shape != Y_host.shape:
        raise ValueError(
            f"predictions and targets must share a 2-D shape; got"
            f" {F_host.shape} vs {Y_host.shape}."
        )
    if sample_weight is not None:
        w_host = np.asarray(sample_weight, dtype=np.float32).ravel()
        if w_host.shape[0] != F_host.shape[0]:
            raise ValueError(
                f"sample_weight length {w_host.shape[0]} != N {F_host.shape[0]}."
            )
    else:
        w_host = np.ones(F_host.shape[0], dtype=np.float32)

    # Classes by rows, (K, N): every sum below runs along the contiguous
    # dimension, a tree sum on either device.
    F = torch.from_numpy(np.ascontiguousarray(F_host.T)).to(device)
    Y = torch.from_numpy(np.ascontiguousarray(Y_host.T)).to(device)
    w = torch.from_numpy(w_host).to(device)

    # Per-class rescale (invariance trick, scaled back at the end).
    max_pred = F.abs().amax(dim=1)
    scale = torch.where(max_pred >= max_abs_prediction_threshold, max_pred,
                        torch.ones_like(max_pred))
    Fs = F / scale[:, None]
    prior1 = (w * Y).sum(dim=1)
    prior0 = w.sum() - prior1
    # Platt's Bayesian targets.
    t_pos = (prior1 + 1.0) / (prior1 + 2.0)
    t_neg = 1.0 / (prior0 + 2.0)
    T = Y * t_pos[:, None] + (1.0 - Y) * t_neg[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def loss_of(a, b):
        raw = -(a[:, None] * Fs + b[:, None])
        return (w * (torch.logaddexp(zero, raw) - T * raw)).sum(dim=1)

    a = torch.zeros_like(prior0)
    b = torch.log((prior0 + 1.0) / (prior1 + 1.0))
    loss = loss_of(a, b)
    for _ in range(iters):
        raw = -(a[:, None] * Fs + b[:, None])
        sig = torch.sigmoid(raw)
        g = w * (sig - T)
        grad_a, grad_b = -(g * Fs).sum(dim=1), -g.sum(dim=1)
        hw = w * sig * (1.0 - sig)
        h_aa = (hw * Fs * Fs).sum(dim=1)
        h_ab = (hw * Fs).sum(dim=1)
        h_bb = hw.sum(dim=1)
        # Tiny ridge keeps the 2x2 solve finite on degenerate columns
        # (constant scores); the backtracking accept test below makes a bad
        # direction a no-op rather than a divergence.
        ridge = 1e-12 + 1e-7 * torch.maximum(h_aa, h_bb)
        det = (h_aa + ridge) * (h_bb + ridge) - h_ab * h_ab
        da = (grad_a * (h_bb + ridge) - grad_b * h_ab) / det
        db = (grad_b * (h_aa + ridge) - grad_a * h_ab) / det
        best_a, best_b, best = a, b, loss
        for s in range(backtracks):
            cand_a, cand_b = a - (0.5 ** s) * da, b - (0.5 ** s) * db
            cand = loss_of(cand_a, cand_b)
            better = cand < best
            best_a = torch.where(better, cand_a, best_a)
            best_b = torch.where(better, cand_b, best_b)
            best = torch.where(better, cand, best)
        a, b, loss = best_a, best_b, best
    return (
        (a / scale).cpu().numpy().astype(np.float64),
        b.cpu().numpy().astype(np.float64),
    )


# sklearn clips probabilities that overshoot 1.0 by float rounding (up to
# 1e-5) back to exactly 1.0.
_OVERSHOOT_EPS = 1e-5


class CalibratedClassifier:
    """A prefit estimator + per-class Platt calibrators.

    Drop-in for the role sklearn's ``CalibratedClassifierCV(cv='prefit',
    method='sigmoid')`` plays in the reference trainer
    (reference: trainer.py:344-396). Exposes ``classes_``,
    ``calibration_a_``/``calibration_b_`` (in classes_ order), ``estimator``,
    and ``predict_proba``/``predict``.
    """

    cv = "prefit"
    method = "sigmoid"

    def __init__(self, estimator: Any, a: np.ndarray, b: np.ndarray) -> None:
        self.estimator = estimator
        self.classes_ = np.asarray(estimator.classes_)
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        n_classes = len(self.classes_)
        n_calibrators = 1 if n_classes == 2 else n_classes
        if a.shape != (n_calibrators,) or b.shape != (n_calibrators,):
            raise ValueError(
                f"Expected {n_calibrators} calibrators for K={n_classes};"
                f" got a.shape={a.shape}, b.shape={b.shape}."
            )
        self.calibration_a_ = a
        self.calibration_b_ = b

    #: valid values for fit_from_scores(backend=...). "scipy" is the
    #: sklearn-parity path (per-class L-BFGS, pinned against sklearn's
    #: _SigmoidCalibration); "device" batches every one-vs-rest fit into
    #: one Newton solve on the device (fit_sigmoid_calibration_batch),
    #: differential-tested against the scipy path.
    BACKENDS = ("scipy", "device")

    @classmethod
    def fit_from_scores(
        cls,
        estimator: Any,
        predictions: np.ndarray,
        y: np.ndarray,
        sample_weight: np.ndarray | None = None,
        backend: str = "scipy",
        device="cuda",
    ) -> "CalibratedClassifier":
        """Fit calibrators from precomputed uncalibrated scores.

        ``predictions`` is (N, K) for multiclass or (N, 1) (positive-class
        column) for binary — the same contract as sklearn's
        ``_fit_calibrator`` that the reference's batched calibration uses
        (reference: trainer.py:359-396). ``backend`` picks the fitter:
        see BACKENDS; ``device`` is where the "device" backend solves.
        """
        if backend not in cls.BACKENDS:
            raise ValueError(
                f"calibration backend must be one of {cls.BACKENDS},"
                f" got {backend!r}"
            )
        predictions = np.asarray(predictions, dtype=np.float64)
        if predictions.ndim != 2:
            raise ValueError(f"predictions must be 2D, got shape {predictions.shape}")
        y = np.asarray(y)
        classes = np.asarray(estimator.classes_)
        n_classes = len(classes)
        if n_classes == 2:
            if predictions.shape[1] != 1:
                raise ValueError(
                    f"binary calibration expects (N, 1) positive-class scores,"
                    f" got {predictions.shape}."
                )
            y_bin = (y == classes[1]).astype(np.float64)
            if backend == "device":
                a_arr, b_arr = fit_sigmoid_calibration_batch(
                    predictions, y_bin[:, None], sample_weight, device=device
                )
                return cls(estimator, a_arr, b_arr)
            a, b = fit_sigmoid_calibration(predictions[:, 0], y_bin, sample_weight)
            return cls(estimator, np.asarray([a]), np.asarray([b]))
        if predictions.shape[1] != n_classes:
            raise ValueError(
                f"predictions has {predictions.shape[1]} columns, expected"
                f" {n_classes} (one per class)."
            )
        # One-vs-rest label binarization in classes_ order, matching
        # sklearn's label_binarize + per-column sigmoid fit.
        if backend == "device":
            targets = (
                np.asarray(y)[:, None] == classes[None, :]
            ).astype(np.float64)
            a_arr, b_arr = fit_sigmoid_calibration_batch(
                predictions, targets, sample_weight, device=device
            )
            return cls(estimator, a_arr, b_arr)
        a_list, b_list = [], []
        for k in range(n_classes):
            y_bin = (y == classes[k]).astype(np.float64)
            a_k, b_k = fit_sigmoid_calibration(predictions[:, k], y_bin, sample_weight)
            a_list.append(a_k)
            b_list.append(b_k)
        return cls(estimator, np.asarray(a_list), np.asarray(b_list))

    def predict_proba(self, X: Any) -> np.ndarray:
        uncalibrated = np.asarray(self.estimator.predict_proba(X), dtype=np.float64)
        return self.calibrate_scores(uncalibrated)

    def calibrate_scores(self, uncalibrated: np.ndarray) -> np.ndarray:
        """Apply the fitted calibrators to precomputed uncalibrated (N, K)
        probabilities — lets callers stream predict_proba in batches without
        re-running the estimator (the reference's memory-efficiency trick)."""
        uncalibrated = np.asarray(uncalibrated, dtype=np.float64)
        n_classes = len(self.classes_)
        if n_classes == 2:
            pos = expit(
                -(self.calibration_a_[0] * uncalibrated[:, 1] + self.calibration_b_[0])
            )
            proba = np.column_stack([1.0 - pos, pos])
        else:
            c = expit(-(self.calibration_a_ * uncalibrated + self.calibration_b_))
            denom = c.sum(axis=1, keepdims=True)
            nonzero = (denom != 0).ravel()
            proba = np.full_like(c, 1.0 / n_classes)
            proba[nonzero] = c[nonzero] / denom[nonzero]
        overshoot = (proba > 1.0) & (proba <= 1.0 + _OVERSHOOT_EPS)
        proba[overshoot] = 1.0
        return proba

    def predict(self, X: Any) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


def fit_temperature(
    log_p: np.ndarray,
    y_idx: np.ndarray,
    sample_weight: np.ndarray | None = None,
    beta_bounds: tuple[float, float] = (1e-3, 100.0),
) -> float:
    """Fit the inverse temperature beta minimizing the weighted NLL of
    softmax(beta * log_p) against integer labels; returns beta.

    ``log_p`` is (N, K) log-probabilities (any per-row additive shift is
    harmless — softmax is shift-invariant). The NLL of an exponential
    family in its natural parameter is convex in beta, so a bounded 1-D
    Brent search lands at the global optimum.
    """
    log_p = np.asarray(log_p, dtype=np.float64)
    y_idx = np.asarray(y_idx)
    if log_p.ndim != 2:
        raise ValueError(f"log_p must be 2-D, got shape {log_p.shape}")
    if y_idx.shape[0] != log_p.shape[0]:
        raise ValueError(
            f"labels length {y_idx.shape[0]} != rows {log_p.shape[0]}."
        )
    if sample_weight is not None:
        w = np.asarray(sample_weight, dtype=np.float64).ravel()
    else:
        w = None
    rows = np.arange(log_p.shape[0])
    true_col = log_p[rows, y_idx]

    def nll(beta: float) -> float:
        z = beta * log_p
        # logsumexp, stabilized per row.
        m = z.max(axis=1)
        lse = m + np.log(np.exp(z - m[:, None]).sum(axis=1))
        per = lse - beta * true_col
        return float((per * w).sum() if w is not None else per.sum())

    from scipy.optimize import minimize_scalar

    res = minimize_scalar(nll, bounds=beta_bounds, method="bounded")
    return float(res.x)


class TemperatureCalibratedClassifier:
    """A prefit estimator + a single temperature parameter.

    The beyond-parity alternative to Platt sigmoid calibration: the
    estimator's probabilities are sharpened/flattened as
    ``p^beta / sum(p^beta)`` — exactly ``softmax(beta * logits)``, so the
    shipped artifact applies it as one fused op and the argmax (accuracy,
    balanced accuracy, every decision metric) is bit-identical to the
    uncalibrated model. Fit minimizes NLL on the calibration split, so the
    calibrated log_loss can only improve on beta=1 there — unlike the
    production prefit-sigmoid recipe, which RAISED log_loss at C2 scale
    for both this stack and sklearn's on the same corpus
    (docs/runs/sklearn_same_corpus_baseline_2026-08-19.json: sklearn
    uncalibrated 0.5719 -> sigmoid-calibrated 0.8709). Same protocol as
    the reference (calibration fit on the ref split, metrics on val;
    reference: mermaid_classifier/pyspacer/trainer.py:344-396).

    Duck-type compatible with CalibratedClassifier everywhere the trainer,
    exporter, and metrics stack touch one: ``classes_``, ``estimator``,
    ``predict_proba``, ``calibrate_scores``, ``predict``, ``cv``/``method``.
    """

    cv = "prefit"
    method = "temperature"

    #: probabilities are clipped here before the log — float32 softmax
    #: underflows to exactly 0.0 around 1e-45.
    _LOG_CLIP = 1e-300

    def __init__(self, estimator: Any, temperature: float) -> None:
        self.estimator = estimator
        self.classes_ = np.asarray(estimator.classes_)
        temperature = float(temperature)
        if not np.isfinite(temperature) or temperature <= 0.0:
            raise ValueError(
                f"temperature must be a positive finite float, got"
                f" {temperature!r}."
            )
        self.temperature_ = temperature

    @classmethod
    def fit_from_scores(
        cls,
        estimator: Any,
        predictions: np.ndarray,
        y: np.ndarray,
        sample_weight: np.ndarray | None = None,
    ) -> "TemperatureCalibratedClassifier":
        """Fit the temperature from precomputed uncalibrated probabilities.

        ``predictions`` is (N, K) for multiclass, or (N, 1) (positive-class
        column) for binary — the same contract as
        ``CalibratedClassifier.fit_from_scores`` so the trainer's streaming
        path branches between the two without reshaping."""
        predictions = np.asarray(predictions, dtype=np.float64)
        if predictions.ndim != 2:
            raise ValueError(
                f"predictions must be 2D, got shape {predictions.shape}"
            )
        y = np.asarray(y)
        classes = np.asarray(estimator.classes_)
        n_classes = len(classes)
        if n_classes == 2 and predictions.shape[1] == 1:
            pos = predictions[:, 0]
            predictions = np.column_stack([1.0 - pos, pos])
        if predictions.shape[1] != n_classes:
            raise ValueError(
                f"predictions has {predictions.shape[1]} columns, expected"
                f" {n_classes} (one per class)."
            )
        # Class values -> column indices, in classes_ order.
        class_to_idx = {c: i for i, c in enumerate(classes.tolist())}
        try:
            y_idx = np.asarray([class_to_idx[v] for v in y.tolist()])
        except KeyError as exc:
            raise ValueError(
                f"label {exc} is not in estimator.classes_."
            ) from exc
        log_p = np.log(np.clip(predictions, cls._LOG_CLIP, None))
        beta = fit_temperature(log_p, y_idx, sample_weight)
        # Snap beta to its f32 value: the shipped artifact stores inv_t as
        # f32 (HeadParams.as_pytree), so fitting-side and artifact-side
        # probabilities use the bit-identical exponent — the export parity
        # gate then measures only f32-vs-f64 arithmetic rounding, not a
        # beta mismatch. (1/(1/beta32) rounds back to beta32 in f32.)
        beta = float(np.float32(beta))
        return cls(estimator, 1.0 / beta)

    def predict_proba(self, X: Any) -> np.ndarray:
        uncalibrated = np.asarray(
            self.estimator.predict_proba(X), dtype=np.float64
        )
        return self.calibrate_scores(uncalibrated)

    def calibrate_scores(self, uncalibrated: np.ndarray) -> np.ndarray:
        """Apply the temperature to precomputed uncalibrated (N, K)
        probabilities (same streaming contract as CalibratedClassifier)."""
        uncalibrated = np.asarray(uncalibrated, dtype=np.float64)
        beta = 1.0 / self.temperature_
        z = beta * np.log(np.clip(uncalibrated, self._LOG_CLIP, None))
        m = z.max(axis=1, keepdims=True)
        e = np.exp(z - m)
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X: Any) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]
