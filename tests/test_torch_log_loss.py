"""The port's ``log_loss`` against sklearn 1.9's on float32 and float64
input: sklearn keeps a float32 array's dtype (eps, clip, logs and mean in
float32) and casts anything else to float64, so the port must too. Cases
hold zero probabilities (where the clip at eps decides the loss) and rows
that do not sum to 1 (where sklearn warns); each is held to sklearn within
1e-12 relative at float64 and 1e-6 at float32, with the same warnings."""

import warnings

import numpy as np
import pytest
from sklearn.metrics import log_loss as sk_log_loss

from mermaid_classifier_tpu_torch.train.trainer import log_loss

TOL = {np.float64: 1e-12, np.float32: 1e-6}


def _dirichlet(n=400, k=5, seed=0):
    """Sparse rows: Dirichlet(0.05) puts many true-class probabilities at
    or below float32's eps."""
    rng = np.random.default_rng(seed)
    proba = rng.dirichlet(np.full(k, 0.05), n)
    labels = np.array([f"c{i}" for i in range(k)])
    return labels[rng.integers(0, k, n)], proba, list(labels)


def _cases():
    y, proba, labels = _dirichlet()
    rng = np.random.default_rng(1)
    scaled = proba * rng.uniform(0.5, 1.0, (len(proba), 1))
    zeros = proba.copy()
    zeros[np.arange(0, len(zeros), 7), :] = 0.0
    zeros[np.arange(0, len(zeros), 7), 0] = 1.0
    return {
        "dirichlet": (y, proba, labels),
        "rows_below_one": (y, scaled, labels),
        "exact_zeros": (y, zeros, labels),
        "binary_column": (np.array(labels[:2])[rng.integers(0, 2, 50)],
                          np.where(rng.random(50) < 0.3, 0.0, rng.random(50)),
                          labels[:2]),
    }


def _observe(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = fn()
    return value, sorted({str(w.message) for w in caught
                          if issubclass(w.category, UserWarning)})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(_cases()))
def test_log_loss_follows_sklearn_dtype(case, dtype):
    y, proba, labels = _cases()[case]
    proba = proba.astype(dtype)
    want, want_warnings = _observe(lambda: sk_log_loss(y, proba, labels=labels))
    got, got_warnings = _observe(lambda: log_loss(y, proba, labels=labels))
    assert got == pytest.approx(want, rel=TOL[dtype], abs=0)
    assert got_warnings == want_warnings
    if case == "rows_below_one":
        assert want_warnings


def test_float32_reads_what_sklearn_reads():
    """The float32 clip at eps 1.19e-7 gives a smaller loss than the float64
    clip at 2.2e-16 on the same sparse rows (about 9.144 against 14.356)."""
    y, proba, labels = _dirichlet()
    p32 = proba.astype(np.float32)
    got32, got64 = log_loss(y, p32, labels), log_loss(y, p32.astype(np.float64), labels)
    assert got32 == pytest.approx(sk_log_loss(y, p32, labels=labels), rel=1e-6)
    assert got64 == pytest.approx(
        sk_log_loss(y, p32.astype(np.float64), labels=labels), rel=1e-12)
    assert got32 < got64 - 1.0
