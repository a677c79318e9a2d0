"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and what the plain reference gives, held against a
limit of its own from ``benchmark/limits/<cell>.json``.

A check passes when its number is at most its limit. Limits, and the
readings they were set from, are in ``PERF.md``.
"""

from __future__ import annotations

import numpy as np


def feature_gap(got: list, want: list) -> float:
    """The compared images' answers against the reference's: the root mean
    square, over every point of every image, of |got - want| / max(|want|,
    the median point's |want|). The median floor keeps a point whose
    features all but vanish from reading its rounding as a large gap."""
    if not got or len(got) != len(want):
        return float("inf")
    if any(np.shape(g) != np.shape(w) for g, w in zip(got, want)):
        return float("inf")
    got = np.concatenate(got).astype(np.float64)
    want = np.concatenate(want).astype(np.float64)
    norms = np.linalg.norm(want, axis=1)
    den = np.maximum(np.maximum(norms, np.median(norms)), np.finfo(np.float64).tiny)
    return float(np.sqrt(np.mean((np.linalg.norm(got - want, axis=1) / den) ** 2)))


def loss_gap(got, want) -> float:
    """The widest relative gap of a step's loss."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def leaf_norm_gap(got: list, want: list, counted: list[bool] | None = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    not the norm of their difference, measured against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    if len(got) != len(want):
        return float("inf")
    g = np.array([np.linalg.norm(np.asarray(a, np.float64)) for a in got])
    w = np.array([np.linalg.norm(np.asarray(a, np.float64)) for a in want])
    keep = np.ones(len(w), bool) if counted is None else np.asarray(counted, bool)
    if not keep.any():
        return float("inf")
    den = np.maximum(w, np.median(w[keep]))
    return float(np.max(np.abs(g - w)[keep] / den[keep]))


def moving_leaves(ref_grads: list, floor: float = 1e-3) -> list[bool]:
    """Leaves whose reference gradient is above ``floor`` times the median
    leaf's: the others move under Adam by round-off alone."""
    norms = np.array([np.linalg.norm(np.asarray(g, np.float64)) for g in ref_grads])
    return [bool(x) for x in norms >= floor * np.median(norms)]


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limit; a number that
    is missing or not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        value = float(value) if value is not None else float("inf")
        passed = bool(np.isfinite(value) and value <= float(limit))
        ok &= passed
        checks[name] = {"value": value, "limit": float(limit)}
    return ok, checks
