"""PyTorch port of ``mermaid_classifier_tpu/train/mlp_classifier.py``: the
sklearn-semantics MLP classifier head, streamed (non-resident) training.

The pinned semantics are the JAX classifier's:

  - Glorot-uniform weights; zero biases (``init="reference"``) or sklearn's
    exact ``np.random.RandomState`` stream with uniform intercepts
    (``init="sklearn"``, bit for bit the JAX init).
  - ``partial_fit(X, y, classes=)`` / ``fit`` / ``predict`` /
    ``predict_proba`` / ``classes_`` (sorted) / ``loss_curve_`` (one entry
    per partial_fit call) / ``n_iter_``.
  - Seeded shuffle: an int ``random_state`` re-creates the same
    ``np.random.default_rng`` every partial_fit call; ``random_state=None``
    seeds a per-instance RNG once from NumPy's global RNG.
  - In-loss L2 on weights only, ``0.5 * alpha / n_b * sum(W^2)`` with
    ``n_b`` the mini-batch's real row count.
  - Optional per-class CE weights: ``sum(w[y_i] * ce_i) / sum(w[y_i])``.
  - ``loss_curve_`` is the regularised loss averaged over the partial_fit
    input, weighted by mini-batch size.
  - Adam (``torch.optim.Adam``: ``m_hat / (sqrt(v_hat) + eps)``, the update
    of optax ``adam(eps_root=0)``) and ReLU only; float32 forward with a
    float64 row-renormalised ``predict_proba`` and a 1e-4 drift warning.

The parameters and the Adam state live on ``device`` (``"cuda"`` by default;
a CUDA device without CUDA raises). A partial_fit uploads its input once and
runs one Adam step per mini-batch, each gathering its rows on the device in
the numpy shuffle order; the step losses stay on the device and are read
back once per call. Every matmul, forward and backward, runs in full float32
(TF32 off), as the JAX head trains at ``Precision.HIGHEST``.

Left out here: the JAX ``mesh`` option and the device-resident training and
evaluation entry points.
"""

from __future__ import annotations

import copy
import math
import warnings
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from mermaid_classifier_tpu_torch.inference.head import mlp_logits
from mermaid_classifier_tpu_torch.models.extractor import _resolve_device
from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32

# Upper bound on the row-sum drift expected from a softmax computed in
# float32 then cast to float64.
_EXPECTED_FP_DRIFT_TOL = 1e-4


def _xavier_uniform(generator: torch.Generator, fan_in: int, fan_out: int) -> torch.Tensor:
    # Glorot uniform: sklearn MLP's init for non-logistic activations
    # (factor 6 in sklearn's _init_coef) and torch's xavier_uniform_.
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty((fan_in, fan_out), dtype=torch.float32)
    return w.uniform_(-limit, limit, generator=generator)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place training cannot change."""
    return t.detach().to("cpu", copy=True).numpy()


class MLPClassifier:
    """sklearn-MLPClassifier-compatible PyTorch classifier head.

    See the module docstring for the supported API subset and pinned
    semantics.
    """

    _estimator_type = "classifier"

    def __init__(
        self,
        hidden_layer_sizes: Sequence[int] = (100,),
        activation: str = "relu",
        solver: str = "adam",
        alpha: float = 0.0001,
        batch_size: int | str = "auto",
        learning_rate_init: float = 0.001,
        max_iter: int = 200,
        shuffle: bool = True,
        random_state: int | None = None,
        tol: float = 1e-4,
        n_iter_no_change: int = 10,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-8,
        class_weight: dict[Any, float] | None = None,
        init: str = "reference",
        device="cuda",
    ):
        if init not in ("reference", "sklearn"):
            raise ValueError(
                f"init must be 'reference' (Xavier weights, zero biases —"
                f" the reference analog) or 'sklearn' (sklearn's exact"
                f" RandomState stream incl. uniform intercepts);"
                f" got {init!r}."
            )
        if activation != "relu":
            raise ValueError(
                f"MLPClassifier only supports activation='relu', got {activation!r}."
            )
        if solver != "adam":
            raise ValueError(f"MLPClassifier only supports solver='adam', got {solver!r}.")

        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.activation = activation
        self.solver = solver
        self.alpha = alpha
        self.batch_size = batch_size
        self.learning_rate_init = learning_rate_init
        self.max_iter = max_iter
        self.shuffle = shuffle
        self.random_state = random_state
        self.tol = tol
        self.n_iter_no_change = n_iter_no_change
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.init = init
        # Per-class loss weighting: class label -> non-negative float,
        # materialized in classes_ order on the first partial_fit.
        self.class_weight = class_weight
        self.device = _resolve_device(device)

    # --- sklearn-compatible coefficient views -----------------------------

    @property
    def coefs_(self) -> list[np.ndarray]:
        """Per-layer weight matrices, (in, out) float32 host copies — sklearn
        naming, and the contract the artifact exporter consumes."""
        return [_host(w) for w in self._params["W"]]

    @property
    def intercepts_(self) -> list[np.ndarray]:
        return [_host(b) for b in self._params["b"]]

    # --- internals ----------------------------------------------------------

    def _resolve_batch_size(self, n_samples: int) -> int:
        if self.batch_size == "auto":
            return min(200, n_samples)
        return min(int(self.batch_size), n_samples)

    def _seed_rng(self) -> np.random.Generator:
        base_seed = self.random_state
        if base_seed is not None:
            return np.random.default_rng(int(base_seed))
        if not hasattr(self, "_none_rng"):
            self._none_rng = np.random.default_rng(
                np.random.randint(0, np.iinfo(np.int32).max)
            )
        return self._none_rng

    def _labels_to_indices(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y)
        idx = np.searchsorted(self.classes_, y)
        missing = idx >= len(self.classes_)
        if missing.any() or not np.array_equal(self.classes_[idx], y):
            bad = set(np.asarray(y).tolist()) - set(self.classes_.tolist())
            raise ValueError(
                f"Labels {sorted(bad)} are not in classes_"
                f" {self.classes_.tolist()}. Pass all classes to the first"
                f" partial_fit call."
            )
        return idx

    def _layer_sizes(self) -> tuple[int, ...]:
        return (self.n_features_in_, *self.hidden_layer_sizes, len(self.classes_))

    def _init_params(self) -> None:
        sizes = self._layer_sizes()
        weights, biases = [], []
        if self.init == "sklearn":
            # sklearn MLPClassifier._init_coef exactly: the same
            # np.random.RandomState stream and draw order (coefs then
            # intercepts, layer by layer), the same Glorot bound, and
            # uniform intercepts.
            rs = np.random.RandomState(
                int(self.random_state) if self.random_state is not None
                else None
            )
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                weights.append(rs.uniform(-bound, bound, (fan_in, fan_out)))
                biases.append(rs.uniform(-bound, bound, fan_out))
        else:
            # 'reference': Xavier-uniform weights, zero biases. The draws
            # come from a seeded CPU generator, so a seed gives the same
            # weights on every device.
            seed = (int(self.random_state) if self.random_state is not None
                    else int(np.random.randint(0, np.iinfo(np.int32).max)))
            gen = torch.Generator().manual_seed(seed)
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
                weights.append(_xavier_uniform(gen, fan_in, fan_out))
                biases.append(torch.zeros(fan_out, dtype=torch.float32))
        self._set_state(weights, biases, None)

    def _set_state(self, weights, biases, adam: dict | None) -> None:
        """Parameters (numpy arrays or tensors, copied onto ``self.device``)
        and a fresh Adam; ``adam`` is optax's ScaleByAdamState as arrays,
        ``{"count": int, "mu": {"W": [...], "b": [...]}, "nu": {...}}``, or
        None for a run that has taken no step."""

        # Contiguous copies whatever the source's strides: a transposed
        # operand sends the matmuls to other kernels, which sum in other
        # orders.
        def dev(a):
            if isinstance(a, torch.Tensor):
                return a.detach().to(self.device, torch.float32,
                                     memory_format=torch.contiguous_format, copy=True)
            return torch.tensor(np.ascontiguousarray(a, np.float32), device=self.device)

        self._params = {
            "W": [dev(w).requires_grad_() for w in weights],
            "b": [dev(b).requires_grad_() for b in biases],
        }
        self._opt = torch.optim.Adam(
            [*self._params["W"], *self._params["b"]],
            lr=float(self.learning_rate_init),
            betas=(float(self.beta_1), float(self.beta_2)), eps=float(self.epsilon),
        )
        if adam is not None and int(adam["count"]) > 0:
            step = torch.tensor(float(adam["count"]), dtype=torch.float32)
            for key in ("W", "b"):
                for p, m, v in zip(self._params[key], adam["mu"][key], adam["nu"][key]):
                    self._opt.state[p] = {
                        "step": step.clone(), "exp_avg": dev(m), "exp_avg_sq": dev(v),
                    }

    def _adam_state(self) -> dict:
        """The Adam state as optax lays it out: count, mu and nu (device
        tensors; count 0 and zero moments before the first step)."""
        state = self._opt.state
        first = state.get(self._params["W"][0])
        count = int(first["step"]) if first else 0

        def moments(name):
            return {key: [state[p][name] if p in state else torch.zeros_like(p.detach())
                          for p in self._params[key]] for key in ("W", "b")}

        return {"count": count, "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}

    def _build_class_weight_vector(self) -> np.ndarray | None:
        """Materialize ``self.class_weight`` into a vector in classes_ order."""
        if self.class_weight is None:
            return None
        weights: list[float] = []
        for cls in self.classes_:
            if cls not in self.class_weight:
                bad = sorted(set(self.classes_.tolist()) - set(self.class_weight))
                raise ValueError(
                    f"class_weight is missing weights for {bad!r}."
                    f" Pass weights for every class in classes_."
                )
            w = float(self.class_weight[cls])
            if w < 0:
                raise ValueError(
                    f"class_weight for {cls!r} is negative ({w!r}); weights must be >= 0."
                )
            weights.append(w)
        return np.asarray(weights, dtype=np.float32)

    # --- training -----------------------------------------------------------

    def partial_fit(
        self,
        X: np.ndarray | list[Any],
        y: np.ndarray | list[Any],
        classes: Sequence[Any] | None = None,
    ) -> "MLPClassifier":
        X_arr = np.ascontiguousarray(X, dtype=np.float32)
        if X_arr.ndim != 2:
            raise ValueError(f"X must be 2D, got shape {X_arr.shape}")

        first_call = not hasattr(self, "_params")
        if first_call:
            if classes is None:
                self.classes_ = np.unique(np.asarray(y))
            else:
                self.classes_ = np.unique(np.asarray(classes))
            self.n_features_in_ = int(X_arr.shape[1])
            self.n_iter_ = 0
            self.loss_curve_: list[float] = []
            self._init_params()
            self._class_weight_vector = self._build_class_weight_vector()
        elif X_arr.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X_arr.shape[1]} features, expected {self.n_features_in_}"
            )

        y_indices = self._labels_to_indices(np.asarray(y))
        n_samples = X_arr.shape[0]
        batch_size = self._resolve_batch_size(n_samples)

        rng = self._seed_rng()
        order = np.arange(n_samples)
        if self.shuffle:
            rng.shuffle(order)

        # Hyperparameters are read on every call, as the JAX epoch builds
        # its optimizer from them each time.
        for group in self._opt.param_groups:
            group.update(lr=float(self.learning_rate_init), eps=float(self.epsilon),
                         betas=(float(self.beta_1), float(self.beta_2)))

        x_dev = torch.from_numpy(X_arr).to(self.device)
        y_dev = torch.from_numpy(y_indices.astype(np.int64)).to(self.device)
        order_dev = torch.from_numpy(order).to(self.device)
        class_w = (None if self._class_weight_vector is None else
                   torch.from_numpy(self._class_weight_vector).to(self.device))
        weights, biases = self._params["W"], self._params["b"]
        # A short tail batch replaces the JAX code's weight-0 padding rows:
        # the data loss and the L2 scale both count real rows only.
        starts = range(0, n_samples, batch_size)
        ns = [min(batch_size, n_samples - s) for s in starts]
        losses = []
        with full_f32():
            for start, n_b in zip(starts, ns):
                idx = order_dev[start:start + n_b]
                yb = y_dev.index_select(0, idx)
                logits = mlp_logits(weights, biases, x_dev.index_select(0, idx))
                ce = -F.log_softmax(logits, dim=1).gather(1, yb[:, None])[:, 0]
                if class_w is None:
                    data_loss = ce.sum() / n_b
                else:
                    wb = class_w.index_select(0, yb)
                    data_loss = (wb * ce).sum() / wb.sum()
                sq = sum((w * w).sum() for w in weights)
                loss = data_loss + (0.5 * self.alpha / n_b) * sq
                self._opt.zero_grad(set_to_none=True)
                loss.backward()
                self._opt.step()
                losses.append(loss.detach())

        # loss_curve_ records the regularised loss averaged across the whole
        # partial_fit input, weighted by real mini-batch size.
        losses_np = torch.stack(losses).cpu().numpy().astype(np.float64)
        self.loss_curve_.append(
            float(np.sum(losses_np * np.asarray(ns, np.float64)) / max(n_samples, 1)))
        self.n_iter_ += 1
        return self

    def fit(
        self,
        X: np.ndarray | list[Any],
        y: np.ndarray | list[Any],
    ) -> "MLPClassifier":
        y_arr = np.asarray(y)
        classes: list[Any] = np.unique(y_arr).tolist()
        # Reset so fit() starts fresh even on a previously-trained instance.
        for attr in ("_params", "_opt", "classes_", "n_features_in_", "n_iter_",
                     "loss_curve_", "best_loss_"):
            if hasattr(self, attr):
                delattr(self, attr)
        # sklearn's convergence contract (MLPClassifier._fit_stochastic):
        # stop once the loss has failed to improve on best_loss_ by more
        # than tol for more than n_iter_no_change consecutive epochs.
        self.best_loss_ = np.inf
        no_improvement = 0
        for _ in range(self.max_iter):
            self.partial_fit(X, y_arr, classes=classes)
            cur = self.loss_curve_[-1]
            if cur > self.best_loss_ - self.tol:
                no_improvement += 1
            else:
                no_improvement = 0
            if cur < self.best_loss_:
                self.best_loss_ = cur
            if no_improvement > self.n_iter_no_change:
                break
        return self

    # --- prediction -----------------------------------------------------------

    def _forward_probs(self, X: np.ndarray | torch.Tensor | list[Any]) -> np.ndarray:
        if not hasattr(self, "_params"):
            raise RuntimeError(
                "MLPClassifier is not fitted. Call partial_fit or fit"
                " before predict/predict_proba."
            )
        if isinstance(X, torch.Tensor):
            # A batch already on the device (the export gate uploads its
            # reference batch once for both forwards) is used as it is.
            x = X.to(self.device, torch.float32)
        else:
            x = np.ascontiguousarray(X, dtype=np.float32)
        if x.ndim != 2:
            raise ValueError(f"X must be 2D, got shape {tuple(x.shape)}")
        if x.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {x.shape[1]} features, expected {self.n_features_in_}"
            )
        x = torch.as_tensor(x, device=self.device)
        with torch.no_grad(), full_f32():
            probs = torch.softmax(
                mlp_logits(self._params["W"], self._params["b"], x), dim=1)
        return self._renormalize_probs(probs.cpu().numpy().astype(np.float64))

    @staticmethod
    def _renormalize_probs(probs_np: np.ndarray) -> np.ndarray:
        # Renormalize so each row sums to exactly 1.0 in float64; warn beyond
        # the expected float32 drift bound.
        row_sums = probs_np.sum(axis=1)
        max_drift = float(np.max(np.abs(row_sums - 1.0)))
        if max_drift > _EXPECTED_FP_DRIFT_TOL:
            warnings.warn(
                f"predict_proba row sums deviate from 1.0 by up to "
                f"{max_drift:.2e}, exceeding the expected float32 "
                f"softmax drift bound ({_EXPECTED_FP_DRIFT_TOL:.0e}). "
                f"Renormalizing anyway, but this likely indicates a "
                f"numerical issue (extreme logits, NaN/Inf, or a bypassed "
                f"softmax) rather than rounding.",
                RuntimeWarning,
                stacklevel=2,
            )
        probs_np /= row_sums[:, np.newaxis]
        return probs_np

    def predict_proba(self, X: np.ndarray | torch.Tensor | list[Any]) -> np.ndarray:
        return self._forward_probs(X)

    def predict(self, X: np.ndarray | torch.Tensor | list[Any]) -> np.ndarray:
        probs = self._forward_probs(X)
        return self.classes_[np.argmax(probs, axis=1)]

    # --- sklearn parameter protocol (lightweight) -------------------------

    def get_params(self, deep: bool = True) -> dict[str, Any]:
        return {
            "hidden_layer_sizes": self.hidden_layer_sizes,
            "activation": self.activation,
            "solver": self.solver,
            "alpha": self.alpha,
            "batch_size": self.batch_size,
            "learning_rate_init": self.learning_rate_init,
            "max_iter": self.max_iter,
            "shuffle": self.shuffle,
            "random_state": self.random_state,
            "tol": self.tol,
            "n_iter_no_change": self.n_iter_no_change,
            "beta_1": self.beta_1,
            "beta_2": self.beta_2,
            "epsilon": self.epsilon,
            "class_weight": self.class_weight,
            "init": self.init,
            "device": self.device,
        }

    def set_params(self, **params: Any) -> "MLPClassifier":
        for key, value in params.items():
            if not hasattr(self, key):
                raise ValueError(f"Invalid parameter {key!r} for MLPClassifier")
            setattr(self, key, value)
        return self

    # --- pickle and copy support -------------------------------------------

    def __getstate__(self) -> dict[str, Any]:
        # Parameters and the Adam state serialize as numpy, in the JAX
        # classifier's layout; the optimizer object is rebuilt on load.
        state = self.__dict__.copy()
        state.pop("_opt", None)
        params = state.pop("_params", None)
        if params is not None:
            state["_params_state"] = {
                key: [_host(t) for t in params[key]] for key in ("W", "b")
            }
            adam = self._adam_state()
            state["_opt_state_state"] = {
                "count": adam["count"],
                **{name: {key: [_host(t) for t in adam[name][key]]
                          for key in ("W", "b")} for name in ("mu", "nu")},
            }
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        params_state = state.pop("_params_state", None)
        opt_state_state = state.pop("_opt_state_state", None)
        self.__dict__.update(state)
        self.device = _resolve_device(self.device)
        if params_state is not None:
            self._set_state(params_state["W"], params_state["b"], opt_state_state)

    def __deepcopy__(self, memo: dict) -> "MLPClassifier":
        # Training updates the parameters and the Adam moments in place, so
        # a snapshot (the trainer's early-stopping copy) clones them on the
        # device; sharing them would let the snapshot track the live model.
        clone = self.__class__.__new__(self.__class__)
        memo[id(self)] = clone
        for k, v in self.__dict__.items():
            if k not in ("_params", "_opt"):
                clone.__dict__[k] = copy.deepcopy(v, memo)
        if hasattr(self, "_params"):
            clone._set_state(self._params["W"], self._params["b"], self._adam_state())
        return clone


def classifier_from_arrays(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    *,
    classes: Sequence[Any],
    adam: dict | None = None,
    device="cuda",
    **hyper: Any,
) -> MLPClassifier:
    """A fitted classifier from plain arrays: ``weights[i]`` (in, out) and
    ``biases[i]`` (out,) as another classifier's ``coefs_`` and
    ``intercepts_`` give them, and optionally its Adam state as optax
    stores it (``{"count": int, "mu": {"W": [...], "b": [...]}, "nu":
    {...}}``). The next ``partial_fit`` continues that run. ``hyper`` are
    the constructor's other arguments; the hidden sizes come from the
    weights."""
    weights = [np.asarray(w, np.float32) for w in weights]
    biases = [np.asarray(b, np.float32) for b in biases]
    clf = MLPClassifier(
        hidden_layer_sizes=tuple(w.shape[1] for w in weights[:-1]),
        device=device, **hyper,
    )
    clf.classes_ = np.unique(np.asarray(classes))
    if weights[-1].shape[1] != len(clf.classes_):
        raise ValueError(
            f"the last layer has {weights[-1].shape[1]} outputs for"
            f" {len(clf.classes_)} classes"
        )
    clf.n_features_in_ = int(weights[0].shape[0])
    clf.n_iter_ = 0
    clf.loss_curve_ = []
    clf._class_weight_vector = clf._build_class_weight_vector()
    clf._set_state(weights, biases, adam)
    return clf
