"""PyTorch port of ``mermaid_classifier_tpu/train/mlp_classifier.py``: the
sklearn-semantics MLP classifier head, streamed and device-resident.

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
  - In-loss L2 on weights only, ``0.5 * alpha / n_real * sum(W^2)`` with
    ``n_real`` the mini-batch's real row count.
  - Optional per-class CE weights: ``sum(w[y_i] * ce_i) / sum(w[y_i])``.
  - ``loss_curve_`` is the regularised loss averaged over the partial_fit
    input, weighted by mini-batch size.
  - Adam in optax's formula (``adam(eps_root=0)``: ``m_hat / (sqrt(v_hat) +
    eps)``) with the step count on the device, and ReLU only; float32
    forward with a float64 row-renormalised ``predict_proba`` and a 1e-4
    drift warning.

One fixed-shape step for both paths, as the JAX code runs one ``lax.scan``
program per call: a call pads its shuffled rows to ``n_batches x B`` (B =
``min(batch_size, n)``), the padding rows pointing at row 0 and class 0 with
weight 0, and uploads the batches' row indices, labels and real row counts
once. Each step gathers its B rows on the device — from the call's uploaded
chunk (``partial_fit``) or from the resident buffer (``partial_fit_resident``,
upcast and, for int8, dequantized after the gather) — derives the weight-0
mask from the real count, and updates the parameters and Adam moments in
place. So on one device the two paths are bitwise equal. The losses stay on
the device and are read back once per call.

On a CUDA device the step is captured once as a ``torch.cuda.CUDAGraph`` per
(source buffer, B, hyperparameters, parameter tensors) and replayed
``n_batches`` times; a device step counter picks each replay's batch and loss
slot. A capture that fails raises; it never runs the eager loop instead. On
the CPU the same step runs eagerly. Every matmul, forward and backward, runs
in full float32 (TF32 off), as the JAX head trains at ``Precision.HIGHEST``.

Device-resident training (``set_resident_features`` and the ``*_resident``
entry points): the feature matrix goes to the device once, in float32,
bfloat16 or int8 storage (per-row ``absmax / 127`` scales, the JAX formula
bit for bit), in about 256 MB slabs through pinned staging; each epoch then
moves only row indices.

Left out here: the JAX ``mesh`` option and the TPU's ahead-of-time program
warming (``warm_resident_programs``): the first call captures the graph.
"""

from __future__ import annotations

import copy
import math
import time
import warnings
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from mermaid_classifier_tpu_torch.inference.head import head_apply, mlp_logits
from mermaid_classifier_tpu_torch.models.extractor import _resolve_device
from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32

# Upper bound on the row-sum drift expected from a softmax computed in
# float32 then cast to float64.
_EXPECTED_FP_DRIFT_TOL = 1e-4

#: sklearn's log_loss clip bound, np.finfo(np.float64).eps; the fused
#: resident eval applies it on the device, in float32 arithmetic.
_SKLEARN_LOG_LOSS_EPS = 2.220446049250313e-16

_STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "int8": torch.int8}


def _xavier_uniform(generator: torch.Generator, fan_in: int, fan_out: int) -> torch.Tensor:
    # Glorot uniform: sklearn MLP's init for non-logistic activations
    # (factor 6 in sklearn's _init_coef) and torch's xavier_uniform_.
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty((fan_in, fan_out), dtype=torch.float32)
    return w.uniform_(-limit, limit, generator=generator)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place training cannot change."""
    return t.detach().to("cpu", copy=True).numpy()


class _StepRunner:
    """The fixed-shape Adam step's static buffers for one (source, B,
    hyperparameters) and, on a CUDA device, the captured graph of the step.

    ``batches`` holds one row per step, ``[B row indices | B class indices |
    n_real]`` (int64); ``counter`` is the device step index that picks the
    replay's row and its ``losses`` slot. The runner keeps the source buffer,
    its scale and the class weights alive as long as the graph may read
    them."""

    def __init__(self, device, src, scale, class_w, batch: int, capacity: int):
        self.src, self.scale, self.class_w = src, scale, class_w
        self.batch, self.capacity = batch, capacity
        self.batches = torch.zeros((capacity, 2 * batch + 1), dtype=torch.int64,
                                   device=device)
        self.losses = torch.zeros(capacity, dtype=torch.float32, device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.graph = None

    def step(self, clf: "MLPClassifier") -> None:
        clf._adam_step(self.src, self.scale, self.class_w, self.batches,
                       self.losses, self.counter, self.batch)

    def capture(self, clf: "MLPClassifier") -> None:
        """Warm the step up on a side stream (PyTorch's whole-network capture
        asks for it), put the state back as it was, then capture one step.
        Capture records the step's kernels without running them."""
        device = clf.device
        state = clf._state_tensors()
        saved = [t.detach().clone() for t in state]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                # Row 0 each time: the buffers may hold a single step.
                self.counter.zero_()
                self.step(clf)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        del saved
        self.counter.zero_()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.step(clf)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of the Adam step failed (B {self.batch});"
                f" the eager step is not run in its place"
            ) from exc
        self.graph = graph

    def run(self, clf: "MLPClassifier", packed: np.ndarray) -> np.ndarray:
        """Run one step per row of ``packed`` and return the step losses
        (one readback)."""
        n_steps = packed.shape[0]
        self.batches[:n_steps].copy_(torch.from_numpy(packed))
        captured = clf.device.type == "cuda" and clf.capture_step
        with full_f32():
            if captured and self.graph is None:
                self.capture(clf)
            self.counter.zero_()
            for _ in range(n_steps):
                if captured:
                    self.graph.replay()
                else:
                    self.step(clf)
        return self.losses[:n_steps].cpu().numpy()


class MLPClassifier:
    """sklearn-MLPClassifier-compatible PyTorch classifier head.

    See the module docstring for the supported API subset and pinned
    semantics.
    """

    _estimator_type = "classifier"

    #: storage dtypes of the resident buffer. bfloat16 halves the upload and
    #: the buffer's device memory, int8 quarters them (symmetric per-row
    #: quantization with an f32 scale vector, dequantized right after the
    #: on-device gather). Compute stays f32: only the one-time storage
    #: rounding of the features differs from the f32 path, behind the
    #: repo's 0.999-cosine gate.
    RESIDENT_DTYPES = ("float32", "bfloat16", "int8")

    #: On a CUDA device, capture the step as a CUDA graph (True) or run it
    #: eagerly (False: the card check of the captured step against eager).
    capture_step = True

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
        and the Adam state in optax's layout: ``adam`` is ``{"count": int,
        "mu": {"W": [...], "b": [...]}, "nu": {...}}`` as arrays or tensors,
        or None for a run that has taken no step. New tensors, so every
        captured step (which holds the old ones' addresses) is dropped."""

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
        if adam is None:
            adam = {"count": 0, **{name: {key: [torch.zeros_like(p.detach())
                                                for p in self._params[key]]
                                          for key in ("W", "b")}
                                   for name in ("mu", "nu")}}
        self._adam = {
            "count": torch.tensor(int(adam["count"]), dtype=torch.int64,
                                  device=self.device),
            **{name: {key: [dev(m) for m in adam[name][key]] for key in ("W", "b")}
               for name in ("mu", "nu")},
        }
        self._runners: dict = {}
        self._class_w_dev = None

    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor one step updates in place."""
        adam = self._adam
        return [*self._params["W"], *self._params["b"],
                *adam["mu"]["W"], *adam["mu"]["b"],
                *adam["nu"]["W"], *adam["nu"]["b"], adam["count"]]

    def _adam_state(self) -> dict:
        """The Adam state as optax lays it out: count (an int, read from the
        device), mu and nu (device tensors)."""
        return {"count": int(self._adam["count"]), "mu": self._adam["mu"],
                "nu": self._adam["nu"]}

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

    def _class_weights_on_device(self) -> torch.Tensor:
        """(K,) f32 per-class weights on the device, ones when unweighted
        (multiplying by exactly 1.0 is exact)."""
        if getattr(self, "_class_w_dev", None) is None:
            vec = getattr(self, "_class_weight_vector", None)
            if vec is None:
                vec = np.ones(len(self.classes_), dtype=np.float32)
            self._class_w_dev = torch.from_numpy(np.asarray(vec, np.float32)).to(self.device)
        return self._class_w_dev

    # --- the step ---------------------------------------------------------------

    def _adam_step(self, src, scale, class_w, batches, losses, counter, batch: int):
        """One Adam step on row ``counter`` of ``batches``: gather, forward,
        the weighted CE plus L2 on the real row count, gradients, optax's
        Adam update in place, the loss into ``losses[counter]``. No host
        sync: the same code runs eagerly and under CUDA graph capture."""
        weights, biases = self._params["W"], self._params["b"]
        row = batches.index_select(0, counter)[0]
        idx, yb, n_real = row[:batch], row[batch:2 * batch], row[2 * batch]
        x = src.index_select(0, idx).to(torch.float32)
        if scale is not None:
            x = x * scale.index_select(0, idx)[:, None]
        # Rows past the real count are the padding: weight 0.
        mask = torch.arange(batch, device=x.device) < n_real
        wb = class_w.index_select(0, yb) * mask
        n_real_f = n_real.to(torch.float32)
        logits = mlp_logits(weights, biases, x)
        ce = -F.log_softmax(logits, dim=1).gather(1, yb[:, None])[:, 0]
        sq = sum((w * w).sum() for w in weights)
        l2 = torch.full_like(n_real_f, 0.5 * self.alpha) / n_real_f
        loss = (wb * ce).sum() / wb.sum() + l2 * sq
        params = [*weights, *biases]
        grads = torch.autograd.grad(loss, params)
        b1, b2 = float(self.beta_1), float(self.beta_2)
        adam = self._adam
        mu = [*adam["mu"]["W"], *adam["mu"]["b"]]
        nu = [*adam["nu"]["W"], *adam["nu"]["b"]]
        with torch.no_grad():
            # optax.adam(eps_root=0): moments, bias correction by the
            # device step count, m_hat / (sqrt(v_hat) + eps), times -lr.
            adam["count"].add_(1)
            t = adam["count"].to(torch.float32)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
            nu_hat = torch._foreach_div(nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, float(self.epsilon))
            torch._foreach_div_(mu_hat, nu_hat)
            torch._foreach_add_(params, mu_hat, alpha=-float(self.learning_rate_init))
            losses.index_copy_(0, counter, loss.detach().view(1))
            counter.add_(1)

    def _run_steps(self, kind: str, src, scale, idx_shuf: np.ndarray,
                   y_shuf: np.ndarray, batch: int) -> tuple[np.ndarray, np.ndarray]:
        """Pad to ``n_batches x batch`` rows (padding rows point at row 0,
        class 0), run one step per mini-batch on the runner of this source
        and geometry, and return the step losses and real row counts."""
        n_samples = len(idx_shuf)
        n_batches = -(-n_samples // batch)
        pad = n_batches * batch - n_samples
        packed = np.zeros((n_batches, 2 * batch + 1), dtype=np.int64)
        for col, values in ((0, idx_shuf), (batch, y_shuf)):
            padded = np.zeros(n_batches * batch, dtype=np.int64)
            padded[:n_samples] = values
            packed[:, col:col + batch] = padded.reshape(n_batches, batch)
        packed[:, 2 * batch] = batch
        packed[-1, 2 * batch] = batch - pad
        key = (kind, batch, float(self.learning_rate_init), float(self.beta_1),
               float(self.beta_2), float(self.epsilon), float(self.alpha))
        runner = self._runners.get(key)
        if (runner is None or runner.src is not src or runner.scale is not scale
                or runner.capacity < n_batches):
            runner = _StepRunner(self.device, src, scale,
                                 self._class_weights_on_device(), batch,
                                 1 << max(n_batches - 1, 0).bit_length())
            self._runners[key] = runner
        losses = runner.run(self, packed).astype(np.float64)
        return losses, packed[:, 2 * batch].astype(np.float64)

    def _drop_runners(self, kind: str) -> None:
        for key in [k for k in getattr(self, "_runners", {}) if k[0] == kind]:
            del self._runners[key]

    def _stage_rows(self, X_arr: np.ndarray) -> torch.Tensor:
        """The streamed call's rows on the device, in a staging buffer that
        keeps its address while it is large enough (the captured step reads
        it); it grows by a quarter when a call outgrows it."""
        n, dim = X_arr.shape
        buf = getattr(self, "_stream_X", None)
        if buf is None or buf.shape[0] < n or buf.shape[1] != dim:
            self._drop_runners("stream")
            self._stream_X = buf = None
            rows = -(-(n + n // 4) // 1024) * 1024
            buf = torch.empty((rows, dim), dtype=torch.float32, device=self.device)
            self._stream_X = buf
        buf[:n].copy_(torch.from_numpy(X_arr))
        return buf

    def _first_fit(self, n_features: int, y, classes) -> None:
        if classes is None:
            self.classes_ = np.unique(np.asarray(y))
        else:
            self.classes_ = np.unique(np.asarray(classes))
        self.n_features_in_ = int(n_features)
        self.n_iter_ = 0
        self.loss_curve_: list[float] = []
        self._init_params()
        self._class_weight_vector = self._build_class_weight_vector()

    def _record_loss(self, losses: np.ndarray, ns: np.ndarray, n_samples: int) -> None:
        # loss_curve_ records the regularised loss averaged across the whole
        # partial_fit input, weighted by real mini-batch size.
        self.loss_curve_.append(float(np.sum(losses * ns) / max(n_samples, 1)))
        self.n_iter_ += 1

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

        if not hasattr(self, "_params"):
            self._first_fit(X_arr.shape[1], y, classes)
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

        src = self._stage_rows(X_arr)
        losses, ns = self._run_steps("stream", src, None, order,
                                     y_indices[order], batch_size)
        self._record_loss(losses, ns, n_samples)
        return self

    def fit(
        self,
        X: np.ndarray | list[Any],
        y: np.ndarray | list[Any],
    ) -> "MLPClassifier":
        y_arr = np.asarray(y)
        classes: list[Any] = np.unique(y_arr).tolist()
        # Reset so fit() starts fresh even on a previously-trained instance.
        for attr in ("_params", "_adam", "_runners", "classes_", "n_features_in_",
                     "n_iter_", "loss_curve_", "best_loss_"):
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

    # --- device-resident training --------------------------------------------

    @staticmethod
    def _int8_row_scales(X: np.ndarray, slab_rows: int = 65536) -> np.ndarray:
        """Per-row symmetric quantization scales: ``absmax / 127``, computed
        slab by slab with max/min reductions (no full-size |X| temporary)."""
        n = X.shape[0]
        scale = np.empty(n, dtype=np.float32)
        for s in range(0, n, slab_rows):
            rows = X[s: s + slab_rows]
            absmax = np.maximum(rows.max(axis=1), -rows.min(axis=1))
            scale[s: s + slab_rows] = absmax / 127.0
        # Effectively-zero rows take scale 1.0 (they quantize to zeros). The
        # floor catches subnormal scales too: the quantizer multiplies by
        # 1/scale, and the reciprocal of a subnormal f32 overflows to inf.
        scale[scale < np.finfo(np.float32).tiny] = 1.0
        return scale

    @staticmethod
    def _quantize_rows_int8(
        rows: np.ndarray,
        inv_scale: np.ndarray,
        tmp: np.ndarray,
        out: np.ndarray,
    ) -> np.ndarray:
        """round(rows / scale) clipped to [-127, 127], written through the
        preallocated ``tmp`` (f32) and ``out`` (int8) buffers."""
        k = rows.shape[0]
        t = tmp[:k]
        np.multiply(rows, inv_scale[:, None], out=t)
        np.rint(t, out=t)
        np.clip(t, -127.0, 127.0, out=t)
        q = out[:k]
        q[...] = t  # f32 -> int8 cast into the preallocated buffer
        return q

    @staticmethod
    def _quantize_matrix_int8(
        X: np.ndarray,
        inv_scale: np.ndarray,
        timings: dict[str, float] | None = None,
        slab_rows: int = 65536,
    ) -> np.ndarray:
        """Full-matrix int8 quantization through bounded scratch slabs,
        adding the CPU time to ``timings["quantize_seconds"]``."""
        t_q = time.perf_counter()
        out = np.empty(X.shape, np.int8)
        k = max(1, min(slab_rows, X.shape[0]))
        tmp = np.empty((k, X.shape[1]), np.float32)
        for s in range(0, X.shape[0], k):
            MLPClassifier._quantize_rows_int8(
                X[s: s + k], inv_scale[s: s + k], tmp, out[s: s + k]
            )
        if timings is not None:
            timings["quantize_seconds"] = timings.get(
                "quantize_seconds", 0.0
            ) + (time.perf_counter() - t_q)
        return out

    def _drop_resident(self) -> None:
        self._drop_runners("resident")
        self._resident_X = None
        self._resident_scale = None

    def set_resident_features(
        self, X: np.ndarray, dtype: str = "float32", wait_rows=None
    ) -> "MLPClassifier":
        """Put the whole feature matrix on the device once, stored as
        ``dtype`` (see RESIDENT_DTYPES). Later ``partial_fit_resident`` and
        resident eval calls address its rows by index, so an epoch moves
        O(rows) indices instead of O(rows x dim) floats. ``wait_rows(n)``
        blocks until rows [0, n) of ``X`` are final: the upload streams
        slabs behind a concurrent fill."""
        if dtype not in self.RESIDENT_DTYPES:
            raise ValueError(
                f"resident dtype must be one of {self.RESIDENT_DTYPES},"
                f" got {dtype!r}"
            )
        if wait_rows is not None and not (
            isinstance(X, np.ndarray) and X.dtype == np.float32
        ):
            # np.asarray below would copy a non-f32 input, snapshotting a
            # buffer the fill is still writing: wait for all of it first.
            wait_rows(int(np.shape(X)[0]))
            wait_rows = None
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2D, got shape {X.shape}")
        self._drop_resident()
        self._resident_n_rows = int(X.shape[0])
        self._resident_dtype = dtype
        # The host-side quantization is timed apart from the transfer.
        timings: dict[str, float] = {"quantize_seconds": 0.0}
        scale = None
        if dtype == "int8":
            # The row scales scan the whole matrix before the first slab.
            if wait_rows is not None:
                wait_rows(X.shape[0])
                wait_rows = None
            t_q = time.perf_counter()
            scale = self._int8_row_scales(X)
            timings["quantize_seconds"] += time.perf_counter() - t_q
        self._resident_X = self._upload_rows(
            X, _STORAGE_DTYPES[dtype], row_scale=scale, timings=timings,
            wait_rows=wait_rows,
        )
        self._resident_scale = (
            None if scale is None else torch.from_numpy(scale).to(self.device))
        self._resident_upload_timings = timings
        return self

    def set_resident_features_storage(
        self,
        stored: np.ndarray | torch.Tensor,
        scale: np.ndarray | None = None,
        wait_rows=None,
    ) -> "MLPClassifier":
        """Put a feature matrix that is already in its storage dtype on the
        device: int8 rows (a numpy array or a CPU tensor) with their per-row
        f32 ``scale`` vector, quantized by the caller with the
        RESIDENT_DTYPES formula, or bf16 rows in a CPU ``torch.bfloat16``
        tensor. The same buffer as ``set_resident_features`` on the f32
        rows, without a full-size f32 staging copy.

        ``wait_rows(n)`` lets the upload run behind the fill that is still
        writing ``stored``; ``scale`` is read only after the last slab has
        waited for every row, so the fill may write it in the same pass."""
        if wait_rows is not None and not (
            isinstance(stored, (np.ndarray, torch.Tensor))
            and (scale is None or (isinstance(scale, np.ndarray)
                                   and scale.dtype == np.float32))
        ):
            # A conversion below would copy a buffer the fill is still
            # writing: wait for all of it first.
            wait_rows(int(np.shape(stored)[0]))
            wait_rows = None
        if isinstance(stored, np.ndarray):
            if stored.dtype != np.int8:
                raise ValueError(
                    f"storage dtype must be int8 or bfloat16, got {stored.dtype}"
                )
            stored = torch.from_numpy(stored)
        if stored.ndim != 2:
            raise ValueError(f"stored must be 2D, got shape {tuple(stored.shape)}")
        if stored.dtype == torch.int8:
            dtype = "int8"
            if scale is None or len(scale) != stored.shape[0]:
                raise ValueError(
                    "int8 storage needs a per-row scale vector of"
                    f" {stored.shape[0]} rows."
                )
        elif stored.dtype == torch.bfloat16:
            dtype = "bfloat16"
            if scale is not None:
                raise ValueError("scale is only valid with int8 storage")
        else:
            raise ValueError(
                f"storage dtype must be int8 or bfloat16, got {stored.dtype}"
            )
        self._drop_resident()
        self._resident_n_rows = int(stored.shape[0])
        self._resident_dtype = dtype
        self._resident_upload_timings = {"quantize_seconds": 0.0}
        self._resident_X = self._upload_rows(stored, stored.dtype,
                                             wait_rows=wait_rows)
        # Reached after the last slab's wait_rows(n_rows): the scale vector
        # is final.
        self._resident_scale = (
            None if scale is None else
            torch.from_numpy(np.asarray(scale, np.float32)).to(self.device))
        return self

    def _upload_rows(
        self,
        X: np.ndarray | torch.Tensor,
        dtype: torch.dtype,
        row_scale: np.ndarray | None = None,
        timings: dict[str, float] | None = None,
        wait_rows=None,
        chunk_bytes: int = 1 << 28,
    ) -> torch.Tensor:
        """``X`` into one preallocated device buffer of ``dtype`` in about
        ``chunk_bytes`` slabs. Each slab waits on ``wait_rows`` for its rows,
        is cast (f32 -> bf16, round to nearest even) or quantized
        (``row_scale``: int8, the RESIDENT_DTYPES formula) into pinned
        staging, and is copied up without blocking the host; two staging
        slabs alternate, so the next slab's host work overlaps the copy.
        On the CPU the slabs are written into the buffer directly."""
        n, dim = X.shape
        buf = torch.empty((n, dim), dtype=dtype, device=self.device)
        if n == 0:
            return buf
        row_bytes = dim * torch.empty((), dtype=dtype).element_size()
        rows_per_slab = max(1, min(n, chunk_bytes // max(row_bytes, 1)))
        pinned = self.device.type == "cuda"
        staging = [torch.empty((rows_per_slab, dim), dtype=dtype, pin_memory=True)
                   for _ in range(2)] if pinned else []
        copied = [None, None]
        inv_scale = q_tmp = None
        if row_scale is not None:
            inv_scale = (1.0 / np.asarray(row_scale, np.float32)).astype(np.float32)
            q_tmp = np.empty((rows_per_slab, dim), np.float32)
        for k, start in enumerate(range(0, n, rows_per_slab)):
            end = min(start + rows_per_slab, n)
            if wait_rows is not None:
                wait_rows(end)
            if pinned:
                slot = k % 2
                if copied[slot] is not None:
                    copied[slot].synchronize()
                dest = staging[slot][:end - start]
            else:
                dest = buf[start:end]
            if inv_scale is not None:
                t_q = time.perf_counter()
                self._quantize_rows_int8(X[start:end], inv_scale[start:end],
                                         q_tmp, dest.numpy())
                if timings is not None:
                    timings["quantize_seconds"] = timings.get(
                        "quantize_seconds", 0.0) + (time.perf_counter() - t_q)
            elif isinstance(X, torch.Tensor):
                dest.copy_(X[start:end])
            else:
                dest.copy_(torch.from_numpy(X[start:end]))
            if pinned:
                buf[start:end].copy_(dest, non_blocking=True)
                copied[slot] = torch.cuda.Event()
                copied[slot].record()
        if pinned:
            torch.cuda.current_stream(self.device).synchronize()
        return buf

    def partial_fit_resident(
        self,
        indices: np.ndarray,
        y: np.ndarray | list[Any],
        classes: Sequence[Any] | None = None,
    ) -> "MLPClassifier":
        """``partial_fit(X_resident[indices], y, classes)`` without the rows
        visiting the host: the same shuffle, padding, mini-batches and step,
        bitwise equal to ``partial_fit`` on the gathered rows."""
        if getattr(self, "_resident_X", None) is None:
            raise ValueError("call set_resident_features(X) first.")
        indices = np.asarray(indices, dtype=np.int32)
        if indices.ndim != 1:
            raise ValueError(f"indices must be 1-D, got {indices.shape}")
        n_resident = int(
            getattr(self, "_resident_n_rows", self._resident_X.shape[0])
        )
        if indices.size and (
            indices.min() < 0 or indices.max() >= n_resident
        ):
            raise ValueError(
                f"indices out of range for the {n_resident}-row resident set."
            )

        if not hasattr(self, "_params"):
            self._first_fit(self._resident_X.shape[1], y, classes)

        y_indices = self._labels_to_indices(np.asarray(y))
        if len(y_indices) != len(indices):
            raise ValueError(
                f"{len(indices)} indices but {len(y_indices)} labels."
            )
        n_samples = len(indices)
        batch_size = self._resolve_batch_size(n_samples)

        # The same shuffle stream as partial_fit: the permutation depends
        # only on (random_state, n_samples).
        rng = self._seed_rng()
        order = np.arange(n_samples)
        if self.shuffle:
            rng.shuffle(order)
        losses, ns = self._run_steps("resident", self._resident_X,
                                     self._resident_scale, indices[order],
                                     y_indices[order], batch_size)
        self._record_loss(losses, ns, n_samples)
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
        max_drift = float(np.max(np.abs(row_sums - 1.0))) if row_sums.size else 0.0
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

    def _check_resident_indices(
        self, indices: np.ndarray, require_fitted: bool
    ) -> torch.Tensor:
        """Preconditions of every resident forward: fitted when asked, a
        buffer, 1-D indices inside it. The indices as a device tensor."""
        if require_fitted and not hasattr(self, "_params"):
            raise RuntimeError(
                "MLPClassifier is not fitted. Call partial_fit or fit"
                " before predict/predict_proba."
            )
        if getattr(self, "_resident_X", None) is None:
            raise ValueError("call set_resident_features(X) first.")
        idx = np.asarray(indices, dtype=np.int64)
        if idx.ndim != 1:
            raise ValueError(f"indices must be 1-D, got {idx.shape}")
        n_rows = int(self._resident_X.shape[0])
        if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
            raise ValueError(
                f"indices out of range for the {n_rows}-row resident set."
            )
        return torch.from_numpy(idx).to(self.device)

    def _resident_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Gathered resident rows, upcast to f32 and dequantized."""
        x = self._resident_X.index_select(0, idx).to(torch.float32)
        if self._resident_scale is not None:
            x = x * self._resident_scale.index_select(0, idx)[:, None]
        return x

    def _resident_probs(self, indices: np.ndarray) -> torch.Tensor:
        idx = self._check_resident_indices(indices, require_fitted=True)
        with torch.no_grad(), full_f32():
            return torch.softmax(mlp_logits(self._params["W"], self._params["b"],
                                            self._resident_rows(idx)), dim=1)

    def predict_proba_resident(self, indices: np.ndarray) -> np.ndarray:
        """predict_proba over rows of the resident buffer: only the (N, K)
        probabilities cross back to the host. Same float64 renormalization
        and drift warning as predict_proba."""
        probs = self._resident_probs(indices)
        return self._renormalize_probs(probs.cpu().numpy().astype(np.float64))

    def predict_resident(self, indices: np.ndarray) -> np.ndarray:
        probs = self.predict_proba_resident(indices)
        return self.classes_[np.argmax(probs, axis=1)]

    def predict_indices_resident(self, indices: np.ndarray) -> np.ndarray:
        """Class-index predictions over resident rows, argmax taken on the
        device: only (N,) int32 cross back. Equal to
        ``predict_proba_resident(indices).argmax(axis=1)``: the float64
        renormalization divides a row by one positive number, which keeps
        its order and its ties."""
        probs = self._resident_probs(indices)
        return torch.argmax(probs, dim=1).to(torch.int32).cpu().numpy()

    def eval_counts_resident(
        self, indices: np.ndarray, y_indices: np.ndarray
    ) -> np.ndarray:
        """Accuracy and uncalibrated log loss over resident rows in one pass
        on the device: (2,) float32 ``[correct_count, neg_log_sum]``.
        ``y_indices`` are positions in ``classes_``, -1 for a label outside
        it (counted wrong, adding no loss, as sklearn's all-zero one-hot row
        does). The count is exact; the loss sum is sklearn 1.9's formula
        (true-class probability over the f32 row sum, clipped at float64
        eps, no renormalization) reduced in float32."""
        y_idx = np.asarray(y_indices, dtype=np.int64)
        if y_idx.shape != np.shape(indices):
            raise ValueError(
                f"y_indices shape {y_idx.shape} != indices shape"
                f" {np.shape(indices)}"
            )
        probs = self._resident_probs(indices)
        with torch.no_grad():
            y = torch.from_numpy(y_idx).to(self.device)
            correct = (torch.argmax(probs, dim=1) == y).to(torch.float32).sum()
            valid = y >= 0
            safe = torch.where(valid, y, torch.zeros_like(y))
            t = probs.gather(1, safe[:, None])[:, 0] / probs.sum(dim=1)
            t = t.clamp(_SKLEARN_LOG_LOSS_EPS, 1.0 - _SKLEARN_LOG_LOSS_EPS)
            neg_log = torch.where(valid, -torch.log(t), torch.zeros_like(t))
            return torch.stack([correct, neg_log.sum()]).cpu().numpy()

    def predict_proba_resident_head(
        self, head: dict, indices: np.ndarray
    ) -> np.ndarray:
        """An exported artifact's calibrated head (``HeadParams.as_tensors``:
        weights, biases and the calibration) over rows of the resident
        buffer, through the serving ``head_apply``. Float64, as
        ``Predictor.predict_proba`` returns. Needs no fitted state: the
        params are the model."""
        idx = self._check_resident_indices(indices, require_fitted=False)

        def dev(v):
            return torch.as_tensor(v, dtype=torch.float32, device=self.device)

        params = {k: [dev(t) for t in v] if isinstance(v, (list, tuple)) else dev(v)
                  for k, v in head.items()}
        with torch.no_grad(), full_f32():
            probs = head_apply(params, self._resident_rows(idx))
        return probs.cpu().numpy().astype(np.float64)

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

    #: Per-instance device scratch: captured steps, the streamed call's
    #: staging buffer, the class weights' device copy. Never pickled or
    #: copied; rebuilt on use.
    _SCRATCH = ("_runners", "_stream_X", "_class_w_dev")

    def __getstate__(self) -> dict[str, Any]:
        # Parameters and the Adam state serialize as numpy, in the JAX
        # classifier's layout. The resident buffer is training data, not
        # model state: never serialized (set_resident_features again after
        # unpickling to resume a resident run).
        state = self.__dict__.copy()
        for key in (*self._SCRATCH, "_adam", "_resident_X", "_resident_scale"):
            state.pop(key, None)
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
        # device; the resident buffer and its scale are shared, since a copy
        # would double gigabytes of device memory. No captured step is
        # carried: the copy captures its own on first use.
        clone = self.__class__.__new__(self.__class__)
        memo[id(self)] = clone
        for k, v in self.__dict__.items():
            if k in ("_resident_X", "_resident_scale"):
                clone.__dict__[k] = v
            elif k not in ("_params", "_adam", *self._SCRATCH):
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
