"""Head training: resident epochs of the MERMAID head through the port's
``MLPClassifier.partial_fit_resident`` over int8 resident storage.

Set-up draws the training split from the seed: ``rows`` int8 rows of the
head's input width with per-row scales (as ``MermaidTrainer`` stages
them), labels over the classes with a Zipf skew, and the effective-number
class weights the recipe trains with. It draws the head's initial
Glorot-uniform weights, builds one classifier from them and uploads the
rows. It then drives that classifier through the window's own call: one
call of ``call_rows`` rows, which captures the window's step, then
``check_steps`` calls of one mini-batch each, which replay the same captured
step from the same runner. All take the first rows of the first epoch's
permutation, so they all differ. The window goes on from there with the
same classifier: epochs, each over a fresh permutation of the rows in calls
of ``call_rows``, until ``--seconds`` have passed; it spans whole calls.

The check, once the window has closed and the program is released, runs
the plain reference twice, with the mini-batches the head's semantics give
each call:

- from the same initial weights over the first call: its loss as the
  program reports it (``loss_curve_``, its steps' losses averaged by rows)
  and every leaf's change over it. Every step of the window's call is
  here: the step counter, each step's batch and loss slot, and the bias
  correction up to the call's last step;
- from the program's own state after that call (parameters and Adam's
  moments and count) over the one-step calls: each step's loss, the first
  step's gradient of every leaf as the optimizer got it (worked out from
  its first moment before and after the step), and every leaf's change
  over the steps. Over a whole call Adam's normalised step carries
  round-off into every leaf, so that TF32 and float32 read alike there
  (``PERF.md``); over a few steps from one state they do not.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, costs, weights
from benchmark.reference import mlp
from benchmark.spans import Spans
from mermaid_classifier_tpu_torch.train.mlp_classifier import classifier_from_arrays

SPAN_NAMES = ("call",)


def class_weights(y: np.ndarray, n_classes: int, beta: float, cap: float) -> np.ndarray:
    """Effective-number weights (1 - beta) / (1 - beta^n_c), normalised to
    mean 1 over the classes, the largest at most ``cap`` times the
    smallest."""
    counts = np.bincount(y, minlength=n_classes).astype(np.float64)
    w = (1.0 - beta) / (1.0 - np.power(beta, np.maximum(counts, 1.0)))
    w = np.minimum(w, w.min() * cap)
    return (w * n_classes / w.sum()).astype(np.float32)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.spans = Spans(enabled=trace)
        self.record: dict = {}

    def setup(self) -> None:
        head, tr = self.config["head"], self.traffic
        layers = head["layers"]
        n, k = int(tr["rows"]), layers[-1]
        q, scale = weights.int8_rows(n, layers[0], self.seed, self.device)
        rng = np.random.default_rng([self.seed, 0x7A1])
        p = 1.0 / np.arange(1, k + 1) ** float(tr["label_zipf"])
        self.y = rng.choice(k, size=n, p=p / p.sum()).astype(np.int64)
        self.class_w = class_weights(self.y, k, float(tr["class_weight_beta"]),
                                     float(tr["class_weight_cap"]))
        self.w0, self.b0 = weights.xavier_head(layers, self.seed, self.device)
        self.clf = classifier_from_arrays(
            self.w0, self.b0, classes=np.arange(k), device=self.device,
            learning_rate_init=head["learning_rate"], alpha=head["alpha"],
            beta_1=head["beta_1"], beta_2=head["beta_2"], epsilon=head["epsilon"],
            batch_size=head["batch_size"], random_state=head["random_state"],
            class_weight={c: float(w) for c, w in enumerate(self.class_w)})
        self.clf.set_resident_features_storage(q, scale)
        # The window's first call, then the one-step calls; the reference
        # follows both.
        self.call_rows = int(tr["call_rows"])
        self.epoch = 0
        self._order = np.empty(0, np.int64)
        idx = self._call()
        self.call_loss = self.clf.loss_curve_[-1]
        self.checked_call = [(q[torch.from_numpy(idx)], scale[idx], self.y[idx])]
        self.after_call = self._state()
        self.step_losses, self.checked_steps = [], []
        for i in range(int(tr["check_steps"])):
            idx = self._call(int(head["batch_size"]))
            self.step_losses.append(self.clf.loss_curve_[-1])
            self.checked_steps.append((q[torch.from_numpy(idx)], scale[idx], self.y[idx]))
            if i == 0:
                b1 = float(head["beta_1"])
                self.grads = [(m1.astype(np.float64) - b1 * m0.astype(np.float64)) / (1.0 - b1)
                              for m1, m0 in
                              zip(self._state()["mu"], self.after_call["mu"])]
        self.params = self._state()["params"]
        del q
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state(self) -> dict:
        """The classifier's parameters and Adam state, on the host, leaves
        in one order (weights, then biases)."""
        state = self.clf.__getstate__()
        adam = state["_opt_state_state"]
        return {"params": [*state["_params_state"]["W"], *state["_params_state"]["b"]],
                "mu": [*adam["mu"]["W"], *adam["mu"]["b"]],
                "nu": [*adam["nu"]["W"], *adam["nu"]["b"]], "count": int(adam["count"])}

    def _next_rows(self, rows: int) -> np.ndarray:
        if len(self._order) == 0:
            self._order = np.random.default_rng([self.seed, self.epoch]).permutation(
                len(self.y))
            self.epoch += 1
        idx, self._order = self._order[:rows], self._order[rows:]
        return idx

    def _call(self, rows: int | None = None) -> np.ndarray:
        """One call on the next ``rows`` rows (the window's ``call_rows``
        by default); returns them."""
        idx = self._next_rows(rows or self.call_rows)
        with self.spans.span("call"):
            self.clf.partial_fit_resident(idx, self.y[idx])
        return idx

    def window(self, seconds: float) -> dict:
        samples = calls = 0
        t0 = time.perf_counter()
        while True:
            samples += len(self._call())
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        head = self.config["head"]
        self.record.update(
            window_s=elapsed, samples=samples,
            flops_per_sample=costs.train_flops_per_sample(head["layers"]),
            peak_flops=costs.PEAK_FLOPS[head["precision"]])
        return {"metrics": {"train_samples_per_s": samples / elapsed},
                "attempted": calls, "failed": 0}

    def stretch(self) -> None:
        """``trace_calls`` more calls under the profiler."""
        steps = 0
        for _ in range(int(self.traffic["trace_calls"])):
            steps += -(-len(self._call()) // int(self.config["head"]["batch_size"]))
        self.record["stretch_steps"] = steps

    def stretch_work(self) -> dict:
        return {}

    def release(self) -> None:
        self.clf = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference(self, **control) -> tuple[dict, dict]:
        """The reference's run of the first call from the initial weights,
        and of the one-step calls from the program's state after it
        (``control``: ``mlp.adam_calls``'s ``tf32`` or ``fault``)."""
        head, after = self.config["head"], self.after_call
        n_w = len(self.w0)
        first = mlp.adam_calls(self.w0, self.b0, self.checked_call, self.class_w, head,
                               self.device, **control)
        steps = mlp.adam_calls(after["params"][:n_w], after["params"][n_w:],
                               self.checked_steps, self.class_w, head, self.device,
                               moments=after, **control)
        return first, steps

    @staticmethod
    def as_program(first: dict, steps: dict) -> dict:
        """A reference run laid out as the program's readings, to put it in
        the program's place."""
        return {"call_loss": first["losses"][0], "call_params": first["params"],
                "step_losses": steps["losses"], "grads": steps["grads"],
                "params": steps["params"]}

    def gaps(self, got: dict, ref: tuple[dict, dict]) -> dict:
        """``got``'s five numbers against the reference run ``ref``."""
        first, steps = ref
        start, after = [*self.w0, *self.b0], self.after_call["params"]

        def change(params, origin):
            return [np.asarray(p, np.float64) - o for p, o in zip(params, origin)]

        counted = compare.moving_leaves(steps["grads"])
        return {
            "call_loss_gap": compare.loss_gap([got["call_loss"]], first["losses"]),
            "call_change_gap": compare.leaf_norm_gap(
                change(got["call_params"], start), change(first["params"], start),
                compare.moving_leaves(first["grads"])),
            "loss_gap": compare.loss_gap(got["step_losses"], steps["losses"]),
            "grad_gap": compare.leaf_norm_gap(got["grads"], steps["grads"], counted),
            "change_gap": compare.leaf_norm_gap(
                change(got["params"], after), change(steps["params"], after), counted),
        }

    def check(self) -> dict:
        program = {"call_loss": self.call_loss, "call_params": self.after_call["params"],
                   "step_losses": self.step_losses, "grads": self.grads,
                   "params": self.params}
        return self.gaps(program, self.reference())
