"""Data + tensor parallel MLP-head training step over a device mesh.

Port of ``mermaid_classifier_tpu/parallel/sharded_train.py``: the weighted
CE + per-minibatch L2 + Adam semantics of ``train.mlp_classifier`` as one
step over a ``(data, model)`` mesh:

- the batch is split over "data" (every rank is given the global batch and
  keeps its data row's slice);
- the hidden layers are split over "model" in the Megatron layout of the
  JAX ``_param_specs``: even layers split the output dim (column parallel,
  bias sharded), odd layers split the input dim (row parallel, bias
  replicated and added after the model-group all-reduce).

XLA derives the JAX step's collectives; here they are written out as
autograd functions: identity forward / all-reduce backward in front of a
column layer, all-reduce forward / identity backward after a row layer, and
an all-gather of the logits when the last layer is column parallel. The
data-parallel loss on each data rank is ``sum(w * ce)`` over its rows
divided by the global ``sum(w)``, so the gradients summed over the data
group are the global batch's; the L2 term enters the gradient on data rank
0 only.

A width that "model" does not divide is zero-padded, as XLA pads it: the
pad columns and rows start at zero and stay exactly zero (their gradients
are zero, so Adam moves them by 0 / (0 + eps)), and padded logits are cut
before the softmax.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32
from mermaid_classifier_tpu_torch.parallel.mesh import Mesh, all_reduce_flat
from mermaid_classifier_tpu_torch.train.mlp_classifier import adam_update


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce over the model group backward: the
    input of a column-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group forward, identity backward: the
    partial sums of a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the column shards along the last dim forward; each
    rank's own slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.width
        return grad[:, start:start + ctx.width].contiguous(), None, None, None


class ShardedHeadTrainer:
    """Sharded training-step factory for the classifier head.

    Semantics contract (pinned by tests against the JAX trainer and the
    port's classifier): one ``train_step`` call == one Adam update on one
    mini-batch with ``loss = sum(w_i * ce_i)/sum(w_i) + 0.5*alpha/n_real *
    sum(W^2)``. Parameters are this rank's shards, ``{"W": [...], "b":
    [...]}`` of tensors on ``mesh.device``; ``unshard_params`` gathers them
    back into the full arrays."""

    def __init__(
        self,
        mesh: Mesh,
        layer_sizes: tuple[int, ...],
        *,
        learning_rate: float = 1e-4,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-8,
        alpha: float = 0.0001,
    ) -> None:
        if len(layer_sizes) < 2:
            raise ValueError("layer_sizes needs at least (input_dim, n_classes)")
        self.mesh = mesh
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        self.learning_rate = float(learning_rate)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)
        self.alpha = float(alpha)
        model = mesh.spec.model
        self.n_layers = len(self.layer_sizes) - 1
        # Per layer (in, out) widths after padding: a column-parallel
        # layer's output dim rounds up to the model size, and the next
        # layer's input follows it.
        self._padded: list[tuple[int, int]] = []
        fan_in = self.layer_sizes[0]
        for i, out in enumerate(self.layer_sizes[1:]):
            out_p = _round_up(out, model) if i % 2 == 0 else out
            self._padded.append((fan_in, out_p))
            fan_in = out_p

    # -- parameter placement -------------------------------------------------

    def _local_slice(self, i: int, full: int) -> slice:
        share = full // self.mesh.spec.model
        start = self.mesh.model_rank * share
        return slice(start, start + share)

    def shard_params(self, params: dict) -> dict:
        """This rank's shards of full ``{"W": [...], "b": [...]}`` numpy
        arrays (``W[i]`` is (in, out)), zero-padded and laid out column /
        row parallel; the same arrays on every rank give one model."""
        ws, bs = [], []
        for i, (w, b) in enumerate(zip(params["W"], params["b"])):
            w = np.asarray(w, np.float32)
            b = np.asarray(b, np.float32)
            fan_in, out_p = self._padded[i]
            wp = np.zeros((fan_in, out_p), np.float32)
            wp[: w.shape[0], : w.shape[1]] = w
            bp = np.zeros(out_p, np.float32)
            bp[: b.shape[0]] = b
            if i % 2 == 0:
                cols = self._local_slice(i, out_p)
                wl, bl = wp[:, cols], bp[cols]
            else:
                wl, bl = wp[self._local_slice(i, fan_in)], bp
            ws.append(torch.tensor(np.ascontiguousarray(wl), device=self.mesh.device))
            bs.append(torch.tensor(np.ascontiguousarray(bl), device=self.mesh.device))
        return {"W": [w.requires_grad_() for w in ws],
                "b": [b.requires_grad_() for b in bs]}

    def unshard_params(self, params: dict) -> dict:
        """The full (unpadded) numpy arrays of sharded ``params``: the
        column shards gathered over the model group, then cut to the real
        widths."""
        model = self.mesh.spec.model

        def gather(t: torch.Tensor, dim: int) -> torch.Tensor:
            parts = [torch.empty_like(t) for _ in range(model)]
            dist.all_gather(parts, t.contiguous(), group=self.mesh.model_group)
            return torch.cat(parts, dim=dim)

        ws, bs = [], []
        for i, (w, b) in enumerate(zip(params["W"], params["b"])):
            w, b = w.detach(), b.detach()
            if model > 1 and i % 2 == 0:
                w, b = gather(w, 1), gather(b, 0)
            elif model > 1:
                w = gather(w, 0)
            fan_in, fan_out = self.layer_sizes[i], self.layer_sizes[i + 1]
            ws.append(w[:fan_in, :fan_out].cpu().numpy())
            bs.append(b[:fan_out].cpu().numpy())
        return {"W": ws, "b": bs}

    def init_params(self, seed: int = 0) -> dict:
        """Xavier-uniform weights / zero biases (the single-device init
        contract), drawn from an explicit CPU ``torch.Generator`` so every
        rank draws the same full arrays, then sharded."""
        gen = torch.Generator().manual_seed(int(seed))
        sizes = self.layer_sizes
        weights, biases = [], []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            w = torch.empty((fan_in, fan_out), dtype=torch.float32)
            weights.append(w.uniform_(-limit, limit, generator=gen).numpy())
            biases.append(np.zeros(fan_out, np.float32))
        return self.shard_params({"W": weights, "b": biases})

    def init_opt_state(self, params: dict) -> dict:
        """Adam's state laid out like the parameter shards."""
        zeros = {key: [torch.zeros_like(p.detach()) for p in params[key]]
                 for key in ("W", "b")}
        return {
            "count": torch.zeros((), dtype=torch.int64, device=self.mesh.device),
            "mu": zeros,
            "nu": {key: [torch.zeros_like(t) for t in v] for key, v in zeros.items()},
        }

    # -- the step ------------------------------------------------------------

    def _forward_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        model = mesh.spec.model
        n = self.n_layers
        for i in range(n):
            w, b = params["W"][i], params["b"][i]
            if i % 2 == 0:
                if i > 0 and model > 1:
                    x = _CopyToModel.apply(x, mesh.model_group)
                x = torch.matmul(x, w) + b
            else:
                x = torch.matmul(x, w)
                if model > 1:
                    x = _ReduceFromModel.apply(x, mesh.model_group)
                x = x + b
            if i < n - 1:
                x = torch.relu(x)
        if (n - 1) % 2 == 0:
            if model > 1:
                x = _GatherFromModel.apply(x, mesh.model_group, model,
                                           mesh.model_rank)
            x = x[:, : self.layer_sizes[-1]]
        return x

    def place_batch(self, x: np.ndarray, y: np.ndarray, w: np.ndarray):
        """This rank's share of a global host mini-batch: its data row's
        slice of ``x`` and ``y``, and the whole weight vector (its sum is
        the loss's denominator). Rows must divide the data-axis size (pad
        with w=0 rows upstream)."""
        n, data = len(x), self.mesh.spec.data
        if n % data:
            raise ValueError(
                f"batch of {n} rows does not divide the {data}-rank data axis;"
                f" pad with w=0 rows first."
            )
        share = n // data
        rows = slice(self.mesh.data_rank * share, (self.mesh.data_rank + 1) * share)
        device = self.mesh.device
        xd = torch.as_tensor(np.asarray(x, np.float32)[rows], device=device)
        yd = torch.as_tensor(np.asarray(y, np.int64)[rows], device=device)
        wd = torch.as_tensor(np.asarray(w, np.float32), device=device)
        return xd, yd, wd

    def train_step(self, params, opt_state, xb, yb, wb, n_real: float):
        """One sharded Adam update, in place; returns (params, opt_state,
        loss) with the global loss as a float."""
        mesh = self.mesh
        share = xb.shape[0]
        w_local = wb[mesh.data_rank * share: (mesh.data_rank + 1) * share]
        flat = [*params["W"], *params["b"]]
        with full_f32():
            logits = self._forward_logits(params, xb)
            ce = -F.log_softmax(logits, dim=1).gather(1, yb[:, None])[:, 0]
            data_loss = (w_local * ce).sum() / wb.sum()
            sq = sum((w * w).sum() for w in params["W"])
            l2 = 0.5 * self.alpha / float(n_real)
            # The L2 gradient enters once, on data rank 0.
            loss = data_loss + l2 * sq if mesh.data_rank == 0 else data_loss
            grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            if mesh.spec.data > 1:
                grads = all_reduce_flat(list(grads), mesh.data_group)
            parts = torch.stack([data_loss.detach(), sq.detach()])
            if mesh.spec.data > 1:
                dist.all_reduce(parts[0:1], group=mesh.data_group)
            if mesh.spec.model > 1:
                dist.all_reduce(parts[1:2], group=mesh.model_group)
            total = float(parts[0] + l2 * parts[1])
            adam_update(flat, grads, opt_state, self.learning_rate,
                        self.beta_1, self.beta_2, self.epsilon)
        return params, opt_state, total

    def predict_proba(self, params, x) -> torch.Tensor:
        """Softmax probabilities of a global batch ``x`` (every rank runs
        every row; the model group's collectives join the shards)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.mesh.device)
        with torch.no_grad(), full_f32():
            return torch.softmax(self._forward_logits(params, x), dim=1)
