"""Plain PyTorch reference of the head-training step: the dequantising
gather, the MLP forward (Linear, ReLU, ..., Linear), the class-weighted
cross-entropy with the L2 term, the backward pass and Adam, in float32
with TF32 off.

The loss of one mini-batch of ``n`` rows with labels ``y`` and per-class
weights ``w``: ``sum(w[y] * ce) / sum(w[y]) + 0.5 * alpha / n * sum(W^2)``
(biases not decayed), as sklearn's MLPClassifier and the MERMAID head
define it. Adam is optax's ``adam(eps_root=0)``: bias-corrected moments
and ``m_hat / (sqrt(v_hat) + eps)``.

``tf32=True`` is the control: the same steps with every matmul, forward
and backward, taking its operands rounded to TF32 (10 explicit mantissa
bits, round to nearest even) and accumulating in f32, as the tensor cores
do with TF32 on: the step below the float32 that the head states. The
rounding is explicit, so the control reads the same on any device.
``fault`` plants one of the faults a training step can have, for the
readings the limits are set from.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import no_tf32


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, nearest even."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.T, a.T @ g


def dequantize(q: np.ndarray | torch.Tensor, scale: np.ndarray) -> torch.Tensor:
    """int8 rows times their per-row f32 scales, in f32."""
    q = torch.as_tensor(q)
    return q.to(torch.float32) * torch.as_tensor(np.asarray(scale, np.float32))[:, None]


def call_batches(n: int, batch_size: int, random_state: int) -> list[np.ndarray]:
    """The mini-batches of one training call over ``n`` rows, as positions
    in the call's rows. The head states sklearn's semantics: each call
    shuffles its rows with a generator seeded anew from ``random_state``,
    then cuts them in order into batches of ``min(batch_size, n)``, the
    last one short."""
    order = np.arange(n)
    np.random.default_rng(int(random_state)).shuffle(order)
    b = min(int(batch_size), n)
    return [order[s:s + b] for s in range(0, n, b)]


FAULTS = ("half_batch", "batch_repeated", "bias_step_1")


def adam_calls(weights, biases, calls, class_weight, head: dict, device,
               tf32: bool = False, fault: str | None = None, moments=None) -> dict:
    """Run the training calls ``calls``, each ``(q, scale, y)``: int8 rows,
    their f32 scales and labels, one Adam step per mini-batch
    (``call_batches``), from the given ``weights`` (in, out) and ``biases``
    and, where given, Adam's state ``moments`` (``{"mu", "nu", "count"}``,
    the moments leaf by leaf in the same order); otherwise from a fresh
    state. Returns ``losses`` (one per call: its steps' losses
    averaged by rows), ``grads`` (the first step's gradient of every leaf,
    weights then biases), ``moments`` (Adam's first moment of every leaf
    after the last step) and ``params`` (every leaf after it).

    ``fault`` plants one of ``FAULTS``: each batch's first half alone, the
    mean taken over it; every step of a call on the call's first batch;
    the bias correction of step 1 at every step."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    dev = torch.device(device)
    params = [torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
              for a in (*weights, *biases)]
    n_w = len(weights)
    if moments is None:
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        t = 0
    else:
        mu, nu = ([torch.tensor(np.asarray(a, np.float32), device=dev) for a in moments[k]]
                  for k in ("mu", "nu"))
        t = int(moments["count"])
    cw = torch.as_tensor(np.asarray(class_weight, np.float32), device=dev)
    lr, b1, b2, eps = (float(head[k]) for k in ("learning_rate", "beta_1", "beta_2", "epsilon"))
    alpha = float(head["alpha"])
    losses, first_grads = [], None
    matmul = _TF32MatMul.apply if tf32 else torch.matmul
    with no_tf32():
        for q, scale, labels in calls:
            batches = call_batches(len(labels), head["batch_size"], head["random_state"])
            if fault == "batch_repeated":
                batches = [batches[0]] * len(batches)
            total = 0.0
            for pos in batches:
                t += 1
                weight = len(pos)
                if fault == "half_batch":
                    pos = pos[:max(1, len(pos) // 2)]
                x = dequantize(q[torch.from_numpy(pos)], np.asarray(scale)[pos]).to(dev)
                y = torch.as_tensor(np.asarray(labels)[pos], dtype=torch.int64, device=dev)
                h = x
                for i in range(n_w):
                    h = matmul(h, params[i]) + params[n_w + i]
                    if i < n_w - 1:
                        h = torch.relu(h)
                ce = -F.log_softmax(h, dim=1).gather(1, y[:, None])[:, 0]
                wy = cw[y]
                loss = (wy * ce).sum() / wy.sum()
                loss = loss + 0.5 * alpha / len(y) * sum((w * w).sum() for w in params[:n_w])
                grads = torch.autograd.grad(loss, params)
                if first_grads is None:
                    first_grads = [g.detach().cpu().numpy() for g in grads]
                step = 1 if fault == "bias_step_1" else t
                with torch.no_grad():
                    for p, g, m, v in zip(params, grads, mu, nu):
                        m.mul_(b1).add_(g, alpha=1 - b1)
                        v.mul_(b2).addcmul_(g, g, value=1 - b2)
                        m_hat = m / (1 - b1 ** step)
                        v_hat = v / (1 - b2 ** step)
                        p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
                total += float(loss.detach()) * weight
            losses.append(total / len(labels))
    return {"losses": losses, "grads": first_grads,
            "moments": [m.cpu().numpy() for m in mu],
            "params": [p.detach().cpu().numpy() for p in params]}
