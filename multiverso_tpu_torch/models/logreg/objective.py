"""Objectives and regularizers as batched functions on tensors.

Counterpart of ``multiverso_tpu/models/logreg/objective.py`` (reference
Applications/LogisticRegression/src/objective/ and regular/): the
per-sample loops of the reference become one batched product per
minibatch, and every gradient is written out by hand, as in the JAX file
(no autograd):

* predict: ``logits = X @ W`` (dense) or a masked gather-dot (sparse);
* the "train loss" metric: squared error of the activation against the
  one-hot label, divided by output_size for multiclass (objective.cpp:50-61);
* gradient: ``X^T @ (act - onehot)`` over the true batch count, plus the
  regularizer's subgradient (L1 ``coef*sign(w)``, L2 ``coef*w``: the JAX
  package's deliberate fix of the reference's L2, regular.cpp:50-56).

Mixed precision (``compute_type="bfloat16"``): the JAX package multiplies
bf16 inputs with a float32 result (``preferred_element_type``). A torch
bf16 matmul would round its result to bf16, so here the inputs are rounded
to bf16 and multiplied as float32: a product of two bf16 values is exact in
float32, so the numbers are the JAX package's up to summation order.

Layout: W is ``(input_size, output_size)``; tables and checkpoints hold it
flattened output-major (reference key = feature + output * input_size).
"""

from __future__ import annotations

from typing import Callable

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config) -> torch.dtype:
    return _DTYPES[getattr(config, "compute_type", "float32")]


def _round_to(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``cdt`` and held as float32."""
    return t.float() if cdt == torch.float32 else t.to(cdt).float()


def _activation(objective_type: str) -> Callable:
    if objective_type == "sigmoid":
        return torch.sigmoid
    if objective_type == "softmax":
        return lambda z: torch.softmax(z, dim=-1)
    return lambda z: z  # default: linear


def _regular_grad(regular_type: str, coef: float) -> Callable:
    if regular_type == "L1":
        return lambda W: coef * torch.sign(W)
    if regular_type == "L2":
        return lambda W: coef * W
    return torch.zeros_like


def _onehot(labels: torch.Tensor, out: int, dtype) -> torch.Tensor:
    if out > 1:
        return torch.nn.functional.one_hot(labels.long(), out).to(dtype)
    return (labels == 1).to(dtype)[..., None]


def loss_metric(act: torch.Tensor, onehot: torch.Tensor,
                weights: torch.Tensor, output_size: int) -> torch.Tensor:
    """Reference squared-error train metric (objective.cpp:50-61), summed
    over real samples (every leading axis)."""
    per_sample = torch.sum((act - onehot) ** 2, dim=-1)
    if output_size > 1:
        per_sample = per_sample / output_size
    return torch.sum(per_sample * (weights > 0))


def _count(weights: torch.Tensor) -> torch.Tensor:
    """Real samples per batch (last axis), at least 1, as float32."""
    return torch.clamp(torch.sum(weights > 0, dim=-1), min=1).float()


def make_dense_grad_fn(config) -> Callable:
    """(W, X, labels, weights) -> (grad, loss_sum); grad is batch-averaged
    and regularized, and the client updater scales it by the learning
    rate. Leading axes of X/labels/weights beyond one batch are batches
    of their own: then grad has a leading batch axis too."""
    act_fn = _activation(config.objective_type)
    reg_fn = _regular_grad(config.regular_type, config.regular_coef)
    out = config.output_size
    cdt = compute_dtype(config)

    def grad_fn(W, X, labels, weights):
        Xc = _round_to(X, cdt)
        logits = torch.matmul(Xc, _round_to(W, cdt))          # (..., B, out)
        act = act_fn(logits)
        onehot = _onehot(labels, out, act.dtype)
        loss = loss_metric(act, onehot, weights, out)
        diff = (act - onehot) * weights[..., None]
        count = _count(weights)[..., None, None]
        grad = torch.matmul(Xc.transpose(-1, -2), _round_to(diff, cdt)) \
            / count + reg_fn(W)
        return grad, loss

    return grad_fn


def make_dense_predict_fn(config) -> Callable:
    act_fn = _activation(config.objective_type)
    return lambda W, X: act_fn(X @ W)


def _sparse_logits(W_rows, keys, values, mask):
    """(x, logits): x = values * mask (..., K); logits (..., out)."""
    x = values * mask
    rows = W_rows[keys]                                     # (..., K, out)
    return x, torch.einsum("...k,...ko->...o", x, rows)


def _sparse_diff(act_fn, out, x, logits, labels, weights):
    act = act_fn(logits)
    onehot = _onehot(labels, out, act.dtype)
    loss = loss_metric(act, onehot, weights, out)
    diff = (act - onehot) * weights[..., None]
    contrib = x[..., None] * diff[..., None, :]             # (..., K, out)
    return contrib, loss


def _scatter_rows(n_rows: int, keys: torch.Tensor, contrib: torch.Tensor):
    """Sum ``contrib`` lanes into rows ``keys`` of an (n_rows, out) zero
    tensor, duplicates accumulating in lane order on every run. On the card
    ``index_add_`` adds duplicates in atomic order, so two runs of one
    window could differ in the last bits; ``index_put_`` with
    ``accumulate`` sorts the lanes stably and sums each row's lanes in
    turn."""
    out = contrib.shape[-1]
    return torch.zeros((n_rows, out), dtype=contrib.dtype,
                       device=contrib.device).index_put_(
        (keys.reshape(-1).long(),), contrib.reshape(-1, out),
        accumulate=True)


def make_sparse_grad_fn(config) -> Callable:
    """(W_rows, keys, values, mask, labels, weights) -> (grad_rows, loss).

    ``W_rows`` is the window's row set (R, out); ``keys`` (B, K) index it.
    The scatter-add over the B*K lanes is the batched form of the
    reference's per-sample sparse accumulation (objective.cpp:70-85); the
    regularizer reaches every row some lane touches, masked lanes too."""
    act_fn = _activation(config.objective_type)
    reg_fn = _regular_grad(config.regular_type, config.regular_coef)
    out = config.output_size

    def grad_fn(W_rows, keys, values, mask, labels, weights):
        x, logits = _sparse_logits(W_rows, keys, values, mask)
        contrib, loss = _sparse_diff(act_fn, out, x, logits, labels, weights)
        n = W_rows.shape[0]
        grad = _scatter_rows(n, keys, contrib) / _count(weights)
        touched = torch.zeros((n, 1), dtype=W_rows.dtype,
                              device=W_rows.device).index_fill_(
            0, keys.reshape(-1), 1.0)
        return grad + reg_fn(W_rows) * touched, loss

    return grad_fn


def make_sparse_window_delta_fn(config) -> Callable:
    """A whole window at once: (W_rows, keys, values, mask, labels,
    weights, lrs) with a leading batch axis (nb) on every sample tensor ->
    (sum over batches of lr_b * grad_b, loss summed over the window), where
    grad_b is ``make_sparse_grad_fn``'s gradient of batch b at the same
    W_rows. One scatter-add serves every batch."""
    act_fn = _activation(config.objective_type)
    reg_fn = _regular_grad(config.regular_type, config.regular_coef)
    out = config.output_size

    def delta_fn(W_rows, keys, values, mask, labels, weights, lrs):
        x, logits = _sparse_logits(W_rows, keys, values, mask)
        contrib, loss = _sparse_diff(act_fn, out, x, logits, labels, weights)
        scale = lrs / _count(weights)                            # (nb,)
        n, nb = W_rows.shape[0], keys.shape[0]
        delta = _scatter_rows(n, keys, contrib * scale[:, None, None, None])
        touched = torch.zeros((nb, n), dtype=W_rows.dtype,
                              device=W_rows.device).scatter_(
            1, keys.reshape(nb, -1), 1.0)
        reg_scale = torch.sum(lrs[:, None] * touched, dim=0)     # (R,)
        return delta + reg_fn(W_rows) * reg_scale[:, None], loss

    return delta_fn


def make_sparse_predict_fn(config) -> Callable:
    act_fn = _activation(config.objective_type)

    def predict_fn(W_rows, keys, values, mask):
        return act_fn(_sparse_logits(W_rows, keys, values, mask)[1])

    return predict_fn


# ---------------------------------------------------------------------------
# FTRL-proximal (reference objective/ftrl_objective.h + updater.cpp:78-102):
# per-coordinate state (z, n); weights derived on the fly:
#   w = 0                                   if |z| <= lambda1
#   w = -(z - sgn(z)*lambda1) / ((beta + sqrt(n))/alpha + lambda2)  otherwise
# after gradient g: sigma = (sqrt(n+g^2) - sqrt(n))/alpha;
#   z += g - sigma*w ; n += g^2  (returned as negated deltas, signed for
#   the server's "state -= delta", reference updater.cpp:86-100).
# ---------------------------------------------------------------------------

def make_ftrl_weights_fn(config) -> Callable:
    a, b = config.alpha, config.beta
    l1, l2 = config.lambda1, config.lambda2

    def weights_fn(z, n):
        w = -(z - torch.sign(z) * l1) / ((b + torch.sqrt(n)) / a + l2)
        return torch.where(torch.abs(z) <= l1, torch.zeros_like(w), w)

    return weights_fn


def make_ftrl_grad_fn(config) -> Callable:
    """(z_rows, n_rows, keys, values, mask, labels, weights) ->
    (delta_z, delta_n, loss). Deltas are batch-averaged (reference
    model.cpp:84-92) and signed for server-side subtraction. With a
    leading batch axis (nb) on the sample tensors, the deltas are per
    batch: (nb, R, out), each at the same (z_rows, n_rows)."""
    act_fn = _activation("sigmoid" if config.output_size == 1 else "softmax")
    out = config.output_size
    a = config.alpha
    weights_fn = make_ftrl_weights_fn(config)

    def grad_fn(z_rows, n_rows, keys, values, mask, labels, weights):
        W_rows = weights_fn(z_rows, n_rows)                  # (R, out)
        x, logits = _sparse_logits(W_rows, keys, values, mask)
        contrib, loss = _sparse_diff(act_fn, out, x, logits, labels, weights)
        n = W_rows.shape[0]
        if keys.dim() == 3:
            # one row block per batch: lane keys offset by batch * R
            nb = keys.shape[0]
            offset = torch.arange(nb, device=keys.device)[:, None, None] * n
            g = _scatter_rows(nb * n, keys + offset, contrib).view(nb, n, out)
            g = g / _count(weights)[:, None, None]
        else:
            g = _scatter_rows(n, keys, contrib) / _count(weights)
        sigma = (torch.sqrt(n_rows + g * g) - torch.sqrt(n_rows)) / a
        return -(g - sigma * W_rows), -(g * g), loss

    return grad_fn
