"""Batched word2vec training step on tensors.

Counterpart of ``multiverso_tpu/models/wordembedding/model.py`` (reference
wordembedding.cpp:58-160), one pair batch at a time:

  h        = mean_masked(IE[inputs])                       (P, D)
  f        = sigmoid(h . EO[outputs])                      (P, C)
  err      = (labels - f) * mask                           (P, C)
  hid_err  = err @ EO[outputs]                             (P, D)
  EO grads = sum over output lanes of err x h
  IE grads = sum over input lanes of hid_err

plain mode:    rows += lr * grad (lr decays per word count)
adagrad mode:  sum_g2 += grad^2; rows += init_lr * grad / sqrt(sum_g2)

The JAX package computes this in XLA outside any Pallas kernel, so the port
writes it as plain tensor code: gathers by advanced indexing, einsum, and
``index_add_`` for the scatter-adds. The block's batches run as a Python
loop where the JAX driver used ``lax.scan``. The step updates the block's
row tensors IN PLACE: the communicator hands it its own copies.

All indices are block-local int64 tensors (positions in the block's
fetched row sets).

``deterministic`` (``-device_pairs`` in a multi-process world, where every
rank runs the same program on its own replica): the scatter-adds go
through ``ops.rows.scatter_add_rows``' deterministic path (segment sums in
lane order, the CPU's ``index_add_`` rounding), because ``index_add_`` on
the card adds duplicates in atomic order and two replicas could end a
last bit apart. It takes the tables' full storage, whose last row is a
trash row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multiverso_tpu_torch.ops.rows import scatter_add_rows


class TrainState(NamedTuple):
    ie: torch.Tensor            # (R_in, D) input-embedding rows
    eo: torch.Tensor            # (R_out, D) output-embedding rows
    ie_g2: Optional[torch.Tensor]  # adagrad accumulators (or None)
    eo_g2: Optional[torch.Tensor]


def make_train_step(use_adagrad: bool, eps: float = 1e-10,
                    deterministic: bool = False):
    """Build the pair-batch step.

    signature: step(state, inputs, imask, outputs, labels, omask, lr)
    -> (state, pairs_loss_sum as a 0-d tensor)
    ``lr`` is the decayed rate (plain) or the initial rate (adagrad).
    """

    def step(state: TrainState, inputs, imask, outputs, labels, omask, lr):
        ie, eo = state.ie, state.eo
        D = ie.shape[1]
        # forward: mean of masked input embeddings (FeedForward)
        in_rows = ie[inputs]                               # (P, Cin, D)
        denom = torch.clamp(imask.sum(dim=1, keepdim=True), min=1.0)
        h = (in_rows * imask[:, :, None]).sum(dim=1) / denom   # (P, D)
        out_rows = eo[outputs]                             # (P, Cout, D)
        logits = torch.einsum("pd,pcd->pc", h, out_rows)
        f = torch.sigmoid(logits)
        err = (labels - f) * omask                         # (P, Cout)
        # loss metric: masked logistic loss (monitoring only)
        loss = -torch.sum(omask * (labels * torch.log(f + 1e-7) +
                                   (1 - labels) * torch.log(1 - f + 1e-7)))
        # backward
        hid_err = torch.einsum("pc,pcd->pd", err, out_rows)  # (P, D)
        eo_contrib = err[:, :, None] * h[:, None, :]        # (P, Cout, D)
        ie_contrib = hid_err[:, None, :] * imask[:, :, None]  # (P, Cin, D)
        out_flat = outputs.reshape(-1)
        in_flat = inputs.reshape(-1)
        if use_adagrad:
            # adagrad needs the per-ROW summed gradient
            eo_grad = scatter_add_rows(torch.zeros_like(eo), out_flat,
                                       eo_contrib.reshape(-1, D),
                                       deterministic)
            ie_grad = scatter_add_rows(torch.zeros_like(ie), in_flat,
                                       ie_contrib.reshape(-1, D),
                                       deterministic)
            eo_g2 = state.eo_g2 + eo_grad * eo_grad
            ie_g2 = state.ie_g2 + ie_grad * ie_grad
            zero = torch.zeros((), dtype=eo.dtype, device=eo.device)
            eo = eo + torch.where(eo_g2 > eps,
                                  lr * eo_grad / torch.sqrt(eo_g2 + 1e-12),
                                  zero)
            ie = ie + torch.where(ie_g2 > eps,
                                  lr * ie_grad / torch.sqrt(ie_g2 + 1e-12),
                                  zero)
            return TrainState(ie, eo, ie_g2, eo_g2), loss
        # plain SGD is additive per pair: scatter straight into the rows
        scatter_add_rows(eo, out_flat, (lr * eo_contrib).reshape(-1, D),
                         deterministic)
        scatter_add_rows(ie, in_flat, (lr * ie_contrib).reshape(-1, D),
                         deterministic)
        return TrainState(ie, eo, None, None), loss

    return step


def train_block(step, state: TrainState, batches: dict, lr):
    """Run ``step`` over a block's stacked (B, P, C) batches in order;
    returns (state, summed loss as a 0-d tensor, never synchronised)."""
    total = None
    for b in range(batches["inputs"].shape[0]):
        state, loss = step(state, batches["inputs"][b],
                           batches["input_mask"][b], batches["outputs"][b],
                           batches["labels"][b], batches["output_mask"][b],
                           lr)
        total = loss if total is None else total + loss
    return state, total


def init_embedding(vocab_size: int, dim: int, seed: int = 1) -> np.ndarray:
    """word2vec input-embedding init: uniform(-0.5, 0.5)/dim."""
    rng = np.random.default_rng(seed)
    return ((rng.random((vocab_size, dim), np.float32) - 0.5) /
            dim).astype(np.float32)


def decayed_lr(init_lr: float, word_count_actual: int, total_words: int,
               epochs: int) -> float:
    """reference UpdateLearningRate (wordembedding.cpp:38-47)."""
    lr = init_lr * (1 - word_count_actual /
                    (float(total_words) * max(epochs, 1) + 1.0))
    return max(lr, init_lr * 1e-4)
