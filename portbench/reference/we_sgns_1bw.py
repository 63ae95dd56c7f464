"""Plain reference of word2vec skip-gram with negative sampling under the
touched-rows AdaGrad step: ``-cbow 0 -hs 0 -use_adagrad 1 -device_pairs 1``.

Plain PyTorch; imports nothing of the program. It is handed the same
inputs as the program (the vocabulary counts, each block's token and
sentence ids, the seed and the configuration) and works out everything
else itself. Where a rule of the port decides WHICH work is done, a copy
frozen here reproduces it, so the reference draws what the program
draws:

* ``block_seed``: a block's draws come from a ``torch.Generator`` on the
  tables' device seeded with (seed, block counter) through numpy's
  SeedSequence; the shrunk windows first, then the negatives' slots;
* ``next_bucket``: the block's tokens padded to a bucket (the lane count
  follows from it);
* the slot table: word i owns round(p_i * T) consecutive slots of
  T = min(max(2^20, 64 V), 2^24), p the unigram^0.75 law;
* the init: input rows uniform(-0.5, 0.5) / D from
  ``numpy.random.default_rng(seed)``, output rows zero;
* the lanes: offset-major (d = -W..-1, 1..W, each over every token),
  batches of ``pair_batch`` consecutive lanes in that order.

The step (word2vec's SGNS, reference wordembedding.cpp:58-160, under
AdaGrad): h = IE[context]; f = sigmoid(h . EO[out]); err = (label - f) *
mask; each touched row's summed batch gradient g feeds g2 += g^2 before
row += lr * g / sqrt(g2) (where g2 > 1e-10). The products run through
``torch.einsum`` (a batched matmul on the card), so the TF32 control is
this same code with TF32 allowed.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-10


def block_seed(seed: int, counter: int) -> int:
    return int(np.random.SeedSequence([seed, counter]).generate_state(
        1, np.uint64)[0])


def next_bucket(n: int, min_bucket: int = 8) -> int:
    b = min_bucket
    while b < n:
        b <<= 1
    if b <= 256:
        return b
    half = b >> 1
    for num in (5, 6, 7):
        cand = (half * num) // 4
        if cand >= n:
            return cand
    return b


def slot_table(counts, device) -> torch.Tensor:
    probs = np.asarray(counts, np.float64) ** 0.75
    cum = np.cumsum(probs / probs.sum())
    T = int(min(max(1 << 20, 64 * len(counts)), 1 << 24))
    bounds = np.round(cum * T).astype(np.int64)
    return torch.from_numpy(np.repeat(np.arange(len(counts), dtype=np.int32),
                                      np.diff(bounds, prepend=0))).to(device)


def init_input(vocab: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random((vocab, dim), np.float32) - 0.5) / dim).astype(
        np.float32)


def block_tokens(block: np.ndarray):
    """A loader block ((sentences, words) ids) -> padded (ids, sent) int32
    vectors: -1 past the tokens."""
    T = block.size
    n = next_bucket(T, min_bucket=1024)
    ids = np.full(n, -1, np.int32)
    ids[:T] = block.reshape(-1)
    sent = np.full(n, -1, np.int32)
    sent[:T] = np.repeat(np.arange(block.shape[0], dtype=np.int32),
                         block.shape[1])
    return ids, sent


def draws(seed: int, counter: int, n: int, window: int, negative: int,
          slots: int, device):
    """The block's shrunk windows (n,) and negative slot indices (P, K)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, counter))
    b = torch.randint(1, window + 1, (n,), generator=gen, device=device)
    d = torch.randint(0, slots, (2 * window * n, negative), generator=gen,
                      device=device)
    return b, d


def lanes(ids: torch.Tensor, sent: torch.Tensor, b: torch.Tensor,
          window: int):
    """Every lane of a block in the port's order: (valid (P,), center (P,),
    context (P,)), P = 2 * window * n."""
    n = ids.shape[0]
    i = torch.arange(n, device=ids.device)
    valid, center, context = [], [], []
    for d in [*range(-window, 0), *range(1, window + 1)]:
        c = (i + d).clamp(0, n - 1)
        ok = ((i + d >= 0) & (i + d < n) & (ids >= 0) & (ids[c] >= 0)
              & (sent[c] == sent) & (b >= abs(d)))
        valid.append(ok)
        center.append(ids)
        context.append(ids[c])
    return torch.cat(valid), torch.cat(center), torch.cat(context)


class Reference:
    """The four tables and the step, in ``dtype``; ``allow_tf32`` lets the
    card's matmuls take TF32. ``fault`` plants one of the faults the
    comparison has to catch: "half" (each batch's second half of lanes
    left out, the gradient taken as the mean over the rest), "token" (every
    lane's context word altered where the lanes are made)."""

    def __init__(self, counts, cfg: dict, seed: int, device,
                 dtype=torch.float32, fault: str = ""):
        self.cfg, self.seed, self.device, self.dtype = cfg, seed, device, dtype
        self.fault = fault
        V, D = len(counts), cfg["size"]
        self.ie = torch.from_numpy(init_input(V, D, seed)).to(device, dtype)
        self.eo = torch.zeros((V, D), dtype=dtype, device=device)
        self.ie_g2 = torch.zeros((V, D), dtype=dtype, device=device)
        self.eo_g2 = torch.zeros((V, D), dtype=dtype, device=device)
        self.slots = slot_table(counts, device)
        self.lr = torch.tensor(cfg["lr"], dtype=torch.float32).to(dtype)
        self.counter = 0

    def block(self, block: np.ndarray, pair_batch: int) -> tuple:
        """Train one loader block; -> (loss sum, valid lanes)."""
        W, K = self.cfg["window"], self.cfg["negative"]
        V = self.ie.shape[0]
        ids_np, sent_np = block_tokens(block)
        ids = torch.from_numpy(ids_np).to(self.device).long()
        sent = torch.from_numpy(sent_np).to(self.device).long()
        self.counter += 1
        b, d = draws(self.seed, self.counter, len(ids_np), W, K,
                     self.slots.shape[0], self.device)
        valid, center, context = lanes(ids, sent, b, W)
        if self.fault == "token":
            context = (context + 1) % V
        negs = self.slots[d].long()
        outs = torch.cat([center[:, None], negs], 1)
        omask = torch.cat([valid[:, None],
                           valid[:, None] & (negs != center[:, None])], 1)
        labels = torch.zeros(1 + K, dtype=self.dtype, device=self.device)
        labels[0] = 1
        P = valid.shape[0]
        loss = torch.zeros((), dtype=torch.float64, device=self.device)
        for s in range(0, P, pair_batch):
            sel = valid[s:s + pair_batch].nonzero().squeeze(1) + s
            scale = 1.0
            if self.fault == "half":
                sel, scale = sel[: len(sel) // 2], 2.0
            if len(sel) == 0:
                continue
            loss += scale * self._step(context[sel], outs[sel],
                                       omask[sel].to(self.dtype), labels,
                                       scale)
        return float(loss), int(valid.sum())

    def _step(self, ctx, outs, om, labels, scale: float) -> torch.Tensor:
        D = self.ie.shape[1]
        h = self.ie[ctx]
        orow = self.eo[outs]
        f = torch.sigmoid(torch.einsum("pd,pcd->pc", h, orow))
        err = (labels - f) * om * scale
        loss = -torch.sum(om * (labels * torch.log(f + 1e-7)
                                + (1 - labels) * torch.log(1 - f + 1e-7)),
                          dtype=torch.float32)
        hid = torch.einsum("pc,pcd->pd", err, orow)
        eo_contrib = (err[:, :, None] * h[:, None, :]).reshape(-1, D)
        self._adagrad(self.eo, self.eo_g2, outs.reshape(-1), eo_contrib)
        self._adagrad(self.ie, self.ie_g2, ctx, hid)
        return loss.to(torch.float64)

    def _adagrad(self, tab, g2tab, ids, contrib) -> None:
        u, inv = torch.unique(ids, return_inverse=True)
        g = torch.zeros((len(u), tab.shape[1]), dtype=tab.dtype,
                        device=tab.device).index_add_(0, inv, contrib)
        g2 = g2tab[u] + g * g
        g2tab[u] = g2
        tab[u] = tab[u] + torch.where(
            g2 > EPS, self.lr * g / torch.sqrt(g2 + 1e-12),
            torch.zeros((), dtype=tab.dtype, device=tab.device))


def follow(counts, blocks: list, cfg: dict, params: dict, seed: int,
           device, dtype=torch.float32, allow_tf32: bool = False,
           fault: str = "") -> dict:
    """The readings of the first ``len(blocks)`` steps (blocks): each
    step's loss and valid lanes; the gradient norm per leaf from the
    AdaGrad state after step 1 (sqrt of the summed g2); each leaf's change
    after the last step (its init kept for the program's change)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        ref = Reference(counts, cfg, seed, device, dtype, fault)
        ie0 = ref.ie.clone()
        out = {"loss": [], "pairs": []}
        for k, blk in enumerate(blocks):
            loss, pairs = ref.block(blk, params["pair_batch"])
            out["loss"].append(loss)
            out["pairs"].append(pairs)
            if k == 0:
                out["grad"] = {"ie": sqrt_sum(ref.ie_g2),
                               "eo": sqrt_sum(ref.eo_g2)}
        out["change"] = {"ie": norm_diff(ref.ie, ie0),
                         "eo": norm_diff(ref.eo, None)}
        out["ie0"] = ie0.float()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sqrt_sum(t: torch.Tensor) -> float:
    return float(t.double().sum()) ** 0.5


def norm_diff(a: torch.Tensor, b, rows: int = 1 << 16) -> float:
    """||a - b|| (b None: ||a||), accumulated in float64 by row chunks."""
    acc = 0.0
    for s in range(0, a.shape[0], rows):
        x = a[s:s + rows].double()
        if b is not None:
            x = x - b[s:s + rows].to(x.device).double()
        acc += float((x * x).sum())
    return acc ** 0.5
