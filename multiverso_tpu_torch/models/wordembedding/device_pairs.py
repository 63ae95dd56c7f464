"""On-device pair generation and training: WordEmbedding ``-device_pairs 1``.

Counterpart of ``multiverso_tpu/models/wordembedding/device_pairs.py``.
The host uploads only a block's subsampled token stream (word ids and
sentence ids); the device derives the training pairs and trains on the
tables' storage directly:

* sentence starts and ends by ``torch.cummax`` and a flipped
  ``torch.cummin`` over the sentence-id vector;
* the word2vec shrunk window ``b ~ U[1, window]`` per center and one
  masked shift pass per offset d in [-W..W] \\ {0}. Skip-gram makes one
  pair per (center, context) lane; CBOW stacks the offsets into the
  pair's input lanes (the step's input mask averages them);
* negatives from the quantized unigram^0.75 slot table (the sampler's
  law, built once on the device), one random gather per draw, with the
  lanes that hit the center masked; or, for hierarchical softmax, the
  center's Huffman path gathered from (points, 1 - codes, mask) tables
  built once;
* the train step over the lane batches, in a Python loop where the JAX
  package scans: ``model.make_train_step`` (plain SGD, dense AdaGrad),
  or, with ``-use_adagrad`` and a table above ``_SPARSE_BYTES``, the
  touched-rows AdaGrad step (``sparse_adagrad_step``), which gathers and
  scatter-sets only the rows a batch touches, through the row kernels.

Row ids map into the storage layout with ``r + r // block_rows`` (the
matrix table's shard blocks, one trash row after each).

Draws: the window draws ``b`` and the negative draws come from a
``torch.Generator`` on the tables' device, seeded from (seed, block
counter), so ``-seed`` reproduces a run on one device. ``train_block``
also takes them as arguments: the JAX package draws with ``jax.random``,
which torch cannot reproduce, so the parity tests give both packages the
same draws.

Subsampling stays on the host (``data.PairGenerator.make_token_block``).

Multi-process worlds: the JAX program is ONE sequential program over a
GLOBAL token vector (every rank's padded shard in rank order, sentence ids
offset by ``rank * sent_span`` so no sentence crosses a rank boundary, one
key for the whole vector, the lane batches taken in that order, each step
seeing the state the previous batch left). Splitting it into per-rank
programs and an exchange of deltas would batch the lanes differently and
hand AdaGrad a sum of squares where it needs the square of a sum. So every
rank gathers every rank's token and sentence vectors (a few KB each, in
the app's ``"we_pop"`` round, or here in ``"we_dp_agreed"``), lays out
the same global vector (``t_pad = next_bucket(max(1024, T_max))`` a
rank), draws from the same seeded generator and runs the whole global
program on its own replica: each rank does the whole global block's work.
The scatter-adds then take their deterministic path
(``ops.rows.scatter_add_rows``, ``dedup_rows(deterministic=True)``), so
the replicas stay bitwise equal on the card. Stats are global.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch import ops
from multiverso_tpu_torch.models.wordembedding.huffman import HuffmanEncoder
from multiverso_tpu_torch.models.wordembedding.model import (TrainState,
                                                             make_train_step)
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.parallel.mesh import next_bucket
from multiverso_tpu_torch.telemetry import trace as ttrace

#: above this many bytes of input-table storage, ``-use_adagrad`` trains
#: with the touched-rows step: the dense step pays O(V * D) a batch, which
#: at word2vec vocabularies (1M x 128, ~512 MB a table) dwarfs the batch
_SPARSE_BYTES = 64 << 20


def sentence_spans(sent: torch.Tensor):
    """-> (position in its sentence, sentence length) of every token, from
    the sentence-id vector (equal neighbours share a sentence)."""
    n = sent.shape[0]
    ar = torch.arange(n, device=sent.device)
    sep = torch.full((1,), -9, dtype=sent.dtype, device=sent.device)
    is_start = sent != torch.cat([sep, sent[:-1]])
    start = torch.cummax(torch.where(is_start, ar, 0), 0).values
    is_end = sent != torch.cat([sent[1:], sep])
    end = torch.cummin(torch.where(is_end, ar, n).flip(0), 0).values.flip(0)
    return ar - start, end - start + 1


def make_lanes(ids: torch.Tensor, sent: torch.Tensor, b: torch.Tensor,
               draws: Optional[torch.Tensor], aux, *, window: int,
               cbow: bool, hs: bool) -> dict:
    """A block's training lanes, with LOGICAL row ids.

    ``ids``, ``sent``: (n,) int32 token and sentence ids, -1 past the
    tokens; ``b``: (n,) shrunk windows in [1, window]; ``draws``: (P, K)
    indices into the slot table ``aux`` (NEG), or None with ``aux`` the
    Huffman (points, labels, mask) tables (HS). P is n for CBOW and
    2 * window * n for skip-gram. Returns inputs (P, Cin) int32, imask
    (P, Cin) f32, outputs (P, Cout) int32, labels (P or 1, Cout) f32 (NEG:
    one row for every lane), omask (P, Cout) f32 and pmask (P,) bool."""
    W = window
    pos, slen = sentence_spans(sent)
    valid = ids >= 0
    shifts, oks = [], []
    for d in [*range(-W, 0), *range(1, W + 1)]:
        fill = torch.full((abs(d),), -1, dtype=ids.dtype, device=ids.device)
        shifted = (torch.cat([ids[d:], fill]) if d > 0
                   else torch.cat([fill, ids[:d]]))
        ok = (valid & (abs(d) <= b) & (pos + d >= 0) & (pos + d < slen)
              & (shifted >= 0))
        shifts.append(shifted)
        oks.append(ok)
    if cbow:
        # one pair per center: the input lanes are its context words
        ibool = torch.stack(oks, 1)                          # (n, 2W)
        inputs = torch.where(ibool, torch.stack(shifts, 1), 0)
        imask = ibool.to(torch.float32)
        pmask = ibool.any(1)
        centers = torch.where(pmask, ids, 0)
    else:
        # skip-gram: one pair per (center, context) lane, offset-major
        pmask = torch.cat(oks)
        centers = torch.where(pmask, ids.repeat(2 * W), 0)
        inputs = torch.where(pmask, torch.cat(shifts), 0)[:, None]
        imask = pmask[:, None].to(torch.float32)
    pm = pmask[:, None].to(torch.float32)
    if hs:
        points, hlabels, hmask = aux
        c = centers.long()
        outputs, labels, omask = points[c], hlabels[c], hmask[c] * pm
    else:
        negs = aux[draws.long()]
        K = negs.shape[1]
        outputs = torch.cat([centers[:, None], negs], 1)
        omask = torch.cat([pmask[:, None],
                           pmask[:, None] & (negs != centers[:, None])],
                          1).to(torch.float32)
        labels = torch.zeros((1, 1 + K), dtype=torch.float32,
                             device=ids.device)
        labels[0, 0] = 1.0
    return {"inputs": inputs, "imask": imask, "outputs": outputs,
            "labels": labels, "omask": omask, "pmask": pmask}


def sparse_adagrad_step(state: TrainState, inputs, imask, outputs, labels,
                        omask, lr, eps: float = 1e-10,
                        deterministic: bool = False):
    """The touched-rows AdaGrad batch step over FULL storage tables: the
    math of ``model.make_train_step``'s AdaGrad branch (a row's summed
    batch gradient feeds its g2 before the update), but only the rows the
    batch touches move: six row gathers and four row scatter-sets. Ids
    are int32 storage ids; ``ops.dedup_rows`` sums duplicate ids into one
    lane and turns the others into pad lanes (-1), which go to the trash
    row (the last storage row) so the scatter-set's duplicates lie only
    there. ``deterministic``: the dedup's segment sum in sorted order
    (``dedup_rows(deterministic=True)``). Updates the tables in place."""
    ie, eo = state.ie, state.eo
    D = ie.shape[1]
    in_rows = ops.gather_rows(ie, inputs.reshape(-1)).reshape(
        inputs.shape + (D,))
    denom = torch.clamp(imask.sum(dim=1, keepdim=True), min=1.0)
    h = (in_rows * imask[:, :, None]).sum(dim=1) / denom
    out_rows = ops.gather_rows(eo, outputs.reshape(-1)).reshape(
        outputs.shape + (D,))
    logits = torch.einsum("pd,pcd->pc", h, out_rows)
    f = torch.sigmoid(logits)
    err = (labels - f) * omask
    loss = -torch.sum(omask * (labels * torch.log(f + 1e-7) +
                               (1 - labels) * torch.log(1 - f + 1e-7)))
    hid_err = torch.einsum("pc,pcd->pd", err, out_rows)
    eo_contrib = err[:, :, None] * h[:, None, :]
    ie_contrib = hid_err[:, None, :] * imask[:, :, None]
    zero = torch.zeros((), dtype=ie.dtype, device=ie.device)

    def row_update(tab, g2tab, ids, contrib):
        uids, grads = ops.dedup_rows(ids.reshape(-1), contrib.reshape(-1, D),
                                     deterministic)
        uids = torch.where(uids < 0, tab.shape[0] - 1, uids)
        g2_rows = ops.gather_rows(g2tab, uids) + grads * grads
        rows = ops.gather_rows(tab, uids) + torch.where(
            g2_rows > eps, lr * grads / torch.sqrt(g2_rows + 1e-12), zero)
        ops.scatter_set_rows(tab, uids, rows)
        ops.scatter_set_rows(g2tab, uids, g2_rows)

    row_update(eo, state.eo_g2, outputs, eo_contrib)
    row_update(ie, state.ie_g2, inputs, ie_contrib)
    return state, loss


def block_seed(seed: int, counter: int) -> int:
    """The seed of a block's draws on the device: (seed, block counter)
    through numpy's SeedSequence."""
    return int(np.random.SeedSequence([seed, counter]).generate_state(
        1, np.uint64)[0])


def _to_device(a, dev) -> torch.Tensor:
    """A given draw array (numpy, read-only too, or a tensor) on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(dev)


class _BlockStats:
    """A block's (loss sum, pair count) as one float64 device tensor (the
    count is exact up to 2^53); the first read copies both to the host."""

    def __init__(self, stats: torch.Tensor):
        self._stats = stats
        self._host = None

    def get(self, i: int) -> float:
        if self._host is None:
            self._host = self._stats.tolist()
        return self._host[i]


class _Stat:
    """One lane of a ``_BlockStats``, read lazily by float() / int()."""

    __slots__ = ("_block", "_i")

    def __init__(self, block: _BlockStats, i: int):
        self._block, self._i = block, i

    def __float__(self) -> float:
        return float(self._block.get(self._i))

    def __int__(self) -> int:
        return int(self._block.get(self._i))


class DevicePairsTrainer:
    """Owns the sampling tables on the device and trains a block in place
    on the Communicator's tables (the caller owns them meanwhile)."""

    def __init__(self, opt, comm, counts, huffman: Optional[
            HuffmanEncoder] = None):
        self.opt = opt
        self.comm = comm
        self.device = comm.device
        self._block_counter = 0
        #: batch steps run, and how many of them took the touched-rows step
        self.batches = 0
        self.sparse_batches = 0
        if opt.hs:
            # the center's root path: inner-node rows of the output table
            # and their 1 - code labels (reference huffman_encoder.cpp);
            # the app's encoder is reused when passed
            enc = huffman
            if enc is None:
                enc = HuffmanEncoder()
                enc.BuildFromTermFrequency(counts)
            V, MC = len(counts), max(enc.max_code_length, 1)
            pts = np.zeros((V, MC), np.int32)
            labs = np.zeros((V, MC), np.float32)
            hmask = np.zeros((V, MC), np.float32)
            for w in range(V):
                info = enc.GetLabelInfo(w)
                L = len(info.codes)
                pts[w, :L] = info.points
                labs[w, :L] = [1 - c for c in info.codes]
                hmask[w, :L] = 1.0
            self._aux = tuple(torch.from_numpy(a).to(self.device)
                              for a in (pts, labs, hmask))
            self.slots = None
        else:
            # the slot table (reference util.h
            # SetNegativeSamplingDistribution; sampler.Sampler's law):
            # word i owns round(p_i * T) consecutive slots
            probs = np.asarray(counts, np.float64) ** 0.75
            cum = np.cumsum(probs / probs.sum())
            T = int(min(max(1 << 20, 64 * len(counts)), 1 << 24))
            bounds = np.round(cum * T).astype(np.int64)
            self.slots = torch.from_numpy(np.repeat(
                np.arange(len(counts), dtype=np.int32),
                np.diff(bounds, prepend=0))).to(self.device)
            self._aux = self.slots

    # -- table storage ---------------------------------------------------------

    def _servers(self):
        c = self.comm
        servers = [c.input_table.server(), c.output_table.server()]
        if self.opt.use_adagrad:
            servers += [c.ie_g2_table.server(), c.eo_g2_table.server()]
        return servers

    def sparse(self) -> bool:
        """Whether ``-use_adagrad`` takes the touched-rows step: the input
        table's storage is above ``_SPARSE_BYTES``."""
        data = self.comm.input_table.server().state["data"]
        return (self.opt.use_adagrad
                and data.numel() * data.element_size() > _SPARSE_BYTES)

    # -- one block -------------------------------------------------------------

    def train_block(self, token_ids: np.ndarray, token_sent: np.ndarray,
                    lr: float, b=None, draws=None, agreed=None):
        """Train one block of tokens in place on the tables. ``b`` ((n,)
        ints in [1, window], n the padded token count) and ``draws`` ((P,
        K) slot indices) replace the block's random draws when given.
        Returns (loss sum, pair count), left on the device until float() /
        int() reads them.

        Multi-process: COLLECTIVE, one call a global block on every rank
        (the app's ``pop_block`` feeds a finished rank empty blocks).
        ``agreed`` is every rank's (token ids, sentence ids) in rank
        order, from the app's ``"we_pop"`` round; without it this call
        gathers them. The block is the global one (module docstring), and
        so are the returned stats."""
        opt = self.opt
        nproc = multihost.process_count()
        if nproc > 1:
            if agreed is None:
                agreed = multihost.host_allgather_objects_capped(
                    (np.asarray(token_ids, np.int32),
                     np.asarray(token_sent, np.int32)), "we_dp_agreed")
            ids, sent = self.global_layout(agreed)
        else:
            T = len(token_ids)
            if T == 0:
                zero = _BlockStats(torch.zeros(2, dtype=torch.float64))
                return _Stat(zero, 0), _Stat(zero, 1)
            t_pad = next_bucket(T, min_bucket=1024)
            ids = np.full(t_pad, -1, np.int32)
            ids[:T] = token_ids
            sent = np.full(t_pad, -1, np.int32)
            sent[:T] = token_sent
        self._block_counter += 1
        n = len(ids)
        dev = self.device
        W, K = opt.window_size, opt.negative_num
        P = n if opt.cbow else 2 * W * n
        if b is None or (draws is None and not opt.hs):
            gen = torch.Generator(device=dev)
            gen.manual_seed(block_seed(opt.seed, self._block_counter))
            if b is None:
                b = torch.randint(1, W + 1, (n,), generator=gen,
                                  device=dev)
            if draws is None and not opt.hs:
                draws = torch.randint(0, self.slots.shape[0], (P, K),
                                      generator=gen, device=dev)
        b = _to_device(b, dev)
        if draws is not None:
            draws = _to_device(draws, dev)
        return self.program(torch.from_numpy(ids).to(dev),
                            torch.from_numpy(sent).to(dev), b, draws, lr,
                            deterministic=nproc > 1)

    @staticmethod
    def global_layout(parts):
        """Every rank's (token ids, sentence ids) -> the global (ids, sent)
        vectors of the JAX package's multi-process block: rank r's tokens
        at ``r * t_pad``, ``t_pad = next_bucket(max(1024, T_max))``, its
        sentence ids offset by ``r * sent_span`` (the global count of
        sentence ids), -1 past each rank's tokens."""
        # the JAX package's parts_bucket(n, 1): one device a rank
        t_pad = next_bucket(max(1024, max(len(t) for t, _ in parts)))
        span = max(max(int(np.max(s, initial=-1)) + 1 for _, s in parts), 1)
        ids = np.full(len(parts) * t_pad, -1, np.int32)
        sent = np.full(len(parts) * t_pad, -1, np.int32)
        for r, (t, s) in enumerate(parts):
            ids[r * t_pad: r * t_pad + len(t)] = t
            sent[r * t_pad: r * t_pad + len(t)] = np.asarray(s) + r * span
        return ids, sent

    def program(self, ids: torch.Tensor, sent: torch.Tensor, b: torch.Tensor,
                draws: Optional[torch.Tensor], lr: float,
                deterministic: bool = False):
        """The block program on device tensors: lanes, then the train step
        over ceil(P / pair_batch) batches (the JAX package rounds the
        batch count up to a bucket; batches of pad lanes change nothing).
        ``deterministic``: the steps' scatter-adds in sorted order."""
        opt = self.opt
        with ttrace.span("we.lanes", cat="we"):
            lanes = make_lanes(ids, sent, b, draws, self._aux,
                               window=opt.window_size, cbow=opt.cbow,
                               hs=opt.hs)
        block_rows = self.comm.input_table.server().block_rows
        sparse = self.sparse()
        B = opt.pair_batch_size
        P = lanes["pmask"].shape[0]
        nb = -(-P // B)

        def batched(a, ids_=False):
            """Lanes padded to whole batches (NEG's one labels row serves
            every lane as it is); row ids mapped into the storage."""
            if ids_:
                a = a + a // block_rows          # logical -> storage row
                if not sparse:
                    a = a.long()
            if a.shape[0] == P < nb * B:
                a = torch.cat([a, a.new_zeros((nb * B - P,) + a.shape[1:])])
            return a

        inputs = batched(lanes["inputs"], True)
        outputs = batched(lanes["outputs"], True)
        imask, labels, omask = (batched(lanes[k])
                                for k in ("imask", "labels", "omask"))
        servers = self._servers()
        states = [s.state["data"] for s in servers]
        state = (TrainState(*states) if opt.use_adagrad
                 else TrainState(states[0], states[1], None, None))
        step = (functools.partial(sparse_adagrad_step,
                                  deterministic=deterministic) if sparse
                else make_train_step(opt.use_adagrad,
                                     deterministic=deterministic))
        # the lr as a float32 scalar, as the JAX step's traced lr
        lr_t = torch.tensor(lr, dtype=torch.float32)
        losses = []
        for i in range(nb):
            sl = slice(i * B, (i + 1) * B)
            with ttrace.span("we.batch", cat="we"):
                state, loss = step(state, inputs[sl], imask[sl], outputs[sl],
                                   labels if labels.shape[0] == 1
                                   else labels[sl], omask[sl], lr_t)
            losses.append(loss)
        self.batches += nb
        self.sparse_batches += nb if sparse else 0
        # the dense AdaGrad step returns fresh tensors: the tables' own
        # verbs must see them
        new = ((state.ie, state.eo, state.ie_g2, state.eo_g2)
               if opt.use_adagrad else (state.ie, state.eo))
        for srv, t in zip(servers, new):
            # through the setter: a CPU table's native store is stale
            srv.state = dict(srv.state, data=t)
        stats = _BlockStats(torch.stack([
            torch.stack(losses).sum().to(torch.float64),
            lanes["pmask"].sum().to(torch.float64)]))
        return _Stat(stats, 0), _Stat(stats, 1)
