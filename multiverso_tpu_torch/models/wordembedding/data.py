"""Corpus reader, DataBlocks, and batched training-pair construction (the
port's copy of ``multiverso_tpu/models/wordembedding/data.py``).

Behavioral equivalent of reference Applications/WordEmbedding/src/reader.*
(tokenize + vocab lookup, MAX_SENTENCE_LENGTH clipping), data_block.*
(sentences + the block's input/output node sets) and block_queue.* (the
loader-thread -> trainer-thread handoff).

A DataBlock eagerly expands into padded *pair batches* — the stacked
tensors the train step consumes:

  skip-gram: inputs (P, 1); CBOW: inputs (P, 2*window) + mask
  NEG: outputs (P, 1+negative) with labels [1, 0...]; negatives pre-sampled
  HS:  outputs (P, max_code) = Huffman points, labels = 1 - code
       (folding the reference's ``error = 1 - label - f`` into ``label - f``)

The block's unique touched rows (inputs + outputs) form its vocab —
exactly the row set the communicator fetches (reference PrepareData /
RequestParameter, communicator.cpp:117).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import native
from multiverso_tpu_torch.models.wordembedding.dictionary import Dictionary
from multiverso_tpu_torch.models.wordembedding.huffman import HuffmanEncoder
from multiverso_tpu_torch.models.wordembedding.sampler import Sampler
from multiverso_tpu_torch.parallel.mesh import next_bucket
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.utils.mt_queue import MtQueue

MAX_SENTENCE_LENGTH = 1000  # reference constant.h kMaxSentenceLength
_TOKEN_CHUNK = 1 << 20      # bytes of text per native tokenizer call


@dataclass
class DataBlock:
    """A block's training pairs in device-ready form + touched row sets.

    ``stacked`` is what the train step loop consumes: a dict of (B, P, C)
    arrays — inputs/input_mask/outputs/labels/output_mask — with row ids
    already remapped to *block-local* indices (positions in
    input_rows/output_rows) and the batch count B padded to a bucket (the
    JAX package's rule, kept so both packages cut a block into the same
    batches). Built by the loader threads so the serial train loop pays
    zero host prep per block."""

    input_rows: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    output_rows: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    word_count: int = 0
    stacked: Optional[dict] = None
    pair_count: int = 0
    # -device_pairs: the block carries only the subsampled token stream
    # (ids + sentence ids); the pairs are derived on the device
    # (device_pairs.py), so ``pair_count`` stays 0 and the trainer returns
    # the true count
    tokens: Optional[np.ndarray] = None
    token_sent: Optional[np.ndarray] = None


def sentences_from_file(path: str, dictionary: Dictionary,
                        tokenizer: Optional[native.VocabTokenizer] = None
                        ) -> Iterator[Tuple[np.ndarray, int]]:
    """Tokenize -> word ids; yields (ids, raw_token_count) per sentence
    (line), out-of-vocabulary words dropped, clipped to
    MAX_SENTENCE_LENGTH (reference reader.cpp).

    Fast path: the C++ tokenizer (``native.VocabTokenizer``; ``tokenizer``
    when the caller built it for ``dictionary`` already, else built here)
    maps 1 MB chunks in one foreign call each; ids come back with -2 at
    newlines and are split into sentences vectorized. The pure-Python path
    runs when the library is unavailable and yields the same sentences."""
    tok = tokenizer or native.VocabTokenizer.create(dictionary.words())

    def emit(ids: np.ndarray):
        for start in range(0, len(ids), MAX_SENTENCE_LENGTH):
            chunk = ids[start: start + MAX_SENTENCE_LENGTH]
            if chunk.size:
                yield chunk, len(chunk)

    def sentences(ids: np.ndarray):
        # split on the -2 newline sentinels, drop the -1 OOV ids
        for sent in np.split(ids, np.nonzero(ids == -2)[0]):
            yield from emit(sent[sent >= 0])

    if tok is not None:
        with open(path, "rb") as f:
            tail = b""
            while True:
                block = f.read(_TOKEN_CHUNK)
                if not block:
                    break
                block = tail + block
                # cut at the last newline; carry the partial line over
                nl = block.rfind(b"\n")
                if nl < 0:
                    tail = block
                    continue
                tail = block[nl + 1:]
                yield from sentences(tok.tokenize_lines(block[: nl + 1]))
            if tail.strip():
                yield from sentences(tok.tokenize_lines(tail))
        return

    lookup = dictionary.GetWordIdx
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            yield from emit(np.fromiter(
                (i for i in map(lookup, tokens) if i >= 0), np.int32))


class PairGenerator:
    """Expands sentences into padded pair batches."""

    def __init__(self, option, dictionary: Dictionary,
                 sampler: Sampler, huffman: Optional[HuffmanEncoder]):
        self.opt = option
        self.dict = dictionary
        self.sampler = sampler
        self.huffman = huffman
        if option.hs and huffman is None:
            raise ValueError("hs mode needs a HuffmanEncoder")

    def pairs_from_sentence(self, ids: np.ndarray):
        """-> list of (input_ids list, output_ids list, labels list)."""
        opt = self.opt
        keep = self.sampler.KeepMask(ids, opt.sample)
        ids = ids[keep]
        n = len(ids)
        if n < 2:
            return []
        windows = self.sampler.rand_windows(n, opt.window_size)
        out = []
        for i in range(n):
            b = windows[i]
            lo, hi = max(0, i - b), min(n, i + b + 1)
            context = [int(ids[j]) for j in range(lo, hi) if j != i]
            if not context:
                continue
            center = int(ids[i])
            if opt.hs:
                info = self.huffman.GetLabelInfo(center)
                outputs = list(info.points)
                labels = [1 - c for c in info.codes]  # fold (1-label-f)
            else:
                # drop negatives that hit the target itself (reference
                # wordembedding.cpp skips target==word_idx draws); the
                # output mask absorbs the shorter list
                negs = [int(x) for x in
                        self.sampler.SampleNegatives(opt.negative_num)
                        if int(x) != center]
                outputs = [center] + negs
                labels = [1.0] + [0.0] * len(negs)
            if opt.cbow:
                out.append((context, outputs, labels))
            else:
                # skip-gram: each context word is an input pair
                for c in context:
                    out.append(([c], outputs, labels))
        return out

    def _compact_tokens(self, sentences: List[np.ndarray]):
        """Sentences -> one (ids, sentence-ids) stream with word2vec
        subsampling applied by REMOVAL (windows then reach farther — the
        word2vec semantics both pair paths must share)."""
        lens = np.fromiter((len(s) for s in sentences), np.int64,
                           len(sentences))
        ids = (np.concatenate(sentences) if sentences
               else np.empty(0, np.int32))
        sent = np.repeat(np.arange(len(sentences), dtype=np.int32), lens)
        if self.opt.sample > 0 and len(ids):
            keep = self.sampler.KeepMask(ids, self.opt.sample)
            ids, sent = ids[keep], sent[keep]
        return ids.astype(np.int32), sent

    def _skipgram_neg_arrays(self, sentences: List[np.ndarray]):
        """Vectorized skip-gram + NEG pair construction over the whole
        block (2*window offset passes over the concatenated ids instead of
        a python loop per pair — the loop capped the app at ~27k words/s).
        Same marginal distributions as pairs_from_sentence (per-center
        shrunk window b~U[1,w], subsampling keep-rule, unigram^0.75
        negatives, center-collision lanes masked instead of dropped), with
        two documented differences: negatives are drawn independently per
        pair (the loop shared one draw across a center's context pairs)
        and pair order is offset-major rather than sentence-major — SGD
        visits the same pairs in a different, still random-ish order.

        Returns full-block (P, C) arrays (inputs, imask, outputs, labels,
        omask) with GLOBAL row ids, or None when the block is empty."""
        opt = self.opt
        ids, sent = self._compact_tokens(sentences)
        if len(ids) == 0:
            return None
        # positions within (possibly filtered) sentences
        _, start_idx, rank, new_lens = np.unique(
            sent, return_index=True, return_inverse=True, return_counts=True)
        pos = np.arange(len(ids)) - start_idx[rank]
        slen = new_lens[rank]
        b = self.sampler.rand_windows(len(ids), opt.window_size)
        centers_l, contexts_l = [], []
        for d in range(-opt.window_size, opt.window_size + 1):
            if d == 0:
                continue
            valid = (np.abs(d) <= b) & (pos + d >= 0) & (pos + d < slen)
            idx = np.nonzero(valid)[0]
            centers_l.append(ids[idx])
            contexts_l.append(ids[idx + d])
        centers = np.concatenate(centers_l).astype(np.int32)
        contexts = np.concatenate(contexts_l).astype(np.int32)
        P = len(centers)
        if P == 0:
            return None
        K = opt.negative_num
        negs = self.sampler.SampleNegatives((P, K)).astype(np.int32)
        outputs_all = np.concatenate([centers[:, None], negs], axis=1)
        omask_all = np.concatenate(
            [np.ones((P, 1), np.float32),
             (negs != centers[:, None]).astype(np.float32)], axis=1)
        labels_row = np.zeros(1 + K, np.float32)
        labels_row[0] = 1.0
        return (contexts[:, None], np.ones((P, 1), np.float32),
                outputs_all, np.broadcast_to(labels_row, (P, 1 + K)),
                omask_all)

    def _pairs_to_arrays(self, pairs):
        """(input, output, label) tuple list -> full (P, C) arrays with
        GLOBAL ids (the cbow/hs construction path)."""
        opt = self.opt
        P = len(pairs)
        if P == 0:
            return None
        cin_max = (2 * opt.window_size) if opt.cbow else 1
        if opt.hs:
            cout_max = self.huffman.max_code_length
        else:
            cout_max = 1 + opt.negative_num
        inputs = np.zeros((P, cin_max), np.int32)
        imask = np.zeros((P, cin_max), np.float32)
        outputs = np.zeros((P, cout_max), np.int32)
        labels = np.zeros((P, cout_max), np.float32)
        omask = np.zeros((P, cout_max), np.float32)
        for i, (ins, outs, labs) in enumerate(pairs):
            inputs[i, : len(ins)] = ins
            imask[i, : len(ins)] = 1.0
            outputs[i, : len(outs)] = outs
            labels[i, : len(labs)] = labs
            omask[i, : len(outs)] = 1.0
        return inputs, imask, outputs, labels, omask

    def _finalize_block(self, inputs, imask, outputs, labels, omask,
                        word_count: int) -> DataBlock:
        """Global-id (P, C) arrays -> a device-ready DataBlock: unique row
        sets, ids remapped to block-local positions, pair axis padded to a
        whole number of batches, batch count padded to a bucket (a fresh
        scan length would recompile the block program), reshaped (B, P, C).
        Runs inside the loader threads — the train loop's per-block host
        cost is just the uploads."""
        V = self.dict.Size()

        def remap(ids):
            """(row set, block-local ids). The row set is every id that
            appears in a lane — masked lanes included: filtering them
            would cost a full boolean-index copy, while the extra rows
            they add round-trip a zero delta (a no-op add). When the set
            covers most of the vocab, fetch every row and keep ids as-is
            — the remap costs more than the untouched rows. Gated on the
            UNIQUE row count, not raw lane count, so sparse blocks over
            huge vocabs keep the sparse fetch. np.unique(return_inverse)
            gives the sorted row set and the remapped ids in one pass
            with no vocab-sized allocation (a bincount here would zero
            O(V) per block — ruinous at word2vec-scale vocabularies)."""
            shape = ids.shape
            rows, inv = np.unique(ids, return_inverse=True)
            if 2 * len(rows) >= V:
                return np.arange(V, dtype=np.int32), ids.astype(np.int32)
            return (rows.astype(np.int32),
                    inv.reshape(shape).astype(np.int32))

        input_rows, loc_in = remap(inputs)
        output_rows, loc_out = remap(outputs)
        P = len(inputs)
        bs = self.opt.pair_batch_size
        nb = next_bucket(-(-P // bs), min_bucket=4)
        Ppad = nb * bs

        def pad(a, dtype):
            out = np.zeros((Ppad,) + a.shape[1:], dtype)
            out[:P] = a
            return out.reshape(nb, bs, -1)

        stacked = {
            "inputs": pad(loc_in, np.int32),
            "input_mask": pad(imask, np.float32),
            "outputs": pad(loc_out, np.int32),
            "labels": pad(labels, np.float32),
            "output_mask": pad(omask, np.float32),
        }
        return DataBlock(input_rows=input_rows,
                         output_rows=output_rows, word_count=word_count,
                         stacked=stacked, pair_count=P)

    def make_token_block(self, sentences: List[np.ndarray],
                         word_count: int, rng_stream=None) -> DataBlock:
        """-device_pairs block: subsample and compact on the host
        (word2vec REMOVES subsampled words, so windows reach farther: a
        data-dependent shape), ship only the surviving (ids, sentence-ids)
        stream."""
        if rng_stream is not None:
            self.sampler.set_thread_stream(rng_stream)
        ids, sent = self._compact_tokens(sentences)
        return DataBlock(word_count=word_count, tokens=ids, token_sent=sent)

    def make_block(self, sentences: List[np.ndarray],
                   word_count: int, rng_stream=None) -> DataBlock:
        # per-block deterministic randomness: the loader spawns streams in
        # block order (sampler.spawn_stream) so -seed reproduces exactly,
        # independent of -threads and scheduling
        if self.opt.device_pairs:
            return self.make_token_block(sentences, word_count, rng_stream)
        if rng_stream is not None:
            self.sampler.set_thread_stream(rng_stream)
        if not self.opt.cbow and not self.opt.hs:
            arrays = self._skipgram_neg_arrays(sentences)
        else:
            pairs = []
            for ids in sentences:
                pairs.extend(self.pairs_from_sentence(ids))
            arrays = self._pairs_to_arrays(pairs)
        if arrays is None:
            return DataBlock(word_count=word_count)
        return self._finalize_block(*arrays, word_count=word_count)


class BlockQueue:
    """Loader thread -> trainer handoff (reference block_queue.h)."""

    def __init__(self, capacity: int = 2):
        self._q: MtQueue[DataBlock] = MtQueue()
        self._space = threading.Semaphore(capacity)

    def push(self, block: DataBlock) -> None:
        """Blocks while the queue is full (a ``we.loader.push_wait``
        span)."""
        if not self._space.acquire(blocking=False):
            with ttrace.span("we.loader.push_wait", cat="we"):
                self._space.acquire()
        self._q.Push(block)

    def pop(self) -> Optional[DataBlock]:
        ok, block = self._q.Pop()
        if not ok:
            return None
        self._space.release()
        return block

    def close(self) -> None:
        self._q.Exit()


def start_loader(option, dictionary: Dictionary, generator: PairGenerator,
                 queue: BlockQueue, epochs: int,
                 tokenizer: Optional[native.VocabTokenizer] = None
                 ) -> threading.Thread:
    """Background loader: stream the corpus into DataBlocks
    (reference distributed_wordembedding.cpp:33-57 loader thread); every
    epoch tokenizes with ``tokenizer`` (see ``sentences_from_file``).

    ``-threads N`` (the reference's trainer-thread knob; training here is
    one jit stream, so the threads go where the host work is) prepares
    blocks in a pool — pair construction is numpy-heavy and releases the
    GIL, so block prep scales while training consumes in order."""

    workers = max(1, int(getattr(option, "thread_cnt", 1)))

    def next_chunk(stream) -> Optional[Tuple[List[np.ndarray], int]]:
        """The next block's sentences and their words, or None at the
        end of the pass."""
        sentences: List[np.ndarray] = []
        n_words = 0
        for ids, raw_count in stream:
            sentences.append(ids)
            n_words += raw_count
            if n_words * 8 >= option.data_block_size:
                break
        return (sentences, n_words) if sentences else None

    def chunks():
        for _ in range(epochs):
            stream = sentences_from_file(option.train_file, dictionary,
                                         tokenizer)
            while True:
                with ttrace.span("we.loader.tokenize", cat="we"):
                    chunk = next_chunk(stream)
                if chunk is None:
                    break
                yield chunk + (generator.sampler.spawn_stream(),)

    def make_block(sentences, n_words, stream) -> DataBlock:
        with ttrace.span("we.loader.make_block", cat="we"):
            return generator.make_block(sentences, n_words,
                                        rng_stream=stream)

    def run_sequential():
        for chunk in chunks():
            queue.push(make_block(*chunk))

    def run_pooled():
        import collections
        from concurrent.futures import ThreadPoolExecutor
        pending = collections.deque()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for chunk in chunks():
                pending.append(pool.submit(make_block, *chunk))
                # emit in order; bound in-flight work (queue.push also
                # backpressures via the BlockQueue capacity)
                while pending and (pending[0].done()
                                   or len(pending) > workers + 1):
                    queue.push(pending.popleft().result())
            while pending:
                queue.push(pending.popleft().result())

    def run():
        try:
            if workers == 1:
                run_sequential()
            else:
                run_pooled()
        finally:
            queue.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
