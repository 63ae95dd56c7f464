"""DistributedWordEmbedding driver.

Counterpart of ``multiverso_tpu/models/wordembedding/distributed.py``
(reference distributed_wordembedding.h/.cpp): Run -> Train -> per-block
loop (a loader thread fills a BlockQueue; each block: fetch the block's
rows, train all its pairs, push the deltas; with ``-is_pipeline 1`` the
host plane prefetches the NEXT block's rows while the current one trains),
words/s logging, and word2vec-format embedding export.

Three planes: the host plane, ``-device_plane 1``, and ``-device_pairs 1``
(only the token stream is uploaded; the pairs are derived and trained on
the device, ``device_pairs.py``).

Multi-process worlds train DATA-PARALLEL: each rank streams its own corpus
shard through ``run()``. Every block's table verbs are collectives, so
``pop_block`` agrees before each block, in one tagged all-gather
(``"we_pop"``), on whether every rank is done; for ``-device_pairs`` the
same round carries every rank's token and sentence vectors, from which
each rank builds the global block (``device_pairs.py``), and a rank whose
shard ran out joins with an empty filler block. The host and device
planes cannot run an empty block, so unequal block streams fail there
LOUDLY on every rank (the CHECK reads the gathered flags). Each rank's
worker 0 saves the embeddings.

CLI: ``python -m multiverso_tpu_torch.models.wordembedding.distributed
-train_file corpus.txt [-size 100 ...] [-platform cuda|cpu]``.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch import api as mv
from multiverso_tpu_torch import native
from multiverso_tpu_torch.models.wordembedding.communicator import \
    Communicator
from multiverso_tpu_torch.models.wordembedding.data import (BlockQueue,
                                                            DataBlock,
                                                            PairGenerator,
                                                            start_loader)
from multiverso_tpu_torch.models.wordembedding.device_pairs import \
    DevicePairsTrainer
from multiverso_tpu_torch.models.wordembedding.dictionary import Dictionary
from multiverso_tpu_torch.models.wordembedding.huffman import HuffmanEncoder
from multiverso_tpu_torch.models.wordembedding.model import (decayed_lr,
                                                             make_train_step,
                                                             train_block)
from multiverso_tpu_torch.models.wordembedding.option import Option
from multiverso_tpu_torch.models.wordembedding.sampler import Sampler
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.timer import Timer
from multiverso_tpu_torch.utils.world import WorldOwner

#: the stacked block arrays and the dtype each becomes on the device
_BLOCK_DTYPES = {"inputs": torch.int64, "input_mask": torch.float32,
                 "outputs": torch.int64, "labels": torch.float32,
                 "output_mask": torch.float32}


class DistributedWordEmbedding:
    def __init__(self, option: Option):
        self.opt = option
        self.dictionary: Optional[Dictionary] = None
        self.huffman: Optional[HuffmanEncoder] = None
        self.sampler: Optional[Sampler] = None
        self.comm: Optional[Communicator] = None
        #: the -device_pairs trainer (None on the other planes)
        self.dp_trainer: Optional[DevicePairsTrainer] = None
        #: the native tokenizer of the dictionary, built once in prepare
        #: (None without the native library: the loader's Python path)
        self.tokenizer: Optional[native.VocabTokenizer] = None
        self._world = WorldOwner()
        self.total_loss = 0.0
        self.total_pairs = 0
        #: per-block (word_count, pair_count, block loss) of the last train
        self.block_log: list = []
        #: seconds the last train waited on the block loader (host clock)
        self.loader_wait_s = 0.0

    # -- setup ----------------------------------------------------------------

    def prepare(self) -> None:
        opt = self.opt
        stop = set()
        if opt.stopwords and opt.sw_file:
            with open(opt.sw_file, encoding="utf-8") as f:
                stop = set(f.read().split())
        if opt.read_vocab_file:
            self.dictionary = Dictionary.load_vocab(opt.read_vocab_file, stop)
        else:
            self.dictionary = Dictionary(stop)
            self.dictionary.build_from_corpus(opt.train_file)
        self.dictionary.RemoveWordsLessThan(max(opt.min_count, 1))
        if self.dictionary.Size() == 0:
            raise ValueError("empty vocabulary after min_count pruning")
        if opt.total_words <= 0:
            opt.total_words = self.dictionary.WordCount()
        self.tokenizer = native.VocabTokenizer.create(
            self.dictionary.words())
        counts = self.dictionary.counts()
        self.sampler = Sampler(counts, seed=opt.seed)
        if opt.hs:
            self.huffman = HuffmanEncoder()
            self.huffman.BuildFromTermFrequency(counts)
        self._world.init_if_needed([f"-mv_device={opt.platform}"])
        with self._world.guard("wordembedding.prepare"):
            self.comm = Communicator(opt, self.dictionary.Size())
            if opt.device_pairs:
                self.dp_trainer = DevicePairsTrainer(opt, self.comm, counts,
                                                     huffman=self.huffman)

    # -- training -------------------------------------------------------------

    def train(self) -> float:
        """Returns the average pair loss of the run. Block losses stay on
        the device until a later block has been dispatched, so reading a
        loss never stalls the next block's launches. Under ``-trace`` the
        call is a ``we.train`` span over ``we.loader_wait`` (each pop of
        the block queue), ``we.block`` (a block's steps and the harvest
        after it) and ``we.harvest`` (the loss reads); the loader's spans
        are ``data.py``'s, the step's ``device_pairs.py``'s."""
        with ttrace.span("we.train", cat="we"):
            return self._train()

    def _train(self) -> float:
        opt = self.opt
        generator = PairGenerator(opt, self.dictionary, self.sampler,
                                  self.huffman)
        queue = BlockQueue(capacity=3 if opt.is_pipeline else 1)
        loader = start_loader(opt, self.dictionary, generator, queue,
                              opt.epoch, self.tokenizer)
        step = make_train_step(opt.use_adagrad)
        timer = Timer()
        words_done = 0
        self.total_loss = 0.0
        self.total_pairs = 0
        self.block_log = []
        self.loader_wait_s = 0.0
        pending = collections.deque()
        multiproc = multihost.process_count() > 1

        def pop_block() -> Optional[DataBlock]:
            with ttrace.span("we.loader_wait", cat="we"):
                t0 = time.perf_counter()
                block = queue.pop()
                self.loader_wait_s += time.perf_counter() - t0
            if not multiproc:
                return block
            pairs = (block is not None and opt.device_pairs
                     and block.tokens is not None)
            mine = ((block.tokens, block.token_sent) if pairs
                    else (np.empty(0, np.int32), np.empty(0, np.int32)))
            parts = multihost.host_allgather_objects_capped(
                (block is None,) + mine, "we_pop")
            if all(p[0] for p in parts):
                return None
            if any(p[0] for p in parts):
                # the gathered flags are the same on every rank, so every
                # rank fails here together instead of one stranding the
                # others in its next collective
                CHECK(opt.device_pairs,
                      "multi-process WordEmbedding with unequal per-rank "
                      "block streams needs -device_pairs 1 (empty filler "
                      "blocks); the host and device planes cannot run an "
                      "empty block: shard the corpus evenly")
            if block is None:
                block = DataBlock(word_count=0,
                                  tokens=np.empty(0, np.int32),
                                  token_sent=np.empty(0, np.int32))
            if opt.device_pairs:
                # every rank's (tokens, sentence ids), in rank order
                block._dp_agreed = [p[1:] for p in parts]
            return block

        def harvest(force: bool = False) -> None:
            with ttrace.span("we.harvest", cat="we"):
                while pending and (force or len(pending) >= 2):
                    loss, pairs, words = pending.popleft()
                    # -device_pairs blocks report both as device scalars
                    loss, pairs = float(loss), int(pairs)
                    self.total_loss += loss
                    self.total_pairs += pairs
                    self.block_log.append((words, pairs, loss))

        current = pop_block()
        prefetch = None
        next_block: Optional[DataBlock] = None
        while current is not None:
            if opt.is_pipeline:
                next_block = pop_block()
                # host-plane prefetch only: the device plane fetches with
                # kernels queued behind the current block's work
                if (next_block is not None and next_block.pair_count
                        and not opt.device_plane):
                    prefetch = self.comm.request_parameter_async(
                        next_block.input_rows, next_block.output_rows)
            with ttrace.span("we.block", cat="we"):
                loss, pairs = self._train_block(current, step)
                pending.append((loss, pairs, current.word_count))
                harvest()
            words_done += current.word_count
            self.comm.add_word_count(current.word_count)
            rate = words_done / max(timer.elapse(), 1e-9)
            Log.Info("[wordembedding] %d words (%.0f words/s), "
                     "avg pair loss %.4f, lr %.5f", words_done, rate,
                     self.total_loss / max(self.total_pairs, 1),
                     self._current_lr())
            if opt.is_pipeline:
                if next_block is not None and next_block.pair_count \
                        and prefetch is not None:
                    next_block._prefetched = self.comm.wait_parameter(
                        prefetch)
                current, prefetch = next_block, None
            else:
                current = pop_block()
        harvest(force=True)
        loader.join()  # unbounded-ok: loader terminates with the corpus
        return self.total_loss / max(self.total_pairs, 1)

    def _current_lr(self) -> float:
        opt = self.opt
        if opt.use_adagrad:
            return opt.init_learning_rate
        return decayed_lr(opt.init_learning_rate, self.comm.get_word_count(),
                          opt.total_words, opt.epoch)

    def _train_block(self, block: DataBlock, step) -> tuple:
        """One block through the train step loop. Returns (loss, pairs);
        the loss is a device scalar (harvested lazily)."""
        if self.opt.device_pairs and block.tokens is not None:
            # pairs made and trained on the device: the token stream is
            # the upload, and the trainer reports the pair count
            return self.dp_trainer.train_block(
                block.tokens, block.token_sent, self._current_lr(),
                agreed=getattr(block, "_dp_agreed", None))
        if not block.pair_count:
            return 0.0, 0
        pre = getattr(block, "_prefetched", None)
        if self.opt.device_plane:
            state, fetched = self.comm.request_parameter_device(
                block.input_rows, block.output_rows)
        elif pre is not None:
            state, fetched = pre
        else:
            state, fetched = self.comm.request_parameter(block.input_rows,
                                                         block.output_rows)
        dev = self.comm.device
        batches = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            device=dev, dtype=_BLOCK_DTYPES[k])
            for k, v in block.stacked.items()}
        # the lr as a float32 scalar: lr * grad rounds as the JAX step's
        # traced float32 lr does
        lr = torch.tensor(self._current_lr(), dtype=torch.float32)
        state, loss = train_block(step, state, batches, lr)
        if self.opt.device_plane:
            self.comm.add_delta_parameter_device(
                state, fetched, block.input_rows, block.output_rows)
        else:
            self.comm.add_delta_parameter(state, fetched, block.input_rows,
                                          block.output_rows)
        return loss, block.pair_count

    # -- export (word2vec format) ---------------------------------------------

    def save_embeddings(self, path: Optional[str] = None) -> None:
        path = path or self.opt.output_file
        emb = self.comm.pull_embeddings()
        words = self.dictionary.words()
        if self.opt.output_binary:
            with open(path, "wb") as f:
                f.write(f"{len(words)} {self.opt.embedding_size}\n".encode())
                for w, row in zip(words, emb):
                    f.write(w.encode("utf-8") + b" ")
                    f.write(np.asarray(row, np.float32).tobytes())
                    f.write(b"\n")
        else:
            with open(path, "w", encoding="utf-8") as f:
                f.write(f"{len(words)} {self.opt.embedding_size}\n")
                for w, row in zip(words, emb):
                    f.write(w + " " + " ".join(f"{x:.6f}" for x in row) + "\n")
        Log.Info("[wordembedding] saved %d x %d embeddings to %s",
                 len(words), self.opt.embedding_size, path)

    # -- lifecycle --------------------------------------------------------------

    def run(self) -> float:
        """Full job (reference Run). A raise after MV_Init shuts down the
        world this driver started; success leaves it up (close() ends
        it)."""
        self.prepare()
        with self._world.guard("wordembedding.run"):
            avg_loss = self.train()
            mv.MV_Barrier()
            if mv.MV_WorkerId() == 0:
                self.save_embeddings()
        return avg_loss

    def close(self) -> None:
        self._world.close()


def main(argv=None) -> int:
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    opt = Option.parse_args(argv)
    if not opt.train_file:
        Log.Error("usage: python -m multiverso_tpu_torch.models."
                  "wordembedding.distributed -train_file corpus.txt "
                  "[-size 100 ...] [-platform cuda|cpu]")
        return 1
    opt.print_args()
    we = DistributedWordEmbedding(opt)
    try:
        we.run()
    finally:
        we.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
