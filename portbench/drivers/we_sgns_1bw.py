"""Driver of ``we_sgns_1bw``: WordEmbedding (word2vec skip-gram, negative
sampling, AdaGrad, pairs made on the device) trained through
``DistributedWordEmbedding.train()``.

Set-up builds one app (``prepare()``: the dictionary, the four tables,
the slot table) and drives it through the first ``check_steps`` steps,
one loader block each (a corpus file of one block per ``train()`` call),
recording what the comparison needs: each step's loss and valid lanes,
the AdaGrad state's norms after step 1, the input table after the last
step. The window then calls ``train()`` again and again on the corpus of
all blocks, ``epochs_per_call`` passes a call: the same app, the same
call and loader. After the window the benchmark checks the window's own
work (the words it handed the app against the app's block log, and every
table finite and moved by the window), the app is closed and the plain
reference follows the checked steps (``portbench/reference/we_sgns_1bw.py``).
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import numpy as np

from portbench.lib import core, roofline, traffic
from portbench.lib.peaks import peaks

REF = core.load_module(Path(__file__).resolve().parents[1] / "reference"
                       / "we_sgns_1bw.py", "portbench_reference_we")


def options(cfg: dict, params: dict, seed: int, vocab: str, train: str,
            out: str, device: str) -> list:
    return ["-train_file", train, "-read_vocab", vocab, "-output", out,
            "-size", str(cfg["size"]), "-window", str(cfg["window"]),
            "-negative", str(cfg["negative"]), "-cbow", str(cfg["cbow"]),
            "-hs", str(cfg["hs"]), "-sample", str(cfg["sample"]),
            "-min_count", str(cfg["min_count"]),
            "-use_adagrad", str(cfg["use_adagrad"]), "-lr", str(cfg["lr"]),
            "-device_pairs", str(cfg["device_pairs"]),
            "-is_pipeline", str(cfg["is_pipeline"]),
            "-data_block_size", str(cfg["data_block_size"]),
            "-pair_batch", str(params["pair_batch"]), "-epoch", "1",
            "-threads", "1", "-seed", str(seed), "-platform", device]


def logical_views(srv) -> list:
    """A matrix server table's logical rows as views of its storage, one
    per shard block (the storage holds a trash row after each block and
    padded columns)."""
    st = srv.state["data"]
    blocks = st.view(srv.num_servers, srv.shard_rows, st.shape[1])
    views, left = [], srv.num_rows
    for s in range(srv.num_servers):
        n = min(srv.block_rows, left)
        views.append(blocks[s, :n, :srv.num_cols])
        left -= n
    return views


def total(views, square: bool, rows: int = 1 << 16) -> float:
    """The sum of the views' elements (or of their squares), accumulated
    in float64 by row chunks."""
    acc = 0.0
    for v in views:
        for s in range(0, v.shape[0], rows):
            x = v[s:s + rows].double()
            acc += float((x * x if square else x).sum())
    return acc


def table_sumsq(comm) -> list:
    """The sum of squares of each of the four tables (input, output and
    their AdaGrad states), in float64: not finite where an element is
    not."""
    return [total(logical_views(t.server()), True)
            for t in (comm.input_table, comm.output_table, comm.ie_g2_table,
                      comm.eo_g2_table)]


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, workdir: str,
                 device: str):
        import torch
        from multiverso_tpu_torch.models.wordembedding.distributed import \
            DistributedWordEmbedding
        from multiverso_tpu_torch.models.wordembedding.option import Option
        self.torch, self.cfg, self.params = torch, cfg, params
        self.seed, self.device = seed, device
        self.inputs = traffic.we_inputs(seed, cfg, cfg["corpus_blocks"],
                                        workdir)
        self.opt = Option.parse_args(options(
            cfg, params, seed, self.inputs["vocab"],
            self.inputs["step_files"][0], workdir + "/vectors.txt", device))
        self.we = DistributedWordEmbedding(self.opt)
        try:
            self._first_steps(params["check_steps"])
        except BaseException:
            self.close()
            raise
        self.opt.train_file = self.inputs["corpus"]
        self.opt.epoch = params["epochs_per_call"]
        self.call_words = params["epochs_per_call"] * sum(
            b.size for b in self.inputs["blocks"])
        self.sumsq0 = table_sumsq(self.we.comm)

    def _first_steps(self, steps: int) -> None:
        """``prepare()``, then the first ``steps`` steps through ``train()``,
        one loader block each, and what the comparison reads of them."""
        self.we.prepare()
        self.prog = {"loss": [], "pairs": []}
        for k in range(steps):
            self.opt.train_file = self.inputs["step_files"][k]
            self.we.train()
            (_, pairs, loss), = self.we.block_log
            self.prog["loss"].append(loss)
            self.prog["pairs"].append(pairs)
            if k == 0:
                # the gradient norm from the AdaGrad state after one
                # step: sqrt of the summed squared gradients
                self.prog["grad"] = {
                    "ie": total(logical_views(self.we.comm.ie_g2_table
                                              .server()), False) ** 0.5,
                    "eo": total(logical_views(self.we.comm.eo_g2_table
                                              .server()), False) ** 0.5}
        self.prog["eo_change"] = total(logical_views(
            self.we.comm.output_table.server()), True) ** 0.5
        self.prog["ie_after"] = [v.to("cpu", copy=True) for v in logical_views(
            self.we.comm.input_table.server())]
        self.blocks_done = steps

    def window(self, seconds: float, phases) -> dict:
        torch = self.torch
        we, tr = self.we, self.we.dp_trainer
        batches0 = tr.batches
        calls = logged = blocks = 0
        wait = 0.0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            we.train()
            phases.add("we.train", t0, time.perf_counter())
            calls += 1
            logged += sum(w for w, _, _ in we.block_log)
            blocks += len(we.block_log)
            wait += we.loader_wait_s
        if self.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        self.window_blocks = blocks
        self.window_words = (calls * self.call_words, logged)
        return {"attempted": blocks, "failed": 0, "window_s": wall,
                "we": {"words": calls * self.call_words, "blocks": blocks,
                       "calls": calls, "loader_wait_s": wait,
                       "batches": tr.batches - batches0}}

    def per_layer(self, rec: dict) -> None:
        """The window's work counted by the benchmark from the tokens and
        the draws (never the program's counters): valid lanes, and each
        batch's unique rows of the input and output tables."""
        torch = self.torch
        cfg, B = self.cfg, self.params["pair_batch"]
        W, K, D = cfg["window"], cfg["negative"], cfg["size"]
        V = cfg["vocab_size"]
        dev = torch.device(self.device)
        slots = REF.slot_table(self.inputs["counts"], dev)
        nblk = len(self.inputs["blocks"])
        lanes_n = rows_in = rows_out = 0
        for j in range(self.window_blocks):
            ids_np, sent_np = REF.block_tokens(self.inputs["blocks"][j % nblk])
            ids = torch.from_numpy(ids_np).to(dev).long()
            sent = torch.from_numpy(sent_np).to(dev).long()
            b, d = REF.draws(self.seed, self.blocks_done + 1 + j,
                             len(ids_np), W, K, slots.shape[0], dev)
            valid, center, context = REF.lanes(ids, sent, b, W)
            batch = torch.arange(valid.shape[0], device=dev) // B
            negs = slots[d].long()
            v = valid.nonzero().squeeze(1)
            lanes_n += len(v)
            rows_in += len(torch.unique(batch[v] * V + context[v]))
            outs = torch.cat([center[v, None], negs[v]], 1)
            rows_out += len(torch.unique((batch[v, None] * V + outs)
                                         .reshape(-1)))
        rows = rows_in + rows_out
        rec["we"].update(flops=roofline.we_flops(lanes_n, rows, D, K),
                         bytes=roofline.we_bytes(lanes_n, rows, D, K))
        if self.device == "cuda":
            rec["we"]["peaks"] = peaks(torch.cuda.get_device_name(0))

    def verify(self) -> dict:
        torch = self.torch
        sumsq = table_sumsq(self.we.comm)
        given, logged = self.window_words
        window = {"window_words_gap": float(abs(given - logged)),
                  "tables_nonfinite": float(sum(not math.isfinite(v)
                                                for v in sumsq)),
                  "tables_unmoved": float(sum(a == b for a, b in
                                              zip(self.sumsq0, sumsq)))}
        self.we.close()
        self.we = None
        if self.device == "cuda":
            torch.cuda.empty_cache()
        steps = self.params["check_steps"]
        ref = REF.follow(self.inputs["counts"], self.inputs["blocks"][:steps],
                         self.cfg, self.params, self.seed,
                         torch.device(self.device))
        ie_after = torch.cat(self.prog.pop("ie_after"))
        prog = dict(self.prog, change={
            "ie": REF.norm_diff(ref.pop("ie0"), ie_after),
            "eo": self.prog["eo_change"]})
        return checks(dict(readings(prog, ref), **window),
                      self.params["limits"])

    def close(self) -> None:
        if self.we is not None:
            self.we.close()
            self.we = None


def gap(p: float, r: float, scale: float) -> float:
    """|p - r| / scale; a gap that is not finite (a NaN or an infinity on
    either side) reads as the largest float, so it fails every limit."""
    g = abs(p - r) / scale
    return g if math.isfinite(g) else sys.float_info.max


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared, each a gap of the program's reading from the
    reference's: the worst step's loss (relative), the worst step's valid
    lanes (exact), the worst leaf's gradient norm after step 1 and change
    after the last step (relative to the larger of the leaf's reference
    norm and the median leaf's). A leaf whose reference gradient is under
    a thousandth of the median leaf's is left out of the change."""
    loss = max(gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"]))
    pairs = max(gap(p, r, 1.0) for p, r in zip(prog["pairs"], ref["pairs"]))
    leaves = sorted(ref["grad"])
    gmed = float(np.median([ref["grad"][k] for k in leaves]))
    cmed = float(np.median([ref["change"][k] for k in leaves]))
    grad = max(gap(prog["grad"][k], ref["grad"][k], max(ref["grad"][k], gmed))
               for k in leaves)
    moved = [k for k in leaves if ref["grad"][k] >= 1e-3 * gmed]
    change = max(gap(prog["change"][k], ref["change"][k],
                     max(ref["change"][k], cmed)) for k in moved)
    return {"loss_gap": loss, "lanes_gap": pairs, "grad_gap": grad,
            "change_gap": change}


def checks(values: dict, limits: dict) -> dict:
    """The readings that have a limit (``limits``, from the workload
    file). ``lanes_gap`` has none: no control or fault moves it."""
    return {k: {"value": v, "limit": limits[k]}
            for k, v in values.items() if k in limits}
