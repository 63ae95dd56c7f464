"""Driver of ``moonlight_16b_a3b``: one chip's share of Moonlight-16B-A3B
(DeepSeek-V3 MoE) trained through the port's parameter tables on the
device plane (``multiverso_tpu_torch.models.moe_lm``).

The app is imported first thing in ``Cell``, before anything is allocated:
a checkout without it fails there, at once. Set-up builds the trainer from
the seed's weights (``reference/moonlight_16b_a3b.py`` ``start_values``:
the program is handed them, the correction biases balanced for them) and trains the first ``check_steps`` steps,
recording what the comparison reads: each step's loss, the token-expert
pairs on held experts (the app's counter), at step 1 each parameter's
pushed delta and each MoE layer's choice of held experts, after the last
step each parameter's change (kept in host memory until the comparison).
The window then trains step after step on the seed's tokens, one trainer
thread in a closed loop, and counts whole steps; it ends with the last
step's sync and ``torch.cuda.synchronize()``. After the window the
benchmark checks the window's own work (the tokens against the app's
counter, every table finite and moved), closes the app and follows the
checked steps with the plain reference, one sequence at a time.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from portbench.lib import core, roofline_moe
from portbench.lib.peaks import peaks

REF = core.load_module(Path(__file__).resolve().parents[1] / "reference"
                       / "moonlight_16b_a3b.py", "portbench_reference_moe")


def table_sumsq(tr, groups: dict) -> dict:
    """Each table's sum of squares in float64 (not finite where an
    element is not), by the reference's tables of parameter names."""
    params = tr.params.params
    return {t: sum(float(params[n].detach().double().pow(2).sum())
                   for n in names) for t, names in groups.items()}


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, workdir: str,
                 device: str):
        # first, before anything is allocated: a checkout without the app
        # fails here at once
        from multiverso_tpu_torch.models.moe_lm import (
            MoeLMTrainer, config_from_published)
        import torch
        self.tr = None
        self.torch, self.cfg, self.params = torch, cfg, params
        self.seed, self.device = seed, device
        self.groups = REF.tables(cfg)
        dtype = {"bfloat16": torch.bfloat16, "float32": None}[
            cfg["matmul_dtype"]]
        self.init = REF.start_values(cfg, params, seed,
                                     torch.device(device))
        self.tr = MoeLMTrainer(
            config_from_published(cfg), lr=cfg["lr"],
            momentum=cfg["momentum"], device=device, matmul_dtype=dtype,
            init=self.init)
        try:
            self._first_steps(params["check_steps"])
        except BaseException:
            self.close()
            raise
        self.sumsq0 = table_sumsq(self.tr, self.groups)

    def _first_steps(self, steps: int) -> None:
        torch, tr = self.torch, self.tr
        c0 = tr.counters()
        losses = []
        for k in range(steps):
            losses.append(tr.step(self._tokens(k), record=k == 0))
            if k == 0:
                rec = tr.recorded
        tr.flush()
        self.prog = {"loss": [float(l) for l in losses],
                     "pairs": tr.counters()["moe.routed_pairs"]
                     - c0["moe.routed_pairs"],
                     "delta_sq": rec["delta_sq"],
                     "held_masks": rec["held_masks"]}
        # each parameter's change after the checked steps, in host memory
        # until the comparison (set-up work: no step runs meanwhile)
        change = {}
        with torch.no_grad():
            for n, p in tr.params.params.items():
                d = p.detach() - self.init(n, p.shape, p.device)
                host = torch.empty(d.shape, dtype=d.dtype,
                                   pin_memory=d.is_cuda)
                change[n] = host.copy_(d)
        self.prog["change"] = change
        self.steps_done = steps

    def _tokens(self, step: int) -> np.ndarray:
        return REF.tokens(self.cfg, self.params, self.seed, step)

    def window(self, seconds: float, phases) -> dict:
        torch, tr = self.torch, self.tr
        c0, sync0 = tr.counters(), tr.sync_s
        losses, ends, pairs = [], [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            toks = self._tokens(self.steps_done)
            t0 = time.perf_counter()
            losses.append(tr.step(toks))
            ends.append(time.perf_counter())
            phases.add("moe.step", t0, ends[-1])
            pairs.append(tr.counters()["moe.routed_pairs"])
            self.steps_done += 1
        tr.flush()
        wall = time.perf_counter() - t_start
        c1 = tr.counters()
        n = len(losses)
        B, S = self.params["batch"], self.params["seq"]
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        self.window_tokens = (n * B * S, c1["moe.tokens"] - c0["moe.tokens"])
        self.window_pairs = c1["moe.routed_pairs"] - c0["moe.routed_pairs"]
        self.window_steps = n
        # for the diag line: each step's host seconds (return to return)
        # and token-expert pairs on held experts
        self.steps_seen = {
            "step_s": [round(b - a, 4) for a, b in
                       zip([t_start] + ends[:-1], ends)],
            "pairs": [int(b - a) for a, b in
                      zip([c0["moe.routed_pairs"]] + pairs[:-1], pairs)]}
        self.record = {"attempted": n, "failed": failed, "window_s": wall,
                "we": {"words": n * B * S},
                "moe": {"steps": n, "tokens": n * B * S,
                        "routed_pairs": self.window_pairs,
                        "experts_pushed": c1["moe.experts_pushed"]
                        - c0["moe.experts_pushed"],
                        "sync_s": tr.sync_s - sync0,
                        "last_loss": float(losses[-1])}}
        return self.record

    def per_layer(self, rec: dict) -> None:
        """The window's FLOPs from the shapes, the tokens and the app's
        count of token-expert pairs on held experts (checked against the
        reference's routing on the checked steps); the least bytes of its
        pushed rows from the app's count of expert rows pushed and the
        window's steps' distinct token ids, drawn again here."""
        B, S = self.params["batch"], self.params["seq"]
        rec["moe"]["flops"] = roofline_moe.step_flops(
            self.cfg, B, S, self.window_pairs / max(self.window_steps, 1)) \
            * self.window_steps
        first = self.steps_done - self.window_steps
        token_rows = sum(len(np.unique(self._tokens(k)[:, :-1]))
                         for k in range(first, self.steps_done))
        rec["moe"]["row_bytes"] = roofline_moe.row_bytes(
            self.cfg, rec["moe"]["experts_pushed"], token_rows)
        if self.device == "cuda":
            rec["moe"]["peaks"] = peaks(self.torch.cuda.get_device_name(0))

    def verify(self) -> dict:
        torch = self.torch
        sumsq = table_sumsq(self.tr, self.groups)
        given, counted = self.window_tokens
        window = {"window_tokens_gap": float(abs(given - counted)),
                  "tables_nonfinite": float(sum(not math.isfinite(v)
                                                for v in sumsq.values())),
                  "tables_unmoved": float(sum(self.sumsq0[t] == sumsq[t]
                                              for t in sumsq))}
        self.close()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        ref = REF.follow(self.cfg, self.params, self.seed,
                         torch.device(self.device),
                         self.params["check_steps"], init=self.init)
        worst: dict = {}
        values = readings(self.prog, ref, self.groups, worst)
        # the harness prints it on stderr: which group and table read worst
        self.record["diag"] = dict(worst, pairs=[self.prog["pairs"],
                                                 sum(ref["pairs"])],
                                   window=self.steps_seen)
        return checks(dict(values, **window), self.params["limits"])

    def close(self) -> None:
        if self.tr is not None:
            self.tr.close()
            self.tr = None


def gap(p: float, r: float, scale: float) -> float:
    """|p - r| / scale; a gap that is not finite (a NaN or an infinity on
    either side) reads as the largest float, so it fails every limit."""
    g = abs(p - r) / scale if scale else (0.0 if p == r else math.inf)
    return g if math.isfinite(g) else sys.float_info.max


def readings(prog: dict, ref: dict, groups: dict,
             worst: Optional[dict] = None) -> dict:
    """The numbers compared, each a gap of the program's reading from the
    reference's:

    * ``loss_gap``: the worst checked step's loss, relative;
    * ``grad_gap``: the worst group's pushed delta norm at step 1,
      relative: each dense table, each held expert (a row), the embedding;
    * ``change_gap``: the worst table's change after the last checked
      step, the norm of the difference over the reference's norm;
    * ``route_differ``: the token-held-expert assignments of step 1 that
      only one side made, over both sides' assignments;
    * ``pairs_gap``: the app's count of token-expert pairs on held experts
      over the checked steps against the reference's routing, relative.

    ``worst`` (when given) takes the group and table that set ``grad_gap``
    and ``change_gap``.
    """
    worst = {} if worst is None else worst
    loss = max(gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"]))
    grad = 0.0
    for t, names in groups.items():
        if t.startswith("experts."):
            rows = {}
            for n in names:
                rows.setdefault(n.split(".")[4], []).append(n)
            sets = list(rows.values())
        else:
            sets = [names]
        for s in sets:
            gp = math.sqrt(sum(prog["delta_sq"][n] for n in s))
            gr = math.sqrt(sum(ref["delta_sq"][n] for n in s))
            if gap(gp, gr, gr) > grad:
                grad = gap(gp, gr, gr)
                worst["grad"] = [s[0], gp, gr]
    change = 0.0
    for t, names in groups.items():
        diff = norm = 0.0
        for n in names:
            r = ref["change"][n]
            p = prog["change"][n].to(r.device)
            diff += float((p.double() - r.double()).pow(2).sum())
            norm += float(r.double().pow(2).sum())
        if gap(math.sqrt(diff), 0.0, math.sqrt(norm)) > change:
            change = gap(math.sqrt(diff), 0.0, math.sqrt(norm))
            worst["change"] = [t, math.sqrt(norm)]
    differ = both = 0
    for mp, mr in zip(prog["held_masks"], ref["held_masks"]):
        mp = mp.to(mr.device)
        # a side that routed fewer tokens made none of the rest's choices
        n = max(len(mp), len(mr))
        mp, mr = _tokens_padded(mp, n), _tokens_padded(mr, n)
        differ += int((mp ^ mr).sum())
        both += int(mp.sum()) + int(mr.sum())
    route = differ / both if both else 0.0
    pairs = gap(prog["pairs"], sum(ref["pairs"]), sum(ref["pairs"]))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "route_differ": route, "pairs_gap": pairs}


def _tokens_padded(mask, n: int):
    """A (tokens, held) choice mask with rows of no choice up to ``n``."""
    out = mask.new_zeros((n,) + tuple(mask.shape[1:]))
    out[: len(mask)] = mask
    return out


def checks(values: dict, limits: dict) -> dict:
    """The readings that have a limit (``limits``, from the workload
    file)."""
    return {k: {"value": v, "limit": limits[k]}
            for k, v in values.items() if k in limits}
