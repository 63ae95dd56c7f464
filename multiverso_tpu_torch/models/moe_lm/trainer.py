"""The MoE language model trained through the parameter tables' device plane.

``config_from_published(conf)`` reads the model's published ``config.json``
keys (DeepSeek-V3 names) and the chip's share: ``n_routed_experts`` the
experts held here, ``router_experts`` the layer's whole count,
``held_experts`` their ids, ``vocab_size`` the vocabulary ids held here;
``bias_update_speed`` (from the DeepSeek-V3 paper, not the config) the
balancing rule's gamma, 0 when absent. ``MoeLMTrainer(cfg, lr, init=...)``
trains it; ``step(tokens)`` takes a (batch, seq + 1) array of ids of the
slice.

The app brings the world up with ``MV_Init`` under the momentum updater and
keeps every parameter in tables through the binding's device route
(``binding/param_manager.py`` ``TorchParamManager(device_plane=True)``):
one ArrayTable a layer for its attention, norms, router and shared or dense
MLP, one for the final norm and the head; a MatrixTable a MoE layer with
one row an expert held here (its gate, up and down matrices flattened); a
MatrixTable of the embedding slice, one row a token id. A step runs forward
and backward, then pushes ``lr`` times the gradient: every array table
whole (``device_update``), the rows of the experts that took tokens and the
step's distinct input ids (``device_apply_rows``). The server's momentum
updater applies them in place on the card, and the next step computes on
the tables' new state. The MoE layers' correction biases live in one more
ArrayTable under the add updater: a step pushes each layer's balancing step
(``device_update``, summed over the ranks), so every replica routes on the
same biases.

Spans: ``moe.step``, ``moe.forward``, ``moe.backward``, ``moe.sync``, and in
each MoE layer ``moe.route`` and ``moe.experts``. Counters: ``moe.tokens``
(tokens trained), ``moe.routed_pairs`` (token-expert pairs on held
experts), ``moe.experts_pushed`` (expert rows pushed), ``moe.sync_s`` (the
sync phase's seconds on the device, first to last kernel, by CUDA events;
the host clock on the CPU).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from multiverso_tpu_torch import api
from multiverso_tpu_torch.binding.param_manager import (DeviceTableParams,
                                                        TorchParamManager)
from multiverso_tpu_torch.models.moe_lm.model import MoeLM, MoeLMConfig
from multiverso_tpu_torch.tables import ArrayTableOption
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.updaters.base import AddOption
from multiverso_tpu_torch.utils.log import CHECK
from multiverso_tpu_torch.utils.world import WorldOwner

#: the published keys whose values this model implements, and those values
FIXED_KEYS = {"q_lora_rank": None, "scoring_func": "sigmoid",
              "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
              "norm_topk_prob": True, "hidden_act": "silu",
              "tie_word_embeddings": False, "attention_bias": False,
              "moe_layer_freq": 1}


def config_from_published(conf: dict) -> MoeLMConfig:
    """A ``MoeLMConfig`` from DeepSeek-V3 ``config.json`` keys and the
    chip's share (``router_experts``, ``held_experts``; module docstring)."""
    for key, want in FIXED_KEYS.items():
        CHECK(conf.get(key, want) == want,
              f"{key}={conf.get(key)!r}: this model implements {want!r}")
    CHECK(conf.get("rope_scaling") is None, "no rope scaling is implemented")
    held = tuple(conf["held_experts"])
    CHECK(len(held) == conf["n_routed_experts"],
          "n_routed_experts counts the held experts")
    return MoeLMConfig(
        hidden=conf["hidden_size"], layers=conf["num_hidden_layers"],
        first_dense=conf["first_k_dense_replace"],
        dense_width=conf["intermediate_size"],
        expert_width=conf["moe_intermediate_size"],
        shared_experts=conf["n_shared_experts"],
        heads=conf["num_attention_heads"],
        qk_nope=conf["qk_nope_head_dim"], qk_rope=conf["qk_rope_head_dim"],
        v_dim=conf["v_head_dim"], kv_rank=conf["kv_lora_rank"],
        rope_theta=float(conf["rope_theta"]), eps=conf["rms_norm_eps"],
        experts=conf["router_experts"], top_k=conf["num_experts_per_tok"],
        route_scale=conf["routed_scaling_factor"], held=held,
        vocab=conf["vocab_size"],
        bias_update_speed=conf.get("bias_update_speed", 0.0))


def table_groups(model: MoeLM) -> dict:
    """``DeviceTableParams``' groups: arrays, stacks and row parameters."""
    arrays: Dict[str, List[str]] = {}
    stacks: Dict[str, List[List[str]]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            l = parts[1]
            if parts[2:4] == ["moe", "experts"]:
                rows = stacks.setdefault(f"experts.{l}", [])
                j = int(parts[4])
                if j == len(rows):
                    rows.append([])
                rows[j].append(name)
            else:
                arrays.setdefault(f"layer.{l}", []).append(name)
        elif name in ("final_norm", "head"):
            arrays.setdefault("head", []).append(name)
    return {"arrays": arrays, "stacks": stacks,
            "row_params": {"embed": "embed"}}


class MoeLMTrainer:
    """One trainer of the model on this process's tables (module
    docstring). ``init(name, shape, device)`` gives each parameter's and
    each correction bias's starting value. ``matmul_dtype`` is autocast's
    type for the matmuls (None: float32)."""

    def __init__(self, cfg: MoeLMConfig, lr: float, init: Callable,
                 momentum: float = 0.9, device: str = "cuda",
                 matmul_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.cfg, self.lr = cfg, lr
        self.matmul_dtype = matmul_dtype
        self._world = WorldOwner()
        self._world.init_if_needed([f"-mv_device={device}",
                                    "-updater_type=momentum"])
        with self._world.guard("moe_lm.init"):
            from multiverso_tpu_torch.zoo import Zoo
            self.device = Zoo.Get().device_ctx.device
            with torch.device(self.device):
                self.model = MoeLM(cfg)
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    p.copy_(init(name, p.shape, self.device))
                for name, b in self.model.named_buffers():
                    if name.endswith(".bias"):
                        b.copy_(init(name, b.shape, self.device))
            self.manager = TorchParamManager(
                self.model, device_plane=True, lr=lr,
                option=AddOption(momentum=momentum, learning_rate=lr),
                groups=dict(table_groups(self.model),
                            updater_type="momentum"))
            self.params: DeviceTableParams = self.manager.device_params
            self._moe = self.model.moe_layers()
            self._expert_tables = [n for n in self.params.tables
                                   if n.startswith("experts.")]
            self._bias = self._bias_table()
            self._cuda = self.device.type == "cuda"
            self._pending: list = []
            self.sync_s = 0.0
            self._c = {n: tmetrics.counter(n) for n in (
                "moe.tokens", "moe.routed_pairs", "moe.experts_pushed",
                "moe.sync_s")}
            #: what a recorded step saw (``step(record=True)``)
            self.recorded: dict = {}

    def _bias_table(self):
        """The MoE layers' correction biases, layer after layer, in one
        ArrayTable under the add updater (None without MoE layers), the
        layers' ``bias`` buffers views of its state."""
        if not self._moe:
            return None
        start = torch.cat([m.bias for m in self._moe])
        srv = api.MV_CreateTable(ArrayTableOption(
            size=start.numel(), updater_type="default")).server()
        srv.device_state()["data"][: start.numel()].copy_(start)
        self._view_biases(srv)
        return srv

    def _view_biases(self, srv) -> None:
        data, e = srv.device_state()["data"], self.cfg.experts
        for i, m in enumerate(self._moe):
            m.bias = data[i * e:(i + 1) * e]

    def _push_biases(self) -> None:
        """Add each layer's balancing step to its bias in the table."""
        steps = [m.bias_step for m in self._moe]
        if self._bias is None or any(s is None for s in steps):
            return
        srv = self._bias
        delta = torch.nn.functional.pad(torch.cat(steps),
                                        (0, srv.padded - srv.size))
        srv.device_set_state(srv.device_update(
            srv.device_state(), delta, AddOption().as_tensors()))
        self._view_biases(srv)
        for m in self._moe:
            m.bias_step = None

    def step(self, tokens: np.ndarray, record: bool = False) -> torch.Tensor:
        """Train one batch, (batch, seq + 1) ids of the slice; returns the
        mean loss as a device scalar (no host read). With ``record`` the
        step keeps, in ``recorded``, each MoE layer's (tokens, held)
        choice mask and each parameter's pushed delta's squared norm."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int64)
        B, S1 = tokens.shape
        with ttrace.span("moe.step", cat="moe"):
            self._resolve(wait=False)
            ids = torch.from_numpy(tokens).to(self.device)
            rows = np.unique(tokens[:, :-1])
            for m in self._moe:
                m.record = record
            with ttrace.span("moe.forward", cat="moe"):
                with torch.autocast(self.device.type,
                                    dtype=self.matmul_dtype or torch.float32,
                                    enabled=self.matmul_dtype is not None):
                    loss = self.model.loss(ids)
            with ttrace.span("moe.backward", cat="moe"):
                loss.backward()
            counts = [m.counts for m in self._moe]
            experts = {t: [j for j, c in enumerate(cs) if c]
                       for t, cs in zip(self._expert_tables, counts)}
            if record:
                self._record()
            with ttrace.span("moe.sync", cat="moe"):
                t0 = time.perf_counter()
                ev = self._event()
                self.manager.sync_all_param(rows=dict(experts, embed=rows))
                self._push_biases()
                self._pending.append((ev, self._event(), t0))
        pairs = sum(sum(cs) for cs in counts)
        self._c["moe.tokens"].inc(B * (S1 - 1))
        self._c["moe.routed_pairs"].inc(pairs)
        self._c["moe.experts_pushed"].inc(sum(map(len, experts.values())))
        return loss.detach()

    def counters(self) -> dict:
        """The app's counters' values, by name."""
        return {n: c.value for n, c in self._c.items()}

    def _event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _resolve(self, wait: bool) -> None:
        """Add the finished syncs' seconds to ``sync_s`` (and its
        counter); ``wait`` waits for every one."""
        while self._pending:
            start, end, t0 = self._pending[0]
            if end is None:
                secs = time.perf_counter() - t0
            else:
                if not wait and not end.query():
                    return
                end.synchronize()
                secs = start.elapsed_time(end) / 1e3
            self._pending.pop(0)
            self.sync_s += secs
            self._c["moe.sync_s"].inc(secs)

    def flush(self) -> None:
        """Wait for the card and count every sync's seconds."""
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self._resolve(wait=True)

    def _record(self) -> None:
        """Before the sync: the pushed deltas (``lr`` times each gradient)
        and the choice masks."""
        names = list(self.params.params)
        sq = torch.stack([(self.params.params[n].grad * self.lr).float()
                          .pow(2).sum() for n in names]).tolist()
        self.recorded = {
            "held_masks": [m.held_mask for m in self._moe],
            "delta_sq": dict(zip(names, sq))}
        for m in self._moe:
            m.record, m.held_mask = False, None

    def close(self) -> None:
        self.model = self.params = self.manager = self._moe = None
        self._bias = None
        self._world.close()
