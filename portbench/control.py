#!/usr/bin/env python3
"""The controls and faults behind each cell's limits.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--out F]

Puts the plain reference in the program's place, computed one precision
below the configuration's (bfloat16 tables and arithmetic; for the
WordEmbedding cells also float32 with TF32 allowed on the card's
matmuls, which reads as the program's own runs do), and with each fault
a cell's comparison has to catch planted in it (a state left unchanged, half
of each batch left out, a token altered where it is produced), at the
cell's own sizes; prints every number the cell compares, beside its
limit, for each seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.lib import core, traffic  # noqa: E402

#: rounds a worker runs under the PS stand-in: four passes over a pool of
#: 32, at which every control and fault reads 16 or more elements unequal
#: to the reference, against a limit of 0 (PERF.md)
PS_ROUNDS = 128


def _we(cfg, params, seed, device) -> dict:
    import torch
    ref_mod = core.load_module(ROOT / "portbench" / "reference"
                               / "we_sgns_1bw.py", "portbench_reference_we")
    drv = core.load_module(ROOT / "portbench" / "drivers" / "we_sgns_1bw.py",
                           "portbench_driver_we")
    steps = params["check_steps"]
    counts = traffic.zipf_counts(cfg["vocab_size"], cfg["corpus_words"],
                                 cfg["zipf_s"])
    blocks = traffic.we_blocks(seed, cfg, cfg["corpus_blocks"])[:steps]
    dev = torch.device(device)

    def follow(**kw):
        out = ref_mod.follow(counts, blocks, cfg, params, seed, dev, **kw)
        out.pop("ie0")
        return out

    ref = follow()
    runs = {"control_tf32": follow(allow_tf32=True),
            "control_bf16": follow(dtype=torch.bfloat16),
            "fault_half": follow(fault="half"),
            "fault_token": follow(fault="token")}
    out = {k: drv.readings(v, ref) for k, v in runs.items()}
    # a step that returns its state unchanged moves no leaf: every change
    # reads 1 (needs no run)
    out["fault_unchanged"] = {"change_gap": 1.0}
    return out


def _ps(cfg, params, seed, device) -> dict:
    import torch
    ref_mod = core.load_module(ROOT / "portbench" / "reference"
                               / "ps_matrix_perf.py", "portbench_reference_ps")
    W, verbs = params["workers"], params["round"]
    rows, cols = cfg["num_rows"], cfg["num_cols"]
    pools = [traffic.ps_pool(seed, w, cfg, params) for w in range(W)]
    sample = [traffic.ps_sample(seed, w, params["sample_every"])
              for w in range(W)]
    own = [traffic.own_rows(rows, W, w) for w in range(W)]
    n = PS_ROUNDS
    dev = torch.device(device)

    def stand_in(dtype=torch.float32, fault=""):
        """The reference in the program's place: what its Gets return on
        the sampled rounds, and its final table."""
        table = torch.zeros((rows, cols), dtype=dtype, device=dev)
        kept = [{} for _ in range(W)]
        for w in range(W):
            lo, hi = own[w]
            for i in range(n):
                ids, d = pools[w][i % len(pools[w])]
                ids_t = torch.from_numpy(ids).to(dev).long()
                d_t = torch.from_numpy(d).to(dev, dtype)
                got = []
                for verb in verbs:
                    if verb == "AddRows":
                        if fault == "half":
                            h = len(ids) // 2
                            table.index_add_(0, ids_t[:h], d_t[:h])
                        elif fault != "unchanged":
                            table.index_add_(0, ids_t, d_t)
                    elif sample[w][i]:
                        r = (table[ids_t] if verb == "GetRows"
                             else table[lo:hi]).float().cpu().numpy().copy()
                        if fault == "token":
                            r.reshape(-1)[0] += 1
                        got.append(r)
                if sample[w][i]:
                    kept[w][i] = got
        return kept, table.float().cpu().numpy()

    out = {}
    for name, kw in (("control_bf16", {"dtype": torch.bfloat16}),
                     ("fault_unchanged", {"fault": "unchanged"}),
                     ("fault_half", {"fault": "half"}),
                     ("fault_token", {"fault": "token"})):
        kept, final = stand_in(**kw)
        ref, bad = ref_mod.replay(rows, cols, pools, [n] * W, kept, verbs,
                                  own, dev)
        out[name] = {"gets_differ": float(bad),
                     "table_differs": float((final != ref).sum())}
    return out


def run(cell: str, cfg: dict, params: dict, seed: int, device: str) -> dict:
    """-> {"control": {number: {"value", "limit"}} for the lower-precision
    control, and each reading of every control and fault}."""
    limits = params["limits"]
    fn = _we if cell.startswith("we_sgns_1bw") else _ps
    res = fn(cfg, params, seed, device)
    # float32 with TF32 allowed reads as the program's own runs do (the
    # step's batched products are 1 x D by D x (1 + K)); bfloat16, the
    # step below, is the control (PERF.md)
    return {"control": {k: {"value": v, "limit": limits[k]}
                        for k, v in res["control_bf16"].items()
                        if k in limits},
            "readings": res}


def main(argv=None) -> int:
    import argparse
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    wl, cfg, _ = core.load_cell(args.workload)
    results = {}
    for s in args.seeds.split(","):
        res = run(args.workload, cfg, wl["params"], int(s), "cuda")
        results[s] = res
        print(json.dumps({"seed": int(s), **res}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
