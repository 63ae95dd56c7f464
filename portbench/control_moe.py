#!/usr/bin/env python3
"""The control and the faults behind the MoE cell's limits.

    python3 portbench/control_moe.py --seeds 1,2,3 [--faults expert,scale,half]
        [--out F]

For each seed: the plain reference in the program's place with the tables
and the momentum state kept in bfloat16, one precision below the float32
the configuration states (``control``; its change is read from its own
bfloat16 start), against the float32 reference, through the cell's checks;
then the cell's whole run with each fault named in ``--faults`` planted in
the program (``expert``: a held expert's output dropped; ``scale``: the
routing scale dropped; ``half``: half of each step's sequences left out of
the loss), at the cell's own sizes. Prints every number the cell compares, beside its limit, and
whether the run would be ``correct``. The benchmark's runs never run
this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.lib import core  # noqa: E402

CELL = "moonlight_16b_a3b.s8k_x8"


def _modules():
    ref = core.load_module(ROOT / "portbench" / "reference"
                           / "moonlight_16b_a3b.py", "portbench_reference_moe")
    drv = core.load_module(ROOT / "portbench" / "drivers"
                           / "moonlight_16b_a3b.py", "portbench_driver_moe")
    return ref, drv


def control(cfg: dict, params: dict, seed: int, device) -> dict:
    """The cell's checks of the reference with bfloat16 tables and
    momentum state, taken as the program, against the float32 reference
    (each number beside its limit)."""
    import torch
    ref_mod, drv = _modules()
    steps = params["check_steps"]
    low = ref_mod.follow(cfg, params, seed, device, steps,
                         dtype=torch.bfloat16)
    low["pairs"] = sum(low["pairs"])
    ref = ref_mod.follow(cfg, params, seed, device, steps)
    return drv.checks(drv.readings(low, ref, ref_mod.tables(cfg)),
                      params["limits"])


def correct(checks: dict) -> bool:
    """The cell's verdict on these checks (``core.run_cell``'s rule)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def faults(seed: int, names=("expert", "scale", "half"),
           seconds: float = 2.0) -> dict:
    """The cell's checks with each fault of ``names`` planted in the
    program."""
    from multiverso_tpu_torch.models.moe_lm import model as mm
    out = {}
    real_pairs, real_route = mm.MoE.pairs, mm.route
    real_loss = mm.MoeLM.loss

    def dropped(self, choice, w):
        return real_pairs(self, choice, w * (self.slot[choice] != 0))
    for name, cls, attr, fn in (
            ("fault_expert", mm.MoE, "pairs", dropped),
            ("fault_scale", mm, "route",
             lambda h, r, b, k, scale: real_route(h, r, b, k, 1.0)),
            ("fault_half", mm.MoeLM, "loss",
             lambda self, t: real_loss(self, t[: t.shape[0] // 2]))):
        if name[len("fault_"):] not in names:
            continue
        real = getattr(cls, attr)
        setattr(cls, attr, fn)
        try:
            res = core.run_cell(CELL, seed, seconds, False)
        finally:
            setattr(cls, attr, real)
        out[name] = {k: v["value"] for k, v in res["checks"].items()}
        out[name]["correct"] = res["correct"]
    return out


def main(argv=None) -> int:
    import argparse
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="",
                   help="comma-separated: expert, scale, half")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    names = [n for n in args.faults.split(",") if n]
    unknown = set(names) - {"expert", "scale", "half"}
    if unknown:
        p.error(f"--faults: unknown {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("control_moe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg, _ = core.load_cell(CELL)
    limits = wl["params"]["limits"]
    results = {}
    for s in args.seeds.split(","):
        seed = int(s)
        ctl = control(cfg, wl["params"], seed, torch.device("cuda"))
        res = {"control_bf16": dict({k: c["value"] for k, c in ctl.items()},
                                    correct=correct(ctl))}
        torch.cuda.empty_cache()
        if names:
            res.update(faults(seed, names))
        results[s] = res
        for name, r in res.items():
            for k, v in r.items():
                if k in limits:
                    print(f"seed {s} {name} {k} {v!r} limit {limits[k]!r}",
                          flush=True)
            print(f"seed {s} {name} correct {r['correct']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
