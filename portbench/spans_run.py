#!/usr/bin/env python3
"""Run one cell of the port's benchmark with the program's spans.

    python3 portbench/spans_run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

As ``portbench/run.py``, with the program's ``-trace`` spans on over the
window (``lib/spans.py``). With ``--trace 1`` the line's ``metrics`` add
the span metrics of the cell (``spans.METRICS``), its
``breakdown.idle_gaps`` name the span open at each gap, and
``breakdown.spans`` gives their raw seconds and how well the program's
clock and the device trace's line up. With ``--trace 0`` the line is
``run.py``'s: set beside ``run.py --trace 0`` it gives what the spans
cost end to end.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton_cache")):
    os.environ[var] = str(ROOT / sub)
sys.path.insert(0, str(ROOT))

from portbench.lib import core, spans  # noqa: E402

if __name__ == "__main__":
    spans.install(core)
    sys.exit(core.main())
