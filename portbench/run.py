#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
comparison with the plain reference read, beside its limit). Exits
non-zero, printing no result, without the CUDA devices the cell asks for
or when the JAX package or JAX was loaded. Run from the root of a
checkout; kernel build caches stay inside it.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# caches at fixed paths inside the checkout, set before torch is imported
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton_cache")):
    os.environ[var] = str(ROOT / sub)
sys.path.insert(0, str(ROOT))

from portbench.lib import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main())
