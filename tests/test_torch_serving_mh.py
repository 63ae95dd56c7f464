"""The port's serving plane in a two-process world against the JAX
package's.

Both ranks of ``tests/_mh_child.py``'s ``serving`` mode run one seeded
script in a JAX-package world (``jax.distributed``, CPU) and again in a
port world (``torch.distributed`` over gloo, ``-mv_device=cpu``): Matrix,
Array and KV tables take both ranks' integer-valued Adds, both ranks
publish at the same stream position (host residence, though the world
asks for ``-mv_serving_residence=device``: a multi-process world serves
from host copies), four reader threads a rank hold the pinned version
while a training burst runs, and 50 lookups after a drain are counted
against the process's host collective rounds. Here: each package's ranks
agree on the versions (1, then 2), issue no host collective on the lookup
path, and serve rows equal to the training Get at the cut; the port's
served values equal the JAX package's bitwise.
"""

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


def test_two_process_serving_matches_jax(tmp_path):
    jax_res, _ = run_world("jax", "serving", tmp_path)
    port_res, _ = run_world("torch", "serving", tmp_path)
    assert set(port_res[0]) == set(jax_res[0])
    for r in range(2):
        for res in (jax_res[r], port_res[r]):
            np.testing.assert_array_equal(res["versions"], [[1, 2], [1, 2]])
            assert int(res["lookup_rounds"]) == 0
        for key in port_res[r]:
            np.testing.assert_array_equal(port_res[r][key], jax_res[r][key],
                                          err_msg=f"rank {r} {key}")
    for key in ("mat_served", "arr_served", "kv_served", "live"):
        np.testing.assert_array_equal(port_res[0][key], port_res[1][key],
                                      err_msg=f"ranks differ: {key}")
