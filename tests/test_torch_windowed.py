"""The port's windowed multi-process engine against the JAX package's.

(a) the window codec in this process: the port encodes a window to the
    JAX package's bytes and each decodes the other's; a flipped bit or a
    truncation raises ``WireCorruption`` before parsing; a head-marker
    blob decodes to its message type; a device-wire value (not ported)
    fails to decode with an error that says so, and a compressed value
    (``-mv_compress``) decodes to the JAX package's bits;
(b) fire-and-forget bursts on four tables (add, sgd, Array, KV) with
    tracked Gets between them, two processes, on the default pipelined
    engine and on ``-mv_pipeline=0``: the ranks' Gets bitwise equal, the
    final tables equal on both engines, to the JAX package's run and to the
    numpy oracle, and every verb applied through a window;
(c) BSP (``-sync=true``) across 2 processes: each rank's i-th Get equal
    to the other's and to the oracle after both ranks' i-th Adds, in the
    port and in the JAX package.
"""

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


def test_window_codec_matches_jax():
    from multiverso_tpu.parallel import wire as jwire
    from multiverso_tpu.updaters.base import AddOption as JAddOption
    from multiverso_tpu.updaters.base import GetOption as JGetOption
    from multiverso_tpu_torch.parallel import wire
    from multiverso_tpu_torch.parallel.seal import WireCorruption
    from multiverso_tpu_torch.updaters.base import AddOption, GetOption

    rng = np.random.default_rng(3)
    ids = rng.integers(0, 100, 7).astype(np.int32)
    vals = rng.standard_normal((7, 5)).astype(np.float32)

    def window(add_opt, get_opt):
        return [("A", 2, {"row_ids": ids, "values": vals,
                          "option": add_opt(worker_id=1, momentum=0.5)}),
                ("G", 0, {"row_ids": None, "option": get_opt(worker_id=3)}),
                ("A", 1, {"keys": ids.astype(np.int64),
                          "values": vals[:, 0].copy(), "option": None})]

    mine = wire.encode_window(window(AddOption, GetOption), seq=9)
    theirs = jwire.encode_window(window(JAddOption, JGetOption), seq=9)
    # the same body; the trailers may differ by algorithm (crc32c or the
    # zlib fallback), and each side opens the other's
    assert wire.decode_head_kind(mine) == ("window", None)
    for blob in (mine, theirs):
        seq, got = wire.decode_window_seq(blob)
        jseq, jgot = jwire.decode_window_seq(blob)
        assert seq == jseq == 9
        for (k, t, p), (jk, jt, jp) in zip(got, jgot):
            assert (k, t) == (jk, jt) and set(p) == set(jp)
            for key in p:
                if isinstance(p[key], np.ndarray):
                    np.testing.assert_array_equal(p[key], jp[key])
                elif p[key] is None:
                    assert jp[key] is None
                else:
                    assert vars(p[key]) == vars(jp[key])
        assert isinstance(got[0][2]["option"], AddOption)
        assert isinstance(got[1][2]["option"], GetOption)
    body = len(mine) - (5 if mine[-1] == 0xC2 else 4)
    assert mine[:body] == theirs[:body]
    for pos in (0, 17, len(mine) // 2, len(mine) - 1):
        bad = bytearray(mine)
        bad[pos] ^= 0x10
        with pytest.raises(WireCorruption):
            wire.decode_window_seq(bytes(bad))
    with pytest.raises(WireCorruption):
        wire.decode_window_seq(mine[:-3])
    marker = wire.encode_head_barrier(33)
    assert wire.decode_head_kind(marker) == ("barrier", 33)
    assert jwire.decode_head_kind(marker) == ("barrier", 33)
    # a JAX device-wire value: not ported; a JAX compressed value (the q
    # tag, -mv_compress): decoded by the port as by the JAX package
    from multiverso_tpu.parallel.compress import (CompressedArray,
                                                  encode_int8_rows)
    from multiverso_tpu.parallel.flat import DeferredArray
    deferred = jwire.encode_window([("A", 0, {"values": DeferredArray.of(
        vals)})])
    with pytest.raises(ValueError, match="device-wire value.*not ported"):
        wire.decode_window_seq(deferred)
    comp = jwire.encode_window([("A", 0, {"values": CompressedArray(
        encode_int8_rows(vals))})])
    got = wire.decode_window_seq(comp)[1][0][2]["values"]
    want = jwire.decode_window_seq(comp)[1][0][2]["values"]
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert 0 < np.abs(got - vals).max() <= np.abs(vals).max() / 254


def test_bursts_on_both_engines_match_jax(tmp_path):
    jax_res, _ = run_world("jax", "burst", tmp_path)
    runs = {}
    for pipeline in ("1", "0"):
        sub = tmp_path / f"pipeline{pipeline}"
        sub.mkdir()
        runs[pipeline], _ = run_world("torch", "burst", sub,
                                      f"-mv_pipeline={pipeline}")
    n_verbs = 30 * 4 + 5 * 2 + 4
    for pipeline, res in runs.items():
        for key in res[0]:
            if key.startswith("final_") or key.startswith("arr_get"):
                np.testing.assert_array_equal(res[0][key], res[1][key],
                                              err_msg=key)
            if key.startswith("final_"):
                for r in range(2):
                    np.testing.assert_array_equal(res[r][key],
                                                  jax_res[r][key],
                                                  err_msg=f"{pipeline} {key}")
                    np.testing.assert_array_equal(res[r][key],
                                                  runs["1"][r][key])
        for r in range(2):
            assert int(res[r]["window_verbs"]) == n_verbs
            assert 1 <= int(res[r]["exchanges"]) <= n_verbs


def test_bsp_across_processes_matches_jax(tmp_path):
    jax_res, _ = run_world("jax", "bsp", tmp_path)
    port_res, _ = run_world("torch", "bsp", tmp_path)
    for key in port_res[0]:
        for r in range(2):
            np.testing.assert_array_equal(port_res[r][key], jax_res[r][key],
                                          err_msg=f"rank {r} {key}")
            np.testing.assert_array_equal(port_res[r][key], port_res[0][key])
