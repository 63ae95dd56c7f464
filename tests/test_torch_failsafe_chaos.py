"""The port's seeded chaos injector and dedup window
(``multiverso_tpu_torch/failsafe/chaos.py``, ``dedup.py``) against the JAX
package's.

(a) One spec arming all 18 sites and one seed give the same decision at
    every one of 10,000 consults of every site in both packages (the
    mailbox, verb, serving, apply, tcp, membership, policy and coordinator
    consults, in one interleaved order), ``corrupt_blob`` corrupts a real
    window blob (the port's flat codec) identically and never its kind
    byte, and a second seed gives another schedule;
(b) ``parse_spec`` accepts the same specs and refuses the same bad ones
    with the same message, and the flags carry the JAX defaults;
(c) ``DedupWindow``: the record / outcome lifecycle (first outcome wins,
    the pending sentinel never leaks) and the FIFO eviction, step by step
    equal to the JAX window.
"""

import numpy as np
import pytest

_ALL = ("mailbox.drop:0.1@0.003,mailbox.dup:0.2,mailbox.delay:0.15,"
        "wire.bitflip:0.3,wire.truncate:0.1,verb.transient:0.25,"
        "verb.failack:0.1,serving.overload:0.2,serving.delay:0.3@0.004,"
        "membership.leave:0.1,membership.join:0.2,apply.delay:0.05@0.5,"
        "policy.flap:1.0@3,coord.kill:0.01,coord.delay:0.2@0.01,"
        "tcp.delay:0.1@0.02,tcp.drop:0.05,tcp.partition:0.02")


def _schedule(chaos, seed, blob, n=10_000):
    inj = chaos.ChaosInjector(chaos.parse_spec(_ALL), seed)
    out = []
    for i in range(n):
        out.append((inj.mailbox_action(), inj.verb_action(bool(i % 3)),
                    inj.serving_admission(), inj.serving_delay(),
                    inj.apply_delay(), inj.tcp_delay(), inj.tcp_drop(),
                    inj.tcp_partition(), inj.membership_fault("leave"),
                    inj.membership_fault("join"), inj.policy_flap(),
                    inj.coord_kill(), inj.coord_delay(),
                    inj.corrupt_blob(blob)))
    return out


def test_schedule_and_corrupt_blob_match_jax():
    from multiverso_tpu.failsafe import chaos as jchaos
    from multiverso_tpu_torch.failsafe import chaos as tchaos
    from multiverso_tpu_torch.parallel import wire
    rng = np.random.default_rng(5)
    blob = wire.encode_window(
        [("A", 0, {"row_ids": rng.integers(0, 100, 40).astype(np.int32),
                   "values": rng.standard_normal((40, 6)).astype(
                       np.float32)}),
         ("G", 1, {"row_ids": np.arange(8, dtype=np.int32)})], seq=3)
    mine = _schedule(tchaos, 1234, blob)
    assert mine == _schedule(jchaos, 1234, blob)
    assert mine != _schedule(tchaos, 1235, blob)
    # every site fired somewhere, the blob was both flipped and cut, and
    # no corruption touched the kind byte
    for k in range(13):
        assert any(d[k] for d in mine), k
    bad = [d[13] for d in mine if d[13] is not None]
    assert any(len(b) == len(blob) for b in bad)
    assert any(len(b) < len(blob) for b in bad)
    assert all(b[0] == blob[0] and b != blob for b in bad)
    # a site's schedule does not depend on the other sites in the spec
    full = tchaos.ChaosInjector(tchaos.parse_spec(_ALL), 7)
    solo = tchaos.ChaosInjector(tchaos.parse_spec("verb.transient:0.25"), 7)
    assert ([full.verb_action(True) == "transient" for _ in range(500)]
            == [solo.verb_action(True) == "transient" for _ in range(500)])


def test_parse_spec_and_flags_match_jax():
    from multiverso_tpu.failsafe import chaos as jchaos
    from multiverso_tpu.utils.log import FatalError as JFatal
    from multiverso_tpu_torch.failsafe import chaos as tchaos
    from multiverso_tpu_torch.failsafe import deadline as tdeadline
    from multiverso_tpu_torch.utils.configure import GetFlag
    from multiverso_tpu_torch.utils.log import FatalError as TFatal
    assert tchaos._SITES == jchaos._SITES and len(tchaos._SITES) == 18
    for spec in (_ALL, "", " verb.transient:0.5 , mailbox.dup:1",
                 "apply.delay:1.0@2.0", "tcp.delay:0.5"):
        assert tchaos.parse_spec(spec) == jchaos.parse_spec(spec), spec
    for spec in ("bogus.site:0.5", "verb.transient:1.5",
                 "verb.transient:-0.1", "mailbox.delay:0.5@x",
                 "verb.failack:", "mailbox.dup"):
        with pytest.raises(JFatal) as jerr:
            jchaos.parse_spec(spec)
        with pytest.raises(TFatal) as terr:
            tchaos.parse_spec(spec)
        assert str(terr.value) == str(jerr.value), spec
    assert GetFlag("mv_deadline_s") == 0.0
    assert GetFlag("mv_max_retries") == 3
    assert GetFlag("mv_dedup_window") == 4096
    assert GetFlag("chaos_spec") == "" and GetFlag("chaos_seed") == 0
    assert tdeadline.DEFAULT_SHUTDOWN_JOIN_S == 30.0
    assert tdeadline.timeout_or_none() is None


def test_dedup_window_matches_jax():
    from multiverso_tpu.failsafe.dedup import DedupWindow as JWin
    from multiverso_tpu.failsafe.dedup import PENDING as JPENDING
    from multiverso_tpu_torch.failsafe.dedup import DedupWindow as TWin
    from multiverso_tpu_torch.failsafe.dedup import PENDING as TPENDING

    def script(win, pending):
        out = [win.seen(("a", 1))]
        win.record(("a", 1))
        out += [win.seen(("a", 1)), win.outcome(("a", 1))]
        win.set_outcome(("a", 1), None)
        out.append(win.outcome(("a", 1)))
        win.set_outcome(("a", 1), "late")       # the first outcome wins
        out.append(win.outcome(("a", 1)))
        win.record("k")
        ready, val = win.outcome("k")
        out.append((ready, val is pending))     # never the sentinel
        for i in range(10):
            win.record(("w", i))
            if i % 3 == 0:
                win.set_outcome(("w", i), i)
            out.append((len(win), win.seen(("w", 0)), win.seen(("a", 1)),
                        win.outcome(("w", max(0, i - 3)))))
        win.record(("w", 2))                    # re-record: to the end
        win.record(("w", 10))
        out.append([win.seen(("w", i)) for i in range(11)])
        return out

    for cap in (1, 4, 8, 4096):
        mine = script(TWin(cap), TPENDING)
        assert mine == script(JWin(cap), JPENDING), cap
    assert mine[1] is True and mine[2] == (False, None)
    assert mine[3] == (True, None) and mine[4] == (True, None)
    small = script(TWin(4), TPENDING)
    # FIFO: w6 and w7 went to make room for the re-recorded w2 and w10
    assert small[-1] == [False, False, True] + [False] * 5 + [True] * 3
