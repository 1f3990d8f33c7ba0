"""The port's engine sub-slice (e): SLO tiers, goodput and the overload
ladder (`inference/overload.py`, `observability/slo.py` and the tier /
ladder parts of `inference/engine.py`), against the JAX package at the
knobs of its own suite (tests/test_slo_overload.py).

At the `tiny` preset in fp32 with the same weights, both engines get the
same inputs and must give the same results: the controller's rung
history under each unit case's signal schedule; the admission order and
the greedy streams (token-exact) under mixed-tier submits; the park
order by request and the streams under 2x KV oversubscription; the
forced ladder's per-step rungs, history and `Overloaded` sheds; rung
3's admission hold; rung 2's chunk schedule; rung 1's drafts (none for
the lowest tier); and the SLO accounting (met / missed, goodput, the
tier histograms' counts).  Within the port the overlap driver's ladder
walks step for step with the synchronous one.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (LLMEngine, Overloaded,
                                        OverloadConfig,
                                        OverloadController, SLOTargets,
                                        SLOTier, goodput)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults as port_faults

# the JAX suite's engine knobs (tests/test_slo_overload.py:28-29)
KW = dict(max_slots=4, max_len=64, max_prompt_len=32, min_bucket=8,
          kv_block_tokens=8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX tiny model, port tiny model with the same weights)."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny"))
    tm = TModel(TConfig.from_preset("tiny"), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture
def faults():
    """Both packages' fault harnesses switched on, rules cleared; arm a
    rule in both with `arm(site, **rule)`."""
    pytest.importorskip("jax")
    from paddle_tpu.framework.flags import set_flags
    from paddle_tpu.testing import get_injector as jax_injector
    inj = (jax_injector(), port_faults.get_injector())

    class Both:
        @staticmethod
        def arm(site, **rule):
            for i in inj:
                i.inject(site, **rule)

        @staticmethod
        def clear():
            for i in inj:
                i.clear()

    Both.clear()
    set_flags({"FLAGS_fault_injection": True})
    port_faults.ENABLED = True
    yield Both
    Both.clear()
    set_flags({"FLAGS_fault_injection": False})
    port_faults.ENABLED = False


def _jax_ladder(**cfg):
    from paddle_tpu.inference import OverloadConfig as JConfig
    return JConfig(**cfg)


def _engines(models, ladder=None, port_kw=None, **kw):
    """(JAX engine, port engine) on the same weights and knobs; with
    `ladder` (OverloadConfig keywords) each arms its own package's
    overload ladder; `port_kw` goes to the port engine only."""
    from paddle_tpu.inference import LLMEngine as JEngine
    jkw, pkw = dict(KW, **kw), dict(KW, **kw, **(port_kw or {}))
    if ladder is not None:
        jkw["overload"] = _jax_ladder(**ladder)
        pkw["overload"] = OverloadConfig(**ladder)
    return JEngine(models[0], **jkw), LLMEngine(models[1], **pkw)


def _mixed_prompts(n, seed=3):
    """The JAX suite's prompts (:205-207)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (20 + 2 * (i % 5),)) for i in range(n)]


def _tokens(reqs):
    return [list(r.tokens) for r in reqs]


# -- units: the controller, tiers, targets, goodput --------------------------

HOT, BAND, CALM = {"queue_depth": 10}, {"queue_depth": 2}, {"queue_depth": 0}
CONTROLLER_CASES = {
    # (:81-115) rungs in order, the band holds, calm walks back down,
    # fewer than down_steps calm ticks cannot move it
    "ladder_and_hysteresis": (
        dict(queue_high=4, queue_low=1, up_steps=2, down_steps=3,
             min_dwell=2),
        [HOT] * 20 + [BAND] * 10 + [CALM] * 40 + [HOT] * 20 + [CALM] * 2),
    # (:118-127) any single pressure signal trips; parked > 0 alone
    "single_signals": (
        dict(up_steps=1, min_dwell=0),
        [{"parked": 1}, {"host_frac": 0.9}, {"preempt_rate": 3}]),
    # the ITL signal with its low-water mark defaulted to half
    "itl_signal": (
        dict(itl_high_s=0.2, up_steps=1, down_steps=2, min_dwell=0),
        [{"itl_ema": 0.3}] * 3 + [{"itl_ema": 0.15}] * 4
        + [{"itl_ema": 0.05}] * 10),
    # max_rung caps the walk; the band between the marks holds
    "max_rung_and_band": (
        dict(queue_high=3, queue_low=1, up_steps=1, down_steps=1,
             min_dwell=0, max_rung=2),
        [HOT] * 6 + [BAND] * 6 + [CALM] * 4),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_history_equal_jax(case):
    """The rung after every tick, the history and the step counters
    are the JAX controller's under each unit case's signals; a forced
    tick escalates past hysteresis in both."""
    pytest.importorskip("jax")
    from paddle_tpu.inference import OverloadController as JController
    cfg, schedule = CONTROLLER_CASES[case]
    j = JController(_jax_ladder(**cfg))
    p = OverloadController(OverloadConfig(**cfg))
    assert [j.update(s) for s in schedule] == \
        [p.update(s) for s in schedule]
    assert p.history == j.history and p.history
    assert (p.escalations, p.deescalations) == \
        (j.escalations, j.deescalations)
    assert p.update({}, force_up=True) == j.update({}, force_up=True)
    if case == "ladder_and_hysteresis":
        assert p.history[:8] == [1, 2, 3, 4, 3, 2, 1, 0]


def test_config_errors_equal_jax():
    pytest.importorskip("jax")
    for bad in (dict(queue_low=9, queue_high=8), dict(host_high=2.0),
                dict(up_steps=0), dict(degraded_prefill_frac=0.0),
                dict(max_rung=5)):
        with pytest.raises(ValueError):
            _jax_ladder(**bad)
        with pytest.raises(ValueError):
            OverloadConfig(**bad)


@pytest.mark.parametrize("tier", [None, " Interactive ", "standard",
                                  "BATCH", "gold"])
def test_tiers_targets_goodput_equal_jax(tier):
    pytest.importorskip("jax")
    from paddle_tpu.observability import slo as J
    if tier == "gold":
        with pytest.raises(ValueError):
            J.SLOTier.check(tier)
        with pytest.raises(ValueError):
            SLOTier.check(tier)
        return
    t = SLOTier.check(tier)
    assert t == J.SLOTier.check(tier)
    assert SLOTier.rank(t) == J.SLOTier.rank(t)
    targets = {"interactive": (0.5, 0.1)}
    for ttft, itl in ((0.4, 0.05), (0.6, 0.05), (0.4, 0.2), (60.0, 5.0)):
        assert SLOTargets(targets).met(t, ttft, itl) == \
            J.SLOTargets(targets).met(t, ttft, itl)
    met, missed = {t: 19}, {t: 1, "batch": 4}
    assert goodput(met, missed) == J.goodput(met, missed)


# -- the engine: admission order, park order ----------------------------------


def _admission_order(eng, reqs, max_steps=400):
    order, seen = [], set()
    for _ in range(max_steps):
        eng.step()
        for r in reqs:
            if r.rid not in seen and (
                    r in eng._slots
                    or any(ps.req is r for ps in eng._prefill.values())
                    or r.done):
                seen.add(r.rid)
                order.append(reqs.index(r))
        if all(r.done for r in reqs):
            break
    return order


def test_admission_order_and_streams_equal_jax(models):
    """(:210-236) With one free slot the queue admits interactive, then
    standard, then batch (FIFO within a tier) in both engines, with the
    same streams."""
    ps = _mixed_prompts(6)
    tiers = ["batch", "batch", "interactive", "standard", "interactive",
             "batch"]
    orders, streams = [], []
    for eng in _engines(models, max_slots=1):
        reqs = [eng.submit(p, max_new_tokens=4, tier=t)
                for p, t in zip(ps, tiers)]
        orders.append(_admission_order(eng, reqs))
        assert all(r.done and r.error is None for r in reqs)
        streams.append(_tokens(reqs))
    assert orders[1] == orders[0] == [2, 4, 3, 0, 1, 5]
    assert streams[1] == streams[0]


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_park_order_and_streams_equal_jax(models, policy):
    """(:239-284) Under ~2x KV oversubscription the park order by
    request and the streams are the JAX engine's; an interactive
    request is never parked; the victim order sorts by tier."""
    ps = _mixed_prompts(6)
    tiers = ["interactive", "batch", "interactive", "batch", "batch",
             "batch"]
    parks, streams = [], []
    for eng in _engines(models, kv_blocks=16, preempt_policy=policy):
        parked = []
        orig = eng._park_slot

        def spy(slot, eng=eng, orig=orig, parked=parked):
            parked.append(eng._slots[slot])
            return orig(slot)

        eng._park_slot = spy
        reqs = [eng.submit(p, max_new_tokens=24, tier=t)
                for p, t in zip(ps, tiers)]
        eng.run(max_steps=5000)
        assert all(r.done and r.error is None for r in reqs)
        assert eng._m_preempt.value >= 1
        assert SLOTier.INTERACTIVE not in {r.tier for r in parked}
        parks.append([reqs.index(r) for r in parked])
        streams.append(_tokens(reqs))
    assert parks[1] == parks[0] and parks[1]
    assert streams[1] == streams[0]
    # the victim ORDER: batch before standard before interactive
    eng = LLMEngine(models[1], **KW)
    rs = [eng.submit(p, max_new_tokens=16, tier=t) for p, t in zip(
        _mixed_prompts(4), ["interactive", "batch", "standard", "batch"])]
    for _ in range(200):
        eng.step()
        if eng.num_active == 4:
            break
    ranks = [SLOTier.rank(eng._slots[s].tier)
             for s in eng._preempt_victims()]
    assert ranks == sorted(ranks) == [0, 0, 1, 2]
    for r in rs:
        r.cancel()
    eng.run(max_steps=500)
    assert eng.num_active == 0


# -- the ladder's rungs -------------------------------------------------------


def _walk(eng, steps):
    """Step `steps` times; the rung after each step."""
    rungs = []
    for _ in range(steps):
        eng.step()
        rungs.append(eng.overload_rung)
    return rungs


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_forced_ladder_history_and_sheds_equal_jax(models, faults, overlap):
    """(:287-323) `engine.overload` times=4 walks both engines to rung
    4 step for step; queued batch requests are shed from the queue and
    new batch submits rejected with `Overloaded` in both; the
    interactive stream is the JAX engine's; cleared, the ladder walks
    back [3, 2, 1, 0].  The port's overlap driver ticks at the same
    step boundaries as the synchronous driver."""
    cfg = dict(queue_high=4, queue_low=0, up_steps=1, down_steps=2,
               min_dwell=0)
    out = []
    ps = _mixed_prompts(4, seed=9)
    for eng in _engines(models, ladder=cfg, port_kw={"overlap": overlap},
                        max_slots=1):
        # the slot busy with a long interactive request; two batch
        # requests wait in the queue
        first = eng.submit(ps[0], max_new_tokens=12, tier="interactive")
        eng.step()
        queued = [eng.submit(p, max_new_tokens=4, tier="batch")
                  for p in ps[1:3]]
        faults.arm("engine.overload", times=4)
        rungs = _walk(eng, 5)
        with pytest.raises(RuntimeError, match="shedding") as shed:
            eng.submit(ps[3], max_new_tokens=4, tier="batch")
        assert type(shed.value).__name__ == "Overloaded"
        ok = eng.submit(ps[3], max_new_tokens=4, tier="interactive")
        eng.run(max_steps=2000)
        faults.clear()
        for _ in range(50):
            eng._overload_tick()
            if eng.overload_rung == 0:
                break
        m = eng.metrics()
        out.append(dict(
            rungs=rungs, history=list(eng._overload.history),
            errors=[type(r.error).__name__ for r in queued],
            tokens=_tokens([first, ok]),
            shed=m["llm_engine_requests_shed_total"]["series"][
                "tier=batch"]["value"],
            deesc=m["llm_engine_overload_deescalations_total"]["series"][
                ""]["value"]))
    assert out[1] == out[0]
    assert out[0]["rungs"][-1] == 4
    assert out[0]["history"] == [1, 2, 3, 4, 3, 2, 1, 0]
    assert out[0]["errors"] == ["Overloaded", "Overloaded"]
    assert out[0]["shed"] == 3 and out[0]["deesc"] == 4


def test_rung3_holds_batch_then_runs_equal_jax(models, faults):
    """(:326-347) At rung 3 a queued batch request is held, not failed;
    once the fault clears the ladder steps down and it runs, with the
    JAX engine's stream."""
    cfg = dict(queue_high=100, queue_low=99, up_steps=1, down_steps=1,
               min_dwell=0, max_rung=3)
    out = []
    for eng in _engines(models, ladder=cfg):
        faults.arm("engine.overload", times=None)
        _walk(eng, 4)
        assert eng.overload_rung == 3
        b = eng.submit(_mixed_prompts(1)[0], max_new_tokens=4, tier="batch")
        _walk(eng, 30)
        held = (b.done, eng.tier_queue_depths())
        faults.clear()
        eng.run(max_steps=2000)
        assert b.done and b.error is None and len(b.tokens) == 4
        out.append((held, list(b.tokens), eng.overload_rung))
    assert out[1] == out[0]
    assert out[0][0] == (False, {"interactive": 0, "standard": 0,
                                 "batch": 1})
    assert out[0][2] < 3


def _chunk_schedule(eng, reqs, max_steps=400):
    """Each step's prefill frontier per request (index: off)."""
    sched = []
    for _ in range(max_steps):
        eng.step()
        sched.append({reqs.index(ps.req): int(ps.off)
                      for ps in eng._prefill.values()})
        if all(r.done for r in reqs):
            break
    assert all(r.done and r.error is None for r in reqs)
    return sched


def test_rung2_chunk_schedule_equal_jax(models, faults):
    """Rung 2 shrinks ONLY the lowest tier's prefill share (and revokes
    its first-chunk guarantee): both engines advance every prefill
    frontier identically, step by step, with the same streams; the
    schedule differs from the rung-0 one."""
    cfg = dict(max_rung=2, degraded_prefill_frac=0.5)
    kw = dict(max_len=96, max_prompt_len=64, prefill_chunk=16,
              step_token_budget=40)
    rng = np.random.RandomState(5)
    ps = [rng.randint(0, 256, (L,)) for L in (60, 50, 44, 30)]
    tiers = ["batch", "interactive", "batch", "standard"]
    scheds, streams = [], []
    for eng in _engines(models, ladder=cfg, **kw):
        faults.arm("engine.overload", times=None)
        _walk(eng, 2)
        assert eng.overload_rung == 2
        reqs = [eng.submit(p, max_new_tokens=6, tier=t)
                for p, t in zip(ps, tiers)]
        scheds.append(_chunk_schedule(eng, reqs))
        streams.append(_tokens(reqs))
        faults.clear()
    assert scheds[1] == scheds[0]
    assert streams[1] == streams[0]
    calm = LLMEngine(models[1], **dict(KW, **kw))
    reqs = [calm.submit(p, max_new_tokens=6, tier=t)
            for p, t in zip(ps, tiers)]
    assert _chunk_schedule(calm, reqs) != scheds[1]
    assert _tokens(reqs) == streams[1]


def _repetitive(period, n, seed=0):
    rng = np.random.RandomState(seed)
    cycle = rng.randint(2, 250, (period,))
    return np.tile(cycle, n // period + 1)[:n]


def test_rung1_lowest_tier_drafts_nothing_equal_jax(models, faults):
    """Rung 1 with speculation on: batch slots draft nothing while
    interactive slots draft and accept, in both engines, with the same
    drafts, counters and streams."""
    cfg = dict(max_rung=1)
    kw = dict(max_len=96, prefill_chunk=8, speculation=4)
    ps = [_repetitive(3, 24, seed=s) for s in range(4)]
    tiers = ["interactive", "batch", "interactive", "batch"]
    out = []
    for eng in _engines(models, ladder=cfg, **kw):
        faults.arm("engine.overload", times=None)
        reqs = [eng.submit(p, max_new_tokens=20, tier=t)
                for p, t in zip(ps, tiers)]
        drafted = {i: 0 for i in range(len(reqs))}
        orig = eng._propose_drafts

        def spy(eng=eng, orig=orig, reqs=reqs, drafted=drafted):
            drafts, cost = orig()
            for slot, d in enumerate(drafts or []):
                if d:
                    drafted[reqs.index(eng._slots[slot])] += len(d)
            return drafts, cost

        eng._propose_drafts = spy
        eng.run(max_steps=3000)
        assert eng.overload_rung == 1
        assert all(r.done and r.error is None for r in reqs)
        m = eng.metrics()
        out.append((drafted, _tokens(reqs), int(m[
            "llm_engine_spec_tokens_accepted_total"]["series"][""][
            "value"])))
        faults.clear()
    assert out[1] == out[0]
    drafted, _, accepted = out[1]
    assert drafted[1] == drafted[3] == 0
    assert drafted[0] > 0 and drafted[2] > 0 and accepted > 0


def test_slo_accounting_equal_jax(models):
    """(:366-388) Met / missed per tier, goodput and the tier
    histograms' counts are the JAX engine's: interactive and standard
    under generous targets (met), batch under an impossible one
    (missed)."""
    targets = {"interactive": (300.0, 300.0), "standard": (300.0, 300.0),
               "batch": (1e-9, 1e-9)}
    ps = _mixed_prompts(5, seed=7)
    tiers = ["interactive", "batch", "standard", "batch", "interactive"]
    out = []
    for eng in _engines(models, slo_targets=targets):
        reqs = [eng.submit(p, max_new_tokens=6, tier=t)
                for p, t in zip(ps, tiers)]
        eng.run(max_steps=2000)
        assert all(r.done and r.error is None for r in reqs)
        m = eng.metrics()

        def per_tier(name, field="value"):
            return {t: m["llm_engine_" + name]["series"][f"tier={t}"][field]
                    for t in SLOTier.ALL}
        out.append((per_tier("slo_met_total"), per_tier("slo_missed_total"),
                    per_tier("slo_goodput"),
                    per_tier("tier_ttft_seconds", "count"),
                    per_tier("tier_itl_seconds", "count"),
                    _tokens(reqs)))
    assert out[1] == out[0]
    met, missed, gp, ttft_n, itl_n, _ = out[1]
    assert met == {"interactive": 2, "standard": 1, "batch": 0}
    assert missed == {"interactive": 0, "standard": 0, "batch": 2}
    assert gp == {"interactive": 1.0, "standard": 1.0, "batch": 0.0}
    assert ttft_n == {"interactive": 2, "standard": 1, "batch": 2}
    assert itl_n == {"interactive": 10, "standard": 5, "batch": 10}
