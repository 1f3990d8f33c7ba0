"""The port's server surface (`inference/serving.py::LLMServer`) and the
engine API it relies on, against the JAX package.

  * the JAX argument order: every parameter of `LLMEngine.__init__`,
    `Request.__init__` and `LLMServer.__init__`, bound positionally by
    the JAX signature, lands on the port's parameter of the same name,
    with the same default; the knobs still unported raise naming their
    ROADMAP item;
  * `Request.result(timeout=)` (a timeout on a live request, the typed
    error re-raised), `LLMEngine.generate` (greedy streams equal to the
    JAX engine's at the `tiny` preset in fp32 with the same weights) and
    `metrics_text()` (Prometheus text that parses);
  * /metrics and /healthz over HTTP on 127.0.0.1:0; the
    `health_snapshot()` key set (and `chip_smoke.HEALTHZ_KEYS`) equal to
    the JAX server's; the canary (the same golden prompt and tokens as
    the JAX server's, quarantine on an injected mismatch, `submit`
    refused); the watchdog on `engine.stall`, gated on the fault's
    callback; the series sampler setting the engine's ITL window; the
    rung-4 shed at the server's door.
"""

import importlib.util
import inspect
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (DeadlineExceeded, EngineUnhealthy,
                                        LLMEngine, LLMServer, Overloaded,
                                        Request, ResultTimeout, SLOTier)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]
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


@pytest.fixture(scope="module")
def port_model():
    return TModel(TConfig.from_preset("tiny"), device="cpu", seed=3)


@pytest.fixture
def harness():
    inj = faults.get_injector()
    inj.clear()
    faults.ENABLED = True
    yield inj
    inj.clear()
    faults.ENABLED = False


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


def _get(addr, path):
    """(status, body) of GET http://addr/path; an HTTP error's status
    and body too."""
    url = f"http://{addr[0]}:{addr[1]}{path}"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _bounded(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# -- the JAX argument order (ROADMAP Queue 3 item 2) ------------------------


def _signatures():
    pytest.importorskip("jax")
    from paddle_tpu.inference import LLMEngine as JEngine
    from paddle_tpu.inference import LLMServer as JServer
    from paddle_tpu.inference import Request as JRequest
    return {"LLMEngine": (JEngine.__init__, LLMEngine.__init__),
            "Request": (JRequest.__init__, Request.__init__),
            "LLMServer": (JServer.__init__, LLMServer.__init__)}


@pytest.mark.parametrize("cls", ["LLMEngine", "Request", "LLMServer"])
def test_every_jax_parameter_binds_positionally(cls):
    """Each parameter of the JAX signature, passed positionally, lands
    on the port's parameter of the same name, and both default it
    alike."""
    jfn, pfn = _signatures()[cls]
    jsig, psig = inspect.signature(jfn), inspect.signature(pfn)
    positional = [p for p in jsig.parameters.values()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    marks = [object() for _ in positional]
    bound = psig.bind(*marks)
    for p, mark in zip(positional, marks):
        assert bound.arguments.get(p.name) is mark, p.name
        assert psig.parameters[p.name].default == p.default, p.name
    assert [p.name for p in psig.parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD] == \
        [p.name for p in positional]
    kinds = {p.kind for p in psig.parameters.values()}
    assert (inspect.Parameter.VAR_KEYWORD in kinds) == \
        any(p.kind is p.VAR_KEYWORD for p in jsig.parameters.values())


@pytest.mark.parametrize("knob,value", [
    ("prefix_hint", {"addr": ["h", 1], "tokens": 8}),
    ("session_id", "s1"), ("handoff", {"addr": ["h", 1]})])
def test_request_fabric_fields_raise(knob, value):
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP: engine sub-slice \(h\)"):
        Request([1, 2, 3], 2, **{knob: value})
    assert Request([1, 2, 3], 2, **{knob: None}).tier == SLOTier.STANDARD


@pytest.mark.parametrize("knob,value", [
    ("hot_window", 8), ("prefetch_depth", 3),
    ("fabric", {"disk_root": "/x"}), ("mesh", "tp"), ("tp", 2), ("sp", 2),
    ("aot_cache", "dir")])
def test_unported_engine_knobs_raise_positionally(port_model, knob, value):
    """An unported knob passed at its JAX position raises naming its
    ROADMAP item; at its "off" value it is accepted."""
    names = list(inspect.signature(LLMEngine.__init__).parameters)[2:]
    defaults = {n: p.default for n, p in inspect.signature(
        LLMEngine.__init__).parameters.items()}
    args = [defaults[n] for n in names]
    args[names.index(knob)] = value
    args[:3] = [4, 64, 32]          # max_slots, max_len, max_prompt_len
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine(port_model, *args)
    args[names.index(knob)] = defaults[knob]
    assert LLMEngine(port_model, *args).max_len == 64


@pytest.mark.parametrize("role,exc", [("prefill", NotImplementedError),
                                      ("decode", NotImplementedError),
                                      ("bogus", ValueError)])
def test_pool_role_raises(port_model, role, exc):
    with pytest.raises(exc):
        LLMServer(port_model, pool_role=role, **KW)


# -- result / generate / metrics_text (ROADMAP Queue 3 item 1) ----------------


def test_result_timeout_and_typed_error(port_model):
    eng = LLMEngine(port_model, **KW)
    ok = eng.submit([5, 6, 7, 8], 4)
    late = eng.submit([9, 10, 11], 30, deadline=1e-3)
    with pytest.raises(ResultTimeout):
        ok.result(timeout=0.01)         # queued: still live
    time.sleep(0.01)
    eng.run()
    assert ok.result(timeout=1) == ok.tokens and len(ok.tokens) == 4
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=1)
    # the event is set after on_done: a waiter sees the callbacks' work
    seen = []
    r = eng.submit([1, 2, 3], 2, on_done=lambda q: seen.append(q.rid))
    t = threading.Thread(target=eng.run)
    t.start()
    assert r.result(timeout=30) == r.tokens and seen == [r.rid]
    t.join(30)
    assert not t.is_alive()


def test_result_through_server(port_model):
    """`Request.result` through the server; a server-side deadline
    error re-raised."""
    srv = LLMServer(port_model, **KW)
    try:
        r = srv.submit([5, 6, 7], 5)
        late = srv.submit([1, 2], 30, deadline=1e-4)
        assert r.result(timeout=60) == srv.result(r) and len(r.tokens) == 5
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=60)
    finally:
        srv.shutdown()


def test_generate_streams_equal_jax(models):
    from paddle_tpu.inference import LLMEngine as JEngine
    prompts = _prompts([5, 9, 17, 26, 7], seed=1)
    want = JEngine(models[0], **KW).generate(prompts, 8)
    got = LLMEngine(models[1], **KW).generate(prompts, 8)
    assert [list(map(int, x)) for x in got] == \
        [list(map(int, x)) for x in want]


def test_metrics_text_parses(port_model):
    eng = LLMEngine(port_model, overload=True, **KW)
    eng.generate(_prompts([6, 9]), 4, tier="interactive")
    assert eng.metrics_registry is eng._metrics
    families, samples = set(), {}
    for line in eng.metrics_text().splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    assert {"llm_engine_overload_rung", "llm_engine_slo_goodput",
            "llm_engine_tier_ttft_seconds"} <= families
    assert samples['llm_engine_slo_met_total{tier="interactive"}'] + \
        samples['llm_engine_slo_missed_total{tier="interactive"}'] == 2
    assert samples['llm_engine_tier_ttft_seconds_count'
                   '{tier="interactive"}'] == 2


# -- /metrics, /healthz, the snapshot's keys ----------------------------------


def _keys(snap):
    """The snapshot's keys, nested dicts' keys as 'outer.inner'."""
    out = set()
    for k, v in snap.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk in v}
    return out


def test_health_snapshot_keys_equal_jax(models):
    from paddle_tpu.inference import LLMServer as JServer
    jsrv = JServer(models[0], **KW)
    try:
        want = jsrv.health_snapshot()
    finally:
        jsrv.shutdown()
    srv = LLMServer(models[1], **KW)
    try:
        got = srv.health_snapshot()
    finally:
        srv.shutdown()
    assert _keys(got) == _keys(want)
    # the features the port lacks report their "off" values
    for k in ("kv_tiered", "tp", "fabric_address", "aot", "pool_role",
              "fabric", "shed", "tier_queue_depth", "overload_rung",
              "degraded", "kv_blocks_total", "slots_total"):
        assert got[k] == want[k], k
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_keys", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.HEALTHZ_KEYS) == set(want)


def test_metrics_and_healthz_over_http(port_model):
    srv = LLMServer(port_model, metrics_port=0, overload=True, **KW)
    try:
        addr = srv.metrics_address
        assert addr[0] == "127.0.0.1" and addr[1] > 0
        srv.submit(_prompts([7])[0], 4, tier="interactive").result(60)
        code, text = _get(addr, "/metrics")
        assert code == 200
        assert "llm_engine_overload_rung 0" in text
        assert 'llm_engine_tier_ttft_seconds_count{tier="interactive"} 1' \
            in text
        code, body = _get(addr, "/healthz")
        h = json.loads(body)
        assert code == 200 and h["status"] == "ok"
        assert h["overload_rung"] == 0 and h["degraded"] is False
        assert set(h["tier_queue_depth"]) == set(SLOTier.ALL)
        assert _get(addr, "/nope")[0] == 404
        assert _get(addr, "/debug/trace?rid=999999")[0] == 404
    finally:
        srv.shutdown()
    assert srv._http is None and not srv._thread.is_alive()


def test_submit_sheds_lowest_tier_at_rung4(port_model):
    srv = LLMServer(port_model, overload=True, **KW)
    try:
        for _ in range(4):
            srv.engine._overload.update({}, force_up=True)
        assert srv.engine.overload_rung == 4
        with pytest.raises(Overloaded):
            srv.submit([1, 2, 3], 4, tier="batch")
        assert srv._pending.qsize() == 0 and srv._n_unfinished == 0
        assert srv.submit([1, 2, 3], 4, tier="standard").result(60)
        h = srv.health_snapshot()
        assert h["shed"]["batch"] == 1 and h["degraded"] is True
    finally:
        srv.shutdown()


# -- the canary, the watchdog, the series -------------------------------------


def test_canary_matches_jax_and_quarantines_on_mismatch(models, harness):
    from paddle_tpu.inference import LLMServer as JServer
    jsrv = JServer(models[0], canary_interval=3600, **KW)
    try:
        want = (list(jsrv._canary_prompt), list(jsrv._canary_expected))
    finally:
        jsrv.shutdown()
    srv = LLMServer(models[1], metrics_port=0, canary_interval=3600, **KW)
    try:
        assert (list(srv._canary_prompt), srv._canary_expected) == want
        assert srv.probe_canary(timeout=60) is True
        harness.inject("engine.canary", times=1)
        assert srv.probe_canary(timeout=60) is False
        h = srv.health_snapshot()
        assert h["status"] == "quarantined" and h["quarantined"]
        # the driver's first tick probes too, so at least two probes
        assert h["canary_failures"] == 1 and h["canary_probes"] >= 2
        assert "canary mismatch" in h["quarantine_reason"]
        assert srv.healthy and srv.engine.freeze_parked
        with pytest.raises(EngineUnhealthy):
            srv.submit([1, 2, 3], 4)
        code, body = _get(srv.metrics_address, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "quarantined"
        # sticky: a clean probe does not lift it
        assert srv.probe_canary(timeout=60) is False
    finally:
        srv.shutdown()
    with pytest.raises(RuntimeError):
        LLMServer(models[1], **KW).probe_canary()


def test_watchdog_trips_on_engine_stall(port_model, harness):
    """A stall wedges the driver inside the `engine.stall` site (the
    rule's callback blocks until released, 30 s at most): the poller
    sees `stalled` once, counted once; after the release the request
    finishes and the flag clears.  Idle staleness is no stall."""
    srv = LLMServer(port_model, watchdog_deadline=0.2, **KW)
    started, release = threading.Event(), threading.Event()

    def wedge(ctx):
        started.set()
        release.wait(30)

    try:
        time.sleep(0.3)
        h = srv.health_snapshot()
        assert not h["stalled"] and h["watchdog_stalls"] == 0
        harness.inject("engine.stall", times=1, exc=None, callback=wedge)
        r = srv.submit([1, 2, 3, 4], 4)
        assert started.wait(30)
        _bounded(lambda: srv.health_snapshot()["stalled"], what="a stall")
        for _ in range(3):
            h = srv.health_snapshot()
            assert h["stalled"] and h["watchdog_stalls"] == 1
        release.set()
        assert len(r.result(timeout=60)) == 4
        h = srv.health_snapshot()
        assert not h["stalled"] and h["watchdog_stalls"] == 1
    finally:
        release.set()
        srv.shutdown()


def test_series_samples_and_feeds_itl_window(port_model):
    srv = LLMServer(port_model, series_interval=0.02, overload=True, **KW)
    try:
        assert srv.engine._itl_window_s is None
        reqs = [srv.submit(p, 40) for p in _prompts([5, 9, 12])]
        _bounded(lambda: srv.engine._itl_window_s is not None,
                 what="the ITL window")
        for r in reqs:
            r.result(timeout=60)
        assert srv.engine._itl_window_s > 0
        payload = srv.metrics_series(n=4)
        assert payload["name"] == srv.name and payload["costs"] == []
        assert "llm_engine_itl_seconds:p50" in payload["series"]
        assert "llm_engine_occupancy" in payload["series"]
    finally:
        srv.shutdown()
    assert srv._series_thread is None
    off = LLMServer(port_model, series_interval=None, **KW)
    try:
        assert off.metrics_series() is None and off.program_costs() == []
    finally:
        off.shutdown()
