"""The port's disaggregated prefill -> decode handoff (engine sub-slice
(h): `Request(handoff=)`, `LLMServer(pool_role=)`,
`LLMServer.adopt({"kind": "handoff"})`) against the JAX package's, at
the knobs of its own suite (tests/test_disagg_serving.py): the `tiny`
preset, the same weights in both packages.

  * the handoff matrix's two fast cells (fp32 with speculation and an
    int8 pool; bf16 plain) and bf16 with an int8 pool: a request
    prefilled on a "prefill" server streams its finished blocks to a
    "decode" server chunk by chunk (at least two frames during the
    prefill) and ends `migrated` after its first token; the adopted
    stream equals the decode server's colocated stream token for token,
    and in fp32 the JAX engine's;
  * a torn chunk (`fabric.handoff_chunk`) finishes colocated on the
    prefill server with the same stream and stages nothing; a torn
    adoption (`handoff.adopt`) raises, and replaying the prompt on the
    decode server gives the same stream;
  * `pool_role` shows in `health_snapshot()` and `/healthz`; an unknown
    role raises ValueError.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMServer
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults

# the JAX suite's knobs (tests/test_disagg_serving.py:37-45)
KW = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
          prefill_chunk=8, kv_block_tokens=8, kv_blocks=12,
          preempt_policy="swap")
# 17 tokens: two full chunk frames stream during the prefill, the third
# block ships with the commit
P_HAND = (np.arange(11, 11 + 17) % 50).astype(np.int32)
# repetitive, so the n-gram drafter proposes with speculation on
P_REP = np.array([5, 6, 7] * 6, dtype=np.int32)
WAIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(dtype, seed):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny", dtype=dtype))
    tm = TModel(TConfig.from_preset("tiny", dtype=dtype), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {"float32": _pair("float32", 0), "bfloat16": _pair("bfloat16", 1)}


@pytest.fixture
def harness():
    inj = faults.get_injector()
    inj.clear()
    faults.ENABLED = True
    yield inj
    inj.clear()
    faults.ENABLED = False


def _wait(pred, msg, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {msg}")


def _servers(model, **kw):
    P = LLMServer(model, name="P", fabric={"timeout": 10.0},
                  pool_role="prefill", **kw)
    D = LLMServer(model, name="D", fabric={"timeout": 10.0},
                  pool_role="decode", **kw)
    return P, D


def _handoff(P, D, prompt, max_new, sid):
    """Prefill on P with D as the handoff target, then adopt on D:
    (the prefill side's request, the adopted stream)."""
    req = P.submit(prompt, max_new, session_id=sid,
                   handoff={"addr": list(D.fabric_address)})
    _wait(lambda: req.done, "the prefill side's completion")
    adopted = D.adopt({"kind": "handoff", "session_id": sid})
    return req, adopted.result(timeout=WAIT)


@pytest.mark.parametrize("dtype,spec,kv", [
    pytest.param("float32", 2, "int8", id="fp32-spec-kvint8"),
    pytest.param("bfloat16", None, None, id="bf16-plain-kvauto"),
    pytest.param("bfloat16", None, "int8", id="bf16-plain-kvint8")])
def test_handoff_equals_colocated(models, dtype, spec, kv):
    jm, tm = models[dtype]
    kw = dict(KW, kv_dtype=kv, speculation=spec)
    prompts, max_new = [P_HAND, P_REP], 12
    P, D = _servers(tm, **kw)
    try:
        refs = [D.result(D.submit(p, max_new), timeout=WAIT)
                for p in prompts]
        for i, (p, ref) in enumerate(zip(prompts, refs)):
            req, out = _handoff(P, D, p, max_new, f"s{i}")
            assert req.migrated and req.error is None
            # P delivered the first token; the adopted stream carries all
            assert list(req.tokens) == ref[:1]
            assert out == ref
        fab = P.health_snapshot()["fabric"]
        assert fab["handoff_chunks"] >= 2 * len(prompts)
        assert fab["handoff_bytes"] > 0
        assert D.health_snapshot()["fabric"]["handoff_staged"] == 0
        assert all(v == 0 for v in
                   D.health_snapshot()["fabric"]["integrity_failures"]
                   .values())
        if spec is not None:
            assert D.engine._m_spec_accepted.value > 0
    finally:
        P.shutdown()
        D.shutdown()
    if dtype == "float32":
        from paddle_tpu.inference import LLMEngine as JEngine
        jref = [list(t) for t in JEngine(jm, **kw).generate(prompts,
                                                            max_new)]
        assert jref == refs


def test_torn_chunk_falls_back_to_colocated(models, harness):
    tm = models["float32"][1]
    P, D = _servers(tm, **KW)
    try:
        ref = D.result(D.submit(P_HAND, 8), timeout=WAIT)
        rule = harness.inject("fabric.handoff_chunk", times=1)
        req = P.submit(P_HAND, 8, session_id="torn",
                       handoff={"addr": list(D.fabric_address)})
        out = P.result(req, timeout=WAIT)
        assert rule.fired == 1
        assert not req.migrated and out == ref
        with pytest.raises(KeyError):          # nothing staged on D
            D.adopt({"kind": "handoff", "session_id": "torn"})
    finally:
        P.shutdown()
        D.shutdown()


def test_torn_adopt_raises_and_replay_matches(models, harness):
    """A tripped `handoff.adopt` raises to the caller; replaying the
    prompt on the decode server gives the handed-off stream."""
    tm = models["float32"][1]
    P, D = _servers(tm, **KW)
    try:
        ref = D.result(D.submit(P_HAND, 8), timeout=WAIT)
        req = P.submit(P_HAND, 8, session_id="s-adopt",
                       handoff={"addr": list(D.fabric_address)})
        _wait(lambda: req.done, "the prefill side's completion")
        assert req.migrated
        rule = harness.inject("handoff.adopt", times=1)
        with pytest.raises(faults.InjectedFault):
            D.adopt({"kind": "handoff", "session_id": "s-adopt"})
        assert rule.fired == 1
        replay = D.result(D.submit(P_HAND, 8), timeout=WAIT)
        assert replay == ref
        adopted = D.adopt({"kind": "handoff", "session_id": "s-adopt"})
        assert adopted.result(timeout=WAIT) == ref    # still staged
    finally:
        P.shutdown()
        D.shutdown()


def test_pool_role_surfaces_and_validates(models):
    tm = models["float32"][1]
    with pytest.raises(ValueError):
        LLMServer(tm, pool_role="bogus", **KW)
    for role in ("prefill", "decode", "mixed"):
        s = LLMServer(tm, pool_role=role, metrics_port=0, **KW)
        try:
            assert s.health_snapshot()["pool_role"] == role
            host, port = s.metrics_address
            with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                        timeout=30) as r:
                assert json.loads(r.read())["pool_role"] == role
            assert s.fabric_address is None      # no fabric configured
        finally:
            s.shutdown()
