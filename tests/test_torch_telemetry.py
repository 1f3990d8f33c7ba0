"""StepTelemetry of the PyTorch port
(paddle_tpu_torch/observability/telemetry.py): the JAX package's cases
(tests/test_observability.py's phases / EMAs and profiler spans,
tests/test_tracing.py's error tagging) run against the port's copy, whose
profiler spans are `torch.profiler.record_function` ranges; and the
metric names against the JAX module's for the same namespace."""

import pytest
import torch

from paddle_tpu_torch.observability import (MetricsRegistry, StepTelemetry,
                                            tracing)


def _val(snap, name):
    return snap[name]["series"][""]["value"]


@pytest.fixture
def traced(tmp_path):
    """Tracing on, a small private ring; the process-global recorder's
    state restored afterwards."""
    prev_enabled = tracing.enabled()
    prev_cap = tracing.recorder().capacity
    tracing.recorder().clear()
    tracing.configure(enabled=True, capacity=256, flight_dir=str(tmp_path))
    yield tmp_path
    tracing.configure(enabled=prev_enabled, capacity=prev_cap,
                      flight_dir="")
    tracing.recorder().clear()


def test_step_telemetry_phases_and_emas():
    reg = MetricsRegistry()
    tel = StepTelemetry(registry=reg, namespace="tr")
    for _ in range(4):
        with tel.phase("data"):
            pass
        with tel.phase("train_step"):
            pass
        tel.step(n_items=8)
    snap = reg.snapshot()
    ph = snap["tr_phase_seconds"]["series"]
    assert ph["phase=data"]["count"] == 4
    assert ph["phase=train_step"]["count"] == 4
    assert _val(snap, "tr_steps_total") == 4
    assert _val(snap, "tr_items_total") == 32
    # the first step arms the clock; the EMAs exist from the second on
    assert _val(snap, "tr_step_time_seconds_ema") > 0
    assert _val(snap, "tr_items_per_sec_ema") > 0
    assert set(tel.snapshot()) == {k for k in snap if k.startswith("tr_")}


def test_step_telemetry_phase_spans_reach_profiler():
    """A phase is a record_function range a running torch.profiler
    sees under `{namespace}/{phase}`."""
    from torch.profiler import ProfilerActivity, profile
    tel = StepTelemetry(registry=MetricsRegistry(), namespace="tr")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.phase("data"):
            torch.ones(4).sum()
    assert "tr/data" in {e.key for e in prof.key_averages()}


def test_step_telemetry_phase_error_tagged(traced):
    reg = MetricsRegistry()
    tel = StepTelemetry(registry=reg, namespace="tr")
    with pytest.raises(ValueError):
        with tel.phase("data"):
            raise ValueError("bad batch")
    with tel.phase("data"):
        pass
    spans = [s for s in tracing.snapshot_spans() if s["name"] == "tr/data"]
    assert len(spans) == 2
    assert spans[0].get("error") is True       # the raising bracket
    assert "error" not in spans[1]
    # the phase histogram still observed both brackets
    ph = reg.snapshot()["tr_phase_seconds"]["series"]
    assert ph["phase=data"]["count"] == 2


def test_ema_rule_and_metric_names_are_the_jax_modules(monkeypatch):
    """Both modules' registries hold the same metric names, and the
    EMA of given step times follows the JAX rule (steps marked at 10,
    11 and 14 s with w 0.5: 1, then 0.5 * 1 + 0.5 * 3 = 2)."""
    pytest.importorskip("jax")
    import paddle_tpu_torch.observability.telemetry as T
    from paddle_tpu.observability import MetricsRegistry as JReg
    from paddle_tpu.observability import StepTelemetry as JTel
    jreg, treg = JReg(), MetricsRegistry()
    for tel in (JTel(registry=jreg, namespace="ft"),
                StepTelemetry(registry=treg, namespace="ft")):
        with tel.phase("data"):
            pass
        tel.step(n_items=2)
    assert set(jreg.snapshot()) == set(treg.snapshot())
    reg = MetricsRegistry()
    tel = StepTelemetry(registry=reg, namespace="e", ema=0.5)
    for now in (10.0, 11.0, 14.0):
        monkeypatch.setattr(T.time, "perf_counter", lambda: now)
        tel.step(n_items=4)
    assert _val(reg.snapshot(), "e_step_time_seconds_ema") == 2.0
    assert _val(reg.snapshot(), "e_items_per_sec_ema") == \
        0.5 * 4 + 0.5 * 4 / 3


def test_step_telemetry_is_exported():
    import paddle_tpu_torch.observability as O
    assert "StepTelemetry" in O.__all__ and O.StepTelemetry is StepTelemetry
