"""StepTelemetry — the training-loop bracket, the port of
`paddle_tpu/observability/telemetry.py`: one object that opens profiler
spans and feeds the metrics registry.

Usable around any eager loop:

    tel = StepTelemetry(namespace="train")
    for batch in loader:
        with tel.phase("data"):        xb, yb = batch
        with tel.phase("train_step"):  loss = step(xb, yb)
        tel.step(n_items=len(xb))

Every phase is a `torch.profiler.record_function` span named
`{namespace}/{phase}` (a running `torch.profiler.profile` shows the step
anatomy), a span of the port's `observability.tracing` recorder (when
tracing is enabled) and an observation in a per-phase histogram of the
registry, so the dashboards exist with no profiler attached.  The
metric names and the EMA rule are the JAX module's:
`{ns}_phase_seconds{phase=}`, `{ns}_steps_total`, `{ns}_items_total`,
`{ns}_step_time_seconds_ema`, `{ns}_items_per_sec_ema`.

Phases time the host: a phase that launches work on the card and does
not wait for it measures the launch.  Time a step end to end with a
synchronising read inside it (the loss's `.item()`)."""

from __future__ import annotations

import time
from contextlib import contextmanager

from .metrics import get_registry, log_buckets

__all__ = ["StepTelemetry"]


class StepTelemetry:
    """Phase brackets + step-time / throughput EMAs.

    `ema` is the smoothing factor of the exponential moving averages
    (the weight of the newest step), so a long job's gauges follow the
    current regime, not its first steps."""

    def __init__(self, registry=None, namespace="train", ema=0.1):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.namespace = namespace
        self._ema_w = float(ema)
        self._phase_hist = reg.histogram(
            f"{namespace}_phase_seconds",
            help="wall time per step phase (data/forward/backward/"
                 "optimizer or data/train_step under hapi fit)",
            labelnames=("phase",),
            buckets=log_buckets(1e-5, 600.0, per_decade=2))
        self._steps = reg.counter(f"{namespace}_steps_total",
                                  help="optimizer steps completed")
        self._items = reg.counter(f"{namespace}_items_total",
                                  help="items (examples/tokens) consumed")
        self._step_ema = reg.gauge(
            f"{namespace}_step_time_seconds_ema",
            help="EMA of end-to-end step wall time")
        self._tput_ema = reg.gauge(
            f"{namespace}_items_per_sec_ema",
            help="EMA of items/s throughput (0 until n_items is passed)")
        self._phase_children: dict = {}
        self._t_step = None
        self._ema_step = None
        self._ema_tput = None

    @contextmanager
    def phase(self, name: str):
        """Bracket one phase: a `record_function` span, a tracing span
        and a histogram observation.  An exception escaping the body
        still records the phase — the tracing span tagged
        ``error=True`` — then propagates."""
        from torch.profiler import record_function
        from . import tracing
        child = self._phase_children.get(name)
        if child is None:
            child = self._phase_hist.labels(phase=name)
            self._phase_children[name] = child
        span = f"{self.namespace}/{name}"
        tr0 = tracing.t0()
        t0 = time.perf_counter()
        err = False
        try:
            with record_function(span):
                yield
        except BaseException:
            err = True
            raise
        finally:
            child.observe(time.perf_counter() - t0)
            tracing.end(span, tr0, error=err)

    def step(self, n_items=None):
        """Mark the end of one optimizer step.  Step time is measured
        mark to mark (so it includes data time); the first call only
        arms the clock."""
        now = time.perf_counter()
        self._steps.inc()
        if n_items:
            self._items.inc(n_items)
        if self._t_step is not None:
            dt = now - self._t_step
            w = self._ema_w
            self._ema_step = dt if self._ema_step is None else \
                (1 - w) * self._ema_step + w * dt
            self._step_ema.set(self._ema_step)
            if n_items and dt > 0:
                tput = n_items / dt
                self._ema_tput = tput if self._ema_tput is None else \
                    (1 - w) * self._ema_tput + w * tput
                self._tput_ema.set(self._ema_tput)
        self._t_step = now

    def reset_clock(self):
        """Disarm the mark-to-mark timer (across epochs or evaluation
        pauses, so the gap stays out of the EMA)."""
        self._t_step = None

    def snapshot(self) -> dict:
        """This telemetry's slice of the registry snapshot."""
        full = self.registry.snapshot()
        pre = f"{self.namespace}_"
        return {k: v for k, v in full.items() if k.startswith(pre)}
