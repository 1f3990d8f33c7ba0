"""The serving engine's decode and verify steps as CUDA graphs — the
port's counterpart of the JAX engine's jitted `_step_fn` / `verify_fn`
and its bounded compile count (`paddle_tpu/inference/engine.py:931-943`,
`:1024-1044`, `:1640-1654`).

    graphs = DecodeGraphs(step, widths=(1, 2, 4, 8), n_cols=Bmax,
                          device=dev)
    graphs.capture(w)                      # once per width, at boot
    inputs = graphs.inputs(w)              # flat int32 device buffer
    inputs.copy_(staged, non_blocking=True)
    logits, greedy = graphs.replay(w)      # static (w, V), (w,) int64

    verify = VerifyGraphs(vstep, widths=(2, 4, 8), batch=8, n_cols=Bmax,
                          device=dev, pool=graphs.pool)
    logits, packed = verify.replay(W)      # (8, W, V), (8 * W + 8,) int64

`step(token, pos, table)` is the eager decode step (the paged forward,
its K4 calls inside); it returns the (w, V) logits.  `vstep(tokens,
pos, valid, table)` is the eager verify step; it returns the (B, W, V)
logits and one packed int64 vector [greedy argmax (B * W) | greedy
accept length (B)].  One graph records each width once over static
device buffers:

  * inputs  — ONE flat int32 buffer, so a step's inputs cross in one
    host-to-device copy: [token (w) | pos (w) | table (w * n_cols)] for
    a decode width w, [tokens (B * W) | pos (B) | valid (B) | table
    (B * n_cols)] for a verify width W (verify steps always run at the
    engine's full width B); `views` gives contiguous views of it;
  * outputs — written by every replay in place: a reader must be
    ordered before the next replay of the same graph on the stream.

Decode and verify graphs share one memory pool
(`torch.cuda.graph_pool_handle()`): they replay one at a time on one
stream, and each keeps references to its own outputs, so no capture
reuses another's outputs.

The warm-up run that precedes a capture EXECUTES the step, so it
writes K/V.  It runs with token 0, pos 0 and all-trash table rows
(block 0, see `kv_pager.TRASH_BLOCK`): every write lands in the trash
block, so a width first seen mid-serving never touches a live slot's
rows.  The capture itself launches nothing.

Launch counts.  A kernel wrapper (K4; Q1 with weight-only int8
weights) counts its launch when it is called,
and during a capture it is called but launches nothing: the launches
it counted there are taken back and recorded per graph
(`recorded[w]`), and every replay adds them again, so a kernel's
count stays "launches that ran on the card".

With a tiered engine (`hot_window`) the step also reads the host
extension tier: pinned memory allocated once at its full size, whose
address each graph records (K4 reads it in place).  A spill or promote
changes only table entries and the tier's bytes, so no graph is
captured again.

A failed capture or replay raises; nothing falls back to the eager
step.  The graphs exist only on a CUDA device: the CPU has none, and
the engine runs the eager steps there.
"""

from __future__ import annotations

import torch

from ..ops import paged_attention as _PA
from ..ops import wo_int8_matmul as _Q1

# the launch counters of the kernels a serving step runs: K4, and Q1
# with weight-only int8 weights (each key is one kernel's)
_COUNTERS = (_PA.LAUNCHES, _Q1.LAUNCHES)

__all__ = ["DecodeGraphs", "VerifyGraphs", "unpack_verify"]


def unpack_verify(packed, batch, W):
    """(argmax (batch, W), accept length (batch,)) views of a verify
    step's packed output (a tensor or a numpy array)."""
    n = batch * W
    return packed[:n].reshape(batch, W), packed[n:n + batch]


class _Graphs:
    """One captured step per width over static buffers (see the module
    docstring).  `replays` counts replays over all widths; `recorded[w]`
    is {kernel: launches one replay of width w makes}."""

    kind = ""

    def __init__(self, step, widths, n_cols, device, pool=None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{device}")
        self._step = step
        self.widths = tuple(int(w) for w in widths)
        self.n_cols = int(n_cols)
        self.device = device
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._graphs = {}        # w -> torch.cuda.CUDAGraph
        self._inputs = {}        # w -> flat int32 device buffer
        self._outputs = {}       # w -> the step's outputs
        self.recorded = {}       # w -> {kernel: launches per replay}
        self.replays = 0

    def __len__(self):
        return len(self._graphs)

    def inputs(self, w):
        """Width `w`'s static input buffer (captured on first use)."""
        self.capture(w)
        return self._inputs[w]

    def capture(self, w):
        """Warm width `w` up on trash tables, then capture it (once)."""
        if w in self._graphs:
            return
        if w not in self.widths:
            raise ValueError(f"{self.kind} width {w} is not one of "
                             f"{self.widths}")
        flat = torch.zeros(self.flat_len(w), dtype=torch.int32,
                           device=self.device)     # all rows trash
        self._inputs[w] = flat
        # warm-up on the current stream: builds and loads the kernels
        # and lets cuBLAS choose its algorithms before the capture
        self._run(w)
        torch.cuda.current_stream(self.device).synchronize()
        before = [dict(c) for c in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        # "thread_local": another thread's CUDA call (an LLMServer
        # caller) does not invalidate a capture on the driver thread
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = self._run(w)
        self.recorded[w] = {k: c[k] - n for c, b in zip(_COUNTERS, before)
                            for k, n in b.items()}
        for c, b in zip(_COUNTERS, before):
            c.update(b)                 # the capture launched nothing
        self._graphs[w] = graph
        self._outputs[w] = out

    def replay(self, w):
        """Run width `w`'s graph on whatever its input buffer holds;
        returns its static output buffers."""
        graph = self._graphs.get(w)
        if graph is None:
            raise RuntimeError(f"{self.kind} width {w} was never captured")
        graph.replay()
        self.replays += 1
        for c in _COUNTERS:
            for k in c:
                c[k] += self.recorded[w][k]
        return self._outputs[w]


class DecodeGraphs(_Graphs):
    """The decode step, one graph per decode width `w`: inputs [token
    (w) | pos (w) | table (w * n_cols)], outputs (logits (w, V), greedy
    argmax (w,) int64)."""

    kind = "decode"

    def flat_len(self, w):
        """int32 elements of width `w`'s input buffer."""
        return w * (2 + self.n_cols)

    def views(self, flat, w):
        """(token (w,), pos (w,), table (w, n_cols)) views of a flat
        buffer (a tensor or a numpy array) laid out as `inputs(w)`."""
        return (flat[:w], flat[w:2 * w],
                flat[2 * w:self.flat_len(w)].reshape(w, self.n_cols))

    def _run(self, w):
        logits = self._step(*self.views(self._inputs[w], w))
        return logits, torch.argmax(logits.to(torch.float32), dim=-1)


class VerifyGraphs(_Graphs):
    """The verify step, one graph per verify width `W` at the engine's
    full width `batch`: inputs [tokens (B * W) | pos (B) | valid (B) |
    table (B * n_cols)], outputs (logits (B, W, V), packed int64 [greedy
    argmax (B * W) | greedy accept length (B)])."""

    kind = "verify"

    def __init__(self, step, widths, batch, n_cols, device, pool=None):
        super().__init__(step, widths, n_cols, device, pool)
        self.batch = int(batch)

    def flat_len(self, W):
        """int32 elements of width `W`'s input buffer."""
        return self.batch * (W + 2 + self.n_cols)

    def views(self, flat, W):
        """(tokens (B, W), pos (B,), valid (B,), table (B, n_cols))
        views of a flat buffer laid out as `inputs(W)`."""
        B = self.batch
        n = B * W
        return (flat[:n].reshape(B, W), flat[n:n + B],
                flat[n + B:n + 2 * B],
                flat[n + 2 * B:self.flat_len(W)].reshape(B, self.n_cols))

    def _run(self, W):
        return self._step(*self.views(self._inputs[W], W))
