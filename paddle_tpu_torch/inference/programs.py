"""The serving engine's decode step as CUDA graphs — the port's
counterpart of the JAX engine's jitted `_step_fn` and its bounded
compile count (`paddle_tpu/inference/engine.py:931-943`, `:1640-1654`).

    graphs = DecodeGraphs(step, widths=(1, 2, 4, 8), n_cols=Bmax,
                          device=dev)
    graphs.capture(w)                      # once per width, at boot
    inputs = graphs.inputs(w)              # flat int32 device buffer
    inputs.copy_(staged, non_blocking=True)
    logits, greedy = graphs.replay(w)      # static (w, V), (w,) int64

`step(token, pos, table)` is the eager decode step (the paged forward,
its K4 calls inside); it returns the (w, V) logits.  For each decode
width `w` one graph records it once over static device buffers:

  * inputs  — ONE flat int32 buffer [token (w) | pos (w) | table
    (w * n_cols)], so a step's inputs cross in one host-to-device copy;
    `token`, `pos` and `table` are contiguous views of it;
  * outputs — the logits (w, V) and their greedy argmax (w,) int64,
    written by every replay in place: a reader of either must be
    ordered before the next replay of the same width on the stream.

All widths share one memory pool (`torch.cuda.graph_pool_handle()`):
they replay one at a time on one stream, and each keeps references to
its own outputs, so no capture reuses another's outputs.

The warm-up run that precedes a capture EXECUTES the step, so it
writes K/V.  It runs with token 0, pos 0 and all-trash table rows
(block 0, see `kv_pager.TRASH_BLOCK`): every write lands in the trash
block, so a width first seen mid-serving never touches a live slot's
rows.  The capture itself launches nothing.

Launch counts.  A kernel wrapper counts its launch when it is called,
and during a capture it is called but launches nothing: the launches
it counted there are taken back and recorded per graph
(`recorded[w]`), and every replay adds them again, so a kernel's
count stays "launches that ran on the card".

A failed capture or replay raises; nothing falls back to the eager
step.  The graphs exist only on a CUDA device: the CPU has none, and
the engine runs the eager step there.
"""

from __future__ import annotations

import torch

from ..ops import paged_attention as _PA

__all__ = ["DecodeGraphs"]


class DecodeGraphs:
    """One captured decode step per width over static buffers (see the
    module docstring).  `replays` counts replays over all widths;
    `recorded[w]` is {kernel: launches one replay of width w makes}."""

    def __init__(self, step, widths, n_cols, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{device}")
        self._step = step
        self.widths = tuple(int(w) for w in widths)
        self.n_cols = int(n_cols)
        self.device = device
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs = {}        # w -> torch.cuda.CUDAGraph
        self._inputs = {}        # w -> flat int32 device buffer
        self._outputs = {}       # w -> (logits, greedy)
        self.recorded = {}       # w -> {kernel: launches per replay}
        self.replays = 0

    def __len__(self):
        return len(self._graphs)

    def flat_len(self, w):
        """int32 elements of width `w`'s input buffer."""
        return w * (2 + self.n_cols)

    def views(self, flat, w):
        """(token (w,), pos (w,), table (w, n_cols)) views of a flat
        buffer (a tensor or a numpy array) laid out as `inputs(w)`."""
        return (flat[:w], flat[w:2 * w],
                flat[2 * w:self.flat_len(w)].reshape(w, self.n_cols))

    def inputs(self, w):
        """Width `w`'s static input buffer (captured on first use)."""
        self.capture(w)
        return self._inputs[w]

    def _run(self, w):
        logits = self._step(*self.views(self._inputs[w], w))
        return logits, torch.argmax(logits.to(torch.float32), dim=-1)

    def capture(self, w):
        """Warm width `w` up on trash tables, then capture it (once)."""
        if w in self._graphs:
            return
        if w not in self.widths:
            raise ValueError(f"decode width {w} is not one of "
                             f"{self.widths}")
        flat = torch.zeros(self.flat_len(w), dtype=torch.int32,
                           device=self.device)     # all rows trash
        self._inputs[w] = flat
        # warm-up on the current stream: builds and loads the kernels
        # and lets cuBLAS choose its algorithms before the capture
        self._run(w)
        torch.cuda.current_stream(self.device).synchronize()
        before = dict(_PA.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # "thread_local": another thread's CUDA call (an LLMServer
        # caller) does not invalidate a capture on the driver thread
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            out = self._run(w)
        self.recorded[w] = {k: _PA.LAUNCHES[k] - n
                            for k, n in before.items()}
        _PA.LAUNCHES.update(before)     # the capture launched nothing
        self._graphs[w] = graph
        self._outputs[w] = out

    def replay(self, w):
        """Run width `w`'s graph on whatever its input buffer holds;
        returns its static (logits, greedy) buffers."""
        graph = self._graphs.get(w)
        if graph is None:
            raise RuntimeError(f"decode width {w} was never captured")
        graph.replay()
        self.replays += 1
        for k, n in self.recorded[w].items():
            _PA.LAUNCHES[k] += n
        return self._outputs[w]
