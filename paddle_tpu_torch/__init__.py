"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module paths (`models/llama.py`, `models/llama_decode.py`,
`inference/engine.py`, ...) so each counterpart is easy to find, and
is PyTorch inside: `nn.Module`s and plain functions on tensors, an
explicit `device=` argument, explicit `torch.Generator`s.  It imports
neither JAX nor anything of `paddle_tpu`.

Every kernel the JAX package wrote in Pallas for the TPU is, in this
package, a kernel written by hand for Hopper (`csrc/*.cu`, built at
first use by `ops/_build.py`).  Entry points run on the card unless the
caller passes `device="cpu"`; with no card and no explicit CPU request
they raise rather than quietly run on the host.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["seed", "default_device", "resolve_device", "__version__", "amp",
           "quantization"]


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none:
    the first CUDA card.  Raises when there is no card — a run that
    asked for the card never falls back to the CPU silently."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run on the host")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or `default_device()` for None."""
    return default_device() if device is None else torch.device(device)


def seed(value: int, device=None) -> torch.Generator:
    """A `torch.Generator` on `device` (the default device for None)
    seeded with `value` — the port's counterpart of `paddle.seed`.  The
    port keeps no global RNG state: callers pass the generator on."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(value))
    return g


from . import amp, quantization  # noqa: E402  (they use the above)
