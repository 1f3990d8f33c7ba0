"""paddle_tpu_torch.testing — the fault-injection harness the engine's
and the store's fault sites consult, and the file-damage helpers
(`faults.py`)."""

from .faults import (FaultInjector, InjectedConnectionError, InjectedFault,
                     corrupt_bytes, fire, get_injector, truncate_file)

__all__ = ["FaultInjector", "InjectedFault", "InjectedConnectionError",
           "fire", "get_injector", "truncate_file", "corrupt_bytes"]
