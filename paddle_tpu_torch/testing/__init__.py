"""paddle_tpu_torch.testing — the fault-injection harness the engine's
fault sites consult (`faults.py`)."""

from .faults import FaultInjector, InjectedFault, fire, get_injector

__all__ = ["FaultInjector", "InjectedFault", "fire", "get_injector"]
