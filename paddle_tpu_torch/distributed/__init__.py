"""paddle_tpu_torch.distributed — the control plane's host-side store
(`store.TCPStore`, with its WAL, leases' grace and fencing epochs).
The collectives over `torch.distributed` come with multi-GPU serving
and training (ROADMAP queue 1 item 5)."""

from .store import StoreError, StoreTimeout, TCPStore

__all__ = ["TCPStore", "StoreError", "StoreTimeout"]
