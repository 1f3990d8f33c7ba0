"""paddle_tpu_torch.inference — the serving path: `LLMEngine` (the
continuous-batching paged-KV engine), `LLMServer` (its thread-safe
front) and `KVPager` (the block-pool bookkeeping), under the JAX
package's public names."""

from .engine import (DeadlineExceeded, EngineUnhealthy, LLMEngine,
                     QueueFull, Request, ResultTimeout)
from .kv_pager import BlocksExhausted, KVPager
from .serving import LLMServer

__all__ = ["LLMEngine", "LLMServer", "Request", "DeadlineExceeded",
           "QueueFull", "EngineUnhealthy", "ResultTimeout", "KVPager",
           "BlocksExhausted"]
