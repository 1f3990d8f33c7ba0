"""paddle_tpu_torch.inference — the serving path: `LLMEngine` (the
continuous-batching paged-KV engine), `LLMServer` (its thread-safe
front), `KVPager` (the block-pool bookkeeping) and `SpecConfig` (the
speculative-decoding knobs), under the JAX package's public names."""

from .engine import (DeadlineExceeded, EngineUnhealthy, LLMEngine,
                     QueueFull, Request, ResultTimeout)
from .kv_pager import BlocksExhausted, KVPager
from .ngram_draft import SpecConfig
from .serving import LLMServer

__all__ = ["LLMEngine", "LLMServer", "Request", "DeadlineExceeded",
           "QueueFull", "EngineUnhealthy", "ResultTimeout", "KVPager",
           "BlocksExhausted", "SpecConfig"]
