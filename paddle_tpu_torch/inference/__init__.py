"""paddle_tpu_torch.inference — the serving path: `LLMEngine` (the
continuous-batching paged-KV engine), `LLMServer` (its thread-safe
front), `KVPager` (the block-pool bookkeeping), `SpecConfig` (the
speculative-decoding knobs), the SLO tiers (`SLOTier`, `SLOTargets`,
`goodput`), the overload ladder (`OverloadConfig`,
`OverloadController`), the KV fabric (`DiskTier`, `FabricServer`,
`FabricError`, `SessionTicket`), the fleet's membership
(`LocalFleet`, `Replica`, `ReplicaLease`), its front door (`Router`,
`RouterRequest`, `RoutingJournal`, `PrefixShadow`, `AutoscalePolicy`;
`PoisonedRequest` and `StaleRouterEpoch`, raised for the router's
poison conviction and leadership epochs), the replica processes
(`ProcessFleet`, `ProcessReplica`, `RespawnCircuitOpen`), the
hot-standby control plane (`HARouter`, `StandbyRouter`, `FleetClient`,
`JournalTailer`) and the radix prefix cache (`RadixPrefixCache`), under
the JAX package's public names."""

from ..observability.slo import SLOTargets, SLOTier, goodput
from .engine import (DeadlineExceeded, EngineUnhealthy, LLMEngine,
                     Overloaded, PoisonedRequest, QueueFull, Request,
                     ResultTimeout, StaleRouterEpoch)
from .fleet_serving import LocalFleet, Replica, ReplicaLease
from .kv_fabric import DiskTier, FabricError, FabricServer, SessionTicket
from .kv_pager import BlocksExhausted, KVPager
from .ngram_draft import SpecConfig
from .overload import OverloadConfig, OverloadController
from .prefix_cache import RadixPrefixCache
from .process_fleet import ProcessFleet, ProcessReplica, RespawnCircuitOpen
from .router import (AutoscalePolicy, PrefixShadow, Router, RouterRequest,
                     RoutingJournal)
from .router_ha import FleetClient, HARouter, JournalTailer, StandbyRouter
from .serving import LLMServer

__all__ = ["LLMEngine", "LLMServer", "Request", "DeadlineExceeded",
           "QueueFull", "EngineUnhealthy", "ResultTimeout", "Overloaded",
           "KVPager", "BlocksExhausted", "SpecConfig", "SLOTier",
           "SLOTargets", "goodput", "OverloadConfig",
           "OverloadController", "DiskTier", "FabricServer",
           "FabricError", "SessionTicket", "LocalFleet", "Replica",
           "ReplicaLease", "RadixPrefixCache", "Router", "RouterRequest",
           "RoutingJournal", "PrefixShadow", "AutoscalePolicy",
           "PoisonedRequest", "StaleRouterEpoch", "ProcessFleet",
           "ProcessReplica", "RespawnCircuitOpen", "HARouter",
           "StandbyRouter", "FleetClient", "JournalTailer"]
