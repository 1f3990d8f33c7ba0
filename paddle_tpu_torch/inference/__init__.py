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
`JournalTailer`), the radix prefix cache (`RadixPrefixCache`) and the
deployment predictor (`Config`, `create_predictor`, `Predictor`,
`PrecisionType`; `serving.standalone_load`, `PredictorPool`), under the
JAX package's public names.

The predictor (ref: AnalysisConfig, AnalysisPredictor's ZeroCopyRun)
runs a `jit.save` program (`.pt2`, weights inside) with the zero-copy
handle API: input handles `x{i}`, output handles `out{i}`, numpy in and
out at the boundary.  It runs on the card unless the `Config` says
`disable_gpu()` (`enable_use_gpu(device_id=)` picks a card); without a
card, `create_predictor` raises, as `default_device()` does.  The JAX
package deploys a `jax.export` module instead; the Analyzer's fusion
passes and TensorRT have no counterpart here (`enable_memory_optim` and
`switch_ir_optim` are inert, `enable_tensorrt_engine` raises)."""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
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
from .serving import (LLMServer, PredictorPool, StandalonePredictor,
                      standalone_load)

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
           "StandbyRouter", "FleetClient", "JournalTailer", "Config",
           "create_predictor", "Predictor", "PrecisionType"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class Config:
    """ref: AnalysisConfig — the model path and the device; the other
    knobs are accepted inert, TensorRT refused."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = None              # the card

    def set_model(self, model_path, params_path=None):
        self.model_path = model_path
        self.params_path = params_path

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = torch.device("cuda", device_id)

    def disable_gpu(self):
        self._device = torch.device("cpu")

    def enable_memory_optim(self, x=True):
        pass  # the caching allocator reuses memory already

    def switch_ir_optim(self, x=True):
        pass  # the program runs op by op, as exported

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError(
            "no TensorRT in the port: the predictor runs the exported "
            "program's operators (K1 as its Hopper kernel) as they are")

    def device(self):
        """The device the predictor runs on: the card unless
        `disable_gpu()` was called; raises when that card is missing."""
        if self._device is None:
            return default_device()
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"paddle_tpu_torch: {self._device} is not "
                               f"available; call Config.disable_gpu() to "
                               f"run on the host")
        return self._device


class _Handle:
    """Zero-copy tensor handle (ref: paddle_infer::Tensor)."""

    def __init__(self, name):
        self.name = name
        self._array = None

    def copy_from_cpu(self, arr):
        self._array = np.asarray(arr)

    def copy_to_cpu(self):
        return np.asarray(self._array)

    def reshape(self, shape):
        if self._array is not None:
            self._array = self._array.reshape(shape)

    def shape(self):
        return list(self._array.shape) if self._array is not None else None


class Predictor:
    """Runs the `jit.save` program at `config.model_path` (with or
    without `.pt2`) on `config.device()`: inputs from the handles `x{i}`
    (or `run(inputs)`), outputs into fresh handles `out{i}` and back as a
    list of numpy arrays."""

    def __init__(self, config: Config):
        self.config = config
        base = config.model_path
        if base.endswith(".pt2"):
            base = base[:-len(".pt2")]
        self._pred = standalone_load(base, device=config.device())
        self._inputs = [_Handle(f"x{i}")
                        for i in range(len(self._pred.input_avals))]
        self._outputs = []

    def get_input_names(self):
        return [h.name for h in self._inputs]

    def get_input_handle(self, name):
        for h in self._inputs:
            if h.name == name:
                return h
        raise KeyError(name)

    def get_output_names(self):
        return [h.name for h in self._outputs]

    def get_output_handle(self, name):
        for h in self._outputs:
            if h.name == name:
                return h
        raise KeyError(name)

    def run(self, inputs=None):
        """ZeroCopyRun (ref analysis_predictor.cc:1807): consumes the
        input handles, fills the output handles, and returns the
        outputs."""
        if inputs is not None:
            for h, a in zip(self._inputs, inputs):
                h.copy_from_cpu(a)
        out = self._pred.run(*(h._array for h in self._inputs))
        outs = out if isinstance(out, list) else [out]
        self._outputs = []
        for i, o in enumerate(outs):
            h = _Handle(f"out{i}")
            h.copy_from_cpu(o)
            self._outputs.append(h)
        return [h.copy_to_cpu() for h in self._outputs]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
