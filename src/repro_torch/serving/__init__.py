"""Speculative serving: the engine, the continuous-batching scheduler, its
offline (``LLMEngine``) and streaming (``AsyncEngine``) front ends, the
round-based baseline and cache operations."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (ABORTED, FINISHED, LLMEngine,
                                           Request, Scheduler,
                                           serve_round_based)
from repro_torch.serving.speculation import (SpeculationConfig,
                                             SpeculationController)
from repro_torch.serving.streaming import (AsyncEngine, StreamHandle,
                                           virtual_twin_report)
from repro_torch.serving import cache_ops
from repro_torch.serving.cache_ops import BlockAllocator, HostPagePool

__all__ = ["ABORTED", "AsyncEngine", "BlockAllocator", "Engine",
           "EngineConfig", "FINISHED", "HostPagePool", "LLMEngine",
           "PrefixCache", "Request", "SamplingParams", "Scheduler",
           "SpeculationConfig", "SpeculationController", "StreamHandle",
           "serve_round_based", "virtual_twin_report", "cache_ops"]
