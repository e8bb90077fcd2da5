"""Serving: ``deepspeed_tpu_torch.init_inference()``.

  config.py    — the ds_config ``inference`` section
  kv_cache.py  — slot (contiguous) and paged (page-pool) KV caches
  paging.py    — host-side page allocator / prefix cache / chunk plans
  engine.py    — InferenceEngine: prefill chunks + batched decode
  sampling.py  — greedy/temperature/top-k/top-p
  scheduler.py — continuous batching at decode-step granularity with
                 chunked-prefill admission, preemption and speculative
                 verify steps
  speculative.py — n-gram and draft-model drafters
"""
from .config import DeepSpeedInferenceConfig, DeepSpeedInferenceConfigError
from .engine import InferenceEngine
from .kv_cache import KVCache, PagedKVCache
from .paging import PageAllocator, PrefixCache
from .scheduler import ContinuousBatchingScheduler, InferenceRequest
