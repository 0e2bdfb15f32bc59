"""Serving subsystem: continuous-batching decode on the schedule IR
(reference: ``repro/serve``).  ``DecodeEngine`` runs the admit →
prefill-chunk → decode-round loop; ``PagedKVCache`` backs it with a page
pool; the work trace is a ``streaming`` schedule whose ``validate()``
audits the serving invariants."""
from .engine import DecodeEngine, EngineConfig, Request
from .kv_cache import PagedKVCache, gather_pages, scatter_prefill, scatter_token

__all__ = ["DecodeEngine", "EngineConfig", "PagedKVCache", "Request",
           "gather_pages", "scatter_prefill", "scatter_token"]
