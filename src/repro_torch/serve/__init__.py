"""Serving loops of the port: the LM continuous batcher, the paged KV
cache over the NFL page table, and the SLO front end over the index (with
its fault injection)."""

from repro_torch.serve.prefix_cache import (MAX_BLOCKS, NFLPageTable,
                                            composite_key, prefix_hash)

__all__ = ["NFLPageTable", "composite_key", "prefix_hash", "MAX_BLOCKS"]
