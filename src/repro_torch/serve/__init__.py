"""Serving loops of the port: the LM continuous batcher, the SLO front
end over the index (with its fault injection), and the NFL page table."""

from repro_torch.serve.prefix_cache import (MAX_BLOCKS, NFLPageTable,
                                            composite_key, prefix_hash)

__all__ = ["NFLPageTable", "composite_key", "prefix_hash", "MAX_BLOCKS"]
