"""Device placement of the key-space-sharded index (DESIGN.md §13).

Port of ``repro.dist.sharding.shard_mesh``.  The JAX package builds a
1-D device mesh over the shards; the port needs only the device of each
shard, since every shard's ``FlatAFLI`` is built with its own explicit
``device`` and launches on that device's streams.  The logical-axis
rules and mesh scopes of the JAX module serve its models' sharding
hints, which have no counterpart on one card.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["shard_mesh"]


def shard_mesh(n_shards: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> List[torch.device]:
    """One device per shard: shard ``s`` lives on ``cuda:(s mod
    device_count)``, so shards wrap round-robin onto the visible cards
    when there are fewer cards than shards (as the JAX package wraps its
    devices); ``device="cpu"`` puts every shard on the CPU.  ``None`` or
    ``"cuda"`` without a card raises, as every entry point of the port
    does; an explicit ``cuda:i`` keeps every shard on that card."""
    dev = resolve_device(device)
    n = max(int(n_shards), 1)
    if dev.type == "cpu":
        return [dev] * n
    if dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", s % count) for s in range(n)]
