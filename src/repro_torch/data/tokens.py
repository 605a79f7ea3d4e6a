"""LM token pipeline: deterministic, shard-aware, checkpointable.

Port of ``repro.data.tokens``, kept as numpy code (the port's own copy):
the batch streams are bit-equal to the JAX package's for every
``(seed, step, shard)``.

Two sources:

* ``SyntheticTokens`` -- seeded per (shard, step): every data-parallel rank
  derives its batch slice from a counter-based hash, so restarts and
  elastic re-sharding reproduce the exact global batch without coordination
  (no file locks, no state exchange).  The stream has n-gram structure (a
  small latent Markov chain) so cross-entropy is learnable, as the
  end-to-end training example needs.
* ``FileTokens`` -- memory-mapped binary shards (a u64 token count, then
  u32 tokens), strided by (rank, world) with a deterministic shuffle per
  epoch.

State is a single integer step, so it goes into checkpoints whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticTokens", "FileTokens", "TokenBatch", "write_token_file"]


@dataclasses.dataclass
class TokenBatch:
    tokens: np.ndarray   # [local_batch, seq] int32
    targets: np.ndarray  # [local_batch, seq] int32 (next-token)
    step: int


def _counter_rng(seed: int, step: int, shard: int) -> np.random.Generator:
    # counter-based: independent stream per (seed, step, shard)
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, shard))
    )


class SyntheticTokens:
    """Markov-structured synthetic corpus, deterministic per (step, shard)."""

    def __init__(self, vocab: int, seq: int, local_batch: int,
                 shard: int = 0, n_shards: int = 1, seed: int = 1234,
                 n_states: int = 64, alpha: float = 0.2):
        self.vocab = vocab
        self.seq = seq
        self.local_batch = local_batch
        self.shard = shard
        self.n_shards = n_shards
        self.seed = seed
        self.step = 0
        base = np.random.default_rng(seed)
        # latent chain: each state emits a distinct token band
        # alpha: transition sharpness (small -> near-deterministic chain
        # -> strong, fast-to-learn bigram signal for the e2e example)
        self._trans = base.dirichlet(np.ones(n_states) * alpha, size=n_states)
        self._trans_cdf = np.cumsum(self._trans, axis=1)
        self._n_states = n_states
        self._band = max(vocab // n_states, 1)

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, st):
        self.step = int(st["step"])

    def next_batch(self) -> TokenBatch:
        rng = _counter_rng(self.seed, self.step, self.shard)
        b, s = self.local_batch, self.seq + 1
        states = np.empty((b, s), np.int64)
        states[:, 0] = rng.integers(0, self._n_states, b)
        u = rng.uniform(0, 1, (b, s))
        for t in range(1, s):
            states[:, t] = np.array(
                [np.searchsorted(self._trans_cdf[st], uu)
                 for st, uu in zip(states[:, t - 1], u[:, t])]
            )
        offs = rng.integers(0, self._band, (b, s))
        toks = (states * self._band + offs) % self.vocab
        toks = toks.astype(np.int32)
        batch = TokenBatch(tokens=toks[:, :-1], targets=toks[:, 1:], step=self.step)
        self.step += 1
        return batch


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens = np.asarray(tokens, dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(np.array([tokens.shape[0]], dtype=np.uint64).tobytes())
        f.write(tokens.tobytes())


class FileTokens:
    """Memory-mapped token shards with deterministic per-epoch shuffling."""

    def __init__(self, path: str, seq: int, local_batch: int,
                 shard: int = 0, n_shards: int = 1, seed: int = 0):
        n = int(np.fromfile(path, dtype=np.uint64, count=1)[0])
        self._data = np.memmap(path, dtype=np.uint32, mode="r", offset=8,
                               shape=(n,))
        self.seq = seq
        self.local_batch = local_batch
        self.shard = shard
        self.n_shards = n_shards
        self.seed = seed
        self.step = 0
        self._n_windows = max((n - 1) // seq, 1)

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, st):
        self.step = int(st["step"])

    def next_batch(self) -> TokenBatch:
        gb = self.local_batch * self.n_shards
        epoch = (self.step * gb) // self._n_windows
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(epoch,))
        )
        perm = rng.permutation(self._n_windows)
        base = (self.step * gb) % self._n_windows
        idx = perm[(base + self.shard * self.local_batch
                    + np.arange(self.local_batch)) % self._n_windows]
        toks = np.stack(
            [self._data[i * self.seq : i * self.seq + self.seq + 1]
             for i in idx]
        ).astype(np.int32)
        if toks.shape[1] < self.seq + 1:  # short tail window
            toks = np.pad(toks, ((0, 0), (0, self.seq + 1 - toks.shape[1])))
        batch = TokenBatch(tokens=toks[:, :-1], targets=toks[:, 1:], step=self.step)
        self.step += 1
        return batch
