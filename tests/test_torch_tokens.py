"""The port's token pipeline and LR schedules against the JAX package's.

Token streams must be bit-equal for every (seed, step, shard), from
``SyntheticTokens`` and from a ``FileTokens`` file written by the JAX
package's ``write_token_file``; the schedules must agree to 1 f32 ulp
over steps 0-200 (the two libraries' ``cos`` differ by up to an ulp)."""

import numpy as np
import pytest

from repro.data.tokens import FileTokens as JFileTokens
from repro.data.tokens import SyntheticTokens as JSyntheticTokens
from repro.data.tokens import write_token_file as j_write_token_file
from repro.train.schedule import ScheduleConfig as JScheduleConfig
from repro.train.schedule import make_schedule as j_make_schedule

from repro_torch.data.tokens import (FileTokens, SyntheticTokens, TokenBatch,
                                     write_token_file)
from repro_torch.train.schedule import ScheduleConfig, make_schedule


def _same_batches(a, b, n):
    for _ in range(n):
        x, y = a.next_batch(), b.next_batch()
        assert isinstance(x, TokenBatch)
        assert x.step == y.step
        assert x.tokens.dtype == y.tokens.dtype == np.int32
        assert np.array_equal(x.tokens, y.tokens)
        assert np.array_equal(x.targets, y.targets)


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq=32, local_batch=4),
    dict(vocab=92544, seq=64, local_batch=2, seed=7, shard=3, n_shards=4),
    dict(vocab=4096, seq=128, local_batch=8, seed=42, n_states=32,
         alpha=0.03),
])
def test_synthetic_tokens_bit_equal(kw):
    _same_batches(SyntheticTokens(**kw), JSyntheticTokens(**kw), 4)


def test_synthetic_tokens_resume_from_state():
    """A pipeline restored from ``state_dict`` continues the stream."""
    kw = dict(vocab=512, seq=16, local_batch=3, seed=5)
    a = SyntheticTokens(**kw)
    for _ in range(3):
        a.next_batch()
    b = SyntheticTokens(**kw)
    b.load_state_dict(a.state_dict())
    j = JSyntheticTokens(**kw)
    j.load_state_dict({"step": 3})
    _same_batches(b, j, 2)


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2), (3, 4)])
def test_file_tokens_bit_equal(tmp_path, shard, n_shards):
    """A file written by the JAX package reads the same through both
    packages, across an epoch boundary (the per-epoch shuffle)."""
    toks = np.random.default_rng(0).integers(0, 50_000, 1_000)
    path = str(tmp_path / "toks.bin")
    j_write_token_file(path, toks)
    kw = dict(seq=16, local_batch=4, shard=shard, n_shards=n_shards,
              seed=3)
    _same_batches(FileTokens(path, **kw), JFileTokens(path, **kw), 8)


def test_write_token_file_same_bytes(tmp_path):
    toks = np.random.default_rng(1).integers(0, 2**31, 257)
    write_token_file(str(tmp_path / "t.bin"), toks)
    j_write_token_file(str(tmp_path / "j.bin"), toks)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(peak_lr=3e-3, warmup_steps=30, total_steps=300, min_ratio=0.5),
    dict(peak_lr=5e-3, warmup_steps=5, total_steps=100),
])
def test_schedule_within_one_ulp(kind, kw):
    js = j_make_schedule(JScheduleConfig(kind=kind, **kw))
    ts = make_schedule(ScheduleConfig(kind=kind, **kw))
    want = np.array([np.float32(js(s)) for s in range(201)])
    got = np.array([ts(s).item() for s in range(201)], np.float32)
    assert ts(0).dtype.is_floating_point and ts(0).shape == ()
    assert _ulps(got, want).max() <= 1, (kind, kw, _ulps(got, want).max())


def test_schedule_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        make_schedule(ScheduleConfig(kind="step"))
