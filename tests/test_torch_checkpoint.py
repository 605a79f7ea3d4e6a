"""The port's checkpointing and the trainer's restart, preemption and
re-placement.

The on-disk format is the port's own (``manifest.json`` and
``torch.save``d leaves; the JAX package writes msgpack and npz), so the
guarantees are held directly: a step dir without ``COMMIT`` is ignored,
``keep`` newest steps stay, bf16 leaves round-trip bit for bit, an async
save is complete after ``wait_pending``, a restarted trainer resumes the
exact state and data stream, SIGTERM leaves a committed final
checkpoint, and a step that raises partway through its in-place update
commits none."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import (AdafactorConfig, AdafactorState,
                                         AdamWConfig, adafactor_init,
                                         adamw_init)
from repro_torch.train.schedule import ScheduleConfig
from repro_torch.train.train_step import TrainConfig, TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _state(opt="adamw", dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(64, 32, generator=g).to(dtype),
              "layers": {"w": torch.randn(2, 32, 48, generator=g).to(dtype),
                         "ln": torch.randn(2, 32, generator=g)},
              "gate": torch.tensor(0.25)}
    if opt == "adamw":
        st = adamw_init(params, AdamWConfig())
        st.m["embed"].normal_(generator=g)
    else:
        st = adafactor_init(params, AdafactorConfig(min_dim_factored=16))
        st.vr["layers"]["w"].uniform_(generator=g)
    return TrainState(params, st, torch.tensor(7, dtype=torch.int32))


def _leaves(tree):
    return [x for _, x in ckpt.tree_flatten(tree)]


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
            y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_round_trip_bit_for_bit(tmp_path, opt):
    st = _state(opt)
    d = str(tmp_path / "ck")
    path = ckpt.save(d, 7, st, extra={"data": {"step": 7}})
    assert os.path.exists(os.path.join(path, "COMMIT"))
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["step"] == 7 and man["n_leaves"] == len(_leaves(st))
    assert man["leaves"][0]["path"] == "params/embed"
    assert man["leaves"][0]["dtype"] == "torch.bfloat16"
    like = _state(opt, seed=1)
    step, tree, extra = ckpt.restore_latest(d, like)
    assert step == 7 and extra == {"data": {"step": 7}}
    assert isinstance(tree, TrainState)
    assert isinstance(tree.opt, type(st.opt))
    assert _bit_equal(tree, st)
    if opt == "adafactor":
        assert isinstance(tree.opt, AdafactorState)
        assert tree.opt.vc["layers"]["w"].shape == (2, 48)


def test_uncommitted_and_staging_dirs_are_ignored(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, _state())
    # a crash mid-save: a staging dir and a final-named dir without COMMIT
    os.makedirs(os.path.join(d, "step_00000009.tmp.deadbeef"))
    os.makedirs(os.path.join(d, "step_00000008"))
    assert ckpt.latest_step(d) == 3
    step, _, _ = ckpt.restore_latest(d, _state())
    assert step == 3
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.restore_latest(str(tmp_path / "none"), _state()) is None


def test_retention_keeps_newest(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _state(), keep=2)
    names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert names == ["step_00000004", "step_00000005"]
    # a second save of a committed step is a no-op
    assert ckpt.save(d, 5, _state(seed=3), keep=2).endswith("step_00000005")
    assert _bit_equal(ckpt.restore_latest(d, _state())[1], _state())


def test_async_save_snapshots_now(tmp_path):
    """``save_async`` copies the leaves before returning: a later in-place
    change of the state is not in the checkpoint."""
    d = str(tmp_path / "ck")
    st = _state()
    want = [x.clone() for x in _leaves(st)]
    ckpt.save_async(d, 1, st)
    for x in _leaves(st):
        x.add_(1)
    ckpt.wait_pending(d)
    _, tree, _ = ckpt.restore_latest(d, st)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tree), want))


def test_restore_checks_the_tree(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    other = _state()
    other.params["extra"] = torch.zeros(3)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_latest(d, other)
    other = _state()
    other.params["embed"] = torch.zeros(64, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_latest(d, other)


# ------------------------------------------------------- trainer restart
def _trainer(tmp_path, opt=None):
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = build_model(cfg, device="cpu")
    data = SyntheticTokens(vocab=cfg.vocab, seq=32, local_batch=4)
    tcfg = TrainerConfig(
        train=TrainConfig(
            optimizer=opt or AdamWConfig(lr=5e-3),
            schedule=ScheduleConfig(peak_lr=5e-3, warmup_steps=5,
                                    total_steps=100)),
        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=5, log_every=100)
    return Trainer(model, tcfg, data), data


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoint_restart_resumes_exactly(tmp_path, opt):
    mk = (None if opt == "adamw"
          else AdafactorConfig(lr=5e-3, min_dim_factored=64))
    trainer, _ = _trainer(tmp_path, mk)
    trainer.run(10)
    want = [x.clone() for x in _leaves(trainer.state)]
    trainer2, data2 = _trainer(tmp_path, mk)
    assert trainer2.initialize() == 10
    assert data2.step == 10  # data pipeline state restored
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(trainer2.state), want))


def test_restart_training_continues(tmp_path):
    """A restart from step 8 continues to 16, and its losses are those of
    an uninterrupted run (the same bits on the CPU)."""
    trainer, _ = _trainer(tmp_path)
    trainer.run(8)
    trainer2, _ = _trainer(tmp_path)
    out = trainer2.run(16)
    assert out["final_step"] == 16
    steps = [m["step"] for m in trainer2.metrics_log]
    assert steps[0] == 8  # resumed, not restarted
    ref, _ = _trainer(tmp_path / "ref")
    ref.run(16)
    assert [m["loss"] for m in ref.metrics_log[8:]] == [
        m["loss"] for m in trainer2.metrics_log]


def test_remesh_keeps_the_state(tmp_path):
    trainer, _ = _trainer(tmp_path)
    trainer.run(3)
    want = [x.clone() for x in _leaves(trainer.state)]
    trainer.remesh(None)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(trainer.state), want))
    assert trainer.run(5)["final_step"] == 5


def test_torn_step_commits_no_checkpoint(tmp_path, monkeypatch):
    """The optimizer raises in step 7 after updating some leaves in place
    (as an out-of-memory error on one slice would): ``run`` re-raises and
    commits no checkpoint of the half-updated state, and a restart resumes
    from step 5, the last one committed, bit for bit."""
    ref, _ = _trainer(tmp_path / "ref")
    ref.run(5)
    want = _leaves(ref.state)
    trainer, _ = _trainer(tmp_path)
    trainer.initialize()
    n_leaves = len(topt.tree_leaves(trainer.state.params))
    real, calls = topt._slices, []

    def failing(*leaves):     # one call a leaf a step
        calls.append(1)
        if len(calls) == 7 * n_leaves + 4:
            raise RuntimeError("CUDA out of memory (simulated)")
        yield from real(*leaves)

    monkeypatch.setattr(topt, "_slices", failing)
    with pytest.raises(RuntimeError, match="simulated"):
        trainer.run(9)
    assert len(trainer.metrics_log) == 7
    assert int(trainer.state.step) == 7
    d = trainer.cfg.ckpt_dir
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000005"]
    monkeypatch.setattr(topt, "_slices", real)
    trainer2, data2 = _trainer(tmp_path)
    assert trainer2.initialize() == 5 and data2.step == 5
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(trainer2.state), want))


SIGTERM_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)

    class Data(SyntheticTokens):
        def next_batch(self):
            if self.step == 3:   # preempted while step 3 is prepared
                os.kill(os.getpid(), signal.SIGTERM)
            return super().next_batch()

    cfg = get_config("internlm2-1.8b", smoke=True)
    tr = Trainer(build_model(cfg, device="cpu"),
                 TrainerConfig(ckpt_dir=sys.argv[1], ckpt_every=100),
                 Data(vocab=cfg.vocab, seq=16, local_batch=2))
    out = tr.run(50)
    print("FINAL", out["final_step"])
""")


def test_sigterm_leaves_a_committed_checkpoint(tmp_path):
    """SIGTERM mid-run: the loop stops after the step in flight and one
    final sync checkpoint is committed (in a child process, whose main
    thread owns the handler)."""
    d = str(tmp_path / "ck")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", SIGTERM_SCRIPT, d],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FINAL 4" in out.stdout
    assert ckpt.latest_step(d) == 4
    assert os.path.exists(os.path.join(d, "step_00000004", "COMMIT"))
    man = json.load(open(os.path.join(d, "step_00000004", "manifest.json")))
    assert man["extra"] == {"data": {"step": 4}}
