"""The port's training loop on the CPU (``repro_torch/train/trainer.py``,
``launch/train.py``, ``distributed/fault.py``), held to the JAX trainer
tests' own rules on their tiny llama (2 layers, d_model 64, vocab 256, batch
8 x 64, bf16): the loss falls (the mean of the last 5 of 30 steps under 0.8x
the first 5's), 2 microbatches track 1 within ``rtol = 2e-2``, a run that
crashes at step 13 and resumes from its step-10 checkpoint ends bit-equal
(params, optimizer state and losses) to an uninterrupted one, the straggler
monitor, bounded restarts; and the launcher prints the JAX launcher's keys
plus ``device``.  The step's parity with JAX is in
``tests/test_torch_train.py``; the launcher on a device mesh in
``tests/test_torch_train_mesh.py``.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.distributed import StepMonitor, run_with_restarts  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import tree  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from test_torch_train import _arch  # noqa: E402


def _tiny(tmp_path, total=30, microbatches=1):
    tc = TrainConfig(lr=3e-3, warmup=5, total_steps=total, ckpt_every=10,
                     ckpt_dir=str(tmp_path), microbatches=microbatches, grad_clip=1.0)
    data = DataConfig(vocab=256, seq_len=64, global_batch=8)
    return Trainer(arch=_arch(tget), tc=tc, data=data, device="cpu")


def test_loss_decreases(tmp_path):
    out = _tiny(tmp_path).run(30)
    losses = [h["loss"] for h in out["history"]]
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), (losses[:5], losses[-5:])


def test_grad_accumulation_equivalent(tmp_path):
    l1 = [h["loss"] for h in _tiny(tmp_path / "a").run(5)["history"]]
    l2 = [h["loss"] for h in _tiny(tmp_path / "b", microbatches=2).run(5)["history"]]
    np.testing.assert_allclose(l1, l2, rtol=2e-2)


def test_crash_resume_matches_uninterrupted(tmp_path):
    out_ref = _tiny(tmp_path / "ref").run(20)
    crash = _tiny(tmp_path / "crash")

    def attempt(start):
        return crash.run(20, start_step=start, fail_at=13 if start != -1 else None)

    result = run_with_restarts(attempt, max_restarts=2)
    steps = [h["step"] for h in result["history"]]
    assert steps == list(range(13)) + list(range(10, 20))  # resumed from step 10
    for a, b in zip(tree.leaves(out_ref["params"]), tree.leaves(result["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree.leaves(out_ref["opt_state"]), tree.leaves(result["opt_state"])):
        assert torch.equal(a, b)
    assert [h["loss"] for h in result["history"][13:]] == \
        [h["loss"] for h in out_ref["history"][10:]]


def test_straggler_monitor():
    m = StepMonitor(ema_decay=0.5, deadline_factor=2.0, warmup_steps=1)
    assert not m.observe(0, 1.0)
    assert not m.observe(1, 1.1)
    assert m.observe(2, 5.0)
    assert m.stragglers == [2]
    assert m.ema < 1.2


def test_run_with_restarts_bounded():
    calls = []

    def always_fails(start):
        calls.append(start)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        run_with_restarts(always_fails, max_restarts=2)
    assert calls == [0, -1, -1]


def test_launcher_prints_the_jax_keys(tmp_path, capsys):
    report = tlaunch.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                           "--steps", "6", "--ckpt-dir", str(tmp_path)])
    keys = {"arch", "steps", "first_loss", "final_loss", "mean_step_s", "stragglers"}
    assert set(report) == keys | {"device"}
    assert report["device"] == "cpu" and report["steps"] == 6
    assert np.isfinite(report["first_loss"]) and np.isfinite(report["final_loss"])
    assert '"final_loss"' in capsys.readouterr().out
