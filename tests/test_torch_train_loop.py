"""The port's training loop (``repro_torch.launch.train``) on the CPU, alone:
the cases of the JAX package's ``tests/test_launch.py:14-50``,
``tests/test_ft.py:64`` and ``tests/test_chaos.py:333-365``, whose
reference runs error on jax 0.9.0 with the default mesh (ROADMAP Queue 3).
Reduced configs (d 64, 2 layers, vocab 256), a few steps.  Bitwise where
the JAX package's tests are: a skipped, rolled-back, preempted or
restarted run commits exactly the clean run's losses.
"""
import shutil

import numpy as np
import pytest

from repro_torch.ckpt.checkpoint import available_steps
from repro_torch.configs.base import ShapeCell, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.ft import FaultPlan, FaultSpec
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.obs import read_jsonl
from repro_torch.optim.adamw import AdamW

STEPS, CKPT_EVERY = 8, 4


def _quiet(*a, **k):
    return None


@pytest.fixture(scope="module")
def lm_setup():
    cfg = reduced(get_arch("smollm-135m"), n_layers=2)
    return cfg, ShapeCell("chaos", 32, 2, "train")


def _train(lm_setup, tmp, name, **kw):
    cfg, cell = lm_setup
    kw.setdefault("ckpt_every", CKPT_EVERY)
    return train(cfg, cell, steps=STEPS, ckpt_dir=f"{tmp}/{name}",
                 log_fn=_quiet, device="cpu", **kw)


@pytest.fixture(scope="module")
def clean_losses(lm_setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos_clean")
    return _train(lm_setup, tmp, "clean")["losses"]


def test_train_loss_decreases():
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=2)
    out = train(cfg, ShapeCell("t", 64, 4, "train"), steps=15,
                log_fn=_quiet, device="cpu")
    assert len(out["losses"]) == 15
    assert out["losses"][-1] < out["losses"][0]
    assert all(np.isfinite(out["losses"]))
    assert out["measured_peak_bytes"] is None


def test_train_sentinel_skip_bitwise(lm_setup, clean_losses, tmp_path):
    out = _train(lm_setup, tmp_path, "skip", fault_plan=FaultPlan(
        [FaultSpec("train.step", 3, "nan")]))
    assert out["skipped_steps"] == 1 and out["rollbacks"] == 0
    assert out["losses"] == clean_losses


def test_train_rollback_replay_bitwise(lm_setup, clean_losses, tmp_path):
    out = _train(lm_setup, tmp_path, "roll", sentinel_bad_steps=3,
                 fault_plan=FaultPlan([FaultSpec(
                     "train.step", CKPT_EVERY + 1, "nan", count=3)]))
    assert out["rollbacks"] == 1 and out["skipped_steps"] == 3
    assert out["losses"] == clean_losses


def test_train_divergent_run_raises(lm_setup, tmp_path):
    # no checkpoint to roll back to: a persistently bad run must raise
    with pytest.raises(FloatingPointError):
        _train(lm_setup, tmp_path, "div", fault_plan=FaultPlan(
            [FaultSpec("train.step", 0, "nan", count=10_000)]))


def test_train_preempt_drains_and_resumes(lm_setup, clean_losses,
                                          tmp_path):
    out = _train(lm_setup, tmp_path, "pre", ckpt_every=100,
                 fault_plan=FaultPlan(
                     [FaultSpec("train.step", 2, "preempt")]))
    assert out["preempted"] and out["losses"] == clean_losses[:3]
    assert available_steps(f"{tmp_path}/pre") == [3]
    res = _train(lm_setup, tmp_path, "pre")  # same dir: auto-resume
    assert res["resumed_from"] == 3
    assert out["losses"] + res["losses"] == clean_losses


def test_kill_restart_replays_identically(tmp_path):
    """Train 10 steps with checkpoints, then restart from step 5: losses
    5..9 are bit-identical (deterministic data, the optimizer state in the
    checkpoint)."""
    cfg = reduced(get_arch("smollm-135m"), n_layers=2)
    cell = ShapeCell("t", 32, 2, "train")
    run1 = train(cfg, cell, steps=10, ckpt_dir=str(tmp_path / "a"),
                 ckpt_every=5, log_fn=_quiet, device="cpu")
    for s in available_steps(tmp_path / "a"):
        if s > 5:
            shutil.rmtree(tmp_path / "a" / f"step_{s:010d}")
    run2 = train(cfg, cell, steps=10, ckpt_dir=str(tmp_path / "a"),
                 ckpt_every=100, log_fn=_quiet, device="cpu")
    assert run2["resumed_from"] == 5
    np.testing.assert_array_equal(np.asarray(run1["losses"][5:]),
                                  np.asarray(run2["losses"]))


def test_train_grad_accumulation_matches():
    """accum=2 on a fixed batch tracks accum=1 (same data)."""
    cfg = reduced(get_arch("smollm-135m"), n_layers=2)
    cell = ShapeCell("t", 32, 4, "train")
    l1 = train(cfg, cell, steps=5, accum=1, log_fn=_quiet,
               device="cpu")["losses"]
    l2 = train(cfg, cell, steps=5, accum=2, log_fn=_quiet,
               device="cpu")["losses"]
    np.testing.assert_allclose(l1, l2, rtol=2e-3)


def test_train_rejects_unknown_compression():
    cfg = reduced(get_arch("smollm-135m"), n_layers=2)
    with pytest.raises(ValueError, match="compression"):
        make_train_step(cfg, AdamW(total_steps=10), compress="fp4")


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_train_compression_names_the_roadmap(scheme):
    cfg = reduced(get_arch("smollm-135m"), n_layers=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        make_train_step(cfg, AdamW(total_steps=10), compress=scheme)
    for none in (None, "none"):
        make_train_step(cfg, AdamW(total_steps=10), compress=none)


def test_train_refuses_a_mesh():
    cfg = reduced(get_arch("smollm-135m"), n_layers=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        train(cfg, ShapeCell("t", 8, 2, "train"), steps=1, mesh=object(),
              device="cpu")


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    args = ["--device", "cpu", "--arch", "smollm-135m", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "c"),
            "--metrics", str(metrics), "--mem-budget", "1G"]
    first = train_mod.main(args)
    assert len(first["losses"]) == 3 and first["resumed_from"] is None
    recs = read_jsonl(str(metrics))
    events = [r["event"] for r in recs]
    assert events.count("train.step") == 3 and "train.compile" in events
    assert "train.plan" in events
    compile_rec = next(r for r in recs if r["event"] == "train.compile")
    assert compile_rec["measured_peak_bytes"] is None  # no card
    again = train_mod.main(args[:5] + ["5"] + args[6:])
    assert again["resumed_from"] == 3 and len(again["losses"]) == 2
    assert "resumed from step 3" in capsys.readouterr().out
