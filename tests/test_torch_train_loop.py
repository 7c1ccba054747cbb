"""The port's fault-tolerant loop and entry points on the CPU: the
counterparts of ``tests/test_training_substrate.py``'s fault-recovery
(rtol = atol = 1e-5) and watchdog tests, a non-finite loss that triggers a
restore, the restart limit, ``launch.train.main`` and
``examples.train_lm.main`` on ``--device cpu``."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.examples import train_lm as TRAIN_LM
from repro_torch.launch import train as TRAIN
from repro_torch.models import steps as ST
from repro_torch.runtime import FaultTolerantLoop, StepWatchdog


def _tiny_setup(tmp_path, fault_hook=None, ckpt_every=4, train_step=None):
    cfg = smoke_config("olmo_1b")
    data_cfg = DataConfig(seq_len=16, global_batch=4,
                          vocab_size=cfg.vocab_size, seed=0)
    stream = SyntheticLMStream(data_cfg)
    model, opt_state = ST.init_train_state(cfg, seed=0, device="cpu")
    step = train_step or ST.make_train_step(cfg)
    return FaultTolerantLoop(step, stream, model, opt_state,
                             ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                             fault_hook=fault_hook)


def _params_close(got, want):
    want = want.state_dict()
    for name, p in got.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_fault_recovery_matches_clean_run(tmp_path):
    clean = _tiny_setup(tmp_path / "clean")
    m_clean, _ = clean.run(10)

    crashed = {"done": False}

    def hook(step):
        if step == 6 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    faulty = _tiny_setup(tmp_path / "faulty", fault_hook=hook)
    m_faulty, opt = faulty.run(10)
    assert faulty.restarts == 1 and clean.restarts == 0
    assert int(opt["step"]) == 10
    _params_close(m_faulty, m_clean)
    # steps 4 and 5 ran twice: once before the fault, once after the restore
    assert [m["step"] for m in faulty.metrics_log] == [0, 1, 2, 3, 4, 5, 4, 5,
                                                      6, 7, 8, 9]


def test_nonfinite_loss_restores(tmp_path):
    """A NaN loss counts as a failure: the loop restores the last checkpoint
    and resumes, ending where the clean run ends."""
    cfg = smoke_config("olmo_1b")
    step = ST.make_train_step(cfg)
    poisoned = {"done": False}

    def nan_once(model, opt_state, batch):
        model, opt_state, metrics = step(model, opt_state, batch)
        if int(opt_state["step"]) == 6 and not poisoned["done"]:
            poisoned["done"] = True
            with torch.no_grad():
                model.embed.fill_(float("nan"))
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return model, opt_state, metrics

    clean = _tiny_setup(tmp_path / "clean")
    m_clean, _ = clean.run(8)
    faulty = _tiny_setup(tmp_path / "nan", train_step=nan_once)
    m_faulty, _ = faulty.run(8)
    assert faulty.restarts == 1
    # step 5's loss was NaN: not logged, the step-4 checkpoint restored
    assert [m["step"] for m in faulty.metrics_log] == [0, 1, 2, 3, 4, 4, 5,
                                                      6, 7]
    assert torch.isfinite(m_faulty.embed).all()
    _params_close(m_faulty, m_clean)


def test_restart_limit_reraises(tmp_path):
    def always(step):
        if step == 1:
            raise RuntimeError("node keeps failing")

    loop = _tiny_setup(tmp_path, fault_hook=always)
    loop.max_restarts = 2
    with pytest.raises(RuntimeError, match="keeps failing"):
        loop.run(3)
    assert loop.restarts == 3


def test_keyboard_interrupt_is_not_a_failure(tmp_path):
    def stop(step):
        raise KeyboardInterrupt

    loop = _tiny_setup(tmp_path, fault_hook=stop)
    with pytest.raises(KeyboardInterrupt):
        loop.run(2)
    assert loop.restarts == 0


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0, warmup=2)
    for i, d in enumerate([1.0, 1.0, 1.0, 1.1, 9.0, 1.0]):
        wd.record(i, d)
    assert wd.flagged == [4]
    assert wd.median == 1.0
    assert StepWatchdog().median == 0.0


def test_launch_train_main_on_cpu(tmp_path, capsys):
    log = tmp_path / "log.json"
    loop = TRAIN.main(["--arch", "olmo_1b", "--smoke", "--steps", "6",
                       "--seq-len", "32", "--global-batch", "4",
                       "--ckpt-every", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ckpt"),
                       "--log", str(log)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("steps=6 wall=") and "first_loss=" in line
    assert "median_step=" in line and line.endswith("stragglers=[]")
    record = json.loads(log.read_text())
    assert [m["step"] for m in record["metrics"]] == list(range(6))
    assert loop.model.device == torch.device("cpu")
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_loop_refuses_a_directory_with_checkpoints(tmp_path):
    """A second run in the same directory would have its step-0 and early
    checkpoints rotated away and restore the first run's: refused."""
    _tiny_setup(tmp_path, ckpt_every=2).run(2)
    with pytest.raises(FileExistsError, match="already holds checkpoints"):
        _tiny_setup(tmp_path)
    _tiny_setup(tmp_path / "new")          # an empty or new one is fine


def test_launch_train_default_ckpt_dir_is_new_per_run(tmp_path, monkeypatch):
    monkeypatch.setattr(TRAIN, "CKPT_ROOT", tmp_path / "ckpt")
    argv = ["--arch", "olmo_1b", "--smoke", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--device", "cpu"]
    dirs = {loop.manager.directory for loop in (TRAIN.main(argv),
                                                TRAIN.main(argv))}
    assert len(dirs) == 2
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == sorted(
        Path(d).name for d in dirs)
    with pytest.raises(FileExistsError):
        TRAIN.main(argv + ["--ckpt-dir", dirs.pop()])


def test_launch_build_places_everything_on_the_device():
    cfg = smoke_config("whisper_large_v3")
    model, opt, step, stream = TRAIN.build(cfg, device="cpu", seq_len=16,
                                           global_batch=2, total_steps=40)
    assert stream.cfg.frontend_len == cfg.frontend_len
    assert stream.cfg.d_model == cfg.d_model
    assert all(t.device.type == "cpu" for t in opt["m"].values())
    batch = {k: torch.from_numpy(v) for k, v in stream.batch_at(0).items()}
    _, opt, metrics = step(model, opt, batch)
    # warmup max(10, 40 // 20) = 10 steps: lr(1) = 3e-4 · 2 / 10
    np.testing.assert_allclose(float(metrics["lr"]), 3e-4 * 2 / 10, rtol=1e-6)


def test_train_lm_example_on_cpu(tmp_path, capsys):
    loop = TRAIN_LM.main(["--device", "cpu", "--steps", "40", "--seq-len",
                          "32", "--global-batch", "2", "--inject-fault"],
                         ckpt_root=str(tmp_path))
    out = capsys.readouterr().out
    assert out.startswith("training olmo_demo_5m: ~5.2M params, seq=32")
    assert "restarts=1" in out and "(decreased: True)" in out
    assert loop.restarts == 1 and len(loop.metrics_log) == 40 + 17
    assert list(tmp_path.iterdir()) == []      # the temporary dir is gone
