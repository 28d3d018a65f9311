"""What the port's ``pretrain`` checks and writes, against the JAX package:
the one-step-lagged non-finite check, the ``metrics.jsonl`` keys, the
warning at the defaults and what the run writes, and the choice of loggers. All on the CPU at the
``vittest14`` size."""

import json
import logging
import sys
import types

import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch.errors import NaNDetectedError

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


def _pretrain(tmp_path, **kwargs):
    """A DINOv2 vittest14 run on six 36 x 36 PPM images; returns (state,
    the metrics.jsonl path)."""
    data = tmp_path / "images"
    if not data.exists():
        data.mkdir()
        rng = np.random.default_rng(0)
        for i in range(6):
            img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
            (data / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())
    args = dict(out=str(tmp_path / "out"), data=str(data),
                model="dinov2/vittest14", method="dinov2", accelerator="cpu",
                batch_size=4, steps=2, precision="fp32", canonical_size=36,
                num_workers=2, method_args=SMALL)
    args.update(kwargs)
    return lt.pretrain(**args), tmp_path / "out" / "metrics.jsonl"


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _poison_step(monkeypatch, bad_step):
    """Makes the ``bad_step``-th train step (1-based, as metrics.jsonl
    numbers steps) report a NaN loss; returns the list of dispatched
    steps."""
    make = T.make_train_step
    dispatched = []

    def make_poisoned(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state, images, generator, **kw):
            metrics = step(state, images, generator, **kw)
            dispatched.append(state.step)
            if state.step == bad_step:
                nan = torch.tensor(float("nan"))
                metrics = {**metrics, "train_loss": nan,
                           "finite": torch.isfinite(nan)}
            return metrics

        return train_step

    monkeypatch.setattr(T, "make_train_step", make_poisoned)
    return dispatched


def test_nan_on_an_unlogged_step_stops_the_run_one_step_later(
        tmp_path, monkeypatch):
    """As the JAX loop does (train_loop.py:295-330): step 3 is not logged
    (log_every 50, burn-in 1, 2, 5), and its flag is read once step 4 is
    dispatched; the capture is step 3's (state step 2)."""
    dispatched = _poison_step(monkeypatch, 3)
    with pytest.raises(NaNDetectedError, match="at step 3 "):
        _pretrain(tmp_path, steps=6, log_every=50)
    assert dispatched == [1, 2, 3, 4]
    assert [p.name for p in (tmp_path / "out" / "debug").iterdir()] == [
        "nan_capture_step2.npz"]
    logged = [r["step"] for r in _records(tmp_path / "out" / "metrics.jsonl")
              if "step" in r]
    assert logged == [1, 2]


def test_nan_on_the_last_step_is_caught(tmp_path, monkeypatch):
    dispatched = _poison_step(monkeypatch, 3)
    with pytest.raises(NaNDetectedError, match="at step 3 "):
        _pretrain(tmp_path, steps=3, log_every=50)
    assert dispatched == [1, 2, 3]


def test_nan_check_off_lets_the_run_finish(tmp_path, monkeypatch):
    _poison_step(monkeypatch, 2)
    state, _ = _pretrain(tmp_path, steps=3, nan_check=False)
    assert state.step == 3


def test_metrics_jsonl_keys_match_the_jax_package(tmp_path):
    from lightly_train_tpu._commands.train import TrainConfig as JaxConfig

    _, path = _pretrain(tmp_path)
    records = _records(path)
    hyperparams = records[0]["hyperparams"]
    # The JAX run logs its config's dump and these (train.py:428-439).
    jax_hyperparams = set(JaxConfig.model_fields) | {
        "resolved_batch_size", "resolved_steps", "resolved_lr",
        "method_args", "optim_args", "devices"}
    # accelerator is the port's own option: the JAX package's device is
    # JAX's platform.
    assert set(hyperparams) == jax_hyperparams | {"accelerator"}
    assert hyperparams["devices"] == 1
    # A JAX metrics line: step and time (_loggers/jsonl.py), the step's
    # metrics (train_loop.py:250-254 and methods/dinov2.py:331-336) and the
    # window's (train_loop.py:339-357).
    jax_metrics = {
        "step", "time", "train_loss", "grad_norm", "finite", "dino_loss",
        "ibot_loss", "koleo_loss", "teacher_temp",
        "profiling/images_per_sec", "profiling/step_time",
        "profiling/data_time", "profiling/device_duty_cycle"}
    steps = records[1:]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert set(r) == jax_metrics
        assert 0.0 <= r["profiling/device_duty_cycle"] <= 1.0


@pytest.mark.parametrize("loggers", [[], {"jsonl": None}])
def test_no_metrics_jsonl_without_the_jsonl_logger(tmp_path, loggers):
    """As the JAX package's build_loggers (_loggers/multi.py:163-168)."""
    state, path = _pretrain(tmp_path, loggers=loggers)
    assert state.step == 2
    assert not path.exists()
    assert (tmp_path / "out" / "checkpoints" / "step_2.pt").exists()


def test_the_default_run_warns_what_it_does_not_write(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="lightly_train_tpu_torch"):
        _pretrain(tmp_path, steps=1)
    warnings = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING]
    # It names what is still not written (the profile trace, the logger
    # backends), and no longer the checkpoints, the grid, the export or the
    # NaN capture, which the run now writes.
    assert any("profile" in m and "tensorboard, wandb and mlflow" in m
               and "ROADMAP item 7.5" in m for m in warnings), warnings
    assert not any("checkpoint" in m or "augmentations.png" in m
                   or "exported_last" in m or "nan_capture" in m
                   or "item 7.3" in m for m in warnings), warnings
    out = tmp_path / "out"
    assert (out / "checkpoints" / "step_1.pt").exists()
    assert (out / "augmentations.png").exists()
    assert (out / "exported_models" / "exported_last" / "metadata.json"
            ).exists()


def test_an_unknown_logger_is_refused(tmp_path):
    with pytest.raises(ValueError, match="Unknown logger 'neptune'"):
        _pretrain(tmp_path, loggers=["jsonl", "neptune"])


def test_an_absent_logger_package_warns_and_the_run_goes_on(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb fails
    with caplog.at_level(logging.WARNING, logger="lightly_train_tpu_torch"):
        state, path = _pretrain(tmp_path, loggers=["jsonl", "wandb"])
    assert state.step == 2
    assert any("wandb logging unavailable" in r.getMessage()
               for r in caplog.records)
    assert [r["step"] for r in _records(path) if "step" in r] == [1, 2]


def test_an_installed_logger_package_is_refused(tmp_path, monkeypatch):
    """The port does not write to it yet, and must not silently log
    nothing."""
    monkeypatch.setitem(sys.modules, "mlflow", types.ModuleType("mlflow"))
    with pytest.raises(NotImplementedError, match="ROADMAP item 7.5"):
        _pretrain(tmp_path, loggers={"mlflow": {}})
    assert not (tmp_path / "out").exists()
