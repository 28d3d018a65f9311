"""What the port's ``pretrain`` refuses or warns about where the JAX package
takes an option the port has not ported yet: each names the ROADMAP item
that ports it, and a name the JAX package does not know either stays a
config error. All on the CPU at the ``vittest14`` size."""

import logging

import numpy as np
import pytest

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch._optim import JAX_OPTIMIZERS
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


def _pretrain(tmp_path, **kwargs):
    """One DINOv2 step of ``kwargs``' model (vittest14 unless given) on
    four 36 x 36 PPM images."""
    data = tmp_path / "images"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
        (data / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())
    args = dict(out=str(tmp_path / "out"), data=str(data),
                model="dinov2/vittest14", method="dinov2", accelerator="cpu",
                batch_size=2, steps=1, precision="fp32", canonical_size=36,
                num_workers=0, method_args=SMALL)
    return lt.pretrain(**{**args, **kwargs})


def test_jax_optimizer_names_are_the_jax_packages():
    from lightly_train_tpu._optim.optimizers import OPTIMIZER_ARGS_TYPES

    assert sorted(JAX_OPTIMIZERS) == sorted(OPTIMIZER_ARGS_TYPES)


@pytest.mark.parametrize("name", sorted(JAX_OPTIMIZERS))
def test_optimizer_names_follow_the_jax_package(tmp_path, name):
    """A misspelt name is unknown, as in the JAX package
    (``_commands/train.py:294-298``); a name the JAX package knows and the
    port lacks is not ported yet (ROADMAP item 10)."""
    typo = name[:-1] + "x"  # adamx, adamw8bix, larx, sgx
    with pytest.raises(ConfigError, match=f"Unknown optimizer '{typo}'"):
        _pretrain(tmp_path / "typo", optim=typo)
    if name != "adamw":
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 10\b"):
            _pretrain(tmp_path / "known", optim=name)


@pytest.mark.parametrize("model,model_args,item", [
    ("dinov2/vittest14", {"remat_every": 2}, "22"),
    ("dinov2/vittest14", {"remat_policy": "dots_saveable"}, "22"),
    ("dinov2/vit7b14", {}, "10"),
])
def test_unported_model_options_name_their_roadmap_item(tmp_path, model,
                                                        model_args, item):
    """The JAX ViT's activation checkpointing (item 22) and ViT-7B/14,
    which needs the attention kernels at head dim 128 (item 10)."""
    with pytest.raises(NotImplementedError, match=rf"ROADMAP item {item}\b"):
        _pretrain(tmp_path, model=model, model_args=model_args)


def test_remat_at_its_defaults_builds_the_model():
    """remat_every 0 and remat_policy None are the JAX ViT's defaults, which
    checkpoint nothing."""
    wrapped = get_wrapped_model("dinov2/vittest14", remat_every=0,
                                remat_policy=None)
    assert wrapped.feature_dim == 32


@pytest.mark.parametrize("value", ["default", "high", "highest"])
def test_matmul_precision_variable_warns_once(tmp_path, monkeypatch, caplog,
                                              value):
    """The port does not apply LIGHTLY_TRAIN_MATMUL_PRECISION yet (ROADMAP
    item 21), and a run that is given it says so once."""
    monkeypatch.setenv("LIGHTLY_TRAIN_MATMUL_PRECISION", value)
    with caplog.at_level(logging.WARNING, logger="lightly_train_tpu_torch"):
        state = _pretrain(tmp_path)
    assert state.step == 1
    said = [r.getMessage() for r in caplog.records
            if "LIGHTLY_TRAIN_MATMUL_PRECISION" in r.getMessage()]
    assert len(said) == 1, said
    assert repr(value) in said[0] and "ROADMAP item 21" in said[0]
    assert "'highest'" in said[0]
