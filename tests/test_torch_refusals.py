"""What the port's ``pretrain`` refuses where the JAX package takes an option
the port has not ported yet: each names the ROADMAP item that ports it, and
a name the JAX package does not know either stays a config error. The
options refused until they were ported (activation checkpointing, item 22;
``LIGHTLY_TRAIN_MATMUL_PRECISION``, item 21) keep their cases here, which
now hold what the port does with them. All on the CPU at the ``vittest14``
size."""

import logging

import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch._commands import train
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
    (``_commands/train.py:294-298``); SGD and LARS run one CPU step on the
    unfused update; AdamW8bit, which the port lacks, is not ported yet
    (ROADMAP item 10)."""
    typo = name[:-1] + "x"  # adamx, adamw8bix, larx, sgx
    with pytest.raises(ConfigError, match=f"Unknown optimizer '{typo}'"):
        _pretrain(tmp_path / "typo", optim=typo)
    if name in ("sgd", "lars"):
        state = _pretrain(tmp_path / "known", optim=name)
        assert state.step == 1 and state.updater.count == 1
        assert type(state.updater).__name__ == "UnfusedUpdate"
        assert "trace" in state.updater.state_dict()
    elif name != "adamw":
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 10\b"):
            _pretrain(tmp_path / "known", optim=name)


@pytest.mark.parametrize("model,model_args,item", [
    ("dinov2/vittest14", {"remat_every": 2}, "22"),
    ("dinov2/vittest14", {"remat_policy": "dots_saveable"}, "22"),
    ("dinov2/vit7b14", {}, "10"),
    ("dinov3/vit7b16", {}, "10"),
    ("dinov3/convnext-tiny", {}, "10"),
])
def test_unported_model_options_name_their_roadmap_item(tmp_path, monkeypatch,
                                                        model, model_args,
                                                        item):
    """The DINOv3 ConvNeXts (item 10) are refused naming their item. A 7B
    ViT trains where its fp32 state fits the card: as a DINOv2 student
    (AdamW's two moments and an EMA teacher, five copies of its
    parameters) it is refused on an 80 GiB card before anything is built,
    naming FSDP (item 7.6) and ``adamw8bit`` (item 10), with its parameter
    count and the bytes it would need (the card's capacity is patched in:
    the CPU has none). The JAX ViT's activation checkpointing (item 22) is
    ported: a run with it takes its step, with the options in the ViT's
    config (a policy without ``remat_every`` checkpoints nothing, as in the
    JAX ViT)."""
    if item == "22":
        state = _pretrain(tmp_path, model=model, model_args=model_args)
        assert state.step == 1
        cfg = state.params["student"].cfg
        assert (cfg.remat_every, cfg.remat_policy) == (
            model_args.get("remat_every", 0),
            model_args.get("remat_policy"))
        return
    if "vit7b" in model:
        monkeypatch.setattr(train, "_device_capacity",
                            lambda accelerator: 80 * 2 ** 30)
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP item {item}\b") as err:
        _pretrain(tmp_path, model=model, model_args=model_args)
    if "vit7b" in model:
        said = str(err.value)
        assert "ROADMAP item 7.6" in said and "adamw8bit" in said
        count = {"dinov2/vit7b14": 8_058_998_784,
                 "dinov3/vit7b16": 6_716_035_072}[model]
        assert f"{count / 1e9:.2f} B" in said
        assert f"{5 * 4 * count} bytes" in said
        assert not (tmp_path / "out").exists()


def test_remat_at_its_defaults_builds_the_model():
    """remat_every 0 and remat_policy None are the JAX ViT's defaults, which
    checkpoint nothing."""
    wrapped = get_wrapped_model("dinov2/vittest14", remat_every=0,
                                remat_policy=None)
    assert wrapped.feature_dim == 32


@pytest.mark.parametrize("value", ["default", "high", "highest"])
def test_matmul_precision_variable_warns_once(tmp_path, monkeypatch, caplog,
                                              value):
    """LIGHTLY_TRAIN_MATMUL_PRECISION is applied (ROADMAP item 21, which
    this case once found missing): the run says so once, warns of nothing
    about it, and leaves the CUDA backend's TF32 switches at the value's
    setting (``tests/test_torch_precision.py`` holds the mapping)."""
    monkeypatch.setenv("LIGHTLY_TRAIN_MATMUL_PRECISION", value)
    with caplog.at_level(logging.INFO, logger="lightly_train_tpu_torch"):
        state = _pretrain(tmp_path)
    assert state.step == 1
    said = [r for r in caplog.records
            if "matmul precision" in r.getMessage().lower()]
    assert len(said) == 1, [r.getMessage() for r in said]
    assert said[0].levelno == logging.INFO and repr(value) in said[0].getMessage()
    tf32 = value != "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
