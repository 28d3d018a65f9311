"""ECViT (EdgeCrafter) in the port, against the JAX package.

- *Backbone*: ``ecvittest`` (width 32, 2 heads, depth 2, ``proj_dim`` 16:
  three projected levels) at 224^2 (a 14 x 14 grid: levels 28, 14, 7),
  112^2 (7: 14, 7, 3) and 96^2 (6: 12, 6, 3, the DINO locals' halving),
  and the same model without ``proj_dim`` (one projector, on P5), from
  checkpoint-scale weights and running statistics carried by
  ``variables_from_jax``, train and eval (``test_torch_parity``: 1e-5
  relative L2, or in train mode the JAX package's own distance under
  batch permutations where larger).
- *Converter*: EdgeCrafter-named state dicts of ``ecvittest`` and
  ``ecvitt`` (fused qkv, ``backbone.``/``projector.`` names, a head the
  conversion drops) bitwise as the JAX conversion.
- *Steps*: three distillation v3 and three DINO steps on ``ecvittest``
  against the JAX package (the fused AdamW+EMA update for DINO, LARS for
  distillation), running statistics threaded.
- *DINOv2* on an ECViT stops at the student's forward with
  ``ModifyScopeVariableError`` in both packages (the patch embed's
  BatchNorm), having written the same files.
"""

import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu.models import convert as JC
from lightly_train_tpu.models import ecvit as JE
from lightly_train_tpu.models.wrapper import WrappedModel as JaxWrappedModel
from lightly_train_tpu_torch.errors import ModifyScopeVariableError
from lightly_train_tpu_torch.models import ecvit as E
from lightly_train_tpu_torch.models.convert import (
    load_torch_checkpoint_for_model,
)
from lightly_train_tpu_torch.models.from_jax import variables_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from test_torch_parity import (
    backbone_matches_jax,
    ecvit_state_dict,
    three_steps_match_jax,
)
from torch_fixtures.threads import one_torch_thread  # noqa: F401

ECVIT = "ecvit/ecvittest"


@pytest.fixture(autouse=True)
def _ieee_fp32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [224, 112, 96])
def test_backbone_matches_jax(size, train):
    backbone_matches_jax(ECVIT, size, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_one_projector_without_proj_dim(train):
    """``proj_dim`` None (the ``ecvitt`` family's choice): only P5 is
    projected, at the embedding width; P3 and P4 are the resized tokens."""
    shape = dict(embed_dim=32, num_heads=2, depth=2,
                 interaction_indexes=(0, 1), proj_dim=None)
    wrapped_j = JaxWrappedModel(name="ecvit/noproj",
                                module=JE.ECViT(JE.ECViTConfig(**shape)),
                                feature_dim=32, patch_size=16,
                                architecture="hybrid", supports_mask=False)
    module = E.ECViT(E.ECViTConfig(**shape))
    assert not hasattr(module, "projector1")
    wrapped = WrappedModel(name="ecvit/noproj", module=module,
                           feature_dim=32, patch_size=16,
                           architecture="hybrid", supports_mask=False)
    backbone_matches_jax(None, 112, train, wrapped_j, wrapped)


@pytest.mark.parametrize("model", [ECVIT, "ecvit/ecvitt"])
def test_conversion_is_the_jax_conversion_bitwise(tmp_path, model):
    path = tmp_path / "ecvit.pth"
    torch.save({"model": ecvit_state_dict(model, 0)}, path)
    got = load_torch_checkpoint_for_model(path, model)
    want = variables_from_jax(JC.load_torch_checkpoint_for_model(path, model))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    module = get_wrapped_model(model).module
    assert set(module.state_dict()) == set(got)
    module.load_state_dict(got)


@pytest.mark.parametrize("method", ["distillationv3", "dino"])
def test_three_steps_match_jax(method):
    # The last block's MLP bias shifts every token by a constant, which
    # reaches the output only through the fused map's projectors, whose
    # train-mode BatchNorms remove it: its exact gradient is zero, and
    # its step moves their running means.
    three_steps_match_jax(ECVIT, method, ("blocks.1.mlp.fc2.bias",),
                          tuple(f"projector{i}.norm.mean" for i in range(3)))


def test_dinov2_refuses_the_patch_embeds_batchnorm(tmp_path):
    """DINOv2 applies its student without ``mutable``: the JAX run stops at
    the first step's student forward, at the patch embed's first
    BatchNorm, with Flax's ModifyScopeVariableError, having written the
    same files as the port's, which raises its error of that name. The
    augmentation grid, drawn before the step in both (most of the case's
    time, in the JAX package's eager augmentation), is off in both:
    ``test_torch_checkpoint.py`` holds it."""
    import os

    rng = np.random.default_rng(0)
    data = tmp_path / "images"
    data.mkdir()
    for i in range(8):
        img = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
        (data / f"{i}.ppm").write_bytes(b"P6\n44 40\n255\n" + img.tobytes())
    args = dict(data=str(data), model=ECVIT, method="dinov2", batch_size=4,
                steps=2, precision="fp32", canonical_size=48, num_workers=0,
                log_augmentations=False, method_args=dict(output_dim=64, hidden_dim=32,
                                 bottleneck_dim=16,
                                 local_view_count=2, global_image_size=64,
                                 local_image_size=32))
    with pytest.raises(Exception) as j_err:
        jlt.pretrain(out=str(tmp_path / "jax"), **args)
    assert type(j_err.value).__name__ == "ModifyScopeVariableError"
    with pytest.raises(ModifyScopeVariableError) as err:
        lt.pretrain(out=str(tmp_path / "port"), accelerator="cpu", **args)
    assert str(j_err.value).split(" because")[0] == \
        str(err.value).split(" because")[0] == \
        'Cannot update variable "mean" in "/pe_conv0/norm"'
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
