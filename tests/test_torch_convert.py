"""Torch checkpoints (Meta DINOv2/DINOv3, timm ViT) into the port, against
the JAX package's conversion.

The state dicts are random at checkpoint scale (linear weights of unit
fan-in variance, norm scales near 1, LayerScale near 0.5, biases and tokens
at 0.5), in each layout the converter takes. The port's
``load_torch_checkpoint_for_model`` must equal the JAX package's followed by
``params_from_jax``, bitwise; ``pretrain(checkpoint=x.pth)`` and a
distillation ``teacher_weights=x.pth`` start from those weights, as the
JAX package's runs do; a ``pos_embed`` for another grid keeps the fresh
init in both packages.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu._checkpoint.checkpoint import (
    resolve_pretrained_source as jax_resolve,
)
from lightly_train_tpu._commands.train_task import (
    _merge_pretrained as jax_merge,
)
from lightly_train_tpu.methods import distillationv3 as JV3
from lightly_train_tpu.models import convert as JC
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu_torch._checkpoint.checkpoint import (
    merge_pretrained,
    resolve_pretrained_source,
)
from lightly_train_tpu_torch.methods import distillationv3 as V3
from lightly_train_tpu_torch.models.convert import (
    load_torch_checkpoint_for_model,
)
from lightly_train_tpu_torch.models.from_jax import (
    params_from_jax,
    variables_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from torch_fixtures.threads import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "images"
DINOV2, DINOV3 = "dinov2/vittest14", "dinov3/vittest16"
D, DEPTH, HIDDEN = 32, 2, 128


def meta_state_dict(variant: str, seed: int = 0, grid: int = 16):
    """A Meta-named ViT state dict at vittest width (32, depth 2).

    ``dinov2``: fused qkv, ``pos_embed`` with its CLS entry (1 + grid^2),
    LayerScale, GELU MLP; ``dinov2-reg``: with 4 register tokens;
    ``dinov2-swiglu``: DINOv2's fused SwiGLU (``w12``, ``w3``);
    ``dinov2-fsdp``: block names chunked ``blocks.0.{i}``; ``timm``: no
    LayerScale; ``dinov3``: no ``pos_embed``, 4 ``storage_tokens``,
    ``qkv.bias_mask``, SwiGLU ``w1/w2/w3`` and RoPE periods (ignored);
    ``dinov3-mlp``: the same with a GELU MLP, as ``dinov3/vittest16``.
    """
    rng = np.random.default_rng(seed)

    def t(*shape, kind="bias"):
        x = rng.standard_normal(shape)
        if kind == "weight":
            x = x / np.sqrt(np.prod(shape[1:]))
        elif kind == "norm":
            x = 1.0 + 0.2 * x
        elif kind == "gamma":
            x = 0.5 + 0.2 * x
        else:
            x = 0.5 * x
        return torch.from_numpy(x.astype(np.float32))

    v3 = variant.startswith("dinov3")
    sd = {"cls_token": t(1, 1, D), "mask_token": t(1, D),
          "patch_embed.proj.weight": t(D, 3, 16 if v3 else 14,
                                       16 if v3 else 14, kind="weight"),
          "patch_embed.proj.bias": t(D)}
    if v3:
        sd["storage_tokens"] = t(1, 4, D)
        sd["rope_embed.periods"] = t(4)
    else:
        sd["pos_embed"] = t(1, 1 + grid * grid, D)
    if variant == "dinov2-reg":
        sd["register_tokens"] = t(1, 4, D)
    for i in range(DEPTH):
        p = f"blocks.0.{i}." if variant == "dinov2-fsdp" else f"blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[f"{p}{n}.weight"], sd[f"{p}{n}.bias"] = t(D, kind="norm"), t(D)
        sd[f"{p}attn.qkv.weight"] = t(3 * D, D, kind="weight")
        sd[f"{p}attn.qkv.bias"] = t(3 * D)
        if v3:
            sd[f"{p}attn.qkv.bias_mask"] = torch.cat(
                [torch.ones(D), torch.zeros(D), torch.ones(D)])
        sd[f"{p}attn.proj.weight"] = t(D, D, kind="weight")
        sd[f"{p}attn.proj.bias"] = t(D)
        if variant != "timm":
            sd[f"{p}ls1.gamma"] = t(D, kind="gamma")
            sd[f"{p}ls2.gamma"] = t(D, kind="gamma")
        if variant == "dinov2-swiglu":
            sd[f"{p}mlp.w12.weight"] = t(2 * HIDDEN, D, kind="weight")
            sd[f"{p}mlp.w12.bias"] = t(2 * HIDDEN)
            sd[f"{p}mlp.w3.weight"] = t(D, HIDDEN, kind="weight")
            sd[f"{p}mlp.w3.bias"] = t(D)
        elif variant == "dinov3":
            for n, shape in (("w1", (HIDDEN, D)), ("w2", (HIDDEN, D)),
                             ("w3", (D, HIDDEN))):
                sd[f"{p}mlp.{n}.weight"] = t(*shape, kind="weight")
                sd[f"{p}mlp.{n}.bias"] = t(shape[0])
        else:
            sd[f"{p}mlp.fc1.weight"] = t(HIDDEN, D, kind="weight")
            sd[f"{p}mlp.fc1.bias"] = t(HIDDEN)
            sd[f"{p}mlp.fc2.weight"] = t(D, HIDDEN, kind="weight")
            sd[f"{p}mlp.fc2.bias"] = t(D)
    sd["norm.weight"], sd["norm.bias"] = t(D, kind="norm"), t(D)
    return sd


def wrap(sd, form):
    """The checkpoint file's layout: flat, ``{"model": sd}``, or names
    prefixed ``module.`` (DDP) or ``backbone.``."""
    if form == "model":
        return {"model": sd}
    if form in ("module", "backbone"):
        return {f"{form}.{k}": v for k, v in sd.items()}
    return sd


def jax_conversion(path, model):
    """The JAX package's conversion carried into the port's naming."""
    return params_from_jax(
        JC.load_torch_checkpoint_for_model(path, model)["params"])


def assert_same(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == torch.float32, k
        assert torch.equal(got[k], ref[k]), k


CASES = [(v, "flat") for v in ("dinov2", "dinov2-reg", "dinov2-swiglu",
                               "dinov2-fsdp", "timm", "dinov3",
                               "dinov3-mlp")]
CASES += [("dinov2", f) for f in ("model", "module", "backbone")]
CASES += [("dinov3", "model")]


@pytest.mark.parametrize("variant,form", CASES)
def test_conversion_equals_the_jax_conversion(tmp_path, variant, form):
    model = DINOV3 if variant.startswith("dinov3") else DINOV2
    path = tmp_path / "weights.pth"
    torch.save(wrap(meta_state_dict(variant), form), path)
    got = load_torch_checkpoint_for_model(path, model)
    assert_same(got, jax_conversion(path, model))
    if variant == "timm":  # identity LayerScale where there is none
        assert torch.equal(got["blocks.0.ls1.gamma"], torch.ones(D))
    if variant.startswith("dinov3"):  # k has no bias; registers carried
        assert "blocks.0.attn.k.bias" not in got
        assert got["register_tokens"].shape == (1, 4, D)
    if variant in ("dinov2", "dinov3-mlp"):  # every leaf of the model
        module = get_wrapped_model(model).module
        assert set(module.state_dict()) == set(got)


@pytest.mark.parametrize("model", ["ecvit/ecvits",
                                   "ultralytics/yolov8s", "ecvit/ecvit_t",
                                   "ultralytics/yolo11n"])
def test_unported_converters_name_item_10(tmp_path, model):
    """The ECViT and ultralytics converters (once refused naming ROADMAP
    item 10) convert full-size EdgeCrafter- and ultralytics-named state
    dicts bitwise as the JAX conversion; a name neither package knows
    (``ecvit/ecvit_t``) is an unknown model in both."""
    from lightly_train_tpu.errors import UnknownModelError as JaxUnknown
    from lightly_train_tpu_torch.errors import UnknownModelError
    from test_torch_parity import ecvit_state_dict, ultralytics_state_dict

    path = tmp_path / "weights.pth"
    if model == "ecvit/ecvit_t":
        torch.save({"w": torch.zeros(1)}, path)
        with pytest.raises(JaxUnknown):
            JC.load_torch_checkpoint_for_model(path, model)
        with pytest.raises(UnknownModelError):
            load_torch_checkpoint_for_model(path, model)
        return
    make = ecvit_state_dict if model.startswith("ecvit") else \
        ultralytics_state_dict
    torch.save({"model": make(model, 0)}, path)
    got = load_torch_checkpoint_for_model(path, model)
    assert_same(got, variables_from_jax(JC.load_torch_checkpoint_for_model(
        path, model)))
    with torch.device("meta"):
        module = get_wrapped_model(model).module
    assert set(module.state_dict()) == set(got)


def test_a_resnet_state_dict_names_item_10(tmp_path):
    """A ResNet state dict (``conv1.weight``) given for a ViT goes to the
    ResNet converter in both packages, which the ViT's config cannot
    size: both raise AttributeError (ResNet conversion is ported, item
    10)."""
    path = tmp_path / "resnet.pth"
    torch.save({"conv1.weight": torch.zeros(4, 3, 7, 7)}, path)
    with pytest.raises(AttributeError, match="stage_sizes"):
        JC.load_torch_checkpoint_for_model(path, DINOV2)
    with pytest.raises(AttributeError, match="stage_sizes"):
        load_torch_checkpoint_for_model(path, DINOV2)


def test_a_518_pos_embed_keeps_the_fresh_init_in_both_packages(tmp_path,
                                                               caplog):
    """Meta's DINOv2 ships ``pos_embed`` for 518^2 (37^2 + 1 entries); the
    registered ViTs hold a 16^2 grid. Both packages keep their fresh
    ``pos_embed`` with a warning and load every other leaf."""
    path = tmp_path / "dinov2_518.pth"
    torch.save(meta_state_dict("dinov2", grid=37), path)
    variables = jax_resolve(str(path), DINOV2)[0]
    init_j = jax.device_get(jax_get_wrapped_model(DINOV2).init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 3)))["params"])
    merged_j = jax_merge(init_j, variables["params"])
    np.testing.assert_array_equal(merged_j["pos_embed"], init_j["pos_embed"])

    state, name, head = resolve_pretrained_source(str(path), DINOV2)
    assert (name, head) == (DINOV2, None)
    module = get_wrapped_model(DINOV2).module
    module.reset_parameters(torch.Generator().manual_seed(0))
    init = module.state_dict()
    with caplog.at_level("WARNING", logger="lightly_train_tpu_torch"):
        merged = merge_pretrained(init, state)
    assert "pos_embed" in caplog.text
    assert torch.equal(merged["pos_embed"], init["pos_embed"])
    ref = params_from_jax(merged_j)
    for k in merged:
        if k != "pos_embed":
            assert torch.equal(merged[k], ref[k]), k


@pytest.fixture
def image_folder(tmp_path):
    """The JPEG fixtures and a PNG: the port's own decoders feed the run."""
    folder = tmp_path / "images"
    shutil.copytree(FIXTURES, folder,
                    ignore=shutil.ignore_patterns("*.py", "*.json"))
    rng = np.random.default_rng(0)
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
        folder / "noise.png")
    return folder


def test_pretrain_from_a_pth_starts_from_the_jax_conversion(tmp_path,
                                                           image_folder):
    """``pretrain(checkpoint=x.pth)`` at learning rate 0 on a JPEG and PNG
    folder: the exported student is the JAX package's conversion of the
    file, bitwise, leaf for leaf; the EMA teacher started from it; then
    ``embed`` of the folder with that export."""
    path = tmp_path / "dinov2_vittest14.pth"
    torch.save({"model": meta_state_dict("dinov2", seed=3)}, path)
    state = lt.pretrain(
        out=str(tmp_path / "out"), data=str(image_folder), model=DINOV2,
        method="dinov2", accelerator="cpu", batch_size=4, steps=1,
        precision="fp32", canonical_size=64, num_workers=2,
        learning_rate=0.0, checkpoint=str(path), method_args=dict(
            output_dim=64, hidden_dim=32, bottleneck_dim=16,
            local_view_count=2, global_image_size=28, local_image_size=14))
    art = tmp_path / "out" / "exported_models" / "exported_last"
    exported = torch.load(art / "model.pt", weights_only=True)
    ref = params_from_jax(jax_resolve(str(path), DINOV2)[0]["params"])
    assert_same(exported, {k: ref[k] for k in exported})
    assert set(exported) == set(ref)
    teacher = state.method_state["teacher"]["student"].state_dict()
    for k in exported:
        torch.testing.assert_close(teacher[k], exported[k], rtol=1e-6,
                                   atol=1e-7)
    out = lt.embed(out=str(tmp_path / "emb.npz"), data=str(image_folder),
                   checkpoint=str(art), image_size=28, batch_size=4,
                   accelerator="cpu")
    emb = np.load(out)["embeddings"]
    assert emb.shape == (12, D) and np.isfinite(emb).all()


def test_a_pth_teacher_starts_as_the_jax_packages(tmp_path):
    """A DINOv3-named ``teacher_weights`` file (storage tokens, the k bias
    mask): the port's frozen teacher holds the JAX distillation's teacher
    variables for the same file, bitwise."""
    path = tmp_path / "dinov3_vittest16.pth"
    torch.save(meta_state_dict("dinov3-mlp", seed=5), path)
    args = dict(teacher=DINOV3, teacher_weights=str(path), image_size=32,
                queue_size=16)
    method = V3.DistillationV3(get_wrapped_model(DINOV2),
                               V3.DistillationV3Args(**args))
    _, method_state = method.init(torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    jax_method = JV3.DistillationV3(jax_get_wrapped_model(DINOV2),
                                    JV3.DistillationV3Args(**args))
    ref = params_from_jax(jax_method._teacher_variables_init["params"])
    assert_same(method_state["teacher"].state_dict(), ref)


def test_pretrain_distillation_with_a_pth_teacher(tmp_path, image_folder):
    path = tmp_path / "dinov3_vittest16.pth"
    torch.save({"model": meta_state_dict("dinov3-mlp", seed=6)}, path)
    state = lt.pretrain(
        out=str(tmp_path / "out"), data=str(image_folder), model=DINOV2,
        accelerator="cpu", batch_size=4, steps=2, precision="fp32",
        canonical_size=64, num_workers=2, log_every=1,
        method_args={"teacher": DINOV3, "teacher_weights": str(path),
                     "image_size": 32})
    ref = load_torch_checkpoint_for_model(path, DINOV3)
    assert_same(state.method_state["teacher"].state_dict(), ref)
    steps = [json.loads(line) for line in
             (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in steps if "step" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
