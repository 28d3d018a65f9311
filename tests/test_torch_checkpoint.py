"""The port's checkpoints, resume, warm start, export, ``embed_dim`` and
``transform_args`` in ``pretrain``, and the augmentation grid, against the
JAX package where both compute the same thing. All on the CPU, fp32, at
the ``vittest14`` size (ports of ``tests/commands/test_pretrain.py`` at the
port's model and method)."""

import json
import logging
import struct

import jax
import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch._checkpoint import checkpoint as C
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._data.image_dataset import (
    ImageDataset,
    list_image_files,
)
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch._visualize import grids as G
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.models.embedding import project_wrapped
from lightly_train_tpu_torch.models.from_jax import params_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import augment as TA
from torch_fixtures.threads import one_torch_thread  # noqa: F401

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


@pytest.fixture
def data(tmp_path):
    """Ten 36 x 36 PPM images."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())
    return folder


def _pretrain(out, data, **kwargs):
    args = dict(out=str(out), data=str(data), model="dinov2/vittest14",
                method="dinov2", accelerator="cpu", batch_size=4, steps=4,
                precision="fp32", canonical_size=36, num_workers=2,
                method_args=SMALL, log_every=1)
    args.update(kwargs)
    return lt.pretrain(**args)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


class _Interrupted(Exception):
    pass


def _interrupt_after(monkeypatch, n_batches):
    """The run's loader raises when it is asked for batch ``n_batches + 1``
    (harness only: the package has no such flag)."""

    class Loader(PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == n_batches:
                    raise _Interrupted
                yield batch

    monkeypatch.setattr(T, "PretrainLoader", Loader)


def _full_state(state):
    """Every tensor a step updates, by name."""
    out = {f"params.{k}": v for k, v in state.params.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in
                state.method_state["teacher"].state_dict().items()})
    for key in ("dino_center", "ibot_center"):
        out[key] = state.method_state[key]
    for key in ("mu", "nu"):
        out.update({f"{key}.{k}": v
                    for k, v in getattr(state.updater, key).items()})
    return out


def test_resume_gives_bitwise_the_uninterrupted_run(tmp_path, data,
                                                    monkeypatch):
    """A steps=4 run stopped after its step-2 checkpoint and resumed ends
    in bitwise the state of the uninterrupted run: the loader skips the
    consumed batches and every step's randomness comes from (seed, step)."""
    full = _pretrain(tmp_path / "full", data, checkpoint_every=2)
    _interrupt_after(monkeypatch, 2)
    with pytest.raises(_Interrupted):
        _pretrain(tmp_path / "cut", data, checkpoint_every=2)
    cut = tmp_path / "cut"
    assert sorted(p.name for p in (cut / "checkpoints").iterdir()) == [
        "step_2.pt"]
    meta = json.loads((cut / "exported_models" / "exported_last"
                       / "metadata.json").read_text())
    assert meta["steps"] == 2
    monkeypatch.undo()
    resumed = _pretrain(cut, data, checkpoint_every=2,
                        resume_interrupted=True)
    assert resumed.step == full.step == 4
    assert resumed.updater.count == full.updater.count == 4
    a, b = _full_state(full), _full_state(resumed)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    logged = [r for r in _records(cut) if "step" in r]
    assert [r["step"] for r in logged] == [1, 2, 3, 4]  # appended
    ref = {r["step"]: r for r in _records(tmp_path / "full") if "step" in r}
    for r in logged[2:]:
        for key in ("train_loss", "dino_loss", "ibot_loss", "koleo_loss",
                    "grad_norm"):
            assert r[key] == ref[r["step"]][key], (r["step"], key)


def test_resume_without_a_checkpoint_starts_at_step_0(tmp_path, data):
    state = _pretrain(tmp_path / "out", data, steps=2,
                      resume_interrupted=True)
    assert state.step == 2


def test_the_two_newest_checkpoints_are_kept(tmp_path, data):
    _pretrain(tmp_path / "out", data, checkpoint_every=1)
    ckpt = tmp_path / "out" / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_3.pt",
                                                      "step_4.pt"]
    assert C.CheckpointManager(ckpt).latest_step() == 4
    saved = torch.load(ckpt / "step_4.pt", weights_only=True)
    assert saved["step"] == 4 and saved["model"] == "dinov2/vittest14"
    assert saved["method"] == "dinov2" and saved["optimizer"]["count"] == 4
    assert set(saved["method_state"]) == {"teacher", "dino_center",
                                          "ibot_center"}


def test_a_save_that_fails_leaves_the_newest_checkpoint_readable(
        tmp_path, data, monkeypatch):
    state = _pretrain(tmp_path / "out", data, steps=1)
    mgr = C.CheckpointManager(tmp_path / "out" / "checkpoints")
    before = (mgr.path(1)).read_bytes()

    def save_half(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(C.torch, "save", save_half)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state, "dinov2/vittest14", "dinov2")
    assert sorted(p.name for p in mgr.ckpt_dir.iterdir()) == ["step_1.pt"]
    assert mgr.latest_step() == 1 and mgr.path(1).read_bytes() == before


def test_an_export_at_every_checkpoint_and_at_the_end(tmp_path, data,
                                                      monkeypatch):
    real = T.export_model
    steps = []

    def spy(*args, **kwargs):
        steps.append(kwargs["extra_meta"]["steps"])
        return real(*args, **kwargs)

    monkeypatch.setattr(T, "export_model", spy)
    state = _pretrain(tmp_path / "out", data, steps=3, checkpoint_every=2)
    assert steps == [2, 3]
    art = tmp_path / "out" / "exported_models" / "exported_last"
    assert sorted(p.name for p in art.iterdir()) == ["metadata.json",
                                                     "model.pt"]
    assert json.loads((art / "metadata.json").read_text()) == {
        "model_name": "dinov2/vittest14", "format_version": 1,
        "method": "dinov2", "steps": 3}
    exported = torch.load(art / "model.pt", weights_only=True)
    student = state.params["student"].state_dict()
    assert exported.keys() == student.keys()
    assert all(torch.equal(exported[k], student[k]) for k in student)


def test_checkpoint_every_auto_is_a_tenth_of_the_steps(tmp_path, data,
                                                       monkeypatch):
    saved = []
    real = C.CheckpointManager.save
    monkeypatch.setattr(C.CheckpointManager, "save",
                        lambda self, step, *a: (saved.append(step),
                                                real(self, step, *a)))
    _pretrain(tmp_path / "out", data, steps=20, batch_size=2)
    assert saved == [2, 4, 6, 8, 10, 12, 14, 16, 18, 20]


def test_a_warm_start_with_lr_0_keeps_the_weights_bitwise(tmp_path, data):
    _pretrain(tmp_path / "a", data, steps=2)
    art = tmp_path / "a" / "exported_models" / "exported_last"
    state = _pretrain(tmp_path / "b", data, steps=1, learning_rate=0.0,
                      checkpoint=str(art))
    loaded = torch.load(art / "model.pt", weights_only=True)
    after = torch.load(tmp_path / "b" / "exported_models" / "exported_last"
                       / "model.pt", weights_only=True)
    assert loaded.keys() == after.keys()
    for k in loaded:
        assert torch.equal(loaded[k], after[k]), k
    # The EMA teacher started from the loaded student: one EMA step of a
    # teacher equal to its student keeps it within rounding.
    teacher = state.method_state["teacher"]["student"].state_dict()
    for k in loaded:
        torch.testing.assert_close(teacher[k], loaded[k], rtol=1e-6,
                                   atol=1e-7)


def test_a_checkpoint_of_another_model_is_refused(tmp_path, data):
    _pretrain(tmp_path / "a", data, steps=1)
    with pytest.raises(ConfigError, match="vittest14"):
        _pretrain(tmp_path / "b", data, model="dinov2/vitt14",
                  checkpoint=str(tmp_path / "a" / "exported_models"
                                 / "exported_last"))
    assert not (tmp_path / "b").exists()


def test_checkpoint_and_resume_cannot_be_combined(tmp_path, data):
    with pytest.raises(ConfigError, match="resume_interrupted"):
        _pretrain(tmp_path / "out", data, checkpoint=str(tmp_path / "x"),
                  resume_interrupted=True)


def test_a_non_empty_out_dir_is_taken_under_resume_interrupted(tmp_path,
                                                               data):
    out = tmp_path / "out"
    out.mkdir()
    (out / "stale.txt").write_text("x")
    assert _pretrain(out, data, steps=1, resume_interrupted=True).step == 1


def _meta_layout(state):
    """A DINOv2 ViT state dict of the port in Meta's naming: fused qkv, a
    zero CLS entry in front of ``pos_embed``, ``patch_embed.proj``."""
    out = {}
    for k, v in state.items():
        if ".attn.q." in k:
            parts = [state[k.replace(".q.", f".{n}.")] for n in "qkv"]
            out[k.replace(".q.", ".qkv.")] = torch.cat(parts)
        elif ".attn.k." in k or ".attn.v." in k:
            continue
        elif k == "pos_embed":
            out[k] = torch.cat([torch.zeros_like(v[:, :1]), v], dim=1)
        elif k == "mask_token":
            out[k] = v[None]
        else:
            out[k.replace("patch_embed.", "patch_embed.proj.")] = v
    return out


@pytest.mark.parametrize("checkpoint", ["auto", "weights.pth"])
def test_raw_and_auto_checkpoints_name_their_roadmap_item(tmp_path, data,
                                                          checkpoint):
    """``"auto"`` (public weights) still names item 20; a torch checkpoint
    in Meta's layout now loads: at learning rate 0 the run exports the
    weights it was written from, bitwise."""
    if checkpoint == "auto":
        with pytest.raises(NotImplementedError, match="ROADMAP item 20"):
            _pretrain(tmp_path / "out", data, checkpoint=checkpoint)
        return
    module = get_wrapped_model("dinov2/vittest14").module
    module.reset_parameters(torch.Generator().manual_seed(11))
    weights = module.state_dict()
    torch.save({"model": _meta_layout(weights)}, tmp_path / checkpoint)
    _pretrain(tmp_path / "out", data, steps=1, learning_rate=0.0,
              checkpoint=str(tmp_path / checkpoint))
    after = torch.load(tmp_path / "out" / "exported_models" / "exported_last"
                       / "model.pt", weights_only=True)
    assert after.keys() == weights.keys()
    for k in weights:
        assert torch.equal(after[k], weights[k]), k


def test_merge_pretrained_shape_rules(monkeypatch, caplog):
    init = {"pos_embed": torch.zeros(1, 4, 2), "w": torch.zeros(2, 3),
            "head": torch.zeros(3)}
    new = {"pos_embed": torch.ones(1, 9, 2), "w": torch.ones(2, 3),
           "other": torch.ones(1)}
    with caplog.at_level(logging.WARNING, logger="lightly_train_tpu_torch"):
        out = C.merge_pretrained(init, new)
    assert out.keys() == init.keys()
    assert torch.equal(out["pos_embed"], init["pos_embed"])  # kept, warned
    assert torch.equal(out["w"], new["w"])
    assert torch.equal(out["head"], init["head"])
    assert "pos_embed" in caplog.text
    bad = {"w": torch.ones(3, 2)}
    with pytest.raises(ConfigError, match="LIGHTLY_TRAIN_ALLOW_SHAPE"):
        C.merge_pretrained(init, bad)
    monkeypatch.setenv("LIGHTLY_TRAIN_ALLOW_SHAPE_MISMATCH", "1")
    assert torch.equal(C.merge_pretrained(init, bad)["w"], init["w"])


def test_embed_dim_trains_the_head_and_exports_backbone_and_head(tmp_path,
                                                                 data):
    state = _pretrain(tmp_path / "out", data, steps=2, embed_dim=24)
    student = state.params["student"]
    assert student.embed.weight.shape == (24, 32)
    assert state.updater.mu["student.embed.weight"].abs().sum() > 0
    art = tmp_path / "out" / "exported_models" / "exported_last"
    meta = json.loads((art / "metadata.json").read_text())
    assert meta["embed_dim"] == 24 and meta["steps"] == 2
    backbone = torch.load(art / "model.pt", weights_only=True)
    head = torch.load(art / "embed_head.pt", weights_only=True)
    assert backbone.keys() == student.backbone.state_dict().keys()
    assert set(head) == {"weight", "bias"}
    assert torch.equal(head["weight"], student.embed.weight)

    out = lt.embed(out=str(tmp_path / "emb.npz"), data=str(data),
                   checkpoint=str(art), image_size=28, batch_size=4,
                   accelerator="cpu")
    emb = np.load(out)["embeddings"]
    assert emb.shape == (10, 24)
    dataset = ImageDataset(list_image_files(data), (28, 28))
    x = torch.from_numpy(np.stack([dataset[i] for i in range(10)]))
    with torch.no_grad():
        ref = student.embed(student.backbone(x.float() / 255.0)["cls_token"])
    np.testing.assert_allclose(emb, ref.numpy(), rtol=1e-5, atol=1e-6)


def test_a_warm_start_with_embed_dim_continues_the_head(tmp_path, data):
    _pretrain(tmp_path / "a", data, steps=2, embed_dim=24)
    art = tmp_path / "a" / "exported_models" / "exported_last"
    _pretrain(tmp_path / "b", data, steps=1, embed_dim=24, learning_rate=0.0,
              checkpoint=str(art))
    head_a = torch.load(art / "embed_head.pt", weights_only=True)
    head_b = torch.load(tmp_path / "b" / "exported_models" / "exported_last"
                        / "embed_head.pt", weights_only=True)
    for k in head_a:
        assert torch.equal(head_a[k], head_b[k])


def _jax_dinov2(embed_dim):
    import jax.numpy as jnp

    from lightly_train_tpu.methods.dinov2 import DINOv2 as JaxDINOv2
    from lightly_train_tpu.methods.dinov2 import DINOv2Args as JaxArgs
    from lightly_train_tpu.models.embedding import (
        project_wrapped as jax_project,
    )
    from lightly_train_tpu.models.package_registry import (
        get_wrapped_model as jax_model,
    )

    wrapped = jax_model("dinov2/vittest14")
    if embed_dim is not None:
        wrapped = jax_project(wrapped, embed_dim, jnp.float32)
    return JaxDINOv2(wrapped, JaxArgs(**SMALL))


def _port_dinov2(embed_dim):
    wrapped = get_wrapped_model("dinov2/vittest14")
    if embed_dim is not None:
        wrapped = project_wrapped(wrapped, embed_dim, torch.float32)
    return DINOv2(wrapped, DINOv2Args(**SMALL))


def test_dinov2_with_embed_dim_has_no_layer_decay():
    """The JAX DINOv2 reads the layer count from ``wrapped.module.cfg``,
    which the projected module lacks: its ``getattr(..., None)`` default
    means uniform lr scales (no layer decay, no patch-embed multiplier),
    but the attribute access before it raises. The port takes the uniform
    scales; the weight-decay mask is the JAX one, leaf for leaf."""
    import jax.numpy as jnp

    j_method = _jax_dinov2(24)
    j_params, _, _ = j_method.init(jax.random.key(0),
                                   jnp.zeros((2, 36, 36, 3), jnp.uint8))
    with pytest.raises(AttributeError, match="cfg"):
        j_method.lr_scales(j_params)
    method = _port_dinov2(24)
    params, _ = method.init(torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    named = dict(params.named_parameters())
    assert method.lr_scales(named) is None
    # Without embed_dim both decay by layer.
    assert _port_dinov2(None).lr_scales(
        dict(_port_dinov2(None).init(torch.Generator().manual_seed(0),
                                     torch.device("cpu"))[0]
             .named_parameters()))["student.blocks.0.attn.q.weight"] < 1.0
    j_mask = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            j_method.wd_mask(j_params))[0]:
        keys = [str(k.key) for k in path]
        nested = {keys[-1]: np.zeros((2, 2) if keys[-1] == "kernel" else 2)}
        for k in reversed(keys[:-1]):
            nested = {k: nested}
        j_mask[next(iter(params_from_jax(nested)))] = bool(v)
    assert j_mask == method.wd_mask(named)
    assert "student.embed.weight" in named and j_mask["student.embed.weight"]


def test_dinov31_with_embed_dim_has_no_layer_decay():
    """DINOv31 inherits DINOv2's lr scales and weight-decay mask: with
    ``embed_dim`` the JAX method's attribute access raises before its
    uniform default, the port takes the uniform scales, and the mask is
    the JAX one leaf for leaf (PaKA head included)."""
    import jax.numpy as jnp

    from lightly_train_tpu.methods.dinov31 import DINOv31 as JaxDINOv31
    from lightly_train_tpu.methods.dinov31 import DINOv31Args as JaxArgs
    from lightly_train_tpu.models.embedding import (
        project_wrapped as jax_project,
    )
    from lightly_train_tpu.models.package_registry import (
        get_wrapped_model as jax_model,
    )
    from lightly_train_tpu_torch.methods.dinov31 import DINOv31, DINOv31Args

    small = dict(SMALL, paka_hidden_dim=32, paka_bottleneck_dim=16)
    j_method = JaxDINOv31(jax_project(jax_model("dinov2/vittest14"), 24,
                                      jnp.float32), JaxArgs(**small))
    j_params, _, _ = j_method.init(jax.random.key(0),
                                   jnp.zeros((2, 36, 36, 3), jnp.uint8))
    with pytest.raises(AttributeError, match="cfg"):
        j_method.lr_scales(j_params)
    method = DINOv31(project_wrapped(get_wrapped_model("dinov2/vittest14"),
                                     24, torch.float32), DINOv31Args(**small))
    params, _ = method.init(torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    named = dict(params.named_parameters())
    assert method.lr_scales(named) is None
    j_mask = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            j_method.wd_mask(j_params))[0]:
        keys = [str(k.key) for k in path]
        nested = {keys[-1]: np.zeros((2, 2) if keys[-1] == "kernel" else 2)}
        for k in reversed(keys[:-1]):
            nested = {k: nested}
        j_mask[next(iter(params_from_jax(nested)))] = bool(v)
    assert j_mask == method.wd_mask(named)
    assert "paka_head.fc1.weight" in " ".join(named)


def _dataset_stub(n):
    class Stub:
        def __len__(self):
            return n

    return Stub()


@pytest.mark.parametrize("start_step", [0, 1, 4, 7])
def test_the_index_stream_after_start_step_matches_jax(start_step):
    """10 images at batch 4: two batches an epoch, reshuffled each epoch."""
    from lightly_train_tpu._data.loader import (
        PretrainLoader as JaxPretrainLoader,
    )
    from lightly_train_tpu.parallel import get_default_mesh

    j_loader = JaxPretrainLoader(_dataset_stub(10), 4, get_default_mesh(),
                                 seed=3)
    j_stream = j_loader._index_stream()
    for _ in range(start_step):  # the JAX producer's fast-forward
        next(j_stream)
    loader = PretrainLoader(_dataset_stub(10), 4, torch.device("cpu"),
                            seed=3)
    loader.start_step = start_step
    stream = loader._index_stream()
    for _ in range(6):
        np.testing.assert_array_equal(next(stream), next(j_stream))


TRANSFORM_ARGS = {
    "random_gray_scale": 0.1,
    "color_jitter": {"prob": 0.5, "hue": 0.1},
    "normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.2, 0.2, 0.2]},
    "global_view": {"gaussian_blur": {"prob": 0.3, "sigmas": [0.2, 1.0]},
                    "solarize": None, "image_size": 42},
    "local_view": {"random_resize": {"min_scale": 0.1}, "random_flip": None,
                   "channel_drop": None},
}


def test_override_view_specs_matches_jax():
    from lightly_train_tpu.ops.augment import (
        override_view_specs as jax_override,
    )

    j_specs = jax_override(_jax_dinov2(None).view_specs(), TRANSFORM_ARGS)
    specs = TA.override_view_specs(_port_dinov2(None).view_specs(),
                                   TRANSFORM_ARGS)
    assert [s.count for s in specs] == [s.count for s in j_specs]
    for s, j in zip(specs, j_specs):
        for field in TA.ViewAugmentConfig.__dataclass_fields__:
            assert getattr(s.config, field) == pytest.approx(
                getattr(j.config, field)), field
    assert specs[0].config.out_size == (42, 42)
    assert specs[2].config.hflip_prob == 0.0


@pytest.mark.parametrize("key", ["channel_drop", "random_rotation"])
def test_unported_transform_args_are_refused(key):
    """Channel drop waits for images of more than 3 channels (ROADMAP item
    19); rotation is ported and sets the views' rotation as in the JAX
    package."""
    args = {key: {"prob": 1.0, "degrees": 20}}
    if key == "channel_drop":
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 19\b"):
            TA.override_view_specs(_port_dinov2(None).view_specs(), args)
        return
    from lightly_train_tpu.ops.augment import (
        override_view_specs as jax_override,
    )

    specs = TA.override_view_specs(_port_dinov2(None).view_specs(), args)
    j_specs = jax_override(_jax_dinov2(None).view_specs(), args)
    assert [(s.config.rotation_prob, s.config.rotation_degrees)
            for s in specs] == [(s.config.rotation_prob,
                                 s.config.rotation_degrees) for s in j_specs]
    assert specs[0].config.rotation_degrees == 20.0


def _png_size(path):
    raw = path.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"
    return struct.unpack(">II", raw[16:24])


def test_transform_args_reach_the_views_and_the_grid(tmp_path, data):
    state = _pretrain(tmp_path / "out", data, steps=1,
                      transform_args=TRANSFORM_ARGS)
    assert state.step == 1
    # One row per view config, 4 images of the global views' 42 x 42.
    assert _png_size(tmp_path / "out" / "augmentations.png") == (
        4 * 42 + 3 * 2, 3 * 42)
    _pretrain(tmp_path / "off", data, steps=1, log_augmentations=False)
    assert not (tmp_path / "off" / "augmentations.png").exists()


@pytest.mark.parametrize("n, sizes", [(8, (28, 28, 14)), (5, (32, 20, 13))])
def test_the_grid_png_matches_jax(tmp_path, n, sizes):
    """Written without PIL; decoded by PIL here to the JAX grid's pixels,
    the smaller views resized with PIL's NEAREST."""
    from PIL import Image

    from lightly_train_tpu._visualize.grids import (
        save_augmentation_grid as jax_grid,
    )

    rng = np.random.default_rng(n)
    views = [rng.standard_normal((n, s, s, 3)).astype(np.float32)
             for s in sizes]
    jax_grid(views, tmp_path / "jax.png")
    G.save_augmentation_grid(views, tmp_path / "port.png")
    with Image.open(tmp_path / "jax.png") as a, \
            Image.open(tmp_path / "port.png") as b:
        assert b.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
