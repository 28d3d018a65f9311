"""The ultralytics YOLOv8, YOLOv5 and YOLO11 backbones and YOLO-NAS in the
port, against the JAX package.

- *Backbones*: ``yolov8test``, ``yolov5test``, ``yolo11test`` (C2PSA's
  plain attention) and ``yolo_nas_test`` at 64^2 and 72^2 (odd maps: the
  YOLO-NAS "SAME" padding both ways) from checkpoint-scale weights and
  running statistics carried by ``variables_from_jax``, train and eval:
  every output within 1e-5 relative L2 (float32, TF32 off; in train mode,
  or within the JAX package's own distance from itself when the batch is
  permuted, where that is larger) and the updated statistics within 1e-5.
- *Converters*: ultralytics-named YOLOv8, YOLOv5 and YOLO11 state dicts
  (with ``num_batches_tracked`` and a head, which the conversion drops)
  bitwise as the JAX conversion; the YOLOv8 inverse bitwise as the JAX
  inverse, and back.
- *Steps*: three distillation v3 steps on ``yolo11test`` and three DINO
  steps (the fused AdamW+EMA update over YOLO-NAS's 0-d ``alpha`` leaves)
  on ``yolo_nas_test`` against the JAX package (``test_torch_parity``).
- *The 0-d leaves*: ``pretrain`` of ``yolo_nas_test`` with the unfused
  LARS, SGD and AdamW chains and with AdamW8bit moves every ``alpha``;
  a resumed run is bitwise the uninterrupted one; the export carries the
  ``alpha`` leaves and ``embed`` of it is an eval-mode forward.
"""

import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu.models import convert as JC
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu_torch._checkpoint.checkpoint import load_exported_model
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._data.image_dataset import (
    ImageDataset,
    list_image_files,
)
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch.models.convert import (
    convert_yolov8_to_ultralytics_state_dict,
    load_torch_checkpoint_for_model,
)
from lightly_train_tpu_torch.models.from_jax import variables_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from test_torch_parity import (
    backbone_matches_jax,
    three_steps_match_jax,
    ultralytics_state_dict,
)

NAS = "super_gradients/yolo_nas_test"


@pytest.fixture(autouse=True)
def _ieee_fp32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model,size", [
    ("ultralytics/yolov8test", 64), ("ultralytics/yolov5test", 64),
    ("ultralytics/yolo11test", 64), (NAS, 64), (NAS, 72)])
def test_backbone_matches_jax(model, size, train):
    backbone_matches_jax(model, size, train)


@pytest.mark.parametrize("model", ["ultralytics/yolov8test",
                                   "ultralytics/yolov5test",
                                   "ultralytics/yolo11test"])
def test_conversion_is_the_jax_conversion_bitwise(tmp_path, model):
    path = tmp_path / "weights.pt"
    sd = ultralytics_state_dict(model, 0)
    torch.save({"model": sd}, path)
    got = load_torch_checkpoint_for_model(path, model)
    want = variables_from_jax(JC.load_torch_checkpoint_for_model(path, model))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # Every parameter and statistic of the backbone, nothing else.
    module = get_wrapped_model(model).module
    assert set(module.state_dict()) == set(got)
    module.load_state_dict(got)
    if model == "ultralytics/yolov8test":
        # The inverse: the JAX inverse of the same variables, bitwise, and
        # the ultralytics state dict back (its head and counters aside).
        back = convert_yolov8_to_ultralytics_state_dict(got)
        j_back = JC.convert_yolov8_to_ultralytics_state_dict(
            JC.load_torch_checkpoint_for_model(path, model))
        assert set(back) == set(j_back)
        for name, value in j_back.items():
            assert torch.equal(back[name], torch.from_numpy(value)), name
        assert set(back) == {k for k in sd if not k.startswith("model.23.")
                             and not k.endswith("num_batches_tracked")}
        for name, value in back.items():
            assert torch.equal(value, sd[name]), name


# student -> (leaves of zero exact gradient, the running means their steps
# shift). YOLO11's C2PSA: the positional branch's BatchNorm bias feeds the
# projection's train-mode BatchNorm, and every bias added to the PSA
# branch (the projection's, the FFN's last) reaches the output only
# through C2PSA's fusing conv and its BatchNorm. YOLO-NAS: each QARepVGG
# block's 3x3 bias is summed straight into the block's BatchNorm.
DEGENERATE = {
    "ultralytics/yolo11test": (
        ("attn.pe.bn.bias", "attn.proj.bn.bias", "ffn1.bn.bias"),
        ("attn.proj.bn.mean", "ffn0.bn.mean", "layer10.cv2.bn.mean")),
    NAS: (("conv3.bias",), (".bn.mean",)),
}


@pytest.mark.parametrize("student,method", [
    ("ultralytics/yolo11test", "distillationv3"), (NAS, "dino")])
def test_three_steps_match_jax(student, method):
    state, start = three_steps_match_jax(student, method,
                                         *DEGENERATE[student])
    if student == NAS:
        alphas = {k: v for k, v in state.params.state_dict().items()
                  if k.endswith("alpha")}
        assert alphas and all(v.ndim == 0 for v in alphas.values())
        assert all(not torch.equal(v, start[k]) for k, v in alphas.items())


@pytest.fixture
def data(tmp_path):
    """Eight 40 x 44 PPM images."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n44 40\n255\n" + img.tobytes())
    return folder


RUN = dict(model=NAS, batch_size=4, precision="fp32", canonical_size=48,
           num_workers=0, accelerator="cpu", log_every=1)
SIMCLR = {"image_size": 32, "hidden_dim": 16, "output_dim": 8}


@pytest.mark.parametrize("optim", ["lars", "sgd", "adamw", "adamw8bit"])
def test_the_alpha_leaves_train_with_every_optimizer(tmp_path, data, optim):
    """SimCLR on YOLO-NAS with each unfused chain and AdamW8bit: every 0-d
    ``alpha`` moves from its init of 1, stays 0-d and finite, and the
    optimizer holds finite state for it."""
    state = lt.pretrain(out=str(tmp_path / "o"), data=str(data),
                        method="simclr", steps=2, optim=optim,
                        method_args=SIMCLR, **RUN)
    named = dict(state.params.named_parameters())
    alphas = [k for k in named if k.endswith("alpha")]
    assert len(alphas) == 4
    for k in alphas:
        assert named[k].shape == () and torch.isfinite(named[k])
        assert not torch.equal(named[k].detach(), torch.ones(()))
    # The optimizer holds its state of each 0-d leaf (moments, a trace,
    # int8 moments and their scales), finite.
    for key, held in state.updater.state_dict().items():
        if isinstance(held, dict):
            for k in alphas:
                assert torch.isfinite(held[k].float()).all(), (key, k)


class _Interrupted(Exception):
    pass


def test_resume_export_and_embed_carry_the_alpha_leaves(tmp_path, data,
                                                        monkeypatch):
    """DINO on YOLO-NAS stopped after its step-2 checkpoint and resumed ends
    bitwise in the uninterrupted run's state (parameters with the 0-d
    leaves, statistics, the teacher's copy, the fused update's moments);
    the export holds the 0-d leaves and ``embed`` of it is an eval-mode
    forward of the exported weights."""
    args = dict(data=str(data), method="dino", steps=4, checkpoint_every=2,
                method_args=dict(output_dim=64, hidden_dim=32,
                                 bottleneck_dim=16, local_view_count=2,
                                 global_image_size=32, local_image_size=16),
                **RUN)
    full = lt.pretrain(out=str(tmp_path / "full"), **args)

    class Loader(PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise _Interrupted
                yield batch

    monkeypatch.setattr(T, "PretrainLoader", Loader)
    with pytest.raises(_Interrupted):
        lt.pretrain(out=str(tmp_path / "cut"), **args)
    monkeypatch.undo()
    resumed = lt.pretrain(out=str(tmp_path / "cut"), resume_interrupted=True,
                          **args)

    def everything(state):
        out = {f"p.{k}": v for k, v in state.params.state_dict().items()}
        out.update({f"t.{k}": v for k, v in
                    state.method_state["teacher"].state_dict().items()})
        out.update({f"o.{k}": v for k, v in
                    state.updater.state_dict().items()
                    if isinstance(v, torch.Tensor)})
        return out

    a, b = everything(full), everything(resumed)
    assert a.keys() == b.keys()
    assert sum(k.endswith("alpha") for k in a) >= 8
    for k in a:
        assert torch.equal(a[k], b[k]), k

    art = tmp_path / "full" / "exported_models" / "exported_last"
    exported = load_exported_model(art)
    alphas = {k: v for k, v in exported["state_dict"].items()
              if k.endswith("alpha")}
    assert len(alphas) == 4 and all(v.ndim == 0 for v in alphas.values())
    path = lt.embed(out=str(tmp_path / "emb.npz"), data=str(data),
                    checkpoint=str(art), image_size=32, batch_size=3,
                    accelerator="cpu")
    emb = np.load(path)["embeddings"]
    wrapped = get_wrapped_model(NAS)
    wrapped.module.load_state_dict(exported["state_dict"])
    dataset = ImageDataset(list_image_files(data), (32, 32))
    x = torch.from_numpy(np.stack([dataset[i] for i in range(8)])) / 255.0
    with torch.no_grad():
        want = wrapped.forward_pool(wrapped.forward_features(x))
    assert emb.shape == (8, 32)
    np.testing.assert_allclose(emb, want.numpy(), rtol=1e-5, atol=1e-6)
