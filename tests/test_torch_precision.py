"""``LIGHTLY_TRAIN_MATMUL_PRECISION`` in the port (``_system.py``): the CUDA
backend's TF32 switches that ``pretrain`` leaves for each value, read on the
CPU after a CPU run. ``default`` and ``high`` allow TF32 in the fp32 GEMMs
and convolutions alike, ``highest`` neither; the CPU path's precision does
not move. The JAX package applies the variable at the start of every run
(``lightly_train_tpu/_system.py``); ``embed`` does not apply it there
either."""

import logging

import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch._system import apply_matmul_precision

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


@pytest.fixture(autouse=True)
def restore_switches():
    """Each case starts from the switches at their opposite (matmul TF32
    off, cuDNN TF32 on: torch's own defaults, the mixture the port ran
    before it applied the variable) and leaves them as it found them."""
    prior = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
        prior)


def _pretrain(tmp_path):
    data = tmp_path / "images"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
        (data / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())
    return lt.pretrain(
        out=str(tmp_path / "out"), data=str(data), model="dinov2/vittest14",
        method="dinov2", accelerator="cpu", batch_size=2, steps=1,
        precision="fp32", canonical_size=36, num_workers=0, method_args=SMALL)


@pytest.mark.parametrize("value,tf32", [("default", True), ("high", True),
                                        ("highest", False)])
def test_pretrain_sets_both_cuda_switches(tmp_path, monkeypatch, value, tf32):
    """The repaired mixture: before the variable was applied, the fp32
    GEMMs ran IEEE fp32 while cuDNN's convolutions ran TF32 (torch's
    defaults), which matches none of the values."""
    monkeypatch.setenv("LIGHTLY_TRAIN_MATMUL_PRECISION", value)
    mkldnn = (torch.backends.mkldnn.matmul.fp32_precision,
              torch.backends.mkldnn.fp32_precision)
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(256, 256, generator=gen) for _ in range(2))
    before = a @ b
    assert _pretrain(tmp_path).step == 1
    assert torch.equal(a @ b, before)
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    # The CPU path stays in exact fp32 (torch.set_float32_matmul_precision
    # would also have moved mkldnn's matmul to TF32).
    assert (torch.backends.mkldnn.matmul.fp32_precision,
            torch.backends.mkldnn.fp32_precision) == mkldnn
    assert torch.backends.mkldnn.matmul.fp32_precision != "tf32"


def test_the_variable_unset_is_default(monkeypatch):
    monkeypatch.delenv("LIGHTLY_TRAIN_MATMUL_PRECISION", raising=False)
    apply_matmul_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True


def test_every_value_is_set_explicitly(monkeypatch):
    """Unlike the JAX package, whose "default" leaves the previous setting
    in place, "default" after "highest" gives TF32 again."""
    for value, tf32 in (("highest", False), ("default", True)):
        monkeypatch.setenv("LIGHTLY_TRAIN_MATMUL_PRECISION", value)
        apply_matmul_precision()
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32


def test_an_unknown_value_warns_and_changes_nothing(monkeypatch, caplog):
    monkeypatch.setenv("LIGHTLY_TRAIN_MATMUL_PRECISION", "float32")
    with caplog.at_level(logging.WARNING, logger="lightly_train_tpu_torch"):
        apply_matmul_precision()
    assert any("Unknown LIGHTLY_TRAIN_MATMUL_PRECISION='float32'"
               in r.getMessage() for r in caplog.records)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is True


def test_embed_does_not_apply_it(tmp_path, monkeypatch):
    from lightly_train_tpu_torch._commands import embed as E

    monkeypatch.setenv("LIGHTLY_TRAIN_MATMUL_PRECISION", "highest")
    _pretrain(tmp_path)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    path = E.embed(out=str(tmp_path / "emb.npz"),
                   data=str(tmp_path / "images"),
                   checkpoint=str(tmp_path / "out" / "exported_models"
                                  / "exported_last"),
                   image_size=28, batch_size=2, accelerator="cpu")
    assert path.exists()
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
