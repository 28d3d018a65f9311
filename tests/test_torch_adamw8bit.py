"""AdamW8bit of the port against the JAX package's ``scale_by_adam8bit``
chain, and its memory count.

- The quantizer: per-block scales bitwise, the int8 values equal except
  where ``x / scale + U - 0.5`` lands on a rounding tie.
- Three steps of the whole chain (clip -> adam8bit -> decoupled weight
  decay -> lr) over leaves of ragged sizes, with the JAX noise (its key
  folded with the count, then with the leaf's index) handed to the port:
  the int8 moments agree except at rounding ties (none here), the scales
  and the parameters within 1e-6 relative.
- ``pretrain(optim="adamw8bit")`` on a ResNet resumes bitwise (the int8
  moments, the scales, the count and the noise generator's state are in
  the checkpoint).
- ``refuse_pretraining`` on the meta device at 80 GiB: the int8 moments and
  their scales counted per leaf; ``adamw8bit`` offered only where it would
  fit (a 7B distillation student), not where it would not (a 7B DINOv2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu._optim import adamw8bit as J8
from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim.adamw8bit import AdamW8bitArgs as JaxArgs
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch._optim import AdamW8bitArgs, AdamWArgs
from lightly_train_tpu_torch._optim import adamw8bit as Q8
from lightly_train_tpu_torch._optim.update import UnfusedUpdate
from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
from lightly_train_tpu_torch.models.package_registry import (
    get_wrapped_model,
    refuse_pretraining,
)
from torch_fixtures.threads import one_torch_thread  # noqa: F401

GIB80 = 80 * 2 ** 30


@pytest.mark.parametrize("shape", [(3,), (256,), (1000,), (17, 33),
                                   (3, 3, 8, 16)])
def test_quantizer_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 0, shape)
         ).astype(np.float32)
    key = jax.random.key(len(shape))
    nb = Q8.n_blocks(x.size)
    u = np.asarray(jax.random.uniform(key, (nb, Q8.BLOCK)))
    jq, js = J8._quantize(jnp.asarray(x), key)
    q, s = Q8.quantize(torch.from_numpy(x), torch.from_numpy(u))
    assert torch.equal(s, torch.from_numpy(np.asarray(js)))
    blocks = np.pad(x.reshape(-1), (0, nb * Q8.BLOCK - x.size)).reshape(
        nb, Q8.BLOCK)
    frac = np.abs(np.asarray(blocks / np.asarray(js) + (u - 0.5)) % 1 - 0.5)
    differ = q.numpy() != np.asarray(jq)
    assert (frac[differ] < 1e-5).all()  # ties only
    assert differ.mean() < 1e-3
    jn, jns = J8._quantize_nearest(jnp.asarray(x))
    n, ns = Q8.quantize(torch.from_numpy(x))
    assert torch.equal(ns, torch.from_numpy(np.asarray(jns)))
    assert np.array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        Q8.dequantize(n, ns, torch.Size(shape)).numpy(),
        np.asarray(J8._dequantize(jn, jns, shape)))


SHAPES = {"a": (40, 24), "b": (24,), "c": (3, 3, 4, 8), "d": (700,)}


def test_three_steps_match_jax():
    """The port's unfused AdamW8bit against the JAX chain over leaves of
    ragged sizes, with the JAX package's noise handed over."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    lr, clip, wd = 3e-2, 1.0, 0.05
    j_args = JaxArgs(lr=lr, weight_decay=wd)
    j_opt = build_optimizer(j_args, lr, params, grad_clip_norm=clip)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_opt.init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    upd = UnfusedUpdate(AdamW8bitArgs(lr=lr, weight_decay=wd), lr, t_params,
                        grad_clip_norm=clip)
    names = sorted(SHAPES)  # the JAX tree's leaf order
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * (0.3 + step)).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, j_state = j_opt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, j_state, j_params)
        j_params = {k: j_params[k] + updates[k] for k in names}
        key = jax.random.fold_in(jax.random.key(0), step + 1)

        def noise(name, shape, key=key):
            return torch.from_numpy(np.asarray(jax.random.uniform(
                jax.random.fold_in(key, names.index(name)), tuple(shape))))

        upd.update_and_apply({k: torch.from_numpy(v) for k, v in
                              grads.items()}, t_params, noise=noise)
        adam = j_state[1]
        for i, name in enumerate(names):
            for ours, theirs in (("mu_q", adam.mu_q), ("nu_q", adam.nu_q)):
                assert np.array_equal(upd.moments[ours][name].numpy(),
                                      np.asarray(theirs[name])), (step, name)
            for ours, theirs in (("mu_scale", adam.mu_scale),
                                 ("nu_scale", adam.nu_scale)):
                np.testing.assert_allclose(
                    upd.moments[ours][name].numpy(),
                    np.asarray(theirs[name]), rtol=1e-6)
            np.testing.assert_allclose(t_params[name].numpy(),
                                       np.asarray(j_params[name]), rtol=1e-6,
                                       atol=1e-7)
        assert int(adam.count) == upd.count == step + 1
    moved = max(np.abs(t_params[k].numpy() - params[k]).max() for k in names)
    assert moved > 1e-2


@pytest.fixture
def images(tmp_path):
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n44 40\n255\n" + img.tobytes())
    return folder


class _Interrupted(Exception):
    pass


def test_pretrain_with_adamw8bit_resumes_bitwise(tmp_path, images,
                                                 monkeypatch):
    args = dict(data=str(images), model="torchvision/resnettest",
                method="simclr", optim="adamw8bit", accelerator="cpu",
                batch_size=4, steps=4, precision="fp32", canonical_size=48,
                num_workers=0, checkpoint_every=2,
                method_args={"image_size": 32, "hidden_dim": 16,
                             "output_dim": 8})
    full = lt.pretrain(out=str(tmp_path / "full"), **args)
    assert type(full.updater.args) is AdamW8bitArgs

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
    a, b = full.updater.state_dict(), resumed.updater.state_dict()
    assert a["count"] == b["count"] == 4
    assert torch.equal(a["generator"], b["generator"])
    for key in ("mu_q", "mu_scale", "nu_q", "nu_scale"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    assert a["mu_q"]["student.stem_conv.weight"].dtype == torch.int8
    for k, v in full.params.state_dict().items():
        assert torch.equal(v, resumed.params.state_dict()[k]), k


def _numels(model):
    with torch.device("meta"):
        return [p.numel() for p in get_wrapped_model(model).module.parameters()]


# name -> (model, method, optimizer, teacher, refused, adamw8bit offered)
REFUSALS = {
    "dinov2_7b_adamw": ("dinov3/vit7b16", "dinov2", AdamWArgs(), None,
                        True, False),
    "dinov2_7b_adamw8bit": ("dinov3/vit7b16", "dinov2", AdamW8bitArgs(), None,
                            True, False),
    "dino_7b_adamw": ("dinov2/vit7b14", "dino", AdamWArgs(), None, True,
                      False),
    "distillation_7b_adamw": ("dinov3/vit7b16", "distillationv3", AdamWArgs(),
                              "dinov3/vitb16", True, True),
    "distillation_7b_adamw8bit": ("dinov3/vit7b16", "distillationv3",
                                  AdamW8bitArgs(), "dinov3/vitb16", False,
                                  False),
    "distillation_7b_adamw8bit_7b_teacher": (
        "dinov3/vit7b16", "distillationv3", AdamW8bitArgs(), "dinov3/vit7b16",
        True, False),
    "resnet50_dino_adamw8bit": ("torchvision/resnet50", "dino",
                                AdamW8bitArgs(), None, False, False),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_counts_the_int8_moments(case):
    model, method, optim_args, teacher, refused, offered = REFUSALS[case]
    ema = get_method_cls(method)[0].ema_teacher
    leaves = _numels(model)
    n = sum(leaves)
    n_teacher = 0 if teacher is None else sum(_numels(teacher))
    int8 = sum(2 * 256 * -(-k // 256) + 2 * 4 * -(-k // 256) for k in leaves)
    if isinstance(optim_args, AdamW8bitArgs):
        need = 4 * (n * (2 + int(ema)) + n_teacher) + int8
    else:
        need = 4 * (n * (4 + int(ema)) + n_teacher)
    assert (need > GIB80) == refused
    if not refused:
        refuse_pretraining(model, optim_args, ema, GIB80, teacher)
        return
    with pytest.raises(NotImplementedError) as err:
        refuse_pretraining(model, optim_args, ema, GIB80, teacher)
    said = str(err.value)
    assert str(need) in said and "ROADMAP item 7.6" in said
    assert ("optim='adamw8bit'" in said) == offered
    if offered:
        need8 = 4 * (n * (2 + int(ema)) + n_teacher) + int8
        assert need8 <= GIB80 and str(need8) in said
