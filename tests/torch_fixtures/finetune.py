"""Shared pieces of the port's fine-tuning tests (no test of its own): the
class-folder and image/mask datasets they write, checkpoint-scale weights
for a JAX task tree, and the patch that makes both packages' ``train_*``
start from those weights.

The datasets are PNGs written with the port's ``write_png`` (RGB) and PIL
(masks), from a numpy seed. Checkpoint-scale values: kernels at
1/sqrt(fan-in), norm scales near 1, LayerScale gammas near 0.5, the rest
(biases, tokens, the position embedding) at 0.5 standard deviations.
"""

import jax
import jax.numpy as jnp
import numpy as np

from lightly_train_tpu_torch._visualize.grids import write_png
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax


def write_class_folders(root, classes=("cat", "dog"), n_train=8, n_val=5,
                        size=40, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in classes:
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                write_png(rng.integers(0, 256, (size, size, 3), np.uint8),
                          d / f"{i}.png")
    return {"train": str(root / "train"), "val": str(root / "val")}


def write_mask_pairs(root, n=6, size=40, num_classes=3, seed=0):
    """``images/`` and ``masks/`` (gray PNG masks of ids < num_classes,
    a border of 255) for a train and a val split."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    data = {"num_classes": num_classes}
    for split in ("train", "val"):
        (root / split / "images").mkdir(parents=True)
        (root / split / "masks").mkdir(parents=True)
        for i in range(n):
            write_png(rng.integers(0, 256, (size, size, 3), np.uint8),
                      root / split / "images" / f"{i}.png")
            blocks = rng.integers(0, num_classes, (4, 4))
            mask = np.kron(blocks, np.ones((size // 4, size // 4), int))
            mask[:2] = 255
            Image.fromarray(mask.astype(np.uint8), "L").save(
                root / split / "masks" / f"{i}.png")
        data[split] = {"images": str(root / split / "images"),
                       "masks": str(root / split / "masks")}
    return data


def checkpoint_scale(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(rng.standard_normal(x.shape))
        if name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree)


def shared_init(monkeypatch, j_cls, p_cls, image_size, seed=0):
    """Patch the JAX task model ``j_cls`` and the port's ``p_cls`` so that
    both inits return the same checkpoint-scale parameters (and the JAX
    init's model state); returns a dict that holds them, as numpy trees,
    once a JAX run has initialized."""
    held = {}
    j_init, p_init = j_cls.init, p_cls.init

    def jax_init(self, rng, sample_batch):
        params, model_state = j_init(self, rng, sample_batch)
        if "params" not in held:
            held["params"] = jax.device_get(checkpoint_scale(params, seed))
            held["model_state"] = jax.device_get(model_state)
        return held["params"], held["model_state"]

    def port_init(self, generator, device):
        module = p_init(self, generator, device)
        module.load_state_dict(task_state_from_jax(held["params"],
                                                   held["model_state"]))
        return module

    monkeypatch.setattr(j_cls, "init", jax_init)
    monkeypatch.setattr(p_cls, "init", port_init)
    return held
