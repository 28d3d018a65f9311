"""``pretrain`` with each of the six ported methods, end to end on the CPU,
in both packages.

Two steps of ``dinov2/vittest14`` at 28^2 (DINO's and DINOv31's local views
at 14^2) on eight 36^2 PPM images, batch "auto" (8 images: 8 in both, a
multiple of the JAX tests' 8 virtual devices), fp32; DetCon-B also with
``use_dataset_masks`` and a ``mask_dir`` of PNG masks. The two runs agree on
the files written, the exported metadata, the metric keys, the resolved
batch, steps and learning rate, and the resolved method and optimizer
arguments; bad arguments raise the same error type and message. Losses
differ only through random numbers, which the packages do not share.
"""

import json

import numpy as np
import pytest

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)
TWO = dict(image_size=28, hidden_dim=32, output_dim=16)
RUNS = {
    "dino": ("dino", SMALL),
    "dinov31": ("dinov31", {**SMALL, "paka_hidden_dim": 16,
                            "paka_bottleneck_dim": 8}),
    "simclr": ("simclr", TWO),
    "densecl": ("densecl", {**TWO, "queue_size": 8}),
    "detconb": ("detconb", {**TWO, "num_masks": 4}),
    "detcons": ("detcons", {**TWO, "num_masks": 4}),
    "detconb_mask_dir": ("detconb", {**TWO, "num_masks": 6,
                                     "use_dataset_masks": True}),
}


@pytest.fixture
def data(tmp_path):
    """Eight 36^2 PPM images, and palette PNG masks for six of them."""
    from PIL import Image

    folder = tmp_path / "images"
    masks = tmp_path / "masks"
    folder.mkdir()
    masks.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())
        if i < 6:
            ids = np.repeat(np.repeat(rng.integers(0, 8, (3, 3)), 12, 0), 12,
                            1)
            im = Image.fromarray(ids.astype(np.uint8), "P")
            im.putpalette(list(rng.integers(0, 256, 768)))
            im.save(masks / f"{i}.png")
    return tmp_path


def _run(pkg, out, data, name, **kwargs):
    method, method_args = RUNS[name]
    args = dict(out=str(out), data=str(data / "images"),
                model="dinov2/vittest14", method=method, steps=2,
                precision="fp32", canonical_size=36, num_workers=0,
                log_every=1, method_args=method_args)
    if name == "detconb_mask_dir":
        args["mask_dir"] = str(data / "masks")
    if pkg is lt:
        args["accelerator"] = "cpu"
    args.update(kwargs)
    return pkg.pretrain(**args)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pretrain_agrees_with_the_jax_package(tmp_path, data, name):
    state = _run(lt, tmp_path / "port", data, name)
    _run(jlt, tmp_path / "jax", data, name)
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert state.step == 2
    assert sorted(p.name for p in port.iterdir()) == sorted(
        p.name for p in ref.iterdir())
    # The same checkpoint steps (step_<n>.pt beside the JAX <n>/).
    assert sorted(p.name for p in (port / "checkpoints").iterdir()) == sorted(
        f"step_{p.name}.pt" for p in (ref / "checkpoints").iterdir()
        if p.name.isdigit())
    meta = "exported_models/exported_last/metadata.json"
    assert json.loads((port / meta).read_text()) == json.loads(
        (ref / meta).read_text())
    got, want = _records(port), _records(ref)
    hp, j_hp = got[0]["hyperparams"], want[0]["hyperparams"]
    for key in ("resolved_batch_size", "resolved_steps", "method_args",
                "optim_args"):
        assert hp[key] == j_hp[key], key
    assert hp["resolved_lr"] == pytest.approx(j_hp["resolved_lr"])
    assert hp["resolved_batch_size"] == 8
    assert [r["step"] for r in got[1:]] == [r["step"] for r in want[1:]]
    for r, j in zip(got[1:], want[1:]):
        assert set(r) == set(j)
        assert all(np.isfinite(r[k]) for k in r if k.endswith("loss"))
    if name == "densecl":
        ms = state.method_state
        assert (ms["queue_ptr"], ms["queue_filled"]) == (0, 8)


@pytest.mark.parametrize("case", ["unknown_method", "unknown_method_arg",
                                  "detcon_grid_not_square",
                                  "dinov31_vertical_flip"])
def test_bad_arguments_raise_what_the_jax_package_raises(tmp_path, data,
                                                         case):
    kwargs = {
        "unknown_method": dict(method="dinov4"),
        "unknown_method_arg": dict(method_args={**TWO, "tempreature": 0.1}),
        "detcon_grid_not_square": dict(method_args={**TWO, "num_masks": 5}),
        "dinov31_vertical_flip": dict(
            transform_args={"random_flip": {"vertical_prob": 0.5}}),
    }[case]
    name = {"unknown_method_arg": "simclr",
            "detcon_grid_not_square": "detconb",
            "dinov31_vertical_flip": "dinov31"}.get(case, "simclr")
    errors = []
    for pkg, out in ((lt, "port"), (jlt, "jax")):
        with pytest.raises(Exception) as err:
            _run(pkg, tmp_path / out, data, name, **kwargs)
        errors.append(err.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    if case != "unknown_method_arg":
        assert str(errors[0]) == str(errors[1])
    else:
        # The port validates without pydantic; both name the key.
        assert "tempreature" in str(errors[0])
        assert "tempreature" in str(errors[1])
