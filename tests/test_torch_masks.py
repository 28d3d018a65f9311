"""Region masks (``mask_dir``) of the port against the JAX package's
``ImageDataset``, which reads them with PIL.

Masks written with PIL into ``tmp_path``, paired with PPM images by file
stem: palette (8- and 4-bit), 8-bit gray, 16-bit gray, 1-bit, gray+alpha,
RGB, RGBA, a JPEG in colour and in gray, and a binary PPM, at odd sizes
(smaller and larger than the canonical size), and an image whose stem has
no mask. The port reads them without PIL (PIL is blocked while it runs), and
every mask is bitwise the JAX package's. Also PIL's NEAREST index rule and
``convert("L")``'s luminance alone, and the loader's ``{"images", "masks"}``
batches.
"""

import sys

import numpy as np
import pytest
import torch

from lightly_train_tpu._data.image_dataset import ImageDataset as JaxDataset
from lightly_train_tpu_torch._data import image_dataset as D
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch.errors import DatasetError

Image = pytest.importorskip("PIL.Image")


def _ids(rng, h, w, n):
    """Blocky region ids below ``n``, so the NEAREST resize picks
    structure, with noise so every rule shows."""
    blocks = rng.integers(0, n, (-(-h // 5), -(-w // 5)))
    ids = np.repeat(np.repeat(blocks, 5, 0), 5, 1)[:h, :w]
    noise = rng.uniform(0, 1, (h, w)) < 0.1
    return np.where(noise, rng.integers(0, n, (h, w)), ids)


def _write_masks(folder, rng):
    """stem -> the PIL image written there (every kind the JAX package
    reads)."""
    folder.mkdir()
    palette = list(rng.integers(0, 256, 768))
    cases = {}

    def save(stem, im, ext="png", **kw):
        im.save(folder / f"{stem}.{ext}", **kw)
        cases[stem] = ext

    p = Image.fromarray(_ids(rng, 41, 29, 200).astype(np.uint8), "P")
    p.putpalette(palette)
    save("palette", p)
    p4 = Image.fromarray(_ids(rng, 17, 300, 16).astype(np.uint8), "P")
    p4.putpalette(palette)
    save("palette4", p4, bits=4)
    save("gray", Image.fromarray(_ids(rng, 255, 37, 256).astype(np.uint8),
                                 "L"))
    save("gray16", Image.fromarray(
        (_ids(rng, 23, 61, 60000)).astype(np.uint16)))
    save("bilevel", Image.fromarray(_ids(rng, 19, 13, 2).astype(bool)))
    la = np.stack([_ids(rng, 33, 35, 256), _ids(rng, 33, 35, 256)], -1)
    save("gray_alpha", Image.fromarray(la.astype(np.uint8), "LA"))
    rgb = np.stack([_ids(rng, 50, 43, 256) for _ in range(3)], -1)
    save("rgb", Image.fromarray(rgb.astype(np.uint8), "RGB"))
    rgba = np.stack([_ids(rng, 31, 31, 256) for _ in range(4)], -1)
    save("rgba", Image.fromarray(rgba.astype(np.uint8), "RGBA"))
    jpg = np.stack([_ids(rng, 45, 39, 256) for _ in range(3)], -1)
    save("jpeg", Image.fromarray(jpg.astype(np.uint8), "RGB"), "jpg",
         quality=90)
    save("jpeg_gray", Image.fromarray(_ids(rng, 27, 55, 256).astype(
        np.uint8), "L"), "jpg", quality=75)
    save("ppm", Image.fromarray(rgb[:21, :40].astype(np.uint8), "RGB"),
         "ppm")
    return cases


@pytest.mark.parametrize("hw", [(36, 36), (37, 23)])
def test_masks_match_the_jax_dataset_bitwise(tmp_path, monkeypatch, hw):
    rng = np.random.default_rng(hw[1])
    cases = _write_masks(tmp_path / "masks", rng)
    images = tmp_path / "images"
    images.mkdir()
    files = []
    for stem in [*cases, "no_mask"]:
        img = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
        path = images / f"{stem}.ppm"
        path.write_bytes(b"P6\n30 30\n255\n" + img.tobytes())
        files.append(str(path))
    ref = JaxDataset(files, hw, mask_dir=tmp_path / "masks")
    expected = [ref[i] for i in range(len(files))]
    modes = {}
    for stem, ext in cases.items():
        with Image.open(tmp_path / "masks" / f"{stem}.{ext}") as im:
            modes[stem] = im.mode
    assert set(modes.values()) >= {"P", "L", "I;16", "1", "LA", "RGB",
                                   "RGBA"}
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = D.ImageDataset(files, hw, mask_dir=tmp_path / "masks")
    for i, (stem, want) in enumerate(zip([*cases, "no_mask"], expected)):
        item = got[i]
        assert item["masks"].dtype == np.int32 and item["masks"].shape == hw
        np.testing.assert_array_equal(item["masks"], want["masks"],
                                      err_msg=f"{stem} ({modes.get(stem)})")
        np.testing.assert_array_equal(item["images"], want["images"])
    assert not expected[-1]["masks"].any()  # no mask: zeros
    # The 16-bit values survive (above 255), the palette gives indices.
    assert expected[list(cases).index("gray16")]["masks"].max() > 255


def test_nearest_index_is_pils():
    """PIL's NEAREST resize on int32 images against the index rule, over
    sizes whose ratios hit its accumulated rounding."""
    for h in [1, 2, 3, 7, 16, 255, 256, 257, 513]:
        for w in [1, 3, 31, 256, 301]:
            a = np.arange(h * w, dtype=np.int32).reshape(h, w)
            for out in [(256, 256), (224, 224), (7, 5), (37, 300), (1, 1)]:
                ref = np.asarray(Image.fromarray(a).resize(out[::-1],
                                                           Image.NEAREST))
                np.testing.assert_array_equal(D.resize_nearest(a, out), ref,
                                              err_msg=f"{(h, w)} -> {out}")


def test_luminance_is_pils_convert_l():
    rgb = np.random.default_rng(0).integers(0, 256, (64, 77, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        D.luminance(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


def test_an_empty_mask_dir_is_refused(tmp_path):
    (tmp_path / "masks").mkdir()
    for cls in (D.ImageDataset, JaxDataset):
        with pytest.raises(Exception, match="No masks under") as err:
            cls(["x.ppm"], (8, 8), mask_dir=tmp_path / "masks")
        assert type(err.value).__name__ == "DatasetError"
    with pytest.raises(DatasetError):
        D.ImageDataset(["x.ppm"], (8, 8), mask_dir=tmp_path / "missing")


def test_loader_yields_image_and_mask_batches(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    files = []
    for i in range(5):
        img = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
        path = tmp_path / "images" / f"{i}.ppm"
        path.write_bytes(b"P6\n20 20\n255\n" + img.tobytes())
        files.append(str(path))
        Image.fromarray(np.full((10, 10), i, np.uint8)).save(
            tmp_path / "masks" / f"{i}.png")
    dataset = D.ImageDataset(files, (16, 16), mask_dir=tmp_path / "masks")
    batch = next(iter(PretrainLoader(dataset, 4, torch.device("cpu"),
                                     num_workers=2)))
    assert set(batch) == {"images", "masks"}
    assert batch["images"].shape == (4, 16, 16, 3)
    assert batch["images"].dtype == torch.uint8
    assert batch["masks"].shape == (4, 16, 16)
    assert batch["masks"].dtype == torch.int32
    # Each image's mask holds its own index.
    for img, mask in zip(batch["images"], batch["masks"]):
        i = next(j for j in range(5) if np.array_equal(
            img.numpy(), dataset[j]["images"]))
        assert (mask == i).all()
