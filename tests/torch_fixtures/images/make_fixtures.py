"""Write the JPEG fixtures of this folder and their ``manifest.json``.

Run from the repository root, on a machine with PIL and the JAX package:

    python tests/torch_fixtures/images/make_fixtures.py

Each image is drawn from a numpy seed (smooth colour fields, edges and
noise) and saved with PIL's JPEG encoder in one of the modes the port's
decoder must match: 4:4:4, 4:2:2 and 4:2:0, progressive, optimized Huffman
tables, restart markers, grayscale, an odd size, and images large enough
for the draft scales 1/2, 1/4 and 1/8 at the canonical 256^2. The manifest
holds, for each file, the SHA-256 of the JAX package's ``decode_image``
output at 256^2 and of the port's, which must be equal: the card's machine,
which has no PIL, holds the port's decode to them.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CANONICAL = (256, 256)
SEED = 19

# name -> (width, height, PIL save options, gray)
FIXTURES = {
    "q85_444.jpg": (320, 240, {"quality": 85, "subsampling": 0}, False),
    "q75_422.jpg": (320, 240, {"quality": 75, "subsampling": 1}, False),
    "q90_420.jpg": (320, 240, {"quality": 90, "subsampling": 2}, False),
    "progressive_420.jpg": (400, 300, {"quality": 80, "progressive": True,
                                       "subsampling": 2}, False),
    "optimized_444.jpg": (256, 256, {"quality": 80, "optimize": True,
                                     "subsampling": 0}, False),
    "restart_420.jpg": (320, 240, {"quality": 80, "subsampling": 2,
                                   "restart_marker_rows": 1}, False),
    "gray.jpg": (300, 200, {"quality": 85}, True),
    "odd_301x227.jpg": (301, 227, {"quality": 85, "subsampling": 2}, False),
    "draft2_600x560.jpg": (600, 560, {"quality": 75, "subsampling": 2},
                           False),
    "draft4_1100x1030.jpg": (1100, 1030, {"quality": 70, "subsampling": 1,
                                          "progressive": True}, False),
    "draft8_2100x2060.jpg": (2100, 2060, {"quality": 60, "subsampling": 2},
                             False),
}


def draw(width: int, height: int, seed: int, gray: bool) -> np.ndarray:
    """Smooth colour fields, a few hard-edged rectangles and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width] / max(width, height)
    f = rng.uniform(1, 6, size=(3, 2))
    ph = rng.uniform(0, 2 * np.pi, size=3)
    img = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx) + ph[c])
        for c in range(3)], axis=-1) * 200
    for _ in range(4):
        x0, y0 = rng.integers(0, width), rng.integers(0, height)
        img[y0:y0 + height // 4, x0:x0 + width // 5] += rng.uniform(-60, 60, 3)
    img += rng.normal(0, 8, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def digest(image: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()


def main() -> None:
    from PIL import Image

    sys.path.insert(0, str(HERE.parents[2]))
    from lightly_train_tpu._data.image_dataset import decode_image as jax_decode
    from lightly_train_tpu_torch._data.image_dataset import (
        decode_image as port_decode,
    )
    from lightly_train_tpu_torch._data.jpeg import draft_scale

    manifest = {"canonical_hw": list(CANONICAL), "files": {}}
    for i, (name, (w, h, options, gray)) in enumerate(FIXTURES.items()):
        path = HERE / name
        Image.fromarray(draw(w, h, SEED + i, gray)).save(path, "JPEG",
                                                         **options)
        ref = jax_decode(str(path), CANONICAL)
        got = port_decode(str(path), CANONICAL)
        diff = np.abs(ref.astype(np.int16) - got.astype(np.int16))
        manifest["files"][name] = {
            "size": [w, h], "options": options,
            "draft_scale": draft_scale((w, h), CANONICAL),
            "bytes": path.stat().st_size,
            "sha256_jax": digest(ref), "sha256_port": digest(got),
            "max_abs": int(diff.max()),
            "share_differing": float((diff > 0).mean()),
        }
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(f["bytes"] for f in manifest["files"].values())
    print(f"{len(FIXTURES)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
