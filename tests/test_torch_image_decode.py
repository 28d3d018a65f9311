"""The port's PNG and JPEG decoders against the JAX package's PIL decode.

Every case decodes one file with the JAX package's ``decode_image`` (PIL:
JPEG draft scales, ``convert("RGB")``, bilinear resize) and with the port's,
and compares the bytes; the raw decodes (before the resize) are compared
too. All cases are exact: max-abs 0 on every PNG, PPM and JPEG case,
baseline and progressive, 4:4:4, 4:2:2, 4:2:0 and gray, at every draft
scale. Also: the refusals, the fixtures' manifest against the JAX decode,
the host library's bindings, and threads decoding at once.
"""

import hashlib
import io
import json
import re
import shutil
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from lightly_train_tpu._data.image_dataset import decode_image as jax_decode
from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._data import image_dataset as D
from lightly_train_tpu_torch._data.jpeg import decode_jpeg, draft_scale
from lightly_train_tpu_torch._data.png import ADAM7, decode_png
from lightly_train_tpu_torch.errors import DatasetError
from torch_fixtures.threads import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
              6: (8, 16)}


# ---------------------------------------------------------------------------
# A PNG writer: every colour type and depth, each filter type, Adam7.
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples, depth):
    """(h, w, ch) sample values -> (h, rowbytes) uint8 scanlines."""
    flat = samples.reshape(samples.shape[0], -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(flat.shape[0], -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(flat.shape[0], -1),
                       axis=1)


def _filter(rows, bpp, filters):
    """Scanlines, each behind its filter byte, row y filtered with
    ``filters[y % len(filters)]``."""
    out = []
    prev = np.zeros(rows.shape[1], dtype=np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        pad = np.zeros(min(bpp, len(row)), np.int32)
        left = np.concatenate([pad, row[:-bpp]])[:len(row)]
        up_left = np.concatenate([pad, prev[:-bpp]])[:len(row)]
        pred = [0, left, prev, (left + prev) >> 1,
                _paeth(left, prev, up_left)][f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8)
                   .tobytes())
        prev = row
    return b"".join(out)


def _chunk(kind, body):
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def write_png(samples, ctype, depth, palette=None, trns=None,
              interlace=False, filters=(0, 1, 2, 3, 4)):
    """PNG bytes of ``samples`` (h, w, ch) sample values; the image data
    split over two IDAT chunks."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b"".join(_filter(_pack(samples[y0::dy, x0::dx], depth), bpp,
                               filters)
                       for x0, y0, dx, dy in ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter(_pack(samples, depth), bpp, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", w.to_bytes(4, "big")
                                         + h.to_bytes(4, "big")
                                         + bytes([depth, ctype, 0, 0,
                                                  int(interlace)]))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw)
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return out + _chunk(b"IEND", b"")


def _png_samples(rng, h, w, ctype, depth):
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
    if ctype == 0 and depth == 16:  # I;16 -> L saturates above 255
        samples[..., 0] = rng.choice([0, 7, 200, 255, 256, 4000, 65535],
                                     (h, w))
    return samples


def _same_as_pil(path, raw, canonical_hw=(256, 256)):
    """The port's raw decode equals PIL's ``convert("RGB")`` and its
    ``decode_image`` the JAX package's."""
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
    got = np.repeat(raw[..., None], 3, axis=2) if raw.ndim == 2 else raw
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(D.decode_image(str(path), canonical_hw),
                                  jax_decode(str(path), canonical_hw))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_CASES = [(ct, d, interlace) for ct, depths in PNG_DEPTHS.items()
             for d in depths for interlace in (False, True)]


@pytest.mark.parametrize("ctype,depth,interlace", PNG_CASES)
def test_png_matches_pil(tmp_path, ctype, depth, interlace):
    """Each colour type and bit depth, plain and Adam7, at 1x1, 3x5 and
    513x301, the rows cycling through all five filter types; a palette
    with tRNS and one shorter than the indices (black past its end, as
    PIL), gray and RGB with tRNS (ignored, as PIL)."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    for h, w in ((1, 1), (3, 5), (301, 513)):
        samples = _png_samples(rng, h, w, ctype, depth)
        palettes = [(None, None)]
        if ctype == 3:
            n = 1 << depth
            palettes = [(rng.integers(0, 256, (n, 3)), bytes(range(n))[:5]),
                        (rng.integers(0, 256, (max(1, n // 2), 3)), None)]
        elif ctype in (0, 2):
            palettes.append((None, bytes(2 * CHANNELS[ctype])))
        for palette, trns in palettes:
            path = tmp_path / f"{h}x{w}.png"
            path.write_bytes(write_png(samples, ctype, depth, palette, trns,
                                       interlace))
            _same_as_pil(path, decode_png(path.read_bytes(), str(path)))


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("ctype,depth", [(2, 8), (0, 2), (6, 16), (3, 4)])
def test_png_each_filter_type(tmp_path, filt, ctype, depth):
    rng = np.random.default_rng(filt)
    path = tmp_path / "f.png"
    samples = _png_samples(rng, 37, 29, ctype, depth)
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path.write_bytes(write_png(samples, ctype, depth, palette,
                               filters=(filt,)))
    _same_as_pil(path, decode_png(path.read_bytes(), str(path)),
                 (24, 40))


@pytest.mark.parametrize("magic,channels", [(b"P6", 3), (b"P5", 1)])
@pytest.mark.parametrize("maxval", [255, 100])
def test_pnm_matches_pil(tmp_path, magic, channels, maxval):
    rng = np.random.default_rng(maxval)
    path = tmp_path / "a.pnm"
    path.write_bytes(magic + b"\n# a comment\n33 21\n%d\n" % maxval
                     + rng.integers(0, maxval + 1, (21, 33, channels),
                                    dtype=np.uint8).tobytes())
    _same_as_pil(path, D.read_ppm(str(path)), (16, 40))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _draw(h, w, seed, gray=False):
    """Smooth fields, edges and noise, as the fixtures."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (3 * yy + (c + 1) * xx)
                                       + c) for c in range(3)], -1) * 200
    img[h // 3:h // 2, w // 4:w // 2] += 50
    img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


# (height, width, PIL save options, gray)
JPEG_CASES = [
    (h, w, {"quality": q, "subsampling": sub, **extra}, False)
    for q in (50, 95) for sub in (0, 1, 2)
    for (h, w), extra in (((64, 80), {}), ((227, 301), {"progressive": True}),
                          ((97, 131), {"optimize": True}),
                          ((120, 200), {"restart_marker_rows": 1}),
                          ((35, 19), {"progressive": True,
                                      "restart_marker_blocks": 3}))
] + [(h, w, {"quality": q}, True)
     for q in (50, 95) for h, w in ((64, 64), (227, 301), (1, 1))] + [
    (1, 1, {"quality": 90, "subsampling": 2}, False),
    (3, 5, {"quality": 90, "subsampling": 1}, False),
    (17, 9, {"quality": 90, "subsampling": 2, "progressive": True}, False),
    (96, 80, {"quality": 90, "keep_rgb": True}, False),
]


def _jpeg_id(case):
    h, w, opts, gray = case
    return f"{h}x{w}-" + ("gray-" if gray else "") + "-".join(
        f"{k}{v}" for k, v in opts.items())


@pytest.mark.parametrize("case", JPEG_CASES, ids=_jpeg_id)
def test_jpeg_matches_pil_at_every_scale(tmp_path, case):
    """The raw decode at 1/1, 1/2, 1/4 and 1/8 against PIL's draft at the
    scale PIL chooses, and ``decode_image`` at 224^2 and 256^2 against the
    JAX package's, exact (max-abs 0)."""
    h, w, opts, gray = case
    path = tmp_path / "case.jpg"
    Image.fromarray(_draw(h, w, h * w, gray)).save(path, "JPEG", **opts)
    data = path.read_bytes()
    for s in (1, 2, 4, 8):
        with Image.open(path) as im:
            if s > 1 and min(w // s, h // s) > 0:
                im.draft(im.mode, (w // s, h // s))
            scale = im.decoderconfig[0] if im.decoderconfig else 1
            ref = np.asarray(im)
        np.testing.assert_array_equal(decode_jpeg(data, str(path), scale),
                                      ref, err_msg=f"scale 1/{scale}")
    for hw in ((224, 224), (256, 256)):
        np.testing.assert_array_equal(D.decode_image(str(path), hw),
                                      jax_decode(str(path), hw))


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_decodes_as_the_jax_package_and_its_manifest(name):
    """Each committed fixture: the port's decode_image at 224^2 and 256^2
    equals the JAX package's, and at 256^2 both digests are the manifest's
    (so the card's reference cannot go stale)."""
    path = str(FIXTURES / name)
    entry = MANIFEST["files"][name]
    w, h = entry["size"]
    assert entry["draft_scale"] == draft_scale((w, h), (256, 256))
    for hw in ((224, 224), (256, 256)):
        ref = jax_decode(path, hw)
        got = D.decode_image(path, hw)
        np.testing.assert_array_equal(got, ref)
    digest = hashlib.sha256(ref.tobytes()).hexdigest()
    assert digest == entry["sha256_jax"] == entry["sha256_port"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == digest
    assert entry["max_abs"] == 0 and entry["share_differing"] == 0.0


def test_fixtures_cover_every_mode():
    files = MANIFEST["files"]
    assert {f["draft_scale"] for f in files.values()} == {1, 2, 4, 8}
    options = [f["options"] for f in files.values()]
    assert {o.get("subsampling") for o in options} >= {0, 1, 2}
    for key in ("progressive", "optimize", "restart_marker_rows"):
        assert any(o.get(key) for o in options), key
    with Image.open(FIXTURES / "gray.jpg") as im:
        assert im.mode == "L"
    assert sum(f["bytes"] for f in files.values()) < 2_000_000


@pytest.mark.parametrize("size,hw", [
    ((2100, 2060), (256, 256)), ((600, 560), (256, 256)),
    ((511, 900), (256, 256)), ((1100, 1030), (224, 224)),
    ((4000, 600), (256, 256)), ((513, 513), (256, 256)),
    ((300, 300), (256, 256))])
def test_draft_scale_is_pils_choice(tmp_path, size, hw):
    """The scale PIL's draft takes where the JAX package calls it (the
    image at least twice the canonical size), else 1."""
    path = tmp_path / "flat.jpg"
    Image.new("RGB", size, (90, 140, 30)).save(path)
    with Image.open(path) as im:
        if size[0] >= 2 * hw[1] and size[1] >= 2 * hw[0]:
            im.draft("RGB", hw[::-1])
        scale = im.decoderconfig[0] if im.decoderconfig else 1
    assert draft_scale(size, hw) == scale


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def _baseline_jpeg(gray=False):
    buf = io.BytesIO()
    Image.fromarray(_draw(32, 48, 0, gray)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _patch_sof(data, marker=None, precision=None):
    at = data.index(b"\xff\xc0")
    data = bytearray(data)
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("kind,data,match", [
    ("arithmetic", lambda: _patch_sof(_baseline_jpeg(), marker=0xC9),
     "arithmetic.*item 19"),
    ("arithmetic-progressive",
     lambda: _patch_sof(_baseline_jpeg(), marker=0xCA), "arithmetic.*item 19"),
    ("12-bit", lambda: _patch_sof(_baseline_jpeg(), precision=12),
     "12-bit.*item 19"),
    ("lossless", lambda: _patch_sof(_baseline_jpeg(), marker=0xC3),
     "lossless.*item 19"),
    ("hierarchical", lambda: _patch_sof(_baseline_jpeg(), marker=0xC5),
     "hierarchical.*item 19"),
    ("truncated", lambda: _baseline_jpeg()[:len(_baseline_jpeg()) // 2],
     "truncated"),
    ("no-eoi", lambda: _baseline_jpeg()[:-2], "truncated"),
])
def test_jpeg_refusals_raise_dataset_error(tmp_path, kind, data, match):
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data())
    with pytest.raises(DatasetError, match=match) as info:
        D.decode_image(str(path), (32, 32))
    assert str(path) in str(info.value)


def test_cmyk_jpeg_is_refused(tmp_path):
    path = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (40, 24), (10, 200, 30, 5)).save(path, "JPEG")
    with pytest.raises(DatasetError, match="CMYK.*item 19"):
        D.decode_image(str(path), (32, 32))


@pytest.mark.parametrize("damage", ["crc", "truncated", "signature",
                                    "filter"])
def test_png_refusals_raise_dataset_error(tmp_path, damage):
    data = bytearray(write_png(np.zeros((4, 4, 3), np.int64), 2, 8))
    if damage == "crc":
        data[-5] ^= 1  # IEND's CRC
    elif damage == "truncated":
        data = data[:len(data) // 2]
    elif damage == "signature":
        data[1] = ord("Q")
    else:  # a filter type past 4
        raw = bytes([7]) + bytes(12)
        data = bytearray(write_png(np.zeros((1, 4, 3), np.int64), 2, 8))
        at = data.index(b"IDAT") - 4
        data = data[:at] + _chunk(b"IDAT", zlib.compress(raw)) \
            + _chunk(b"IEND", b"")
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(DatasetError) as info:
        D.decode_image(str(path), (8, 8))
    assert str(path) in str(info.value)


def test_decompression_bombs_are_refused_before_decoding(tmp_path):
    """Headers of more than twice PIL's MAX_IMAGE_PIXELS raise as PIL does,
    before any image buffer is allocated."""
    png = bytearray(write_png(np.zeros((1, 1, 3), np.int64), 2, 8))
    png[16:24] = (20000).to_bytes(4, "big") + (20000).to_bytes(4, "big")
    png[29:33] = zlib.crc32(bytes(png[12:29])).to_bytes(4, "big")
    jpeg = bytearray(_baseline_jpeg())
    at = jpeg.index(b"\xff\xc0")
    jpeg[at + 5:at + 9] = b"\xff\xff\xff\xff"  # 65535 x 65535
    for name, data in (("bomb.png", png), ("bomb.jpg", jpeg)):
        path = tmp_path / name
        path.write_bytes(bytes(data))
        with pytest.raises(DatasetError, match="decompression bomb"):
            D.decode_image(str(path), (8, 8))
        with pytest.raises(Image.DecompressionBombError):
            jax_decode(str(path), (8, 8))


def test_other_formats_without_pil_name_item_19(tmp_path, monkeypatch):
    path = tmp_path / "a.bmp"
    Image.new("RGB", (4, 4)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(DatasetError, match="ROADMAP item 19"):
        D.decode_image(str(path), (8, 8))


def test_content_picks_the_decoder_not_the_extension(tmp_path):
    """A PNG named .jpg decodes, as PIL opens it by its content."""
    path = tmp_path / "really_a_png.jpg"
    path.write_bytes(write_png(np.full((6, 5, 3), 77, np.int64), 2, 8))
    np.testing.assert_array_equal(D.decode_image(str(path), (8, 8)),
                                  jax_decode(str(path), (8, 8)))


# ---------------------------------------------------------------------------
# The host library
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_native.HOST_LIBRARIES))
def test_host_library_sources_match_their_bindings(name):
    """Each C entry point exists with as many parameters as its ctypes
    argtypes (ctypes checks neither)."""
    source = (_native.CSRC / f"{name}.c").read_text()
    for symbol, argtypes in _native.HOST_LIBRARIES[name].items():
        found = re.findall(r"\nint\s+" + re.escape(symbol)
                           + r"\s*\(([^)]*)\)\s*\{", source)
        assert len(found) == 1, symbol
        assert len(found[0].split(",")) == len(argtypes), symbol


def test_a_missing_compiler_is_named(monkeypatch):
    monkeypatch.setenv("CC", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="No C compiler"):
        _native.host_compiler()


def test_threads_build_once_and_decode_alike(tmp_path, monkeypatch):
    """Twelve threads on a fresh build folder, with a short switch interval:
    the library builds once (no torn file), and every thread's decodes
    equal the serial ones."""
    names = sorted(MANIFEST["files"])
    serial = {n: D.decode_image(str(FIXTURES / n), (64, 64)) for n in names}
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", {})
    results, errors = [], []

    def work(k):
        try:
            for n in names[k % 3::3]:
                results.append((n, D.decode_image(str(FIXTURES / n),
                                                  (64, 64))))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 4 * len(names)
    for n, image in results:
        np.testing.assert_array_equal(image, serial[n])
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]


def test_a_jpeg_and_png_folder_lists_and_decodes(tmp_path):
    folder = tmp_path / "images"
    shutil.copytree(FIXTURES, folder, ignore=shutil.ignore_patterns(
        "*.py", "*.json"))
    (folder / "p.png").write_bytes(write_png(
        np.full((20, 30, 4), 9, np.int64), 6, 8))
    files = D.list_image_files(folder)
    assert len(files) == len(MANIFEST["files"]) + 1
    dataset = D.ImageDataset(files, (48, 48))
    for i in range(len(dataset)):
        assert dataset[i].shape == (48, 48, 3)
        assert dataset[i].dtype == np.uint8
