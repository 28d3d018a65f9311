"""Guards of the PyTorch port: what it imports, where it runs, and that
``pretrain`` runs end to end on the CPU when asked to."""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch.errors import (
    ConfigError,
    ConfigUnknownKeyError,
    ConfigValidationError,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pydantic", "PIL",
             "lightly_train_tpu"}
PORT_FILES = sorted((ROOT / "lightly_train_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_update.py", ROOT / "time_attention.py",
    ROOT / "compare_sass.py"]
SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


def _imports(tree):
    """(top-level module, enclosing function name) for every import."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            name = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], name) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], name))
            visit(child, name)

    visit(tree, None)
    return out


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for module, func in _imports(ast.parse(path.read_text())):
        if module == "PIL" and path.name == "image_dataset.py" \
                and func in ("decode_image", "decode_mask"):
            continue  # the lazy imports, where PIL is installed
        assert module not in FORBIDDEN, f"{path}: imports {module}"


@pytest.mark.parametrize("name", sorted(_native.LIBRARIES))
def test_native_library_sources_match_their_bindings(name):
    """Each library's ``csrc/<name>.cu`` exists and defines its C entry
    point ``extern "C"`` with as many parameters as its ctypes argtypes:
    ctypes checks neither, and a missing parameter would shift every later
    argument on the card."""
    symbol, argtypes = _native.LIBRARIES[name]
    source = (_native.CSRC / f"{name}.cu").read_text()
    found = re.findall(
        r'extern\s+"C"\s+int\s+' + re.escape(symbol) + r"\s*\(([^)]*)\)",
        source)
    assert len(found) == 1, f"{name}.cu: no extern \"C\" int {symbol}(...)"
    assert len(found[0].split(",")) == len(argtypes)


@pytest.mark.parametrize("path", sorted(_native.CSRC.iterdir()),
                         ids=lambda p: p.name)
def test_kernels_use_no_warp_level_mma(path):
    """Every attention kernel runs on Hopper's warpgroup products (wgmma):
    no source holds the warp-level mma.sync or its ldmatrix loads."""
    source = path.read_text()
    assert "mma.sync" not in source and "ldmatrix" not in source


def _write_ppm_folder(folder: Path, n: int = 6, size: int = 36) -> None:
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(
            f"P6\n{size} {size}\n255\n".encode() + img.tobytes())


def test_pretrain_refuses_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device exists")
    with pytest.raises(RuntimeError, match="accelerator='cpu'"):
        lt.pretrain(out=str(tmp_path / "out"), model="dinov2/vittest14",
                    method="dinov2", steps=1, batch_size=2)


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_pretrain_on_cpu_end_to_end(tmp_path, grad_accum_steps):
    data = tmp_path / "images"
    _write_ppm_folder(data)
    out = tmp_path / "out"
    state = lt.pretrain(
        out=str(out), data=str(data), model="dinov2/vittest14",
        method="dinov2", accelerator="cpu", batch_size=4, steps=2,
        precision="fp32", canonical_size=36, num_workers=2,
        grad_accum_steps=grad_accum_steps, method_args=SMALL,
    )
    assert state.step == 2
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
             .splitlines()]
    assert "hyperparams" in lines[0]
    steps = [r for r in lines if "step" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in steps)
    ckpt = torch.load(out / "checkpoints" / "step_2.pt", weights_only=False)
    assert ckpt["step"] == 2 and "student.cls_token" in ckpt["params"]


def test_pretrain_refuses_a_non_empty_out_dir(tmp_path):
    (tmp_path / "stale.txt").write_text("x")
    with pytest.raises(ConfigError, match="not empty"):
        lt.pretrain(out=str(tmp_path), model="dinov2/vittest14",
                    method="dinov2", accelerator="cpu")


def test_config_errors():
    with pytest.raises(ConfigUnknownKeyError, match="batch_size"):
        lt.pretrain(out="unused", batch_sise=4, accelerator="cpu")
    with pytest.raises(ConfigValidationError):
        lt.pretrain(out="unused", precision="fp16", accelerator="cpu")
    with pytest.raises(ConfigValidationError):
        lt.pretrain(out="unused", accelerator="tpu")


@pytest.mark.parametrize("method", ["dino", "simclr"])
def test_unported_methods_name_their_roadmap_item(tmp_path, method):
    """Every method of the JAX package is ported; what such a run still
    lacks names its item: here the 8-bit AdamW (ROADMAP item 10)."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 10\b"):
        lt.pretrain(out=str(tmp_path / "o"), model="dinov2/vittest14",
                    method=method, accelerator="cpu", steps=1,
                    optim="adamw8bit")


@pytest.mark.parametrize("option", [
    {"fsdp": 2}, {"mask_dir": "m"},
    {"profile_start": 2}, {"profile_steps": 1}, {"checkpoint": "last.pt"},
    {"profile": True}, {"loggers": ["tensorboard"]},
])
def test_unported_options_are_refused(tmp_path, option):
    # The options wait for parts of item 7. A checkpoint path that is no
    # file is read as an exported folder: without one it raises what the
    # JAX package raises there (FileNotFoundError, its metadata.json).
    # mask_dir is ported: a folder without masks raises what the JAX
    # package raises (DatasetError).
    if "mask_dir" in option:
        from lightly_train_tpu_torch.errors import DatasetError

        _write_ppm_folder(tmp_path / "images", n=2)
        with pytest.raises(DatasetError, match="No masks under m"):
            lt.pretrain(out=str(tmp_path / "o"), data=str(
                tmp_path / "images"), model="dinov2/vittest14",
                method="dinov2", accelerator="cpu", steps=1, **option)
        return
    expected = (FileNotFoundError if "checkpoint" in option
                else NotImplementedError)
    with pytest.raises(expected, match=None if "checkpoint" in option
                       else r"ROADMAP item 7\b"):
        lt.pretrain(out=str(tmp_path / "o"), model="dinov2/vittest14",
                    method="dinov2", accelerator="cpu", steps=1, **option)


def test_fp32_pretrain_is_accepted_for_the_card(tmp_path):
    """The attention kernels take fp32, so fp32 on the card is a run like
    bf16: without a card it stops at the missing device, not at a refusal
    of the precision."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the run would start")
    with pytest.raises(RuntimeError, match="accelerator='cpu'"):
        lt.pretrain(out=str(tmp_path / "o"), model="dinov2/vittest14",
                    method="dinov2", precision="fp32", steps=1)


def test_ppm_decode_without_pil_matches_pil(tmp_path, monkeypatch):
    from lightly_train_tpu_torch._data import image_dataset as D

    data = tmp_path / "images"
    _write_ppm_folder(data, n=1, size=40)
    path = str(next(data.iterdir()))
    raw = D.read_ppm(path)
    assert raw.shape == (40, 40, 3)
    try:
        from PIL import Image
    except ImportError:
        pytest.skip("PIL absent: nothing to compare with")
    with Image.open(path) as im:
        np.testing.assert_array_equal(raw, np.asarray(im.convert("RGB")))
    # Down- and upscales, odd sizes, one axis unchanged, one pixel wide;
    # noise, a flat image and a gradient.
    rng = np.random.default_rng(1)
    sizes = [((40, 40), (24, 24)), ((37, 53), (256, 256)),
             ((513, 301), (224, 224)), ((3, 5), (17, 11)),
             ((255, 257), (256, 256)), ((100, 100), (33, 67)),
             ((17, 19), (17, 18)), ((480, 640), (256, 256)),
             ((1000, 1), (7, 3)), ((5, 5), (1, 1))]
    refs = []
    for i, ((h, w), hw) in enumerate(sizes):
        img = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
               np.full((h, w, 3), 255, dtype=np.uint8),
               (np.add.outer(np.arange(h), np.arange(w))[..., None]
                * np.array([1, 3, 7]) % 256).astype(np.uint8)][i % 3]
        ppm = tmp_path / f"case_{i}.ppm"
        ppm.write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        with Image.open(ppm) as im:
            refs.append((ppm, hw, np.asarray(
                im.convert("RGB").resize(hw[::-1], Image.BILINEAR))))
    # PNG and JPEG (baseline 4:2:0, progressive 4:2:2, gray; one large
    # enough for draft scale 1/4) as the JAX package decodes them with PIL:
    # draft at twice the canonical size, convert("RGB"), BILINEAR.
    for i, (name, (h, w), hw, opts) in enumerate([
            ("a.png", (37, 53), (24, 24), {}),
            ("b.jpg", (120, 90), (64, 64), {"quality": 90}),
            ("c.jpg", (1030, 1100), (256, 256), {"progressive": True,
                                                 "subsampling": 1}),
            ("d.jpeg", (301, 227), (224, 224), {"quality": 80})]):
        img = (np.add.outer(np.arange(h), 2 * np.arange(w))[..., None]
               * np.array([1, 3, 7]) % 256).astype(np.uint8)
        img = np.clip(img + rng.integers(0, 30, img.shape), 0, 255)
        img = img.astype(np.uint8)
        path = tmp_path / name
        Image.fromarray(img[..., 0] if name.startswith("d") else img).save(
            path, **opts)
        with Image.open(path) as im:
            if im.size[0] >= 2 * hw[1] and im.size[1] >= 2 * hw[0]:
                im.draft("RGB", hw[::-1])
            refs.append((path, hw, np.asarray(
                im.convert("RGB").resize(hw[::-1], Image.BILINEAR))))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    for path, hw, ref in refs:
        # The port's decoders, then PIL's BILINEAR repeated in numpy: the
        # same bytes.
        np.testing.assert_array_equal(D.decode_image(str(path), hw), ref)
