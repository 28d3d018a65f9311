"""The port's CLI (``python -m lightly_train_tpu_torch``) and public API
against the JAX package's: the override parser on a table of argvs,
``list_models`` and ``list_methods`` output, ``pretrain`` through the CLI
against the Python call, the commands not ported yet, and the names the
package exports. On the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu._cli import main as jax_main
from lightly_train_tpu._cli import parse_cli_overrides as jax_parse
from lightly_train_tpu_torch._cli import NOT_PORTED, main, parse_cli_overrides
from test_torch_run_surface import SMALL, write_images
from torch_fixtures.threads import one_torch_thread  # noqa: F401

ARGVS = [
    [],
    ["out=o", "data=d"],
    ["steps=3", "batch_size=4", "precision=fp32"],
    ["method_args.teacher=dinov3/vittest16", "method_args.queue_size=16"],
    ['method_args={"image_size": 32}', "overwrite=true", "seed=null"],
    ["loggers=[\"jsonl\", \"tensorboard\"]", "learning_rate=1e-3"],
    ["a.b.c=1", "a.b.d=x", "a.e=2.5"],
    ["out=path=with=equals", "name="],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_overrides_parse_as_in_jax(argv):
    assert parse_cli_overrides(argv) == jax_parse(argv)


@pytest.mark.parametrize("argv", [["steps"], ["a=1", "a.b=2"]])
def test_bad_overrides_exit_as_in_jax(argv):
    with pytest.raises(SystemExit) as j:
        jax_parse(argv)
    with pytest.raises(SystemExit) as t:
        parse_cli_overrides(argv)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("command", ["list_models", "list_methods"])
def test_lists_print_what_the_jax_cli_prints(capsys, command):
    assert jax_main([command]) == 0
    want = capsys.readouterr().out
    assert main([command]) == 0
    assert capsys.readouterr().out == want


def test_python_m_lists_the_models():
    out = subprocess.run(
        [sys.executable, "-m", "lightly_train_tpu_torch", "list_models"],
        capture_output=True, text=True, timeout=120,
        cwd=Path(lt.__file__).parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == lt.list_models()


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*")
                  if p.is_file() and p.suffix != ".log")


@pytest.mark.parametrize("command", ["pretrain", "train"])
def test_pretrain_through_the_cli_writes_what_the_call_writes(
        tmp_path, capsys, command):
    """The same run through ``main`` and through ``lt.pretrain``: the same
    files and the same metric keys; ``train`` warns that it is deprecated."""
    write_images(tmp_path / "images")
    args = dict(data=str(tmp_path / "images"), model="dinov2/vittest14",
                method="dinov2", accelerator="cpu", batch_size=4, steps=1,
                precision="fp32", canonical_size=36, num_workers=2,
                method_args=SMALL)
    lt.pretrain(out=str(tmp_path / "call"), **args)
    argv = [f"out={tmp_path / 'cli'}"] + [
        f"{k}={json.dumps(v) if not isinstance(v, str) else v}"
        for k, v in args.items()]
    capsys.readouterr()
    assert main([command] + argv) == 0
    assert ("deprecated" in capsys.readouterr().err) == (command == "train")
    assert _files(tmp_path / "cli") == _files(tmp_path / "call")
    keys = [sorted(json.loads(line)) for line in
            (tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()]
    assert keys == [sorted(json.loads(line)) for line in
                    (tmp_path / "call" / "metrics.jsonl").read_text(
                    ).splitlines()]


@pytest.mark.parametrize("command,item", sorted(NOT_PORTED.items()))
def test_unported_commands_name_their_item(capsys, command, item):
    """Every command of the JAX CLI that the port lacks exits non-zero and
    names its ROADMAP item."""
    assert main([command, "out=x"]) == 2
    assert f"ROADMAP item {item})" in capsys.readouterr().err


def test_every_jax_command_is_ported_or_named(capsys):
    jax_main(["--help"])
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines()
              if line.startswith("  ") and not line.startswith("   ")}
    ported = {"pretrain", "train", "embed", "export", "evaluate_knn",
              "list_models", "list_methods"}
    assert listed == ported | set(NOT_PORTED)
    assert main(["--help"]) == 0
    assert main(["nonsense"]) == 2


def test_the_public_api_holds_the_new_names():
    for name in ("train", "export", "evaluate_knn", "list_models",
                 "ModelFormat", "ModelPart", "EmbeddingFormat"):
        assert name in lt.__all__ and name in jlt.__all__, name
    assert lt.train is lt.pretrain
    assert [m.value for m in lt.ModelPart] == [m.value for m in jlt.ModelPart]
    assert [m.value for m in lt.ModelFormat] == [
        m.value for m in jlt.ModelFormat]
    assert lt.list_models() == jlt.list_models()
