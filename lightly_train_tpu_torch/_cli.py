"""CLI: ``python -m lightly_train_tpu_torch <command> key=value ...``.

Port of ``lightly_train_tpu/_cli.py``: dotted ``key=value`` overrides
(each value read as JSON where it parses, else as a string) become the
keyword arguments of the Python API. Commands: ``pretrain`` (and ``train``,
its deprecated alias), ``embed``, ``export``, ``evaluate_knn``,
``list_models`` and ``list_methods``. The JAX package's other commands exit
with code 2 and name the ROADMAP item that ports them.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

# Commands of the JAX CLI that the port does not have yet -> ROADMAP item.
NOT_PORTED = {
    "export_onnx": "16",
    "export_stablehlo": "16",
    "export_savedmodel": "16",
    "predict_semantic_segmentation": "15",
    "benchmark_object_detection": "15",
    "extract_video_frames": "17",
}


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def parse_cli_overrides(argv: List[str]) -> Dict[str, Any]:
    """Parse ``a.b=1 c="x"`` into a nested dict."""
    out: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(
                f"Invalid argument '{arg}'; expected key=value (dotted keys ok)."
            )
        key, raw = arg.split("=", 1)
        value = _parse_value(raw)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise SystemExit(f"Conflicting CLI key '{key}'.")
        node[parts[-1]] = value
    return out


_HELP = """\
lightly-train-tpu (PyTorch + CUDA) — vision pretraining on the card

Usage: python -m lightly_train_tpu_torch <command> [key=value ...]

Commands:
  pretrain              Pretrain a model (out=... data=... model=... method=...)
  train                 Deprecated alias of pretrain
  embed                 Write embeddings (out=... data=... checkpoint=...)
  export                Export a trained model (out=... checkpoint=... format=...)
  evaluate_knn          kNN eval of a backbone (data=... checkpoint=...)
  list_models           List available models
  list_methods          List available pretraining methods

Not ported yet: """ + ", ".join(
    f"{c} (ROADMAP item {i})" for c, i in NOT_PORTED.items())


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_HELP)
        return 0
    command, rest = argv[0], argv[1:]
    if command == "list_models":
        from lightly_train_tpu_torch import list_models

        print("\n".join(list_models()))
        return 0
    if command == "list_methods":
        from lightly_train_tpu_torch import list_methods

        print("\n".join(list_methods()))
        return 0
    if command in NOT_PORTED:
        print(f"'{command}' is not ported to PyTorch yet (ROADMAP item "
              f"{NOT_PORTED[command]}).", file=sys.stderr)
        return 2
    overrides = parse_cli_overrides(rest)
    if command in ("pretrain", "train"):
        from lightly_train_tpu_torch import pretrain

        if command == "train":
            print("WARNING: 'train' is deprecated; use 'pretrain'.",
                  file=sys.stderr)
        pretrain(**overrides)
        return 0
    if command == "embed":
        from lightly_train_tpu_torch import embed

        embed(**overrides)
        return 0
    if command == "export":
        from lightly_train_tpu_torch import export

        export(**overrides)
        return 0
    if command == "evaluate_knn":
        from lightly_train_tpu_torch import evaluate_knn

        print(json.dumps(evaluate_knn(**overrides)))
        return 0
    print(f"Unknown command '{command}'.\n\n{_HELP}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
