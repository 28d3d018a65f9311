"""``pretrain`` command: end-to-end SSL pretraining on the card.

Port of ``lightly_train_tpu/_commands/train.py`` for the first slice:
output-dir checks, logging, dataset + loader, model/method/optimizer
resolution with the "auto" cascade, the train loop with its one-step-lagged
non-finite check, ``metrics.jsonl`` and a final ``checkpoints/last.pt``
(``torch.save``). The run is placed on the card (``accelerator="cuda"``, the
default) or, only when asked, on the CPU.

Not ported yet, and refused when set to anything but their defaults:
``embed_dim``, ``transform_args``, ``fsdp`` > 1, ``mask_dir``,
``checkpoint``, ``checkpoint_every``, ``resume_interrupted``,
``log_augmentations``, ``profile``, ``profile_start``, ``profile_steps``, and
the tensorboard, wandb and mlflow loggers where their package is installed
(ROADMAP item 7; where it is absent the run warns and goes on, as the JAX
package does). The fields keep the JAX package's names and defaults, so
configs stay compatible. At the defaults no periodic checkpoint, no
augmentation grid and no ``exported_models/exported_last`` is written yet;
every run says so in a warning.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional, Union

import torch

from lightly_train_tpu_torch._commands.train_loop import fit, make_train_step
from lightly_train_tpu_torch._configs.config import AUTO, Auto, Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._data.image_dataset import (
    ImageDataset,
    list_image_files,
)
from lightly_train_tpu_torch._data.loader import PretrainLoader, SyntheticLoader
from lightly_train_tpu_torch._loggers.multi import (
    build_loggers,
    resolve_loggers,
)
from lightly_train_tpu_torch._logging import (
    get_logger,
    set_up_console_logging,
    set_up_file_logging,
)
from lightly_train_tpu_torch._optim import (
    OPTIMIZER_ARGS_TYPES,
    cosine_warmup,
)
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch._scaling import ScalingInfo
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model

logger = get_logger("pretrain")


@dataclasses.dataclass
class TrainConfig(Config):
    out: str
    data: Union[str, List[str], None] = None
    model: str = "dinov2/vitb14"
    model_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    method: str = "distillation"
    method_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    embed_dim: Optional[int] = None
    transform_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optim: str = "auto"
    optim_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: Union[int, Auto] = AUTO
    grad_accum_steps: int = 1
    steps: Union[int, Auto] = AUTO
    epochs: Optional[int] = None
    learning_rate: Union[float, Auto] = AUTO
    warmup_fraction: float = 0.1
    precision: Literal["bf16", "fp32"] = "bf16"
    fsdp: int = 1
    canonical_size: int = 256
    mask_dir: Optional[str] = None
    num_workers: int = 8
    seed: int = 0
    log_every: int = 50
    loggers: Union[List[str], Dict[str, Optional[Dict[str, Any]]]] = (
        dataclasses.field(default_factory=lambda: ["jsonl"]))
    log_augmentations: bool = True
    nan_check: bool = True
    checkpoint_every: Union[int, Auto] = AUTO
    checkpoint: Optional[str] = None
    profile: bool = False
    profile_start: int = 10
    profile_steps: int = 5
    resume_interrupted: bool = False
    overwrite: bool = False
    # Where the run goes (the upstream LightlyTrain name): the card unless
    # the caller asks for the CPU.
    accelerator: Literal["cuda", "cpu"] = "cuda"


_NOT_PORTED = {
    "embed_dim": None, "transform_args": {}, "fsdp": 1, "mask_dir": None,
    "checkpoint": None, "checkpoint_every": AUTO, "resume_interrupted": False,
    "log_augmentations": True, "profile": False, "profile_start": 10,
    "profile_steps": 5,
}


def _check_ported(config: TrainConfig) -> list:
    """Raises for an option that is not ported; returns the resolved
    loggers."""
    for key, default in _NOT_PORTED.items():
        if getattr(config, key) != default:
            raise NotImplementedError(
                f"pretrain option {key}={getattr(config, key)!r} is not ported "
                "to PyTorch yet (ROADMAP item 7)."
            )
    return resolve_loggers(config.loggers)


def resolve_device(accelerator: str) -> torch.device:
    """The run's device. Never falls back: asking for the card without one
    is an error."""
    if accelerator == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pretrain runs on the card (accelerator='cuda') but PyTorch sees "
            "no CUDA device. Pass accelerator='cpu' to run on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


def pretrain(
    out: str,
    data: Union[str, List[str], None] = None,
    model: str = "dinov2/vitb14",
    method: str = "distillation",
    **kwargs: Any,
) -> TrainState:
    """Pretrain ``model`` with ``method`` on images under ``data``."""
    config = config_validate(
        TrainConfig,
        {"out": out, "data": data, "model": model, "method": method, **kwargs},
    )
    return pretrain_from_config(config)


def pretrain_from_config(config: TrainConfig) -> TrainState:
    loggers = _check_ported(config)
    device = resolve_device(config.accelerator)
    out_dir = Path(config.out)
    if out_dir.exists() and any(out_dir.iterdir()) and not config.overwrite:
        raise ConfigError(
            f"Output directory {out_dir} is not empty. Pass overwrite=True."
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    set_up_console_logging()
    set_up_file_logging(out_dir / "train.log")
    logger.info("Device: %s (%s)", device,
                torch.cuda.get_device_name(device) if device.type == "cuda"
                else "CPU")
    logger.warning(
        "The port writes less than the JAX package at these defaults: no "
        "periodic checkpoints (checkpoint_every='auto'), no "
        "augmentations.png (log_augmentations=True) and no "
        "exported_models/exported_last; only checkpoints/last.pt at the end "
        "(ROADMAP item 7)."
    )

    # ---- data -------------------------------------------------------------
    canonical_hw = (config.canonical_size, config.canonical_size)
    dataset = None
    dataset_size = 0
    if config.data is not None:
        dirs = [config.data] if isinstance(config.data, str) else config.data
        files = [f for d in dirs for f in list_image_files(Path(d))]
        dataset = ImageDataset(files, canonical_hw)
        dataset_size = len(dataset)

    # ---- model + method ---------------------------------------------------
    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    wrapped = get_wrapped_model(config.model, dtype=dtype, **config.model_args)
    method_cls, method_args_cls = get_method_cls(config.method)
    method_args = config_validate(method_args_cls, config.method_args)

    batch_size = (
        config.batch_size if config.batch_size != AUTO
        else min(method_cls.default_batch_size, max(dataset_size, 8))
    )
    steps_per_epoch = max(dataset_size // batch_size, 1) if dataset else 1
    if config.steps != AUTO:
        total_steps = int(config.steps)
    elif config.epochs is not None:
        total_steps = config.epochs * steps_per_epoch
    else:
        total_steps = method_cls.default_steps
    epochs = total_steps // steps_per_epoch if steps_per_epoch else 0
    method_args.resolve_auto(
        ScalingInfo(dataset_size=dataset_size or 1, epochs=max(epochs, 1)))
    method = method_cls(wrapped, method_args)

    if dataset is not None:
        loader = PretrainLoader(dataset, batch_size, device, seed=config.seed,
                                num_workers=config.num_workers)
    else:
        loader = SyntheticLoader(batch_size, device, canonical_hw, config.seed)

    # ---- optimizer --------------------------------------------------------
    if config.optim == "auto" and not config.optim_args:
        optim_args = method.default_optimizer_args()
    else:
        defaults = method.default_optimizer_args()
        optim_type = config.optim if config.optim != "auto" else defaults.type
        if optim_type not in OPTIMIZER_ARGS_TYPES:
            raise NotImplementedError(
                f"Optimizer '{optim_type}' is not ported yet (ported: "
                f"{sorted(OPTIMIZER_ARGS_TYPES)}; ROADMAP item 10)."
            )
        merged = {**({"lr": defaults.lr} if defaults.type == optim_type
                     else {}), **config.optim_args}
        optim_args = config_validate(OPTIMIZER_ARGS_TYPES[optim_type], merged)
    base_lr = (
        config.learning_rate if config.learning_rate != AUTO
        else (optim_args.lr if optim_args.lr != AUTO else 1e-3)
    )
    lr = method.learning_rate_for(batch_size, float(base_lr))
    warmup_steps = int(config.warmup_fraction * total_steps)
    lr_schedule = cosine_warmup(lr, total_steps, warmup_steps)

    # ---- state ------------------------------------------------------------
    init_gen = torch.Generator().manual_seed(config.seed)
    params, method_state = method.init(init_gen, device)
    named = dict(params.named_parameters())
    updater = build_fused_updater(method, optim_args, lr_schedule, named,
                                  total_steps)
    state = TrainState(step=0, params=params, method_state=method_state,
                       updater=updater)
    step_gen = torch.Generator(device=device).manual_seed(config.seed)

    run_loggers = build_loggers(out_dir, loggers)
    run_loggers.log_hyperparams({
        **config.dump(),
        "resolved_batch_size": batch_size,
        "resolved_steps": total_steps,
        "resolved_lr": lr,
        "method_args": method_args.dump(),
        "optim_args": optim_args.dump(),
        "devices": 1,
    })

    def on_log(step: int, metrics: Dict[str, float]) -> None:
        run_loggers.log_metrics(metrics, step)
        logger.info("step %d/%d loss=%.4f img/s=%.1f", step, total_steps,
                    metrics.get("train_loss", float("nan")),
                    metrics.get("profiling/images_per_sec", 0.0))

    train_step = make_train_step(method, total_steps, aug_dtype=dtype,
                                 grad_accum_steps=config.grad_accum_steps)
    logger.info(
        "Starting pretraining: model=%s method=%s steps=%d batch=%d lr=%.2e",
        config.model, config.method, total_steps, batch_size, lr,
    )
    try:
        fit(train_step, state, loader, total_steps, step_gen,
            log_every=config.log_every, on_log=on_log,
            nan_check=config.nan_check)
    finally:
        run_loggers.close()

    ckpt_dir = out_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    teacher = state.method_state["teacher"]
    torch.save({
        "step": state.step,
        "model": config.model,
        "method": config.method,
        "params": state.params.state_dict(),
        "method_state": {
            "teacher": teacher.state_dict(),
            "dino_center": state.method_state["dino_center"],
            "ibot_center": state.method_state["ibot_center"],
        },
        "optimizer": updater.state_dict(),
    }, ckpt_dir / "last.pt")
    return state
