"""``pretrain`` command: end-to-end SSL pretraining on the card.

Port of ``lightly_train_tpu/_commands/train.py``: output-dir checks, logging,
dataset + loader, model/method/optimizer resolution with the "auto" cascade
(the default method is distillation v3; the update is the fused AdamW+EMA
one for AdamW with an EMA method, else the unfused chain),
``embed_dim`` and ``transform_args``, the ``checkpoint=`` warm start from an
exported artifact, ``resume_interrupted``, the train loop with its
one-step-lagged non-finite check, ``metrics.jsonl``, the augmentation grid
at step 0, checkpoints every ``checkpoint_every`` steps and at the end
(``checkpoints/step_<n>.pt``, the 2 newest kept) and
``exported_models/exported_last`` beside each. The run is placed on the card
(``accelerator="cuda"``, the default) or, only when asked, on the CPU.

``LIGHTLY_TRAIN_MATMUL_PRECISION`` is applied at the start of every run
(``_system.py``); a non-finite step writes ``debug/nan_capture_step<N>.npz``
and stops the run (``_debug/``), which ``replay_nan_capture`` re-runs.

``mask_dir`` pairs each image with a region mask by file stem (DetCon's
``use_dataset_masks``); the loader then yields ``{"images", "masks"}``
batches.

As in the JAX package, the run's file list is written once, by the main
process, to a memory-mapped file that the dataset reads
(``_data/mmap_lifecycle.py``), the system is logged at the start, the run
is reported to the event tracker (``_events/``, local and off by default),
the tensorboard, wandb and mlflow loggers write where their package imports
(and warn where it does not), and ``profile=True`` traces steps
``[profile_start, profile_start + profile_steps)`` into ``out/profile``
with ``torch.profiler``.

Not ported yet, and refused when set to anything but its default: ``fsdp``
> 1 (ROADMAP item 7.6). The fields keep the JAX package's names and
defaults, so configs stay compatible.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional, Union

import torch
from torch import nn

from lightly_train_tpu_torch._checkpoint.checkpoint import (
    CheckpointManager,
    export_model,
    merge_pretrained,
    resolve_pretrained_source,
)
from lightly_train_tpu_torch._commands.train_loop import fit, make_train_step
from lightly_train_tpu_torch._configs.config import AUTO, Auto, Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._data.image_dataset import (
    ImageDataset,
    list_image_files,
)
from lightly_train_tpu_torch._data.loader import PretrainLoader, SyntheticLoader
from lightly_train_tpu_torch._data.memory_mapped_sequence import (
    MemoryMappedSequence,
    write_items_to_file,
)
from lightly_train_tpu_torch._data.mmap_lifecycle import dataset_mmap_path
from lightly_train_tpu_torch._debug.nan_guard import NaNGuard
from lightly_train_tpu_torch._events import tracker
from lightly_train_tpu_torch._loggers.multi import (
    build_loggers,
    resolve_loggers,
)
from lightly_train_tpu_torch._logging import (
    get_logger,
    set_up_console_logging,
    set_up_file_logging,
)
from lightly_train_tpu_torch._optim import OPTIMIZER_ARGS_TYPES, cosine_warmup
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch._optim.update import build_update
from lightly_train_tpu_torch._scaling import ScalingInfo
from lightly_train_tpu_torch._system import (
    apply_matmul_precision,
    log_system_information,
)
from lightly_train_tpu_torch._visualize.grids import save_augmentation_grid
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.methods.base import TrainState, ViewSpec
from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
from lightly_train_tpu_torch.models.embedding import project_wrapped
from lightly_train_tpu_torch.models.package_registry import (
    get_wrapped_model,
    refuse_pretraining,
    resolve_model_name,
)
from lightly_train_tpu_torch.ops.augment import (
    ViewAugmentConfig,
    augment_view_with_geometry,
    override_view_specs,
)
from lightly_train_tpu_torch.parallel.distributed import is_main_process

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


# Options not ported yet, with their defaults and the ROADMAP item that
# ports them: each is refused when set to anything else.
_NOT_PORTED = {"fsdp": (1, "7.6")}


def _resolve_optim_args(config: TrainConfig, defaults):
    """The run's optimizer arguments: the method's defaults unless
    ``optim`` or ``optim_args`` is given (the JAX package's cascade)."""
    if config.optim == "auto" and not config.optim_args:
        return defaults
    optim_type = config.optim if config.optim != "auto" else defaults.type
    if optim_type not in OPTIMIZER_ARGS_TYPES:
        raise ConfigError(
            f"Unknown optimizer '{optim_type}'. "
            f"Options: {sorted(OPTIMIZER_ARGS_TYPES)}"
        )
    merged = {**({"lr": defaults.lr} if defaults.type == optim_type
                 else {}), **config.optim_args}
    return config_validate(OPTIMIZER_ARGS_TYPES[optim_type], merged)


def _device_capacity(accelerator: str) -> Optional[int]:
    """Bytes of memory of the card a run would use; None on the CPU and
    without a card (where :func:`resolve_device` raises)."""
    if accelerator == "cpu" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory


def _check_config(config: TrainConfig) -> None:
    """Raises for an option that is not ported, for options that
    contradict each other, for an unknown logger and for a model whose
    training state does not fit the card."""
    method_cls, method_args_cls = get_method_cls(config.method)
    # Distillation's frozen teacher, by name (its args' ``teacher``).
    teacher = (config.method_args.get("teacher", method_args_cls.teacher)
               if "teacher" in {f.name for f in
                                dataclasses.fields(method_args_cls)}
               else None)
    refuse_pretraining(
        config.model,
        _resolve_optim_args(config, method_cls.default_optimizer_args()),
        method_cls.ema_teacher, _device_capacity(config.accelerator),
        teacher)
    for key, (default, item) in _NOT_PORTED.items():
        if getattr(config, key) != default:
            raise NotImplementedError(
                f"pretrain option {key}={getattr(config, key)!r} is not ported "
                f"to PyTorch yet (ROADMAP item {item})."
            )
    # transform_args' refusals (channel_drop) before anything is built.
    override_view_specs([ViewSpec(ViewAugmentConfig(), 1)],
                        config.transform_args or None)
    if config.checkpoint is not None and config.resume_interrupted:
        raise ConfigError(
            "checkpoint= and resume_interrupted=True cannot be combined: "
            "checkpoint starts a NEW run from previous weights, "
            "resume_interrupted continues an interrupted run. Set one."
        )
    resolve_loggers(config.loggers)


def resolve_device(accelerator: str) -> torch.device:
    """The run's device. Never falls back: asking for the card without one
    is an error."""
    if accelerator == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "The port runs on the card (accelerator='cuda') but PyTorch sees "
            "no CUDA device. Pass accelerator='cpu' to run on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


def build_updater(method, optim_args, lr_schedule, named: Dict[str, Any],
                  total_steps: int, seed: int = 0):
    """The fused AdamW+EMA updater where the (optimizer, method) pair has
    one, else the unfused chain (AdamW8bit's noise seeded from ``seed``)."""
    updater = build_fused_updater(method, optim_args, lr_schedule, named,
                                  total_steps)
    if updater is None:
        updater = build_update(method, optim_args, lr_schedule, named,
                               total_steps, seed)
    return updater


def pretrain(
    out: str,
    data: Union[str, List[str], None] = None,
    model: Any = "dinov2/vitb14",
    method: str = "distillation",
    **kwargs: Any,
) -> TrainState:
    """Pretrain ``model`` with ``method`` on images under ``data``.
    ``model`` is a registered name, a ``WrappedModel`` or a
    ``torch.nn.Module``; an object is registered under its wrapper's name
    (``package_registry.resolve_model_name``), which the config, the
    checkpoints and the export carry."""
    config = config_validate(
        TrainConfig,
        {"out": out, "data": data, "model": resolve_model_name(model),
         "method": method, **kwargs},
    )
    return pretrain_from_config(config)


def pretrain_from_config(config: TrainConfig) -> TrainState:
    """Checks the config, then runs the pretraining inside the file list's
    lifecycle (its reference count, reuse and the check for a concurrent
    run on the same out dir)."""
    _check_config(config)
    if config.data is None:
        return _pretrain_body(config, None)
    with dataset_mmap_path(config.data, config.out, config.resume_interrupted,
                           config.overwrite) as mmap_path:
        return _pretrain_body(config, mmap_path)


def _pretrain_body(config: TrainConfig,
                   mmap_path: Optional[Path]) -> TrainState:
    device = resolve_device(config.accelerator)
    pretrained = None
    if config.checkpoint is not None:
        pretrained = resolve_pretrained_source(config.checkpoint,
                                               config.model)
        if pretrained[1] != config.model:
            # Disjoint parameter names would merge as a silent no-op.
            raise ConfigError(
                f"checkpoint was exported for model '{pretrained[1]}' but "
                f"this run pretrains '{config.model}'. Pass "
                f"model='{pretrained[1]}' or a matching checkpoint."
            )
    out_dir = Path(config.out)
    if (out_dir.exists() and any(out_dir.iterdir())
            and not (config.overwrite or config.resume_interrupted)):
        raise ConfigError(
            f"Output directory {out_dir} is not empty. Pass overwrite=True "
            "or resume_interrupted=True."
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    set_up_console_logging()
    set_up_file_logging(out_dir / "train.log")
    logger.info("Device: %s (%s)", device,
                torch.cuda.get_device_name(device) if device.type == "cuda"
                else "CPU")
    apply_matmul_precision()
    log_system_information()
    logger.warning(
        "The port runs on one device: sharding the model over devices "
        "(fsdp > 1) is refused (ROADMAP item 7.6)."
    )

    # ---- data -------------------------------------------------------------
    canonical_hw = (config.canonical_size, config.canonical_size)
    dataset = None
    dataset_size = 0
    if config.data is not None:
        if is_main_process() and not mmap_path.exists():
            dirs = ([config.data] if isinstance(config.data, str)
                    else config.data)
            write_items_to_file(
                [f for d in dirs for f in list_image_files(Path(d))],
                mmap_path)
        dataset = ImageDataset(
            MemoryMappedSequence(mmap_path), canonical_hw,
            mask_dir=Path(config.mask_dir) if config.mask_dir else None)
        dataset_size = len(dataset)

    # ---- model + method ---------------------------------------------------
    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    wrapped = get_wrapped_model(config.model, dtype=dtype, **config.model_args)
    if config.embed_dim is not None:
        wrapped = project_wrapped(wrapped, config.embed_dim, dtype)
        logger.info("Training an embedding model: %s features project to "
                    "dim %d", config.model, config.embed_dim)
    method_cls, method_args_cls = get_method_cls(config.method)
    method_args = config_validate(method_args_cls, config.method_args)
    tracker.track_training_started(
        task_type="ssl_pretraining", model=config.model,
        method=config.method, batch_size=config.batch_size, devices=1,
        steps=config.steps,
    )

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
    optim_args = _resolve_optim_args(config, method.default_optimizer_args())
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
    if pretrained is not None:
        _load_pretrained(params, method_state, pretrained, config)
    named = dict(params.named_parameters())
    updater = build_updater(method, optim_args, lr_schedule, named,
                            total_steps, config.seed)
    state = TrainState(step=0, params=params, method_state=method_state,
                       updater=updater)
    ckpt_mgr = CheckpointManager(out_dir / "checkpoints")
    if config.resume_interrupted and ckpt_mgr.latest_step() is not None:
        ckpt_mgr.restore(state)
        if hasattr(loader, "start_step"):
            loader.start_step = state.step
        logger.info("Resumed from step %d", state.step)
    step_gen = torch.Generator(device=device)

    run_loggers = build_loggers(out_dir, config.loggers)
    run_loggers.log_hyperparams({
        **config.dump(),
        "resolved_batch_size": batch_size,
        "resolved_steps": total_steps,
        "resolved_lr": lr,
        "method_args": method_args.dump(),
        "optim_args": optim_args.dump(),
        "devices": 1,
    })
    checkpoint_every = (
        config.checkpoint_every if config.checkpoint_every != AUTO
        else max(total_steps // 10, 1)
    )

    def on_log(step: int, metrics: Dict[str, float]) -> None:
        run_loggers.log_metrics(metrics, step)
        logger.info("step %d/%d loss=%.4f img/s=%.1f", step, total_steps,
                    metrics.get("train_loss", float("nan")),
                    metrics.get("profiling/images_per_sec", 0.0))

    def on_checkpoint(step: int, s: TrainState) -> None:
        ckpt_mgr.save(step, s, config.model, config.method)
        # A usable backbone at every checkpoint, not only at the end.
        student = s.params["student"]
        extra: Dict[str, Any] = {"method": config.method, "steps": step}
        embed_head = None
        if config.embed_dim is not None:
            # The bare backbone, fine-tune compatible, and the head beside.
            embed_head = student.embed.state_dict()
            student = student.backbone
            extra["embed_dim"] = config.embed_dim
        export_model(out_dir / "exported_models" / "exported_last",
                     config.model, student.state_dict(), extra_meta=extra,
                     embed_head=embed_head)

    def on_first_batch(batch: torch.Tensor) -> None:
        # The augmentation grid: one view of each view config of the first
        # 8 images, from one fixed seed (method.py:169-191 upstream).
        if not config.log_augmentations:
            return
        gen = torch.Generator(device=device)
        views = []
        for spec in override_view_specs(method.view_specs(),
                                        config.transform_args or None):
            gen.manual_seed(config.seed + 1)
            view, _ = augment_view_with_geometry(gen, batch[:8], spec.config)
            views.append(view.cpu().numpy())
        save_augmentation_grid(views, out_dir / "augmentations.png")

    train_step = make_train_step(method, total_steps, aug_dtype=dtype,
                                 grad_accum_steps=config.grad_accum_steps,
                                 transform_args=config.transform_args or None)
    logger.info(
        "Starting pretraining: model=%s method=%s steps=%d batch=%d lr=%.2e",
        config.model, config.method, total_steps, batch_size, lr,
    )
    try:
        fit(train_step, state, loader, total_steps, step_gen,
            seed=config.seed, log_every=config.log_every, on_log=on_log,
            on_checkpoint=on_checkpoint, checkpoint_every=checkpoint_every,
            nan_guard=NaNGuard(out_dir, enabled=config.nan_check),
            on_first_batch=on_first_batch,
            profile_dir=str(out_dir / "profile") if config.profile else None,
            profile_start=config.profile_start,
            profile_steps=config.profile_steps)
    finally:
        run_loggers.close()
    ckpt_mgr.wait()
    ckpt_mgr.close()
    return state


def _load_pretrained(params: nn.ModuleDict, method_state: Dict[str, Any],
                     pretrained: tuple, config: TrainConfig) -> None:
    """The ``checkpoint=`` warm start: the artifact's backbone (and, with
    ``embed_dim``, its head where the widths match) into the student, then
    the EMA teacher refreshed from it. Optimizer state and schedules start
    fresh."""
    backbone_state, _, head_state = pretrained
    student = params["student"]
    if config.embed_dim is None:
        student.load_state_dict(
            merge_pretrained(student.state_dict(), backbone_state))
    else:
        student.backbone.load_state_dict(
            merge_pretrained(student.backbone.state_dict(), backbone_state))
        if head_state is not None:
            if head_state["weight"].shape == student.embed.weight.shape:
                student.embed.load_state_dict(head_state)
            else:
                logger.warning(
                    "Checkpoint embed head %s does not match embed_dim=%d; "
                    "the projection re-initializes.",
                    tuple(head_state["weight"].shape), config.embed_dim)
    # The teacher starts from the loaded student too (the reference loads
    # the weights before its teacher copy).
    teacher = method_state.get("teacher")
    if isinstance(teacher, nn.ModuleDict) and "student" in teacher:
        teacher["student"].load_state_dict(student.state_dict())
    logger.info("Initialized student weights from checkpoint '%s'",
                config.checkpoint)
