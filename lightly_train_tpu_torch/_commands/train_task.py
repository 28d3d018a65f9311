"""Fine-tuning runtime and the ``train_*`` entry points.

Port of ``lightly_train_tpu/_commands/train_task.py``: the generic step loop
of every task (the transform on the device, the loss, gradient accumulation
over microbatches, the unfused update), validation every ``val_every``
steps with device-summed statistics (or each batch's collected on the host
where the task's ``val_mode`` is "collect": instance and panoptic
segmentation), ``exported_best`` on the task's watch
metric and ``exported_last`` at the end, checkpoints every ``save_every``
steps and at the end, ``resume_interrupted``, the loggers, the event
tracker, the system log and the first batch's label grid.

Ported entry points: ``train_image_classification``,
``train_image_classification_multihead``, ``train_semantic_segmentation``
(the linear probe, and EoMT with a ``-eomt`` model),
``train_semantic_segmentation_multihead``, ``train_instance_segmentation``
(EoMT, or LT-DETR with a mask head for a ``-ltdetr`` model),
``train_panoptic_segmentation`` (EoMT), and ``train_object_detection``
(LT-DETR, or PicoDet for ``picodet-s`` / ``picodet-l``). They run on the
card unless the caller passes ``accelerator="cpu"``
(``_commands/train.py::resolve_device``, which never falls back).

A task may augment the transformed batch (``augment_batch``, detection's
Mosaic and the rest) on a generator stream of its own, and keep an EMA of
its parameters (``use_ema``) that validation and the exports use.

The update is ``_optim/update.py``'s unfused chain (AdamW by default, with
the task's per-parameter lr scales, and EoMT's two schedules by parameter
group); a frozen backbone's parameters get a
zero gradient there, so AdamW's decoupled weight decay still shrinks them by
``1 - lr * wd`` a step, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional, Tuple, Union

import numpy as np
import torch

from lightly_train_tpu_torch._checkpoint.checkpoint import (
    CheckpointManager,
    export_model,
    merge_pretrained,
    resolve_pretrained_source,
)
from lightly_train_tpu_torch._commands.train import resolve_device
from lightly_train_tpu_torch._commands.train_loop import step_seed
from lightly_train_tpu_torch._configs.config import AUTO, Auto, Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._data.classification_dataset import (
    ImageClassificationDataset,
)
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch._data.task_loader import TaskValLoader
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
from lightly_train_tpu_torch._optim import OPTIMIZER_ARGS_TYPES
from lightly_train_tpu_torch._optim.update import UnfusedUpdate
from lightly_train_tpu_torch._system import (
    apply_matmul_precision,
    log_system_information,
)
from lightly_train_tpu_torch._transforms import (
    build_train_transform,
    resolve_task_transform_args,
)
from lightly_train_tpu_torch._visualize.grids import save_label_grid
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.package_registry import (
    get_wrapped_model,
    resolve_model_name,
)
from lightly_train_tpu_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD
from lightly_train_tpu_torch.ops.ema import ema_update, ema_warmup_momentum
from lightly_train_tpu_torch.tasks.base import TaskTrainModel, TaskTrainState

logger = get_logger("train_task")


@dataclasses.dataclass
class TrainTaskConfig(Config):
    out: str
    model: str
    task_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checkpoint: Optional[str] = None  # pretrained backbone artifact
    steps: Union[int, Auto] = AUTO
    batch_size: Union[int, Auto] = AUTO
    optim: str = "auto"
    optim_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    learning_rate: Union[float, Auto] = AUTO
    precision: Literal["bf16", "fp32"] = "bf16"
    grad_accum_steps: int = 1
    image_size: int = 224
    # Validation staging resolution; above ``image_size`` segmentation
    # validates tiled at the training size ("auto": image_size).
    val_image_size: Union[int, Auto] = AUTO
    num_workers: int = 8
    seed: int = 0
    log_every: int = 50
    loggers: Union[List[str], Dict[str, Optional[Dict[str, Any]]]] = (
        dataclasses.field(default_factory=lambda: ["jsonl"]))
    val_every: Union[int, Auto] = AUTO
    save_every: Union[int, Auto] = AUTO
    # Overrides of the task's transform schema
    # (``_transforms/task_transforms.py``).
    transform_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Legacy scalar knob: overrides random_flip.horizontal_prob when set.
    hflip_prob: Optional[float] = None
    resume_interrupted: bool = False
    overwrite: bool = False
    # Where the run goes: the card unless the caller asks for the CPU.
    accelerator: Literal["cuda", "cpu"] = "cuda"


def _device_train_transform(batch: Dict[str, torch.Tensor],
                            flip: Optional[torch.Tensor],
                            dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The shared train transform of a task without a transform schema:
    the horizontal flip of the samples where ``flip`` ((B,) bool, None for
    none) is set, joint with ``masks``, ``seg_map`` and normalized cxcywh
    ``boxes``, and the ImageNet normalization."""
    images = batch["images"].float() / 255.0
    out = dict(batch)
    if flip is not None:
        images = torch.where(flip[:, None, None, None], images.flip(2),
                             images)
        for name in ("masks", "seg_map"):
            if name in batch:
                out[name] = torch.where(flip[:, None, None],
                                        batch[name].flip(2), batch[name])
        if "boxes" in batch:
            b = batch["boxes"]
            flipped = torch.cat([1.0 - b[..., :1], b[..., 1:]], dim=-1)
            out["boxes"] = torch.where(flip[:, None, None], flipped, b)
    return _normalized(out, images, dtype)


def _device_val_transform(batch: Dict[str, torch.Tensor],
                          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Validation: the ImageNet normalization only."""
    return _normalized(dict(batch), batch["images"].float() / 255.0, dtype)


def _normalized(out: Dict[str, torch.Tensor], images: torch.Tensor,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    out["images"] = ((images - mean) / std).to(dtype)
    return out


@contextlib.contextmanager
def _ema_weights(state: TaskTrainState):
    """Within the block the model holds the EMA of its parameters, where
    the state keeps one; its own parameters come back after."""
    ema = state.method_state.get("ema")
    if ema is None:
        yield
        return
    named = dict(state.params.named_parameters())
    live = {name: p.detach().clone() for name, p in named.items()}
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(ema[name])
    try:
        yield
    finally:
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(live[name])


def _resolve_optim_args(config: TrainTaskConfig, train_model: TaskTrainModel):
    """The task's optimizer defaults unless ``optim`` or ``optim_args`` is
    given; then the named optimizer's arguments from ``optim_args`` alone
    (the JAX task cascade: no default is merged in)."""
    defaults = train_model.default_optimizer_args()
    if config.optim == "auto" and not config.optim_args:
        return defaults
    optim_type = config.optim if config.optim != "auto" else defaults.type
    if optim_type not in OPTIMIZER_ARGS_TYPES:
        raise ConfigError(f"Unknown optimizer '{optim_type}'. "
                          f"Options: {sorted(OPTIMIZER_ARGS_TYPES)}")
    return config_validate(OPTIMIZER_ARGS_TYPES[optim_type], config.optim_args)


def _build_transform(config: TrainTaskConfig, train_model: TaskTrainModel,
                     dtype: torch.dtype):
    """``fn(batch, generator) -> batch``: the task's schema resolved from
    ``transform_args`` (segmentation's ``ignore_index`` from the task
    unless set there), or the shared flip and normalization for a task
    without one."""
    kind = train_model.transform_kind
    if kind is None:
        if config.transform_args:
            raise ConfigError(
                f"transform_args is not supported for task "
                f"'{train_model.task}' (its pipeline is configured via "
                "task_args)")
        hflip = config.hflip_prob if config.hflip_prob is not None else 0.5

        def transform(batch, generator):
            B = batch["images"].shape[0]
            flip = (torch.rand(B, generator=generator,
                               device=generator.device) < hflip
                    if hflip > 0 else None)
            return _device_train_transform(batch, flip, dtype)

        return transform
    user = dict(config.transform_args)
    ignore = getattr(train_model.args, "ignore_index", None)
    if (kind != "image_classification" and ignore is not None
            and "ignore_index" not in user):
        user["ignore_index"] = int(ignore)
    resolved = resolve_task_transform_args(
        kind, user, (config.image_size, config.image_size), config.hflip_prob)
    logger.info("Train transform (%s): %s", kind, resolved.model_dump())
    return build_train_transform(resolved, dtype)


def _save_label_grid(out_dir: Path, batch: Dict[str, torch.Tensor]) -> None:
    """``visualizations/first_batch_labels.png`` of the first train batch,
    its masks overlaid; a failure is logged, never raised."""
    try:
        save_label_grid(
            batch["images"].float().cpu().numpy(),
            out_dir / "visualizations" / "first_batch_labels.png",
            batch["masks"].cpu().numpy() if "masks" in batch else None)
    except Exception as e:  # the grid must never stop a run
        logger.warning("Label-grid visualization skipped: %s", e)


def _split(batch: Dict[str, torch.Tensor], k: int) -> list:
    """``k`` microbatches, each a dict of the batch's k-th parts."""
    if k == 1:
        return [batch]
    parts = {key: value.chunk(k) for key, value in batch.items()}
    return [{key: chunks[i] for key, chunks in parts.items()}
            for i in range(k)]


def make_task_step(train_model: TaskTrainModel, grad_accum_steps: int = 1):
    """``step(state, batch, generator) -> metrics`` on a transformed batch,
    updating ``state`` in place: the loss of each of ``grad_accum_steps``
    microbatches (BatchNorm statistics carried from one to the next), the
    gradients averaged over them, the update, and where the state holds an
    EMA of the parameters (``method_state["ema"]``), its update at
    ``ema_warmup_momentum(step, 0.9998)``. The metrics are the mean
    loss (``train_loss``), the gradients' global norm before clipping and
    the task's metrics averaged over the microbatches."""

    def step(state: TaskTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> Dict[str, Any]:
        named = dict(state.params.named_parameters())
        for p in named.values():
            p.grad = None
        micro = _split(batch, grad_accum_steps)
        loss_sum = 0.0
        metric_sums: Dict[str, Any] = {}
        for mb in micro:
            loss, metrics = train_model.loss_fn(state.params, mb, generator,
                                                state.step)
            (loss / len(micro)).backward()
            loss_sum = loss_sum + loss.detach()
            for key, value in metrics.items():
                metric_sums[key] = metric_sums.get(key, 0.0) + value
        grads = {name: p.grad for name, p in named.items()}
        for p in named.values():
            p.grad = None
        grad_norm = state.updater.update_and_apply(grads, named)
        ema = state.method_state.get("ema")
        if ema is not None:
            ema_update(ema, named, ema_warmup_momentum(state.step, 0.9998))
        state.step += 1
        n = len(micro)
        return {"train_loss": loss_sum / n, "grad_norm": grad_norm,
                **{k: v / n for k, v in metric_sums.items()}}

    return step


def run_task_training(
    config: TrainTaskConfig,
    train_model: TaskTrainModel,
    train_dataset: Any,
    val_dataset: Optional[Any],
    model_meta: Dict[str, Any],
    pretrained: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[TaskTrainState, Dict[str, float]]:
    """The fine-tuning loop shared by every task entry point. Returns the
    final state and the last validation metrics."""
    device = resolve_device(config.accelerator)
    # Validation above the training resolution runs tiled at this size.
    train_model.val_tile_size = config.image_size
    out_dir = Path(config.out)
    if out_dir.exists() and any(out_dir.iterdir()) and not (
            config.overwrite or config.resume_interrupted):
        raise ConfigError(
            f"Output directory {out_dir} is not empty. Pass overwrite=True "
            "or resume_interrupted=True."
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    set_up_console_logging()
    set_up_file_logging(out_dir / "train.log")
    apply_matmul_precision()
    log_system_information()

    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    args = train_model.args
    batch_size = (config.batch_size if config.batch_size != AUTO
                  else args.default_batch_size)
    tracker.track_training_started(
        task_type=train_model.task, model=model_meta.get("model_name", "?"),
        method=type(train_model).__name__, batch_size=batch_size, devices=1,
        steps=config.steps,
    )
    total_steps = (config.steps if config.steps != AUTO
                   else args.default_steps)
    # Step-based schedules inside the task (EoMT's attention-mask
    # annealing) end with this run, not at the task's default_steps.
    train_model.total_steps = total_steps
    accum = max(1, config.grad_accum_steps)
    if batch_size % accum != 0:
        raise ConfigError(
            f"batch_size {batch_size} must be "
            f"divisible by grad_accum_steps {accum}.")
    train_loader = PretrainLoader(train_dataset, batch_size, device,
                                  config.seed, config.num_workers)
    val_loader = (TaskValLoader(val_dataset, batch_size, device,
                                config.num_workers)
                  if val_dataset is not None else None)

    # ---- optimizer --------------------------------------------------------
    optim_args = _resolve_optim_args(config, train_model)
    base_lr = (float(config.learning_rate) if config.learning_rate != AUTO
               else float(optim_args.lr) if optim_args.lr != AUTO else 1e-4)
    base_lr = train_model.scaled_lr(base_lr, batch_size)
    lr_schedule = train_model.lr_schedule(base_lr, total_steps)

    # ---- state ------------------------------------------------------------
    model = train_model.init(torch.Generator().manual_seed(config.seed),
                             device)
    if pretrained is not None:
        model.backbone.load_state_dict(merge_pretrained(
            model.backbone.state_dict(),
            train_model.wrap_pretrained(pretrained), require_overlap=True))
        logger.info("Initialized backbone from pretrained checkpoint")
    named = dict(model.named_parameters())
    updater = UnfusedUpdate(
        optim_args, lr_schedule, named,
        grad_clip_norm=train_model.grad_clip_norm(),
        lr_scales=train_model.lr_scales(named), seed=config.seed,
        schedule_groups=train_model.lr_schedule_groups(base_lr, total_steps,
                                                       named))
    state = TaskTrainState(step=0, params=model, updater=updater)
    if train_model.use_ema():
        # The EMA covers the parameters only: BatchNorm statistics stay the
        # live model's, in validation and in the exports too, as in the JAX
        # runtime (its ema_params beside one model_state).
        state.method_state["ema"] = {
            name: p.detach().clone() for name, p in named.items()}
    train_tf = _build_transform(config, train_model, dtype)
    ckpt_mgr = CheckpointManager(out_dir / "checkpoints")
    if config.resume_interrupted and ckpt_mgr.latest_step() is not None:
        ckpt_mgr.restore(state)
        # The same shuffled stream, without the batches already consumed.
        train_loader.start_step = state.step
        logger.info("Resumed from step %d", state.step)

    run_loggers = build_loggers(out_dir, config.loggers)
    run_loggers.log_hyperparams({
        **config.dump(),
        "task": train_model.task,
        "resolved_steps": total_steps,
        "resolved_batch_size": batch_size,
        **model_meta,
    })
    val_every = (config.val_every if config.val_every != AUTO
                 else max(total_steps // 10, 1))
    save_every = config.save_every if config.save_every != AUTO else val_every
    watch_name, watch_mode = train_model.watch_metric
    model_name = model_meta.get("model_name", config.model)

    def run_validation() -> Dict[str, float]:
        if val_loader is None:
            return {}
        total: Optional[Dict[str, torch.Tensor]] = None
        collected = []
        with torch.no_grad(), _ema_weights(state):
            for batch in val_loader:
                stats = train_model.val_step(
                    state.params, _device_val_transform(batch, dtype))
                if train_model.val_mode == "collect":
                    collected.append({k: v.cpu().numpy()
                                      for k, v in stats.items()})
                    continue
                total = (stats if total is None else
                         {k: total[k] + v for k, v in stats.items()})
        if train_model.val_mode == "collect":
            return train_model.val_finalize(collected) if collected else {}
        return train_model.val_finalize(total) if total is not None else {}

    def export_artifact(name: str) -> None:
        with _ema_weights(state):
            weights = {k: v.clone() for k, v in
                       state.params.state_dict().items()}
        export_model(
            out_dir / "exported_models" / name, model_name, weights,
            extra_meta={
                **{k: v for k, v in model_meta.items() if k != "model_name"},
                "task": train_model.task,
                "task_args": args.dump(),
                "steps": state.step,
            })

    step_fn = make_task_step(train_model, accum)
    generator = torch.Generator(device=device)
    # The task's batch augmentations draw from a stream of their own.
    aug_generator = torch.Generator(device=device)
    burn_in = {1, 2, 5, 10, 50, 100}
    best_value: Optional[float] = None
    last_val: Dict[str, float] = {}
    current = start_step = state.step
    t_window = time.perf_counter()
    window = 0
    data_wait = 0.0
    logger.info("Fine-tuning %s: model=%s steps=%d batch=%d",
                train_model.task, model_name, total_steps, batch_size)
    train_iter = iter(train_loader)
    try:
        while current < total_steps:
            t_data = time.perf_counter()
            batch = next(train_iter)
            data_wait += time.perf_counter() - t_data
            generator.manual_seed(step_seed(config.seed, current))
            batch = train_tf(batch, generator)
            aug_generator.manual_seed(step_seed(config.seed, current, 1))
            batch = train_model.augment_batch(batch, aug_generator, current)
            if current == start_step:
                _save_label_grid(out_dir, batch)
            pending = step_fn(state, batch, generator)
            current += 1
            window += 1
            if (current in burn_in or current % config.log_every == 0
                    or current == total_steps):
                metrics = {k: float(v) for k, v in pending.items()}
                dt = time.perf_counter() - t_window
                metrics["profiling/images_per_sec"] = (
                    batch_size * window / max(dt, 1e-9))
                metrics["profiling/data_time"] = data_wait / max(window, 1)
                metrics["profiling/device_duty_cycle"] = max(
                    0.0, 1.0 - data_wait / max(dt, 1e-9))
                data_wait = 0.0
                run_loggers.log_metrics(metrics, current)
                logger.info("step %d/%d loss=%.4f img/s=%.1f", current,
                            total_steps, metrics["train_loss"],
                            metrics["profiling/images_per_sec"])
                t_window = time.perf_counter()
                window = 0
            if current % val_every == 0 or current == total_steps:
                val_metrics = run_validation()
                if val_metrics:
                    last_val = val_metrics
                    run_loggers.log_metrics(val_metrics, current)
                    logger.info("val @ %d: %s", current,
                                {k: round(v, 4) for k, v in
                                 val_metrics.items()})
                    value = val_metrics.get(watch_name)
                    if value is not None and (
                            best_value is None
                            or (watch_mode == "max" and value > best_value)
                            or (watch_mode == "min" and value < best_value)):
                        best_value = value
                        export_artifact("exported_best")
            if current % save_every == 0 and current < total_steps:
                ckpt_mgr.save(current, state, model_name, train_model.task)
        ckpt_mgr.save(current, state, model_name, train_model.task)
        export_artifact("exported_last")
    finally:
        run_loggers.close()
    if best_value is not None:
        logger.info("Best %s: %.4f", watch_name, best_value)
    return state, last_val


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _config(out: str, model: Any, kwargs: Dict[str, Any]) -> TrainTaskConfig:
    """The validated config; the device and the loggers checked before
    anything is built."""
    config = config_validate(TrainTaskConfig, {
        "out": out, "model": resolve_model_name(model), **kwargs})
    resolve_device(config.accelerator)
    resolve_loggers(config.loggers)
    return config


def _load_backbone(config: TrainTaskConfig):
    """(wrapped backbone, pretrained state dict or None, model meta).
    ``checkpoint`` is an exported artifact folder (its model name wins) or
    a Meta/timm ``.pth`` file converted for ``model``; ``"auto"`` (public
    weights) waits for ROADMAP item 20."""
    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    pretrained = None
    model_name = config.model
    if config.checkpoint is not None:
        pretrained, model_name, _ = resolve_pretrained_source(
            config.checkpoint, model_name)
    else:
        logger.warning(
            "No checkpoint given: the %s backbone fine-tunes from RANDOM "
            "init. Pass checkpoint=<pretrain artifact or torch .pth>.",
            model_name)
    wrapped = get_wrapped_model(model_name, dtype=dtype)
    return wrapped, pretrained, {"model_name": model_name}


def _resolve_mask_classes(data: Dict[str, Any], ignore_index: int = 255
                          ) -> Tuple[int, Optional[np.ndarray]]:
    """(num_classes, class LUT or None) of a mask dataset: ``classes``
    ({raw id: name}) minus ``ignore_classes`` map to contiguous train ids,
    every other raw id to ``ignore_index``; the plain ``num_classes`` form
    has no LUT."""
    if "classes" not in data:
        return int(data["num_classes"]), None
    classes = {int(k): v for k, v in dict(data["classes"]).items()}
    ignore = {int(i) for i in (data.get("ignore_classes") or ())}
    included = [cid for cid in sorted(classes) if cid not in ignore]
    if not included:
        raise ConfigError(
            "data['classes'] minus data['ignore_classes'] left no classes.")
    lut = np.full(max(max(classes), ignore_index) + 1, ignore_index, np.int32)
    for tid, cid in enumerate(included):
        lut[cid] = tid
    return len(included), lut


def _classification(out: str, data: Dict[str, str], model: Any,
                    kwargs: Dict[str, Any], args_cls, model_cls):
    config = _config(out, model, kwargs)
    hw = (config.image_size, config.image_size)
    train_ds = ImageClassificationDataset(Path(data["train"]), hw)
    val_ds = (ImageClassificationDataset(Path(data["val"]), hw,
                                         classes=train_ds.classes)
              if "val" in data else None)
    task_args = config_validate(args_cls, {
        "num_classes": len(train_ds.classes), **config.task_args})
    wrapped, pretrained, meta = _load_backbone(config)
    meta["classes"] = train_ds.classes
    return run_task_training(config, model_cls(wrapped, task_args), train_ds,
                             val_ds, meta, pretrained)


def _segmentation(config: TrainTaskConfig, data: Dict[str, Any], args_cls,
                  model_cls, meta: Optional[Dict[str, Any]] = None):
    from lightly_train_tpu_torch.tasks.semantic_segmentation_linear import (
        MaskSemanticSegmentationDataset,
    )

    hw = (config.image_size, config.image_size)
    val_size = (config.val_image_size if config.val_image_size != AUTO
                else config.image_size)
    num_classes, class_lut = _resolve_mask_classes(data)
    train_ds = MaskSemanticSegmentationDataset(
        Path(data["train"]["images"]), Path(data["train"]["masks"]), hw,
        class_lut=class_lut)
    val_ds = (MaskSemanticSegmentationDataset(
        Path(data["val"]["images"]), Path(data["val"]["masks"]),
        (val_size, val_size), class_lut=class_lut)
        if "val" in data else None)
    task_args = config_validate(args_cls, {"num_classes": num_classes,
                                           **config.task_args})
    wrapped, pretrained, model_meta = _load_backbone(config)
    model_meta.update(meta or {})
    return run_task_training(config, model_cls(wrapped, task_args), train_ds,
                             val_ds, model_meta, pretrained)


def train_image_classification(out: str, data: Dict[str, str], model: Any,
                               **kwargs: Any):
    """data: {"train": <dir>, "val": <dir>}, class-folder roots."""
    from lightly_train_tpu_torch.tasks.image_classification import (
        ImageClassificationArgs,
        ImageClassificationTrainModel,
    )

    return _classification(out, data, model, kwargs, ImageClassificationArgs,
                           ImageClassificationTrainModel)


def train_image_classification_multihead(out: str, data: Dict[str, str],
                                         model: Any, **kwargs: Any):
    """Several classification heads at different learning rates in one
    run."""
    from lightly_train_tpu_torch.tasks.multihead import (
        ImageClassificationMultiheadArgs,
        ImageClassificationMultiheadTrainModel,
    )

    return _classification(out, data, model, kwargs,
                           ImageClassificationMultiheadArgs,
                           ImageClassificationMultiheadTrainModel)


def train_semantic_segmentation(out: str, data: Dict[str, Any], model: Any,
                                **kwargs: Any):
    """data: {"train": {"images": dir, "masks": dir}, "val": {...},
    "num_classes": int} (or ``classes`` and ``ignore_classes``). A model
    name ending in ``-eomt`` (``dinov2/vitb14-eomt``) trains the EoMT mask
    transformer; without it (``-linear`` or no suffix) the linear probe."""
    from lightly_train_tpu_torch.tasks.eomt_semantic_segmentation import (
        EoMTSemanticSegmentationArgs,
        EoMTSemanticSegmentationTrainModel,
    )
    from lightly_train_tpu_torch.tasks.semantic_segmentation_linear import (
        LinearSemanticSegmentationArgs,
        LinearSemanticSegmentationTrainModel,
    )

    config = _config(out, model, kwargs)
    use_eomt = config.model.endswith("-eomt")
    config = dataclasses.replace(
        config,
        model=config.model.removesuffix("-eomt").removesuffix("-linear"))
    if use_eomt:
        return _segmentation(config, data, EoMTSemanticSegmentationArgs,
                             EoMTSemanticSegmentationTrainModel,
                             {"architecture": "eomt"})
    return _segmentation(config, data, LinearSemanticSegmentationArgs,
                         LinearSemanticSegmentationTrainModel,
                         {"architecture": "linear"})


def train_semantic_segmentation_multihead(out: str, data: Dict[str, Any],
                                          model: Any, **kwargs: Any):
    """Several linear segmentation heads at different learning rates in one
    run."""
    from lightly_train_tpu_torch.tasks.multihead import (
        SemanticSegmentationMultiheadArgs,
        SemanticSegmentationMultiheadTrainModel,
    )

    return _segmentation(_config(out, model, kwargs), data,
                         SemanticSegmentationMultiheadArgs,
                         SemanticSegmentationMultiheadTrainModel)


def _slot_task(config: TrainTaskConfig, build, args_cls, model_cls,
               num_classes: Optional[int], architecture: str):
    """A slot-map task (EoMT, or LT-DETR instance segmentation) on the
    datasets ``build(split)`` makes of ``data``'s splits."""
    hw = (config.image_size, config.image_size)
    max_instances = int(config.task_args.get("max_instances", 50))
    train_ds = build("train", hw, max_instances)
    val_ds = build("val", hw, max_instances)
    task_args = config_validate(args_cls, {
        "num_classes": (train_ds.num_classes if num_classes is None
                        else num_classes), **config.task_args})
    wrapped, pretrained, meta = _load_backbone(config)
    meta["architecture"] = architecture
    return run_task_training(config, model_cls(wrapped, task_args), train_ds,
                             val_ds, meta, pretrained)


def train_instance_segmentation(out: str, data: Dict[str, Any], model: Any,
                                **kwargs: Any):
    """Instance segmentation. data (COCO): {"train": {"images": dir,
    "annotations": json}, "val": {...}}; data (YOLO-seg): {"format":
    "yolo", "num_classes": int, "train": {"images": dir, "labels": dir},
    "val": {...}}. A model name ending in ``-ltdetr`` trains the LT-DETR
    detector with a mask head (``ltdetrv2-*`` names are not resolved here,
    as in the JAX package); with ``-eomt`` or without a suffix, EoMT."""
    from lightly_train_tpu_torch.tasks.detection.ltdetr_seg import (
        InstanceSegmentationLTDETRArgs,
        LTDETRInstanceSegmentationTrainModel,
    )
    from lightly_train_tpu_torch.tasks.eomt_instance_panoptic import (
        COCOInstanceSegmentationDataset,
        EoMTInstanceSegmentationArgs,
        EoMTInstanceSegmentationTrainModel,
        YOLOInstanceSegmentationDataset,
    )

    config = _config(out, model, kwargs)
    use_ltdetr = config.model.endswith("-ltdetr")
    config = dataclasses.replace(config, model=config.model.removesuffix(
        "-eomt").removesuffix("-ltdetr"))
    yolo = data.get("format") == "yolo"

    def build(split, hw, max_instances):
        if split not in data:
            return None
        s = data[split]
        if yolo:
            return YOLOInstanceSegmentationDataset(
                Path(s["images"]), Path(s["labels"]),
                int(data["num_classes"]), hw, max_instances)
        return COCOInstanceSegmentationDataset(
            Path(s["images"]), Path(s["annotations"]), hw, max_instances)

    if use_ltdetr:
        return _slot_task(config, build, InstanceSegmentationLTDETRArgs,
                          LTDETRInstanceSegmentationTrainModel,
                          data.get("num_classes"), "ltdetr")
    return _slot_task(config, build, EoMTInstanceSegmentationArgs,
                      EoMTInstanceSegmentationTrainModel,
                      data.get("num_classes"), "eomt")


def train_panoptic_segmentation(out: str, data: Dict[str, Any], model: Any,
                                **kwargs: Any):
    """EoMT panoptic segmentation, COCO panoptic format: data: {"train":
    {"images": dir, "panoptic": dir, "annotations": json}, "val":
    {...}}."""
    from lightly_train_tpu_torch.tasks.eomt_instance_panoptic import (
        COCOPanopticSegmentationDataset,
        EoMTPanopticSegmentationArgs,
        EoMTPanopticSegmentationTrainModel,
    )

    config = _config(out, model, kwargs)
    config = dataclasses.replace(config,
                                 model=config.model.removesuffix("-eomt"))

    def build(split, hw, max_instances):
        if split not in data:
            return None
        s = data[split]
        return COCOPanopticSegmentationDataset(
            Path(s["images"]), Path(s["panoptic"]), Path(s["annotations"]),
            hw, max_instances)

    return _slot_task(config, build, EoMTPanopticSegmentationArgs,
                      EoMTPanopticSegmentationTrainModel,
                      data.get("num_classes"), "eomt")


# ltdetrv2-{s,m,l,x} resolve to the EdgeCrafter ECViT backbones; the
# hidden _ltdetrv2-test to the test size.
_LTDETRV2_ZOO = {
    "ltdetrv2-s": "ecvit/ecvitt",
    "ltdetrv2-m": "ecvit/ecvittplus",
    "ltdetrv2-l": "ecvit/ecvits",
    "ltdetrv2-x": "ecvit/ecvitsplus",
    "_ltdetrv2-test": "ecvit/ecvittest",
}


def train_object_detection(out: str, data: Dict[str, Any], model: Any,
                           **kwargs: Any):
    """LT-DETR object detection. data (YOLO): {"format": "yolo", "train":
    {"images": dir, "labels": dir}, "val": {...}, "num_classes": int (or
    "classes": {id: name})}; data (COCO): {"format": "coco", "train":
    {"images": dir, "annotations": json}, "val": {...}}. ``model``: a
    backbone name with or without ``-ltdetr``, or ``ltdetrv2-{s,m,l,x}``
    (``-coco`` allowed; ECViT backbones); or PicoDet: a name starting
    with ``picodet`` (``picodet-l``: the large preset, any other the
    small one, unless ``task_args`` sets ``model_size``), its ESNet
    trained from scratch (``checkpoint=`` is refused)."""
    from lightly_train_tpu_torch.tasks.detection.data import (
        COCOObjectDetectionDataset,
        YOLOObjectDetectionDataset,
    )
    from lightly_train_tpu_torch.tasks.detection.ltdetr import (
        ObjectDetectionArgs,
        ObjectDetectionTrainModel,
    )

    use_picodet = isinstance(model, str) and model.startswith("picodet")
    if isinstance(model, str) and not use_picodet:
        zoo = model.removesuffix("-coco")
        model = _LTDETRV2_ZOO.get(zoo, model.removesuffix("-ltdetr"))
    config = _config(out, model, kwargs)
    hw = (config.image_size, config.image_size)
    fmt = data.get("format", "yolo")

    def build(split: Dict[str, str]):
        if fmt == "coco":
            return COCOObjectDetectionDataset(
                Path(split["images"]), Path(split["annotations"]), hw,
                skip_if_annotations_missing=bool(
                    data.get("skip_if_annotations_missing", True)))
        return YOLOObjectDetectionDataset(Path(split["images"]),
                                          Path(split["labels"]), hw)

    train_ds = build(data["train"])
    val_ds = build(data["val"]) if "val" in data else None
    num_classes = int(data.get("num_classes")
                      or len(data.get("classes") or ())
                      or len(getattr(train_ds, "class_names", []) or [])
                      or 0)
    if num_classes <= 0:
        raise ConfigError(
            "num_classes could not be determined: pass data={'classes':"
            " {id: name, ...}, ...} or data={'num_classes': N, ...} (YOLO"
            " datasets carry no category list).")
    if use_picodet:
        from lightly_train_tpu_torch.tasks.detection.picodet import (
            PicoDetArgs,
            PicoDetTrainModel,
        )

        model_size = "l" if config.model.endswith("-l") else "s"
        task_args = config_validate(PicoDetArgs, {
            "num_classes": num_classes, "model_size": model_size,
            **config.task_args})
        train_model = PicoDetTrainModel(None, task_args)
        if config.checkpoint is not None:
            raise ConfigError(
                "checkpoint= is not supported for picodet models (the "
                "ESNet backbone trains from scratch like the reference "
                "PicoDet recipe); remove checkpoint= or pick a "
                "'<backbone>-ltdetr' model.")
        return run_task_training(
            config, train_model, train_ds, val_ds,
            {"model_name": config.model, "architecture": "picodet"}, None)
    task_args = config_validate(ObjectDetectionArgs, {
        "num_classes": num_classes, **config.task_args})
    wrapped, pretrained, meta = _load_backbone(config)
    meta["architecture"] = "ltdetr"
    return run_task_training(config,
                             ObjectDetectionTrainModel(wrapped, task_args),
                             train_ds, val_ds, meta, pretrained)
