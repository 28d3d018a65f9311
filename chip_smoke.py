#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, in parallel).
2. Hold each kernel against its plain PyTorch version on the card and time
   kernel, plain version and the nearest single PyTorch call
   (``library_ms``): the attention kernels K1/K2 (flat layout) in bf16 and
   fp32 at the ViT-B/14 global and local shapes, at N = 730 (ViT-B/14 on
   378^2 images), at head dim 16 (a small grid and the vittest14 shapes
   of phase 3e) and, in fp32, at the frozen DINOv3 ViT-B/16 teacher's
   shape of phase 3f (N = 201), at ECViT-S's global shape of phase 3p
   (64, 197, 6, 64) in both dtypes, at its local shape (192, 37, 6, 64) in
   bf16, and in fp32 at the shapes of the fp32 checks of 3o and 3p (the
   teacher's (4, 54, 12, 64), ECViT-S+'s (4, 50, 6, 64)), and in both
   dtypes at ``evaluate_knn``'s batch of phase 3q (256, 257, 12, 64), and
   at fine-tuning's shapes of phase 3r (bf16 (128, 257, 12, 64) and (16,
   257, 12, 64), fp32 (8, 257, 12, 64)), and in bf16 at ECViT-T's shape of
   phase 3t (16, 197, 3, 64); the script fails if 3o, 3p, 3q, 3r, 3s or
   3t launched K1 or K2 at a shape phase 2 did not hold; K1/K2
   at head dim 128 in both dtypes at
   the 7B teacher's and 7B student's shape of phases 3j and 3l, the 7B
   embed shape of phase 3k, at N = 37 and at N = 730; K4/K5
   (``vmem_attention``) in both layouts and dtypes at the ViT-B/14
   shapes and at the 7B embed shape, and in ``vmem_attention``'s layout at
   the hd-16 ones; every backward run twice and held bitwise equal to
   itself; K3, one launch over the
   ViT-B/14 leaves and synthetic ones that exercise its chunk plan (ragged
   sizes, a leaf of no gradient), with lr 0 (bitwise), over two steps of
   ``FusedAdamWEMA`` with every gradient reallocated in between, at several
   chunk sizes, and ``update_and_apply`` on the main path's model
   (``time_update.py``: its host time, ``update_host_ms``).
   In fp32 a control checks the tolerance itself: the kernels fed inputs
   rounded to bf16 must fail it (each output's verdict is printed). The
   SASS of every attention library (each forward and backward, both
   dtypes, at every head dim) must hold wgmma (HGMMA) instructions; that
   of the three that fill rings with cp.async (the bf16 forward and
   backward, ``flat_attention_fwd_sm90.cu`` and
   ``flat_attention_bwd_sm90.cu``, and the fp32 forward, whose two-pass
   hd-128 and hd-16 kernels land their rows by cp.async) LDGSTS too; and
   that of both forwards UTMALDG (the TMA loads of their hd-128 kernel for
   64 < N <= 304, ``attention_fwd_hd128_resident.cuh``; the fp32 hd-64
   forward and backward, ``flat_attention_fwd_f32_sm90.cu`` and
   ``flat_attention_bwd_f32_sm90.cu``, load with ld.global and split in
   registers); no library's SASS may hold the warp-level mma.sync
   (HMMA), and no build log a ptxas warning that it serialized the wgmma
   products (the build's report, spills included, is printed for every
   kernel, the hd-128 ones too).
   Those times are device times (calls captured in a CUDA graph and
   replayed); ``host_ms`` is the kernel's time with its host-side launch
   (Python, ctypes, argument checks; K3's staging copy) included.
3. Run the main paths, each with every launch counter set to 0 just before
   and read just after: ``pretrain`` with DINOv2 on ViT-B/14 at batch 32 in
   bf16 (3) and in fp32 (3b) for 4 steps each on a folder of generated PPM
   images, checking finite losses, the launch counts, and the trained
   backbone against an fp32 CPU reference on a small input, and that
   every forward and backward went to the library its dtype routes to; and
   (3c) the public ``vmem_attention`` op, the one path of K4/K5, forward
   and backward in both dtypes. Phases 3 and 3b checkpoint only at the end,
   after the timed steps, and check the one step file and
   ``exported_models/exported_last`` it leaves. (3d) The rest of the loop a
   user runs: the bf16 main path interrupted after its step-2 checkpoint
   and resumed with ``resume_interrupted``, held against phase 3's
   uninterrupted run (losses of steps 3 and 4 within 1e-3 relative, the
   student within 1e-3 relative L2, and whether they were bitwise equal),
   with each checkpoint's save time and size; phase 3's
   ``augmentations.png`` (its PNG header); and ``embed`` of the 64 images
   with phase 3's exported artifact in fp32 (12 K1 launches on the fp32
   wgmma forward, no K2), held against an fp32 CPU reference, with its
   images per second. (3e) ``pretrain`` DINOv2 on vittest14 (width 32, 2
   heads: head dim 16) at batch 32 for 2 steps in bf16 and in fp32, on the
   same images, counters set to 0 just before and read just after: every
   forward and every backward on its dtype's wgmma library at hd 16,
   finite losses, the backbone against an fp32 CPU reference. (3f)
   ``pretrain`` at its defaults (no model, no method: distillation v3 of
   ViT-B/14 from a frozen DINOv3 ViT-B/16 teacher with LARS, batch 64 and
   queue 16 for the 64 images) for 4 steps in bf16 and 2 in fp32, counters
   set to 0 just before and read just after: per step 24 K1 launches (12
   of the fp32 teacher on the fp32 forward at N = 201, 12 of the student
   on its dtype's forward at N = 257), 12 K2 and no K3; finite losses, the
   queue full (16 rows), the student and the teacher against fp32 CPU
   references; then the bf16 run interrupted after its step-2 checkpoint
   and resumed, held against the uninterrupted one. (3g) DINOv2 ViT-B/14
   in bf16 with ``model_args={"remat_every": 2, "drop_path_rate": 0.1}``
   and Sinkhorn centering for 3 steps: K1 48 a step (6 blocks recomputed
   in each of the 2 student forwards), peak memory beside phase 3's; and
   one fixed batch stepped twice with and without remat (and with
   ``remat_policy="dots_saveable"``), the losses and parameters against
   the run without remat. (3h) The fp32 DINOv2 and distillation paths for
   2 steps under each ``LIGHTLY_TRAIN_MATMUL_PRECISION`` value: the TF32
   switches each run leaves, step times, peak memory, and the trained CLS
   against the fp32 CPU reference. (3i) vittest14 in bf16 with a parameter
   set to NaN after a chosen step: the capture, ``NaNDetectedError``
   naming the step, and ``replay_nan_capture`` on the card naming the
   poisoned parameter. (3j) ``pretrain`` distillation v3 of ViT-B/14 in
   bf16 from a frozen random DINOv3 7B/16 teacher (fp32, head dim 128,
   built on the card and drawn leaf by leaf) at batch 64 for 2 steps:
   per step 40 K1 launches of the teacher on the fp32 forward at
   (64, 201, 32, 128), 12 K1 and 12 K2 of the student at hd 64, no K3;
   finite losses, the teacher's CLS and patch features on 2 images
   against itself with the plain attention (IEEE fp32), the method's
   init time, step times, peak memory and the end-of-run checkpoint's
   size and save time; one more step under ``torch.profiler`` (the
   device's busy share, the teacher's K1 share, the five kernels that
   take the most device time). (3k) ``embed`` in bf16 at batch 64 with a
   DINOv2 7B/14 export (30 GiB, written by ``export_model`` from a model
   drawn on the card): 40 K1 launches on the bf16 forward at
   (64, 257, 32, 128), no K2; two images' embeddings against the same
   model with its kernels and with the plain attention; the export's
   write and load times, img/s and peak memory. (3l) ``pretrain``
   distillation v3 of a full-width, full-depth DINOv3 7B/16 student (head
   dim 128, drawn on the card) in bf16 with LARS at momentum 0 and
   ``model_args={"remat_every": 1}``, batch 64, for 2 steps: per step 80
   K1 launches of the student on the bf16 forward at (64, 201, 32, 128)
   (40 forward, 40 recomputed), 40 K2 on the bf16 backward there, 12 K1 of
   the fp32 ViT-B/16 teacher at (64, 201, 12, 64), no K3; finite losses,
   step times, peak memory, the checkpoint handed over at the end
   (counted, not written: 3j writes a 7B checkpoint) and the export
   written at the end (timed); one profiled step (the share of the
   device's time in K1 and K2); on one
   fixed batch, the student's gradients with the kernels held to those
   with K2's plain version in its place (5e-2 relative L2 on each checked
   leaf), and those with autograd through the plain forward written down;
   and DINOv2 with the same student refused, with the card's own
   capacity, before anything is allocated (so are the distillation
   student with AdamW and with LARS at momentum 0.9, offered
   ``adamw8bit``). (3m, run after 3i) A user's
   own files: the committed JPEG fixtures (``tests/torch_fixtures/
   images``) decoded on the card's host by the port's decoder to the
   digests of the JAX package's PIL decode in their ``manifest.json``;
   five PNGs written here (RGB, RGBA, palette, 16-bit, Adam7) decoded to
   their pixels; a folder of 64 files of both; the decoder's images per
   second at 256^2 on 1 and 8 threads beside what phase 3's bf16 step
   consumes, with the host's CPUs; ``pretrain`` DINOv2 ViT-B/14 bf16 from
   the folder warm-started from a Meta-named ``.pth`` (the initial student
   equal to its conversion; K1, K2 and K3 as phase 3's), distillation v3
   from a DINOv3-named ``.pth`` teacher (``storage_tokens``,
   ``bias_mask``; the teacher equal to its conversion), and ``embed`` of
   the folder. (3n, run after 3m) The other methods: ``pretrain`` with
   DINO (batch 32), SimCLR, DenseCL, DetCon-B, DetCon-S (batch 64) and
   DINOv31 (batch 32) on ViT-B/14 at full width, bf16, 4 steps each on
   phase 3's images, and DetCon-B with ``use_dataset_masks`` and a
   ``mask_dir`` of PNGs written here with ``zlib`` (palette, 8- and 16-bit
   gray; the card's machine has no PIL), counters set to 0 just before
   each run and read just after: K1, K2 and K3 a step as each method's
   forwards and backwards give them (K3 only for DINO and DINOv31, AdamW
   with an EMA teacher), every launch on the bf16 hd-64 libraries, no call
   of PyTorch's SDPA or of the plain attention, finite losses; one JSON
   line a run (steps 2-4 in ms, peak GiB, launches a step, the losses);
   then one fp32 step of each method on a fixed batch with the kernels
   against the same step with their plain versions (loss and gradients,
   held to the fp32 attention tolerances at LayerScale 0.5, printed at
   the seeded init). (3o, run after 3n) CNN students and adamw8bit:
   ``pretrain(model="torchvision/resnet50")`` at its defaults
   (distillation v3 from the frozen DINOv3 ViT-B/16, batch 64, LARS), DINO
   on ResNet-50 (batch 32), ``dinov3/convnext-tiny`` and
   ``rtdetr/rtdetr_r50vd`` by distillation and ``dinov2/vitb14`` by
   distillation with ``optim="adamw8bit"`` (batch 64), bf16, 3 steps each,
   counters set to 0 just before each run and read just after: K1 12 fp32
   a step (the teacher) in the distillation runs, 24 and K2 12 in the
   ViT-B/14 one, K3 1 a step in DINO, no SDPA or plain attention; finite
   losses, the BatchNorm running statistics finite and moved, and DINO's
   EMA teacher reading the student's statistics; ``embed`` of the
   ResNet-50 export against an eval-mode forward of the exported weights;
   ResNet-50 distillation for 2 fp32 steps on the card against the same
   steps on the CPU (1e-2); and the ``dinov3/vit7b16`` student of 3l with
   ``adamw8bit`` for 2 steps (K1 92, K2 40 a step), its peak printed
   beside ``refuse_pretraining``'s count of its state (no checkpoint or
   export written). (3p, run after 3o) The last backbones of item 10:
   ``pretrain(model="ecvit/ecvitsplus")`` at its defaults (distillation v3
   from the frozen DINOv3 ViT-B/16, batch 64, LARS), DINO on
   ``ecvit/ecvits`` (batch 32), ``ultralytics/yolov8x``, ``yolov5x`` and
   ``yolo11x`` by distillation (batch 64), DINO on
   ``super_gradients/yolo_nas_l`` (batch 32) and ``pretrain(model=...)``
   of a torch CNN with ``nn.BatchNorm2d`` defined here, bf16, 3 steps
   each, counters set to 0 just before each run and read just after: the
   ECViT students' K1 and K2 at (64, 197, 6, 64) (and DINO's locals at
   (192, 37, 6, 64)), the teacher's 12 fp32 K1 a step in every
   distillation run, K3 1 a step in DINO, no SDPA or plain attention;
   finite losses, the running statistics finite and moved, each EMA
   teacher reading the student's; ``embed`` of the ECViT-S+ export
   against an eval-mode forward; ECViT-S+ distillation for 2 fp32 steps
   on the card against the CPU (1e-2, the parameters' change too), its
   launches counted. (3q, run after 3p) The rest of pretraining's
   surface: phase 3's bf16 DINOv2 run with ``embed_dim`` 256,
   ``profile=True`` over steps 2-3 and the tensorboard, wandb and mlflow
   loggers (launches as phase 3's; the trace under ``out/profile`` naming
   K1, K2 and K3 and no flash or memory-efficient kernel; each absent
   logger package warned; the memory-mapped file list present with one
   reference during the run and gone after); ``export`` of its export in
   the three formats and two parts (``embed`` of the re-export against the
   original; the Meta-named ``torch_state_dict`` given back as
   ``checkpoint=``); ``evaluate_knn`` of it on a class folder of 512 train
   and 128 val images at its defaults (batch 256: 12 K1 a batch at (256,
   257, 12, 64)) in fp32 under ``LIGHTLY_TRAIN_MATMUL_PRECISION=highest``
   and at the default and in bf16, the embeddings of 16 images against
   the port's CPU run and the accuracy against the CPU's ``knn_accuracy``
   of the same embeddings; and the CLI in a subprocess (``list_models``,
   and ``pretrain`` of DINOv2 ViT-B/14 for 2 steps at phase 3's batch, its
   launches counted in the subprocess and held to phase 3's). (3r, after
   3q) Fine-tuning from phase 3's export at ViT-B/14 width, bf16, 4 steps
   each: ``train_image_classification`` at its default batch of 128 (the
   backbone trained: K1 and K2 12 a step at (128, 257, 12, 64), K1 12 a
   val batch) and linear ``train_semantic_segmentation`` at its default
   batch of 16 (frozen: K1 12 a step at (16, 257, 12, 64), no K2; val at
   448^2 in 9 tiles, 108 K1 a val batch), each val batch's launches
   counted around it and a step's from the rest, K3 0 and no SDPA or plain
   attention in either, finite losses, the val metric keys,
   ``exported_best`` and ``exported_last``, step times, peak memory and
   the val step's time; both multihead entry points at vittest14 (K1 at
   (8, 257, 2, 16) only), the classification one stopped after its step-2
   checkpoint and resumed (the restored state bitwise the checkpoint's,
   every loss bitwise the uninterrupted run's, and the two runs' launches
   its launches); one fp32
   step of the classification path on 8 images
   (SGD, LayerScale 0.5, ``highest``) on the card against the port's CPU
   path, the loss, the parameters and their change within 1e-2, its 12 K1
   and 12 K2 fp32 at (8, 257, 12, 64). (3s, after 3r) EoMT from phase 3's
   export at ViT-B/14 width, bf16, batch 16, 100 queries in the last 3
   blocks, at the default slot counts: ``train_semantic_segmentation``
   with ``dinov2/vitb14-eomt`` on masks of 150 classes (32 active slots)
   for 4 steps, validated at 448^2 in 9 tiles, and
   ``train_instance_segmentation`` on a COCO JSON of polygons and RLEs and
   on a YOLO-seg folder and ``train_panoptic_segmentation`` on id-encoded
   panoptic PNGs, 48 shapes an image, all written here, at 50 slots for 3
   steps each, validated at 224^2:
   a train step K1 and K2 9 each at (16, 257, 12, 64) (the plain blocks)
   and 3 masked plain attentions (the joint blocks), a val batch K1 9 at
   257 and 3 at (16, 357, 12, 64) a tile and no masked attention, K3 0, no
   SDPA or unmasked plain attention, finite losses and val metrics, the
   exports' ``architecture`` "eomt"; a panoptic run at vittest14 with one
   joint block, and the same run stopped after its step-2 checkpoint and
   resumed (the restored state and every loss bitwise the uninterrupted
   run's, both runs' launches those of the uninterrupted one, as in 3r);
   one fp32 semantic
   step at
   vittest14 on the card against the CPU (the same uniforms, the Hungarian
   matcher: assignments equal, the loss within 1e-4, the parameters'
   change within 1e-2). (3t, after 3s) LT-DETR detection from phase 3's
   export: ``train_object_detection`` of ``dinov2/vitb14-ltdetr`` at the
   JAX defaults (D-FINE, 300 queries, 2 denoising groups, the EMA), bf16,
   batch 16, on YOLO labels and on a COCO JSON of 24-40 boxes an image in
   80 classes that the phase writes for phase 3's images (K1 and K2 12 a
   step at (16, 257, 12, 64), K1 12 a val batch), ``ltdetrv2-s`` (ECViT-T,
   random init: K1 and K2 12 a step at (16, 197, 3, 64)), each with its
   step ms, val batch ms, peak GiB and the host's Hungarian and GO-union
   syncs a step; ``vittest14-ltdetr`` with the RT-DETRv2 decoder, every
   window on and rotate-90, stopped after its step-2 checkpoint and resumed
   (the restored state and every loss bitwise the uninterrupted run's);
   one fp32 step at
   vittest14 on the card against the CPU (the same denoising draws, the
   Hungarian matcher: the loss within 1e-5, the parameters' change within
   1e-3 where the CPU's gradient is not 0 to rounding). (3u, after 3t)
   LT-DETR instance segmentation and PicoDet: ``train_instance_segmentation``
   of ``dinov2/vitb14-ltdetr`` from phase 3's export at the JAX defaults
   (D-FINE, 300 queries, the EdgeCrafter mask head, 50 slots), bf16, batch
   16, on 3s's COCO instance JSON (K1 and K2 12 a step at (16, 257, 12,
   64), K1 12 a val batch), ``ecvit/ecvitt-ltdetr`` (K1 and K2 12 a step at
   (16, 197, 3, 64)), ``picodet-s`` at 416^2 and ``picodet-l`` at 640^2 on
   3t's YOLO boxes (no K1, K2 or K3), each with its step ms, val batch ms,
   peak GiB and host syncs a step, PicoDet's stem cost by unfold and by
   cuDNN; ``vittest14-ltdetr`` segmentation with the linear head and
   PicoDet at its test preset, each stopped after its step-2 checkpoint and
   resumed (bitwise); one fp32 step of each new model on the card against
   the CPU (held as 3t's; PicoDet with its BatchNorms on their running
   statistics, and in train mode printed). 3j, 3k, 3m, 3r, 3s, 3t and 3u
   delete what they wrote.
   Each phase's wall time is printed. ``pretrain`` applies
   ``LIGHTLY_TRAIN_MATMUL_PRECISION`` (TF32 in the fp32 GEMMs and
   convolutions by default), so every path runs under ``default`` unless a
   phase sets it, and IEEE fp32 is pinned back before any plain version
   runs.

The kernels run unless ``LIGHTLY_TRAIN_VMEM_ATTENTION`` turns them off, and
then this check fails.

``--profile`` adds a phase 4: a ``torch.profiler`` window over a few
training steps in each precision (fp32 under the variable, as ``pretrain``
runs it), printing the device's busy share and the kernels that take the
most device time.

``--only-3t`` (``--only-3u``) runs phase 1, phase 3's bf16 run (for its
export) and phase 3t (3u), and prints the contract's last two lines but no
kernels line.

``--7b-lars`` runs phase 1 and then only the DINOv3 7B/16 distillation
student with LARS at momentum 0.9 (``run_7b_lars``): its peak memory, or
where it does not fit the point at which it ran out, beside
``refuse_pretraining``'s count, which must refuse it with the card's
capacity exactly when it does not fit.

Prints the card's name and power limit, one JSON line with every kernel's
results, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it prints no result
and exits with 1.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor peak
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor peak
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0
BATCH = 32
STEPS = 4
HEADS, HEAD_DIM = 12, 64
# (B, N, H, hd) of ViT-B/14's attention: 2 global views x batch at 224^2
# (16 x 16 patches + CLS), 8 local views x batch at 96^2 (6 x 6 + CLS).
GLOBAL = (2 * BATCH, 257, HEADS, HEAD_DIM)
LOCAL = (8 * BATCH, 37, HEADS, HEAD_DIM)
# The global views at 378^2 (27 x 27 patches + CLS), at batch 32 and 8.
GLOBAL_378 = (2 * BATCH, 730, HEADS, HEAD_DIM)
GLOBAL_378_B8 = (16, 730, HEADS, HEAD_DIM)
# vittest14 (width 32, 2 heads: hd 16), the model of the port's CPU runs:
# its attention in pretrain at batch 32 (phase 3e), and a small grid.
VITTEST_STEPS = 2
VITTEST_GLOBAL = (2 * BATCH, 257, 2, 16)
VITTEST_LOCAL = (8 * BATCH, 37, 2, 16)
HD16_SMALL = (8, 257, 2, 16)
# Phase 3f: ``pretrain`` at its defaults on the 64 images: batch
# min(1536, 64) = 64 of one view, queue 16 (fewer than 1000 images); the
# frozen DINOv3 ViT-B/16 teacher at 224^2 (14 x 14 patches + CLS + 4
# registers) in fp32 in every precision, the ViT-B/14 student at GLOBAL.
DISTILL_BATCH = 2 * BATCH
TEACHER = (DISTILL_BATCH, 201, HEADS, HEAD_DIM)
DISTILL_STEPS = {"bf16": 4, "fp32": 2}
DISTILL_QUEUE = 16
DISTILL_KEYS = ("train_loss", "loss_global", "loss_local", "grad_norm")
# ViT-B/14's blocks.
DEPTH = 12
# The 7B ViTs (width 4096, 32 heads: head dim 128, 40 blocks). Phase 3j:
# distillation v3 of ViT-B/14 from a frozen random DINOv3 7B/16 teacher
# (fp32 in every precision) at 224^2: 196 patches + CLS + 4 registers.
# Phase 3k: embed with a DINOv2 7B/14 export in bf16 at 224^2: 256 patches
# + CLS. Phase 3l: distillation v3 of a DINOv3 7B/16 student in bf16 (its
# attention at TEACHER_7B's shape) from the default ViT-B/16 teacher, with
# LARS at momentum 0 (parameters and gradients alone: 2 fp32 copies, 50
# GiB) and every block recomputed in the backward. All at batch 64. Phase 2
# adds an N <= 64 shape and N = 730 (the 7B/14 on 378^2 images).
HEADS_7B, HEAD_DIM_7B, DEPTH_7B = 32, 128, 40
TEACHER_7B = (DISTILL_BATCH, 201, HEADS_7B, HEAD_DIM_7B)
EMBED_7B = (DISTILL_BATCH, 257, HEADS_7B, HEAD_DIM_7B)
LOCAL_7B = (DISTILL_BATCH, 37, HEADS_7B, HEAD_DIM_7B)
GLOBAL_378_7B = (16, 730, HEADS_7B, HEAD_DIM_7B)
TEACHER_7B_STEPS = 2
STUDENT_7B = "dinov3/vit7b16"
STUDENT_7B_STEPS = 2
STUDENT_7B_ARGS = {"method": "distillationv3",
                   "optim_args": {"momentum": 0.0},
                   "model_args": {"remat_every": 1}}
# The student leaves whose gradients phase 3l holds to those with K2's
# plain version: the first and last blocks' attention and MLP, a middle
# block, the tokens and the patch embedding.
STUDENT_7B_LEAVES = (
    "student.cls_token", "student.patch_embed.weight",
    "student.blocks.0.attn.q.weight", "student.blocks.0.mlp.w1.weight",
    "student.blocks.20.attn.k.weight", "student.blocks.39.attn.v.weight",
    "student.blocks.39.mlp.w2.weight", "student.norm.weight",
)
# Phase 3g: DINOv2 bf16 with activation checkpointing every 2nd block,
# drop path 0.1 and Sinkhorn centering; the fixed-batch comparison's
# variants (the model_args of each beside drop path 0.1).
REMAT = {"remat_every": 2, "drop_path_rate": 0.1}
REMAT_STEPS = 3
REMAT_VARIANTS = {
    "no remat": {},
    "remat": {"remat_every": 2},
    "remat dots_saveable": {"remat_every": 2,
                            "remat_policy": "dots_saveable"},
}
# Phase 3h: the fp32 steps under each LIGHTLY_TRAIN_MATMUL_PRECISION value
# (TF32 in the CUDA fp32 GEMMs and convolutions, or not); the trained CLS
# is held to 1e-2 in each (check_backbone).
PRECISIONS = {"default": True, "high": True, "highest": False}
PRECISION_STEPS = 2
# Phase 3i: vittest14 in bf16 for NAN_STEPS steps, checkpointing every
# NAN_STEP steps, with NAN_LEAF set to NaN once state step NAN_STEP has run
# (before that step's checkpoint is written): state step NAN_STEP is the
# first non-finite step, step NAN_STEP + 1 of metrics.jsonl.
NAN_STEPS, NAN_STEP = 4, 2
NAN_LEAF = "student.blocks.1.mlp.fc1.weight"
# Phase 3m: a user's own files. The committed JPEG fixtures (with the
# digests of the JAX package's PIL decode in their manifest) and PNGs
# written here fill a folder of FILES_COUNT files; DINOv2 ViT-B/14 bf16
# warm-started from a Meta-named .pth for FILES_STEPS steps, distillation
# v3 from a Meta-named DINOv3 ViT-B/16 .pth teacher for
# FILES_DISTILL_STEPS, then embed of the folder. FILES_DECODES decodes of
# the large (draft-scale) fixtures time the decoder on the card's host.
FIXTURES = ROOT / "tests" / "torch_fixtures" / "images"
FILES_COUNT = 64
FILES_STEPS = 3
FILES_DISTILL_STEPS = 2
FILES_DECODES = 48
FILES_MODEL, FILES_TEACHER = "dinov2/vitb14", "dinov3/vitb16"
# Phase 3n: the other methods. ``pretrain`` with each on ViT-B/14 at full
# width, 224^2, bf16, METHODS_STEPS steps on phase 3's images: run ->
# (method, batch, method_args, K1, K2 a step in blocks of ViT-B/14, K3 a
# step). K1 runs once a block in every forward (teacher and student, each
# view group), K2 once a block in every student backward; K3 once a step
# for AdamW with an EMA teacher (DINO, DINOv31), the unfused chain
# otherwise (SimCLR and DetCon: LARS; DenseCL: SGD).
METHODS_STEPS = 4
METHOD_RUNS = {
    # 2 global views: teacher (1 forward), student (globals, locals).
    "dino": ("dino", 32, {}, 3, 2, 1),
    # One student forward over both views.
    "simclr": ("simclr", 64, {}, 1, 1, 0),
    # Student on view 0, EMA teacher on view 1.
    "densecl": ("densecl", 64, {}, 2, 1, 0),
    "detconb": ("detconb", 64, {}, 2, 1, 0),
    # Two student forwards, no teacher.
    "detcons": ("detcons", 64, {}, 2, 2, 0),
    # DINOv2's 3 and 2, and PaKA's teacher (clean view) and student (g1).
    "dinov31": ("dinov31", 32, {}, 5, 3, 1),
    # Region masks from a mask_dir of PNGs written here (palette, 8-bit and
    # 16-bit gray; every fourth image without one).
    "detconb_mask_dir": ("detconb", 64, {"use_dataset_masks": True}, 2, 1,
                         0),
}
# Phase 3n's fp32 step with the kernels against the same step with their
# plain versions: the fp32 attention tolerances of phase 2 (PERF.md, the
# kernel table), each gradient leaf's max-abs error within 2^-7 of its
# largest magnitude and the relative L2 of the whole gradient (every leaf
# as one vector, as phase 2 holds each output tensor) and of the loss
# within 1e-3; or, where larger, the plain versions' own distance from the
# exact attention (``exact_attention``: p not rounded to bf16). Both round
# p and ds to bf16 from products 2^-16 apart, so some roundings go the
# other way; a step whose gradient cancels (a contrastive loss near
# uniform, KoLeo's vanishing distances at the init) magnifies that beyond
# 1e-3 in both (SimCLR 2.6e-3, DenseCL 1.2e-3 at LayerScale 0.5 on an
# NVIDIA H100 80GB HBM3 at 700 W), and the kernels stay no further from
# the exact attention than the plain versions are. Each leaf's relative L2
# is printed, not held.
METHODS_FP32_TOL = (2.0 ** -7, 1e-3)
# Phase 3o: CNN students and adamw8bit, on phase 3's images at 224^2,
# bf16, CNN_STEPS steps each: run -> (model, method, batch, other pretrain
# options, K1 fp32, K1 bf16, K2, K3 a step). Distillation's frozen DINOv3
# ViT-B/16 teacher launches 12 fp32 K1 a step at TEACHER, whatever the
# student; a CNN student launches no attention; DINO's AdamW with an EMA
# teacher takes K3 once a step. (a) is ``pretrain`` at its defaults
# (distillation v3, LARS, batch min(1536, 64)) with a ResNet-50.
CNN_STEPS = 3
CNN_RUNS = {
    "a_resnet50": ("torchvision/resnet50", None, None, {}, DEPTH, 0, 0, 0),
    "b_dino_resnet50": ("torchvision/resnet50", "dino", BATCH, {}, 0, 0, 0,
                        1),
    "c_convnext_tiny": ("dinov3/convnext-tiny", "distillation",
                        DISTILL_BATCH, {}, DEPTH, 0, 0, 0),
    "d_rtdetr_r50vd": ("rtdetr/rtdetr_r50vd", "distillation", DISTILL_BATCH,
                       {}, DEPTH, 0, 0, 0),
    "e_vitb14_adamw8bit": ("dinov2/vitb14", "distillation", DISTILL_BATCH,
                           {"optim": "adamw8bit"}, DEPTH, DEPTH, DEPTH, 0),
}
# (g): the DINOv3 7B/16 student of phase 3l with adamw8bit in place of
# LARS at momentum 0 (int8 moments: about 10 bytes a parameter), every
# block recomputed, for CNN_7B_STEPS steps.
CNN_7B_STEPS = 2
CNN_7B_ARGS = {"method": "distillationv3", "optim": "adamw8bit",
               "model_args": {"remat_every": 1}}
# (a)'s check: ResNet-50 distillation, fp32, CNN_FP32_STEPS steps on one
# fixed batch of CNN_FP32_BATCH images at CNN_FP32_SIZE^2 (small, for the
# CPU's side), on the card against the CPU: the parameters after the
# steps, the running statistics and the losses within 1e-2 relative L2
# (and the parameters' change for 3p (g)'s ECViT-S+; ``check_cnn_fp32``).
CNN_FP32_STEPS, CNN_FP32_BATCH, CNN_FP32_SIZE = 2, 4, 112
# Phase 3p: the last backbones of item 10, on phase 3's images at 224^2,
# bf16, ITEM10_STEPS steps each: run -> (model, method, batch, K1 fp32 by
# shape, K1 bf16 by shape, K2 by shape, K3, all a step). ECViT-S and S+
# (width 384, 6 heads: hd 64) take 14 x 14 patch tokens and a register
# token at 224^2 and 6 x 6 and the register at DINO's 96^2 locals; their
# 12 blocks launch K1 once each a forward and K2 once each a backward.
# The ultralytics and YOLO-NAS CNNs launch no attention kernel (YOLO11's
# C2PSA attends in plain products, as the JAX package does). (a) is
# ``pretrain`` at its defaults with ECViT-S+; "module" is a user's own
# torch CNN (``user_cnn``) at ``pretrain``'s defaults.
ECVIT_HEADS = 6
ECVIT_GLOBAL = (DISTILL_BATCH, 197, ECVIT_HEADS, HEAD_DIM)
ECVIT_LOCAL = (6 * BATCH, 37, ECVIT_HEADS, HEAD_DIM)
# The fp32 checks on one batch of CNN_FP32_BATCH at CNN_FP32_SIZE^2 (3o (a)'s
# and 3p (g)'s ``check_cnn_fp32``): ECViT-S+'s 7 x 7 patch tokens and its
# register; the DINOv3 ViT-B/16 teacher's 7 x 7, its CLS and 4 registers.
ECVIT_FP32 = (CNN_FP32_BATCH, (CNN_FP32_SIZE // 16) ** 2 + 1, ECVIT_HEADS,
              HEAD_DIM)
TEACHER_FP32_CHECK = (CNN_FP32_BATCH, (CNN_FP32_SIZE // 16) ** 2 + 5, HEADS,
                      HEAD_DIM)
ITEM10_STEPS = 3
_TEACHER_K1 = {TEACHER: DEPTH}
ITEM10_RUNS = {
    "a_ecvitsplus": ("ecvit/ecvitsplus", None, None, _TEACHER_K1,
                     {ECVIT_GLOBAL: DEPTH}, {ECVIT_GLOBAL: DEPTH}, 0),
    "b_dino_ecvits": ("ecvit/ecvits", "dino", BATCH, {},
                      {ECVIT_GLOBAL: 2 * DEPTH, ECVIT_LOCAL: DEPTH},
                      {ECVIT_GLOBAL: DEPTH, ECVIT_LOCAL: DEPTH}, 1),
    "c_yolov8x": ("ultralytics/yolov8x", "distillation", DISTILL_BATCH,
                  _TEACHER_K1, {}, {}, 0),
    "c_yolov5x": ("ultralytics/yolov5x", "distillation", DISTILL_BATCH,
                  _TEACHER_K1, {}, {}, 0),
    "c_yolo11x": ("ultralytics/yolo11x", "distillation", DISTILL_BATCH,
                  _TEACHER_K1, {}, {}, 0),
    "d_dino_yolo_nas_l": ("super_gradients/yolo_nas_l", "dino", BATCH, {},
                          {}, {}, 1),
    "e_torch_module": ("module", None, None, _TEACHER_K1, {}, {}, 0),
}


# Phase 3q: the rest of pretraining's surface on one card. (a) The bf16
# main path of phase 3 with the trace window over steps 2-3
# (SURFACE_PROFILE), the three logger backends (each writes where its
# package imports and warns where it does not) and ``embed_dim`` (so that
# both parts export); (b) ``export`` of its
# export in every format and part; (c) ``evaluate_knn`` of that export on a
# class folder of KNN_CLASSES classes (KNN_TRAIN train and KNN_VAL val
# images at 256^2) at its defaults: batch 256 at 224^2, KNN_SHAPE, 12 K1 a
# batch; its fp32 embeddings against the port's CPU run on KNN_CPU_IMAGES
# of them; (d) the CLI in a subprocess: ``list_models``, and the main path
# of phase 3 for CLI_STEPS steps with the launches counted in the subprocess
# (CLI_CHILD: ``python -m lightly_train_tpu_torch`` through ``runpy``, as
# ``-m`` runs it, then the counts printed as one line).
SURFACE_PROFILE = {"profile": True, "profile_start": 1, "profile_steps": 2}
SURFACE_LOGGERS = {"tensorboard": {}, "wandb": {}, "mlflow": {}}
SURFACE_EMBED_DIM = 256
KNN_CLASSES, KNN_TRAIN, KNN_VAL = 4, 512, 128
KNN_BATCH = 256
KNN_SHAPE = (KNN_BATCH, 257, HEADS, HEAD_DIM)
KNN_BATCHES = -(-KNN_TRAIN // KNN_BATCH) + -(-KNN_VAL // KNN_BATCH)
KNN_CPU_IMAGES = 16
# The fp32 embeddings' relative L2 from the CPU's: IEEE fp32 GEMMs
# (``highest``) leave the kernels' bf16 p as the only difference; TF32
# GEMMs round each GEMM input to 2^-11 relative. On an H100 the two read
# 3.9e-5 and 9.6e-5, and the same path in bf16 8.0e-3: 1e-3 under TF32 is
# ten times the sound reading and fails an fp32 run that went bf16.
KNN_TOL = {"highest": 1e-4, "default": 1e-3}
CLI_STEPS = 2
CLI_CHILD = """
import json, runpy, sys
from lightly_train_tpu_torch._optim import fused_update as F
from lightly_train_tpu_torch.ops.kernels import attention as A
sys.argv[0] = "lightly_train_tpu_torch"
try:
    runpy.run_module("lightly_train_tpu_torch", run_name="__main__",
                     alter_sys=True)
finally:
    print("launches " + json.dumps({
        "launches": [fn.launches for fn in (
            A.flat_attention_fwd, A.flat_attention_bwd, F.fused_adamw_ema,
            A.vmem_attention_fwd, A.vmem_attention_bwd)],
        "by_shape": [[lib, [b, n, h, hd], c] for (lib, (b, h, n, hd)), c
                     in A.shape_launches.items()]}), flush=True)
"""

# Phase 3r: fine-tuning (ROADMAP item 12) at ViT-B/14 width, warm-started
# from phase 3's bf16 DINOv2 export, bf16, FT_STEPS steps each. (a)
# ``train_image_classification`` at its default batch of 128 on two class
# folders of FT_TRAIN images each (FT_VAL val images each), the backbone
# trained: K1 and K2 12 a step at FT_CLS, K1 12 a val batch; (b) linear
# ``train_semantic_segmentation`` at its default batch of 16 (backbone
# frozen: no K2) on phase 3's images with FT_SEG_CLASSES-class masks,
# validated at FT_VAL_SIZE^2 on FT_SEG_VAL images in FT_TILES tiles of
# 224^2, 12 K1 a tile; (c) the two multihead entry points at vittest14
# (hd 16, batch 8: HD16_SMALL), the classification one FT_MH_STEPS steps,
# stopped after its step-2 checkpoint and resumed; (d) one fp32 step of
# (a)'s path on 8 images (FT_FP32) on the card against the port's CPU path.
FT_MODEL, FT_STEPS = "dinov2/vitb14", 4
FT_TRAIN, FT_VAL = 64, 32
FT_CLS = (2 * FT_TRAIN, 257, HEADS, HEAD_DIM)
FT_SEG = (16, 257, HEADS, HEAD_DIM)
FT_SEG_CLASSES, FT_SEG_VAL, FT_VAL_SIZE, FT_TILES = 8, 16, 448, 9
FT_MH_STEPS, FT_MH_BATCH = 4, 8
FT_FP32 = (8, 257, HEADS, HEAD_DIM)
FT_NO_AUG = {"random_crop": None, "random_flip": None, "color_jitter": None}

# Phase 3s: EoMT (ROADMAP item 13) at ViT-B/14 width from phase 3's bf16
# export, bf16, batch 16 (EoMT's default), 100 queries in the last
# EOMT_JOINT blocks (the auto count at depth 12): a train step runs K1 and
# K2 EOMT_PLAIN times at FT_SEG and the plain masked attention EOMT_JOINT
# times (at (16, 12, 357, 357)); a val batch runs K1 EOMT_PLAIN times at
# FT_SEG and EOMT_JOINT times at EOMT_QUERIES_SHAPE a tile, no masked
# attention. (a) train_semantic_segmentation with "-eomt" on phase 3's
# images and EOMT_SEG_CLASSES-class masks, EOMT_STEPS steps, validated at
# FT_VAL_SIZE^2 in FT_TILES tiles; (b) train_instance_segmentation on a
# COCO JSON of polygons and RLEs and on a YOLO-seg folder, (c)
# train_panoptic_segmentation on id-encoded panoptic PNGs, EOMT_TASK_STEPS
# steps each, validated at 224^2; then a stopped and resumed panoptic run
# at vittest14 with one joint block (K1 and K2 at HD16_SMALL in its plain
# block); (d) one fp32 semantic step at vittest14 on the card against the
# CPU, the same uniforms and the Hungarian matcher on both.
EOMT_MODEL, EOMT_STEPS, EOMT_TASK_STEPS = "dinov2/vitb14-eomt", 4, 3
EOMT_QUERIES, EOMT_JOINT = 100, 3
EOMT_PLAIN = DEPTH - EOMT_JOINT
EOMT_QUERIES_SHAPE = (16, 257 + EOMT_QUERIES, HEADS, HEAD_DIM)
# (a) at EoMT's defaults: ADE20K's 150 classes, in 16-pixel blocks (more
# than 32 classes an image, so the default max_active_slots of 32 binds);
# (b) and (c) at the default max_instances of 50, with EOMT_SHAPES shapes
# an image (COCO: octagons and one RLE rectangle; panoptic: rectangles,
# one of them a crowd) of COCO's EOMT_CLASSES thing classes.
EOMT_VAL, EOMT_SEG_CLASSES, EOMT_SEG_BLOCK = 16, 150, 16
EOMT_CLASSES, EOMT_SHAPES, EOMT_SLOTS = 80, 48, 50
EOMT_NO_AUG = {"scale_jitter": None, "random_crop": None,
               "random_flip": None, "color_jitter": None}
EOMT_SMALL = {"model": "dinov2/vittest14-eomt", "batch_size": 8,
              "task_args": {"num_joint_blocks": 1, "max_instances": 8}}

# Phase 3t: LT-DETR detection (ROADMAP items 14.1, 14.2), bf16, batch 16
# at 224^2 on phase 3's images (train) and DET_VAL more (val), with YOLO
# labels and a COCO JSON of DET_BOXES_MIN to DET_BOXES_MAX boxes an image in
# DET_CLASSES classes. (a) dinov2/vitb14-ltdetr from phase 3's export at
# the JAX defaults (D-FINE, 300 queries, dn_groups 2, the EMA), DET_STEPS
# steps and one validation on each format: K1 and K2 DEPTH times a step at
# FT_SEG, K1 DEPTH times a val batch. (b) ltdetrv2-s (ECViT-T, random
# init) on YOLO: K1 and K2 12 times a step at DET_ECVIT. (c)
# vittest14-ltdetr with the RT-DETRv2 decoder, every window on from step 0
# and rotate90_prob 0.5, batch 8 (K1/K2 at HD16_SMALL), stopped after its
# step-2 checkpoint and resumed. (d) one fp32 step at vittest14 on the card
# against the CPU (the same denoising draws, the Hungarian matcher).
DET_MODEL, DET_STEPS, DET_VAL, DET_CLASSES = "dinov2/vitb14-ltdetr", 4, 16, 80
DET_BOXES_MIN, DET_BOXES_MAX = 24, 40
DET_ECVIT = (16, 197, 3, HEAD_DIM)
DET_WINDOWS = {"decoder": "rtdetrv2", "mosaic_window": [0, 1000],
               "mixup_window": [0, 1000], "zoom_out_window": [0, 1000],
               "rotate90_prob": 0.5}

# Phase 3u: LT-DETR instance segmentation and PicoDet (ROADMAP items 14.3,
# 14.4), batch 16, on the COCO instance JSON of phase 3s's writer (phase
# 3's images, EOMT_SHAPES shapes an image in EOMT_CLASSES classes, its
# EOMT_VAL validation images) and the YOLO boxes of phase 3t's writer.
# (a) train_instance_segmentation dinov2/vitb14-ltdetr from phase 3's
# export at the JAX defaults (D-FINE, 300 queries, 3 decoder layers, the
# EdgeCrafter mask head, EOMT_SLOTS slots), bf16, SEG_STEPS steps and one
# validation: K1 and K2 DEPTH times a step at FT_SEG, K1 DEPTH times a val
# batch. (b) the same with ecvit/ecvitt-ltdetr (random init): K1 and K2
# 12 times a step at DET_ECVIT. (c) picodet-s at 416^2 and picodet-l at
# 640^2 (fp32 in every precision, as in the JAX package), PICO_STEPS
# steps and one validation each: no K1, K2 or K3; each stem's cost, by
# unfold (the path's) and by cuDNN. (d) vittest14-ltdetr segmentation with
# the linear head and PicoDet at its test preset, each stopped after its
# step-2 checkpoint and resumed, bitwise. (e) one fp32 step of each new
# model on the card against the CPU.
SEG_MODEL, SEG_ECVIT, SEG_STEPS = ("dinov2/vitb14-ltdetr",
                                   "ecvit/ecvitt-ltdetr", 3)
PICO_RUNS = {"picodet-s": 416, "picodet-l": 640}
PICO_STEPS, PICO_TEST_SIZE = 3, 160

# The phase running now and when it started (``phase``).
_CLOCK = {"name": None, "t0": 0.0}


def phase(msg: str, **kwargs) -> None:
    """Prints ``msg`` ("phase <id>: ..."); when <id> differs from the
    phase running, first that phase's wall time."""
    name = msg.split(":")[0]
    if name != _CLOCK["name"]:
        end_phase()
        _CLOCK.update(name=name, t0=time.perf_counter())
    print(msg, flush=True)


def end_phase() -> None:
    """Prints the wall time of the phase running, if any, and ends it."""
    if _CLOCK["name"] is not None:
        print(f"  ({_CLOCK['name']}: {time.perf_counter() - _CLOCK['t0']:.1f}"
              " s)", flush=True)
    _CLOCK["name"] = None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call of ``fn`` launched from the host, launch overhead
    included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, replays: int = 20, per_graph: int = 1) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in
    one CUDA graph, replayed ``replays`` times between two events, so the
    host's launch overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    """(least time in ms, "bytes" or "operations"): each input read once,
    each output written once, against the published H100 SXM peaks."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Tolerances of the attention kernels against their plain versions, per
# input dtype: (max-abs as a share of the plain output's largest magnitude,
# relative L2). bf16 outputs may differ by a few bf16 ulps at the top of
# their range (a probability near a bf16 rounding boundary can round the
# other way when the fp32 sums are taken in another order); the relative L2
# catches a systematic error on a few rows (a dropped or mis-scaled key on
# the ragged edge). fp32 outputs are not rounded to bf16, but p and ds still
# are, on both sides, and the kernels' hi/lo bf16 products are about 2^-16
# off the plain fp32 ones, so some of those roundings go the other way:
# max-abs as for bf16 (one ds one ulp off moves a dk element of a 37-token
# head by ~2^-8 of the largest), relative L2 1e-3, which a kernel computing
# in bf16 alone exceeds (the control in attention_case shows it). Where
# dp - delta cancels (one key, N = 1: dq and dk are rounding residue) both
# bounds add cancel_floor. lse within 5e-3 in both (fp32, __expf,
# reordered sums).
TOLERANCE = {"bf16": (2.0 ** -7, 1e-2), "fp32": (2.0 ** -7, 1e-3)}
LSE_TOLERANCE = 5e-3
DTYPES = ("bf16", "fp32")


def torch_dtype(name: str):
    import torch

    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


# kernel -> (wrapper, direction, line of the TPU kernel it replaces in
# lightly_train_tpu/ops/pallas/attention.py); the CUDA source is the one
# the dtype and head dim route to (attention.fwd_library, bwd_library), at
# hd 16 the header whose kernel that library launches.
KERNELS = {
    "K1": ("flat_attention_fwd", "fwd", 241),
    "K2": ("flat_attention_bwd", "bwd", 265),
    "K4": ("vmem_attention_fwd", "fwd", 69),
    "K5": ("vmem_attention_bwd", "bwd", 92),
}
# The attention libraries, all on Hopper's wgmma, with the instructions
# their SASS must hold (HGMMA: wgmma; LDGSTS: cp.async, where a design fills
# its ring with it: the bf16 forward and backward, and the fp32 forward's
# two-pass hd-128 and hd-16 kernels; UTMALDG: TMA loads, both forwards'
# resident hd-128 kernel and the bf16 backward's two hd-128 kernels), the
# warp-level product that no library's SASS may hold (HMMA: mma.sync), and
# ptxas's warnings that it serialized their wgmma products (C7510-C7519).
SM90_LIBRARIES = {
    "flat_attention_fwd_sm90": ("HGMMA", "LDGSTS", "UTMALDG"),
    "flat_attention_bwd_sm90": ("HGMMA", "LDGSTS", "UTMALDG"),
    "flat_attention_fwd_f32_sm90": ("HGMMA", "LDGSTS", "UTMALDG"),
    "flat_attention_bwd_f32_sm90": ("HGMMA",),
}
WARP_MMA = "HMMA"
SERIALIZED = tuple(f"C751{i}" for i in range(10))


# The largest N whose hd-128 forward runs the resident kernel in either
# dtype (csrc/attention_fwd_hd128_resident.cuh, kResidentMaxN; above 64).
RESIDENT_MAX_N = 304


def kernel_source(direction: str, dtype: str, hd: int, n_tokens: int,
                  library: str) -> str:
    """The CUDA source whose kernel ``library`` launches for this dtype,
    head dim and N: at hd 16 and 128 the header the library includes (the
    bf16 backward at hd 128 runs attention_bwd_hd128_tma.cuh's two kernels
    at every N, fp32 the three role kernels of attention_bwd_hd128.cuh)."""
    if (direction, hd) == ("fwd", 128) and (
            64 < n_tokens <= RESIDENT_MAX_N):
        return "attention_fwd_hd128_resident.cuh"
    if (direction, hd, dtype) == ("bwd", 128, "bf16"):
        return "attention_bwd_hd128_tma.cuh"
    if hd in (16, 128):
        return f"attention_{direction}_hd{hd}.cuh"
    return library + ".cu"


def cancel_floor(scale: float, hd: int, do, v, other) -> float:
    """Per element, one 2^-16 rounding of dp = do . v (the hi/lo products'
    precision) carried through ds into dq (``other`` = k) or dk (``other`` =
    q): 2^-16 scale sqrt(hd) rms(do) rms(v) rms(other). It matters only
    where the exact dq and dk are near 0."""
    rms = [x.float().pow(2).mean().sqrt().item() for x in (do, v, other)]
    return 2.0 ** -16 * scale * hd ** 0.5 * math.prod(rms)


def compare(got, ref, dtype: str, floor: float = 0.0) -> tuple:
    """(max-abs error, relative L2, whether both are within the dtype's
    tolerance plus ``floor`` per element)."""
    max_rel, l2 = TOLERANCE[dtype]
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    ref_norm = ref.float().norm().item()
    rel = diff.norm().item() / ref_norm if ref_norm else math.inf
    ok = (err <= max_rel * ref.float().abs().max().item() + 8 * floor
          and diff.norm().item() <= l2 * ref_norm + floor * diff.numel() ** 0.5)
    return err, rel, ok


def held(tag: str, got, ref, dtype: str, floor: float = 0.0) -> float:
    """Max-abs error of ``got`` against ``ref``; fails past the dtype's
    tolerance."""
    err, rel, ok = compare(got, ref, dtype, floor)
    print(f"  {tag}: max_abs_err {err:.3e}, relative L2 {rel:.3e} (tol "
          f"{TOLERANCE[dtype]} + floor {floor:.2e})")
    if not ok:
        fail(f"{tag}: max-abs {err}, relative L2 {rel} (tol "
             f"{TOLERANCE[dtype]} + floor {floor})")
    return err


def attention_bounds(B: int, N: int, H: int, hd: int, dtype: str) -> tuple:
    """(forward, backward) bounds: q, k, v in and o out (forward), q, k, v,
    o, do in and dq, dk, dv out (backward), plus the fp32 lse, against the
    necessary products (2 forward, 5 backward, 2 N^2 hd each per head) at
    the tensor peak of the input type (TF32 for fp32)."""
    elem = B * N * H * hd * (2 if dtype == "bf16" else 4)
    flops = 4.0 * B * H * N * N * hd
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_TF32_FLOPS
    lse = B * H * N * 4
    return (bound_ms(4 * elem + lse, flops, peak),
            bound_ms(8 * elem + lse, 2.5 * flops, peak))


def attention_case(A, card: str, kernels: str, dtype: str, shape: tuple,
                   layout: str) -> tuple:
    """One forward and one backward kernel against their plain versions at
    ``shape`` = (B, N, H, hd), then timed: (forward row, backward row), the
    backward run twice and held bitwise equal to itself (no atomics); at a
    head dim the backward does not take, the forward alone: (forward
    row,).

    ``kernels`` "flat" runs K1/K2 on (B, N, H * hd) tensors; "vmem" runs
    K4/K5 on (B, H, N, hd) tensors, real ones (``layout`` "bhnd") or the
    transposed views of (B, N, H, hd) ones ("bnhd", what ``vmem_attention``
    hands the kernels). In fp32 a control follows: the kernels on the inputs
    rounded to bf16 (what a kernel computing in bf16 alone would see) must
    fail the fp32 tolerance against the plain version on the unrounded
    inputs, or the tolerance does not check the fp32 form."""
    import torch

    B, N, H, hd = shape
    dt = torch_dtype(dtype)
    scale = hd ** -0.5
    backward = hd in A.HEAD_DIMS["bwd"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + N + hd)
    if kernels == "flat":
        q, k, v, do = (torch.randn((B, N, H * hd), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        views = [x.view(B, N, H, hd).transpose(1, 2) for x in (q, k, v, do)]
        heads = (H,)
        fwd_k, bwd_k = A.flat_attention_fwd, A.flat_attention_bwd
        fwd_p, bwd_p = A.flat_attention_fwd_plain, A.flat_attention_bwd_plain
        tag, names = f"K1/K2 {dtype} {shape}", ("K1", "K2")
    else:
        full = (B, H, N, hd) if layout == "bhnd" else (B, N, H, hd)
        q, k, v, do = (torch.randn(full, generator=gen, device="cuda").to(dt)
                       for _ in range(4))
        if layout == "bnhd":
            q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
        views = [q, k, v, do]
        heads = ()
        fwd_k, bwd_k = A.vmem_attention_fwd, A.vmem_attention_bwd
        fwd_p, bwd_p = A.vmem_attention_fwd_plain, A.vmem_attention_bwd_plain
        tag, names = f"K4/K5 {dtype} {layout} {shape}", ("K4", "K5")

    def fwd():
        return fwd_k(q, k, v, *heads, scale)

    def fwd_plain():
        return fwd_p(q, k, v, *heads, scale)

    def bwd():
        return bwd_k(q, k, v, o, do, lse, *heads, scale)

    def bwd_plain():
        return bwd_p(q, k, v, o, do, lse, *heads, scale)

    o, lse = fwd()
    o_ref, lse_ref = fwd_plain()
    grads, grads_ref = (bwd(), bwd_plain()) if backward else ((), ())
    if backward and not all(torch.equal(a, b) for a, b in zip(grads, bwd())):
        fail(f"{tag}: two backwards of the same inputs differ")
    torch.cuda.synchronize()
    floors = {"dq": cancel_floor(scale, hd, do, v, k),
              "dk": cancel_floor(scale, hd, do, v, q)}
    errs = {name: held(f"{tag} {name}", got, ref, dtype, floors.get(name, 0.0))
            for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, *grads),
                                      (o_ref, *grads_ref))}
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  {tag} lse: max_abs_err {lse_err:.3e} (tol {LSE_TOLERANCE})")
    if not lse_err <= LSE_TOLERANCE:
        fail(f"{tag} lse: {lse_err}")
    control = None
    if dtype == "fp32":
        r = [x.to(torch.bfloat16).float() for x in (q, k, v, do)]
        o_c, lse_c = fwd_k(*r[:3], *heads, scale)
        got_c = (o_c, *(bwd_k(*r[:3], o_c, r[3], lse_c, *heads, scale)
                        if backward else ()))
        ref_c = (o_ref, *(bwd_p(q, k, v, o_ref, do, lse_ref, *heads, scale)
                          if backward else ()))
        verdicts = {name: compare(got, ref, dtype, floors.get(name, 0.0))
                    for name, got, ref in zip(("o", "dq", "dk", "dv"), got_c,
                                              ref_c)}
        control = {name: rel for name, (_, rel, _) in verdicts.items()}
        print(f"  {tag} control (inputs rounded to bf16): relative L2 "
              + ", ".join(f"{n} {rel:.3e} ({'within' if ok else 'outside'})"
                          for n, (_, rel, ok) in verdicts.items())
              + f" (tol {TOLERANCE[dtype][1]:g}; must fail)")
        if all(ok for _, _, ok in verdicts.values()):
            fail(f"{tag}: the fp32 tolerance passes a kernel fed bf16 inputs")

    qh, kh, vh, doh = views
    fwd_bound, bwd_bound = attention_bounds(B, N, H, hd, dtype)
    common = {"shape": list(shape), "dtype": dtype, "layout": layout}
    if control is not None:
        common["control_rel_l2"] = control
        common["control_outside"] = {n: not ok for n, (_, _, ok) in
                                     verdicts.items()}
    rows = (
        {**common, "max_abs_err": max(errs["o"], lse_err),
         "ms": device_ms(fwd, per_graph=10),
         "plain_ms": device_ms(fwd_plain),
         "library_ms": device_ms(
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 qh, kh, vh, scale=scale), per_graph=10),
         "host_ms": time_ms(fwd),
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
    )
    if backward:
        rows += ({
            **common, "max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")),
            "ms": device_ms(bwd, per_graph=10),
            "plain_ms": device_ms(bwd_plain),
            "library_ms": library_backward_ms(qh, kh, vh, doh, scale),
            "host_ms": time_ms(bwd),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]},)
    for name, r in zip(names, rows):
        print(f"  {name} {dtype} {layout} {shape}: {r['ms']:.4f} ms (with "
              f"host launch {r['host_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]",
              flush=True)
    return rows


# (kernels, dtype, (B, N, H, hd), layout) of phase 2: K1/K2 at the ViT-B/14
# global and local shapes of both pretrain paths, at ViT-B/14 on 378^2
# images (N = 730, at batch 8 and 32), and at hd 16 on a small grid and at
# the vittest14 shapes of phase 3e, and in fp32 at the teacher's shape of
# phase 3f; K1/K2 at hd 128 (the 7B teacher's and student's shape of
# phases 3j and 3l, the embed shape of phase 3k, N = 37 and N = 730);
# K1/K2 at ECViT's shapes of phase 3p (bf16 global and local, fp32 in (g))
# and fp32 at the teacher's shape of the fp32 checks of 3o (a) and 3p (g);
# K1/K2 at evaluate_knn's batch of phase 3q (c) in both dtypes; K1/K2 at
# the fine-tuning shapes of phase 3r (bf16 (a) and (b), fp32 (d)) and K1
# at EoMT's joint blocks' shape in validation (phase 3s, bf16);
# K4/K5 at the ViT-B/14 shapes and the 7B embed shape in both layouts and
# dtypes, and at the hd-16 shapes in vmem_attention's layout.
# Between them the shapes take both configurations of the fp32 hd-64
# forward (resident and streamed), and both forms of each hd-16 and hd-64
# kernel (one tile, several).
HD16_SHAPES = (HD16_SMALL, VITTEST_GLOBAL, VITTEST_LOCAL)
HD128_SHAPES = (TEACHER_7B, EMBED_7B, LOCAL_7B, GLOBAL_378_7B)
ATTENTION_CASES = [
    ("flat", dtype, shape, "flat")
    for dtype in DTYPES
    for shape in (GLOBAL, LOCAL, GLOBAL_378_B8, GLOBAL_378, *HD16_SHAPES,
                  *HD128_SHAPES)
] + [("flat", "fp32", TEACHER, "flat")] + [
    ("flat", dtype, ECVIT_GLOBAL, "flat") for dtype in DTYPES] + [
    ("flat", "bf16", ECVIT_LOCAL, "flat"),
    ("flat", "fp32", ECVIT_FP32, "flat"),
    ("flat", "fp32", TEACHER_FP32_CHECK, "flat")] + [
    ("flat", dtype, KNN_SHAPE, "flat") for dtype in DTYPES] + [
    ("flat", "bf16", FT_CLS, "flat"), ("flat", "bf16", FT_SEG, "flat"),
    ("flat", "fp32", FT_FP32, "flat"),
    ("flat", "bf16", EOMT_QUERIES_SHAPE, "flat"),
    ("flat", "bf16", DET_ECVIT, "flat")] + [
    ("vmem", dtype, shape, layout)
    for layout in ("bnhd", "bhnd")
    for dtype in DTYPES
    for shape in (GLOBAL, LOCAL, *(HD16_SHAPES if layout == "bnhd" else ()),
                  EMBED_7B)
]


def check_attention(A, card: str) -> dict:
    """K1/K2 and K4/K5 against their plain versions: {(kernel, dtype):
    [row, ...]} for the kernels JSON line."""
    rows = {}
    for kernels, dtype, shape, layout in ATTENTION_CASES:
        names = ("K1", "K2") if kernels == "flat" else ("K4", "K5")
        for name, row in zip(names, attention_case(A, card, kernels, dtype,
                                                   shape, layout)):
            rows.setdefault((name, dtype), []).append(row)
    return rows


def library_backward_ms(qh, kh, vh, doh, scale):
    """Time of PyTorch's own attention backward on the same inputs (the
    yardstick for K2 and K5): flash attention for bf16, memory-efficient
    attention for fp32 (flash takes 16-bit types only); None where this
    PyTorch build lacks it."""
    import torch

    aten = torch.ops.aten
    try:
        if qh.dtype == torch.bfloat16:
            out = aten._scaled_dot_product_flash_attention(
                qh, kh, vh, 0.0, False, False, scale=scale)
            o, lse, cq, ck, mq, mk, seed, offset = out[:8]

            def backward():
                return aten._scaled_dot_product_flash_attention_backward(
                    doh, qh, kh, vh, o, lse, cq, ck, mq, mk, 0.0, False,
                    seed, offset, scale=scale)
        else:
            o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, None, True, 0.0, False, scale=scale)

            def backward():
                return aten._scaled_dot_product_efficient_attention_backward(
                    doh, qh, kh, vh, None, o, lse, seed, offset, 0.0,
                    [True, True, True, False], False, scale=scale)

        backward()
    except (RuntimeError, TypeError) as err:
        print(f"  (no attention backward yardstick: {err})")
        return None
    return device_ms(backward, per_graph=10)


def vitb_leaf_shapes():
    """Every parameter shape of ViT-B/14 + DINO and iBOT heads (65536
    prototypes), as the main path's fused update sees them."""
    import torch

    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    with torch.device("meta"):
        wrapped = get_wrapped_model("dinov2/vitb14", dtype=torch.bfloat16)
        method = DINOv2(wrapped, DINOv2Args())
        heads = [method._head(), method._head()]
    shapes = [p.shape for p in wrapped.module.parameters()]
    for h in heads:
        shapes += [p.shape for p in h.parameters()]
    return shapes


def k3_leaves(shapes, gen):
    """(g, p, mu, nu, t) of each leaf of ``shapes`` on the card, from
    ``gen``."""
    import torch

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return [[randn(shape), randn(shape), randn(shape),
             torch.rand(shape, generator=gen, device="cuda"), randn(shape)]
            for shape in shapes]


def k3_scalars(n: int, lr: float = 2e-3):
    """(n, 8) scalar rows (cs, bc1, bc2, a, wd, m, 0, 0) that differ from
    leaf to leaf."""
    import numpy as np

    s = np.tile(np.float32([0.7, 1.5, 1.1, lr, 0.04, 0.995, 0, 0]), (n, 1))
    s[:, 3] *= 1 + np.arange(n) % 3
    s[:, 4] *= np.arange(n) % 2
    return s


def k3_plain(F, leaves, table, hp, clip=None) -> list:
    """The plain version leaf by leaf on the card: new (p, mu, nu, t) of each
    leaf (a gradient of None is zeros). ``table``: the (leaves, 8) scalars
    on the card, whose column 0 the clip scale of ``clip`` overwrites; no
    copy from the host, so a CUDA graph can capture it."""
    import torch

    if clip is not None:
        table[:, 0] = F.clip_scale_plain(*clip)
    return [F.fused_adamw_ema_leaf_plain(
        torch.zeros_like(p) if g is None else g, p, mu, nu, t, s, **hp)
        for (g, p, mu, nu, t), s in zip(leaves, table)]


def check_fused_update(F, card: str) -> dict:
    """K3 against its plain version, one launch over the real ViT-B/14 +
    head leaves and synthetic ones that exercise the chunk plan (n = 1, 3,
    5, 4097, 65537, a chunk + 3, and a leaf of no gradient); with lr 0
    (the weights bitwise unchanged); and over two steps of ``FusedAdamWEMA``
    whose gradients are all reallocated in between, against the same class
    on the CPU. Then the times of the 239 ViT-B/14 leaves alone, K3 at
    several chunk sizes, and ``update_and_apply`` on the main path's model
    (``time_update.py``)."""
    import torch

    import time_update

    shapes = vitb_leaf_shapes()
    n_vit = len(shapes)
    n_params = sum(math.prod(s) for s in shapes)
    synthetic = [(1,), (3,), (5,), (4097,), (65537,), (F.CHUNK_ELEMS + 3,),
                 (768,)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    leaves = k3_leaves(shapes + synthetic, gen)
    leaves[-1][0] = None  # a leaf with no gradient
    scalars = k3_scalars(len(leaves))
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    state = F.LeafSet(*([leaf[k] for leaf in leaves] for k in range(1, 5)))
    got = [[x.clone() for x in leaf[1:]] for leaf in leaves]
    state_got = F.LeafSet(*([leaf[k] for leaf in got] for k in range(4)))
    F.fused_adamw_ema(state_got, [leaf[0] for leaf in leaves], scalars, **hp)
    err = 0.0
    for mine, ref in zip(got, k3_plain(
            F, leaves, torch.tensor(scalars, device="cuda"), hp)):
        for a, b in zip(mine, ref):
            err = max(err, (a - b).abs().max().item())
    del got, state_got
    # lr 0 (a warm start with learning_rate=0): p' = p - 0 * u is p.
    p0 = [leaf[1].clone() for leaf in leaves]
    F.fused_adamw_ema(state, [leaf[0] for leaf in leaves],
                      k3_scalars(len(leaves), lr=0.0), **hp)
    torch.cuda.synchronize()
    lr0_bitwise = all(torch.equal(leaf[1], p) for leaf, p in zip(leaves, p0))
    del p0
    err_steps = two_steps_new_grads(F, shapes[:12] + synthetic)
    # Same fp32 arithmetic, only FMA contraction and sqrt/div rounding may
    # differ: values are O(1), so 1e-5 absolute.
    print(f"  K3 {n_vit} leaves + {len(synthetic)} synthetic, one launch: "
          f"max_abs_err {err:.3e}; two steps with new gradients "
          f"{err_steps:.3e} (tol 1e-5); lr 0 keeps p bitwise: {lr0_bitwise}")
    if not (err <= 1e-5 and err_steps <= 1e-5):
        fail(f"fused AdamW+EMA: {err}, {err_steps}")
    if not lr0_bitwise:
        fail("fused AdamW+EMA with lr 0 changed the weights")

    # Times over the 239 ViT-B/14 leaves (the main path's update).
    vit = leaves[:n_vit]
    grads = [leaf[0] for leaf in vit]
    scalars = scalars[:n_vit]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = (norm, 3.0)
    by_chunk = {}
    for chunk in (4096, 8192, 16384, 32768, 65536):
        timed = F.LeafSet(*([leaf[k] for leaf in vit] for k in range(1, 5)),
                          chunk_elems=chunk)
        table = timed.stage(grads, scalars)
        by_chunk[chunk] = device_ms(
            lambda: timed.launch(table, clip, **hp), replays=10)
    print("  K3 device ms by chunk_elems: " + ", ".join(
        f"{k} {v:.4f}" for k, v in by_chunk.items()) + f" [{card}]")
    timed = F.LeafSet(*([leaf[k] for leaf in vit] for k in range(1, 5)))
    table = timed.stage(grads, scalars)

    plain_table = torch.tensor(scalars, device="cuda")

    def plain_pass():
        k3_plain(F, vit, plain_table, hp, clip)

    # 5 fp32 reads + 4 fp32 writes and ~15 fp32 operations per parameter.
    b = bound_ms(36.0 * n_params, 15.0 * n_params, PEAK_FP32_FLOPS)
    row = {
        "leaves": n_vit, "n_params": n_params, "max_abs_err": err,
        "max_abs_err_two_steps": err_steps, "lr0_bitwise": lr0_bitwise,
        "chunk_elems": F.CHUNK_ELEMS,
        "ms": device_ms(lambda: timed.launch(table, clip, **hp), replays=10),
        "ms_by_chunk_elems": by_chunk,
        "plain_ms": device_ms(plain_pass, replays=5),
        "library_ms": None,
        "host_ms": time_ms(lambda: F.fused_adamw_ema(timed, grads, scalars,
                                                     clip, **hp), iters=10),
        "bound_ms": b[0], "bound_by": b[1],
    }
    del leaves, vit, grads, state, timed, table
    torch.cuda.empty_cache()
    # No profiler window here: it could slow the main paths' launches.
    upd = time_update.measure(profile=False)
    row.update({k: upd[k] for k in ("update_host_ms", "update_host_ms_min",
                                    "update_host_ms_max", "norm_host_ms",
                                    "update_ms")})
    print(f"  K3 all leaves: {row['ms']:.4f} ms (with the host's staging and "
          f"launch {row['host_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"update_and_apply: host {row['update_host_ms']:.4f} ms (its grad "
          f"norm {row['norm_host_ms']:.4f} ms), with the card "
          f"{row['update_ms']:.4f} ms [{card}]")
    return row


def two_steps_new_grads(F, shapes) -> float:
    """Max-abs error of two ``FusedAdamWEMA`` steps on the card (K3) against
    the same on CPU copies (the plain version), with a clip norm that the
    second step's large gradients exceed, a leaf of no gradient, and every
    gradient reallocated between the steps while the old ones live (a stale
    address table would read the old ones)."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._optim import AdamWArgs

    rng = np.random.default_rng(SEED + 2)
    names = [f"leaf{i}" for i in range(len(shapes))]
    start = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in zip(names, shapes)}
    runs = {}
    for device in ("cuda", "cpu"):
        params = {n: torch.tensor(v, device=device) for n, v in start.items()}
        teacher = {n: v.clone() for n, v in params.items()}
        upd = F.FusedAdamWEMA(
            AdamWArgs(lr=1e-3, weight_decay=0.04), lambda c: 1e-3 * (1 + c),
            params, grad_clip_norm=3.0, momentum_fn=lambda s: 0.99,
            lr_scales={n: 0.5 + (i % 3) for i, n in enumerate(names)})
        runs[device] = (params, teacher, upd)
    old = None
    for step in range(2):
        grads_np = {n: (rng.standard_normal(s) * (1e-4 if step == 0 else 10.0)
                        ).astype(np.float32) for n, s in zip(names, shapes)}
        for device, (params, teacher, upd) in runs.items():
            grads = {n: torch.tensor(g, device=device)
                     for n, g in grads_np.items()}
            grads[names[-1]] = None
            if device == "cuda":
                if old is not None and {g.data_ptr() for g in old if g is not
                                        None} & {g.data_ptr() for g in
                                                 grads.values() if g is not
                                                 None}:
                    fail("two-step K3 check: a gradient kept its address")
                old = list(grads.values())
            upd.update_and_apply(grads, params, teacher, step)
    torch.cuda.synchronize()
    err = 0.0
    (p_c, t_c, u_c), (p_h, t_h, u_h) = runs["cuda"], runs["cpu"]
    for a, b in ((p_c, p_h), (t_c, t_h), (u_c.mu, u_h.mu), (u_c.nu, u_h.nu)):
        for n in names:
            err = max(err, (a[n].cpu() - b[n]).abs().max().item())
    return err


def write_images(folder: Path, n: int, size: int, seed: int = SEED,
                 offset: float = 0.0) -> None:
    """Binary PPM images from a numpy seed: smooth colour fields plus noise,
    so crops, blur and jitter see structure; ``offset`` shifts their
    brightness."""
    import numpy as np

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for i in range(n):
        f = rng.uniform(1, 6, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx)
                               + ph[c]) for c in range(3)
        ], axis=-1) * 200 + rng.normal(0, 20, (size, size, 3)) + offset
        img = np.clip(img, 0, 255).astype(np.uint8)
        header = f"P6\n{size} {size}\n255\n".encode()
        (folder / f"img_{i:03d}.ppm").write_bytes(header + img.tobytes())


def reset_counters(A, F) -> tuple:
    """Sets every launch counter to 0; returns the per-kernel counters in
    the order K1, K2, K3, K4, K5."""
    counters = (A.flat_attention_fwd, A.flat_attention_bwd,
                F.fused_adamw_ema, A.vmem_attention_fwd,
                A.vmem_attention_bwd)
    for fn in counters:
        fn.launches = 0
    for by_lib in (A.fwd_launches, A.bwd_launches):
        by_lib.update(dict.fromkeys(by_lib, 0))
    A.shape_launches.clear()
    return counters


def launches_by_shape(A) -> dict:
    """{(library, (B, N, H, hd)): launches} since the counters were set
    to 0."""
    return {(lib, (b, n, h, hd)): count
            for (lib, (b, h, n, hd)), count in A.shape_launches.items()}


def pretrain_main_path(lt, out: Path, data: Path, precision: str,
                       steps: int = STEPS, **kwargs):
    """``pretrain`` DINOv2 ViT-B/14 at batch 32 for ``steps`` steps,
    logging every step."""
    return lt.pretrain(
        out=str(out), data=str(data), model="dinov2/vitb14",
        method="dinov2", batch_size=BATCH, steps=steps, precision=precision,
        log_every=1, canonical_size=256, seed=SEED, **kwargs)


def pin_ieee() -> None:
    """The CUDA fp32 GEMMs and convolutions in IEEE fp32 (no TF32), as the
    plain versions are held: ``pretrain`` applies
    LIGHTLY_TRAIN_MATMUL_PRECISION (TF32 by default), so this follows every
    phase that runs it."""
    from lightly_train_tpu_torch._system import set_tf32

    set_tf32(False)


def dinov2_expected(steps: int, remat_every: int = 0) -> list:
    """K1..K5 launches of ``steps`` DINOv2 ViT-B/14 steps: K1 once a block
    in the teacher's and the student's two forwards, and again in each
    recomputed block of the student's (every ``remat_every``-th: the
    teacher runs under no_grad, where nothing is checkpointed); K2 once a
    block in each student backward; K3 once a step."""
    recomputed = len(range(0, DEPTH, remat_every)) if remat_every else 0
    return [(3 * DEPTH + 2 * recomputed) * steps, 2 * DEPTH * steps, steps,
            0, 0]


def logged_steps(out: Path) -> list:
    return [r for r in (json.loads(line) for line in
                        (out / "metrics.jsonl").read_text().splitlines())
            if "step" in r]


def run_main_path(lt, A, F, card: str, precision: str, work: Path) -> dict:
    """``pretrain`` DINOv2 ViT-B/14 at batch 32 in ``precision`` for STEPS
    steps into ``work / precision``, with every launch counter set to 0
    just before and read just after: K1/K2 once per block and view group,
    K3 once a step over all leaves, K4/K5 never. It checkpoints only at the end
    (``checkpoint_every=STEPS``), after the timed steps: the ~2 GiB save
    would otherwise land in a step's time."""
    import torch

    data = work / "images"
    run_dir = work / precision
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = pretrain_main_path(lt, run_dir, data, precision,
                               checkpoint_every=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches),
                  "bwd": dict(A.bwd_launches)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = logged_steps(run_dir)
    saved = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    if saved != [f"step_{STEPS}.pt"]:
        fail(f"checkpoints {saved} != step_{STEPS}.pt alone")
    meta = json.loads((run_dir / "exported_models" / "exported_last"
                       / "metadata.json").read_text())
    if meta["steps"] != STEPS or meta["model_name"] != "dinov2/vitb14":
        fail(f"exported_last metadata {meta}")

    if [r["step"] for r in steps] != list(range(1, STEPS + 1)):
        fail(f"logged steps {[r['step'] for r in steps]}")
    for r in steps:
        for key in ("train_loss", "dino_loss", "ibot_loss", "koleo_loss",
                    "grad_norm"):
            if not math.isfinite(r[key]):
                fail(f"step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f} (dino "
              f"{r['dino_loss']:.4f}, ibot {r['ibot_loss']:.4f}, koleo "
              f"{r['koleo_loss']:.4f}), grad_norm {r['grad_norm']:.4f}, "
              f"{r['profiling/step_time'] * 1e3:.1f} ms, "
              f"{r['profiling/images_per_sec']:.1f} img/s [{card}]")
    expected = [36 * STEPS, 24 * STEPS, STEPS, 0, 0]
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); peak memory {peak_gib:.2f} GiB; wall "
          f"{wall:.1f} s")
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")
    # Every forward and backward of the path at hd 64 in the run's
    # dtype on the wgmma kernels of that dtype.
    check_routes(A, f"{precision} main path", by_library,
                 torch_dtype(precision), HEAD_DIM,
                 {"fwd": 36 * STEPS, "bwd": 24 * STEPS})
    student = state.params["student"]
    check_backbone(student, "dinov2/vitb14", precision, 768)
    times = [r["profiling/step_time"] for r in steps]
    return {
        "launches": launches, "launches_by_library": by_library,
        "step_ms": [t * 1e3 for t in times],
        "images_per_sec": [r["profiling/images_per_sec"] for r in steps],
        "peak_gib": peak_gib, "out": run_dir, "steps": steps,
        "student": {k: v.detach().cpu() for k, v in
                    student.state_dict().items()},
    }


def check_backbone(student, model: str, precision: str, width: int,
                   label: str = "") -> None:
    """The trained backbone on a small input against an fp32 CPU reference
    (plain attention): bf16 over 12 blocks keeps the CLS features within 5%
    relative L2; fp32 (bf16 probabilities only, as on the TPU) within 1%,
    with IEEE fp32 or TF32 GEMMs alike (TF32 rounds each GEMM input to
    2^-11 relative, an eighth of bf16's 2^-8, whose runs land at up to
    1.07e-2 (PERF.md section 6): TF32 should land near 1.3e-3). The run's
    dtype shows that the attention launches came from the kernels' fp32
    form. The card's forward runs under the CUDA backend's TF32 switches as
    they are."""
    import torch

    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    tol = 5e-2 if precision == "bf16" else 1e-2
    images = torch.rand((2, 224, 224, 3), device="cuda") * 4 - 2
    with torch.no_grad():
        out = student(images)["cls_token"]
        if out.dtype != torch_dtype(precision):
            fail(f"{precision} run computed in {out.dtype}")
        got = out.float().cpu()
        ref_model = get_wrapped_model(model).module
        ref_model.load_state_dict(
            {k: v.float().cpu() for k, v in student.state_dict().items()})
        ref = ref_model(images.cpu())["cls_token"]
    rel = ((got - ref).norm() / ref.norm()).item()
    print(f"  trained {model} cls on 2 images vs fp32 CPU reference{label}: "
          f"relative L2 {rel:.3e} (tol {tol:g})")
    if not (got.shape == (2, width) and torch.isfinite(got).all()
            and rel <= tol):
        fail(f"{model} backbone disagrees with the CPU reference: {rel}")


def run_vittest_path(lt, A, F, card: str, precision: str, work: Path) -> dict:
    """Phase 3e: ``pretrain`` DINOv2 on vittest14 (width 32, 2 heads: hd 16)
    at batch 32 for VITTEST_STEPS steps in ``precision``, on phase 3's
    images, with every launch counter set to 0 just before and read just
    after: K1 6 a step (2 blocks x 3 view groups) at VITTEST_GLOBAL and
    VITTEST_LOCAL, every one on the dtype's wgmma forward; K2 4 a step,
    every one on the dtype's wgmma backward (csrc/attention_bwd_hd16.cuh in
    flat_attention_bwd_sm90 or _f32_sm90); K3 once a step. Finite losses,
    and the trained backbone against an fp32 CPU reference."""
    import torch

    out = work / f"vittest_{precision}"
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = lt.pretrain(
        out=str(out), data=str(work / "images"), model="dinov2/vittest14",
        method="dinov2", batch_size=BATCH, steps=VITTEST_STEPS,
        precision=precision, log_every=1, canonical_size=256, seed=SEED,
        checkpoint_every=VITTEST_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)}
    steps = logged_steps(out)
    if [r["step"] for r in steps] != list(range(1, VITTEST_STEPS + 1)):
        fail(f"vittest14 logged steps {[r['step'] for r in steps]}")
    for r in steps:
        for key in ("train_loss", "dino_loss", "ibot_loss", "koleo_loss",
                    "grad_norm"):
            if not math.isfinite(r[key]):
                fail(f"vittest14 step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f}, grad_norm "
              f"{r['grad_norm']:.4f}, {r['profiling/step_time'] * 1e3:.1f} "
              f"ms [{card}]")
    expected = [6 * VITTEST_STEPS, 4 * VITTEST_STEPS, VITTEST_STEPS, 0, 0]
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); wall {wall:.1f} s")
    if launches != expected:
        fail(f"vittest14 launch counts {launches} != {expected}")
    check_routes(A, f"vittest14 {precision}", by_library,
                 torch_dtype(precision), 16,
                 {"fwd": expected[0], "bwd": expected[1]})
    check_backbone(state.params["student"], "dinov2/vittest14", precision,
                   32)
    shutil.rmtree(out)
    return {"launches": launches, "launches_by_library": by_library,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps]}


class Interrupted(Exception):
    """Raised by the phase-3d loader after its second batch."""


def run_resume_path(lt, A, F, card: str, work: Path, ref: dict, run,
                    steps: int, keys: tuple, expected: list,
                    expected_by_library: dict, tag: str) -> dict:
    """Phase 3d (and 3f), resume: ``run(out, **kwargs)`` (a bf16 main path
    of ``steps`` steps) with ``checkpoint_every=2``, stopped after its
    step-2 checkpoint by a loader that raises when asked for a third batch,
    then resumed with ``resume_interrupted=True`` to step ``steps``; held
    against the uninterrupted run ``ref`` (the same seed, data and steps)
    on the logged ``keys`` of the resumed steps and the student. Launch
    counters are set to 0 before the first run and read after the second:
    ``expected`` (K1..K5) and ``expected_by_library``."""
    import torch

    from lightly_train_tpu_torch._checkpoint import checkpoint as C
    from lightly_train_tpu_torch._commands import train as T

    out = work / f"resume_{tag}"
    loader_cls, save = T.PretrainLoader, C.CheckpointManager.save
    saves = []

    class StopAfterTwo(loader_cls):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise Interrupted
                yield batch

    def timed_save(self, step, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, step, *args)
        saves.append((step, (time.perf_counter() - t0) * 1e3,
                      self.path(step).stat().st_size / 2 ** 30))

    counters = reset_counters(A, F)
    C.CheckpointManager.save = timed_save
    T.PretrainLoader = StopAfterTwo
    try:
        run(out, checkpoint_every=2)
        fail(f"the interrupted {tag} run was not interrupted")
    except Interrupted:
        pass
    finally:
        T.PretrainLoader = loader_cls
    try:
        saved = sorted(p.name for p in (out / "checkpoints").iterdir())
        meta = json.loads((out / "exported_models" / "exported_last"
                           / "metadata.json").read_text())
        print(f"  interrupted after step 2: checkpoints {saved}, "
              f"exported_last steps {meta['steps']}")
        if saved != ["step_2.pt"] or meta["steps"] != 2:
            fail(f"interrupted {tag} run left {saved}, exported steps "
                 f"{meta['steps']}")
        state = run(out, checkpoint_every=2, resume_interrupted=True)
        torch.cuda.synchronize()
    finally:
        C.CheckpointManager.save = save
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)}
    print(f"  launches over both runs K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); by library {by_library} (expected "
          f"{expected_by_library})")
    if launches != expected or by_library != expected_by_library:
        fail(f"{tag} resume path launch counts {launches}, {by_library}")
    for step, ms, gib in saves:
        print(f"  checkpoint save at step {step}: {ms:.1f} ms, {gib:.3f} GiB "
              f"[{card}]")

    logged = logged_steps(out)
    if [r["step"] for r in logged] != list(range(1, steps + 1)):
        fail(f"{tag} resume path logged steps {[r['step'] for r in logged]}")
    bitwise = True
    for r, r_ref in zip(logged[2:], ref["steps"][2:]):
        for key in keys:
            rel = abs(r[key] - r_ref[key]) / max(abs(r_ref[key]), 1e-12)
            bitwise &= r[key] == r_ref[key]
            print(f"  step {r['step']} {key}: resumed {r[key]!r}, "
                  f"uninterrupted {r_ref[key]!r} (relative {rel:.3e}, tol "
                  f"1e-3)")
            if not (math.isfinite(r[key]) and rel <= 1e-3):
                fail(f"{tag} resumed step {r['step']} {key}: relative {rel}")
    student = {k: v.detach().cpu() for k, v in
               state.params["student"].state_dict().items()}
    diff = math.sqrt(sum((student[k] - v).float().pow(2).sum().item()
                         for k, v in ref["student"].items()))
    norm = math.sqrt(sum(v.float().pow(2).sum().item()
                         for v in ref["student"].values()))
    bitwise &= all(torch.equal(student[k], v)
                   for k, v in ref["student"].items())
    print(f"  resumed student vs uninterrupted: relative L2 {diff / norm:.3e}"
          f" (tol 1e-3); bitwise equal: {bitwise}")
    if not diff <= 1e-3 * norm:
        fail(f"{tag} resumed student: relative L2 {diff / norm}")
    shutil.rmtree(out)
    return {"launches": launches, "save_ms": [ms for _, ms, _ in saves],
            "bitwise": bitwise}


def distill_expected(A, precision: str, steps: int) -> tuple:
    """What ``steps`` steps of phase 3f launch: K1..K5; K1/K2 by library;
    K1/K2 by (library, shape). Per step 12 teacher forwards on the fp32
    forward at TEACHER, 12 student forwards and backwards on the run
    dtype's libraries at GLOBAL."""
    import torch

    n = 12 * steps
    dtype = torch_dtype(precision)
    teacher_fwd = A.fwd_library(torch.float32, HEAD_DIM)
    fwd, bwd = A.fwd_library(dtype, HEAD_DIM), A.bwd_library(dtype, HEAD_DIM)
    by_library = {"fwd": dict.fromkeys(A.fwd_launches, 0),
                  "bwd": dict.fromkeys(A.bwd_launches, 0)}
    by_library["fwd"][teacher_fwd] += n
    by_library["fwd"][fwd] += n
    by_library["bwd"][bwd] += n
    by_shape = {(teacher_fwd, TEACHER): n, (fwd, GLOBAL): n, (bwd, GLOBAL): n}
    return [2 * n, n, 0, 0, 0], by_library, by_shape


def distill_pretrain(lt, out: Path, data: Path, precision: str, steps: int,
                     **kwargs):
    """``pretrain`` at its defaults (no model, no method, batch and queue
    from the data) for ``steps`` steps, logging every step."""
    return lt.pretrain(out=str(out), data=str(data), steps=steps,
                       precision=precision, log_every=1, seed=SEED, **kwargs)


def write_teacher(folder: Path) -> None:
    """An exported DINOv3 ViT-B/16 with seeded weights and LayerScale 0.5,
    for ``teacher_weights``. At the random init (LayerScale 1e-5) every
    image's CLS lies within about 1e-5 of the learned token, so the queue's
    rows coincide, the loss is log Q and the gradient vanishes; this
    teacher's CLS tells the images apart, as a pretrained one does."""
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    module = get_wrapped_model("dinov3/vitb16").module
    module.reset_parameters(torch.Generator().manual_seed(SEED + 1))
    for name, p in module.named_parameters():
        if name.endswith("gamma"):
            p.data.fill_(0.5)
    export_model(folder, "dinov3/vitb16", module.state_dict())


def run_distillation_path(lt, A, F, card: str, precision: str, work: Path,
                          teacher: Path = None) -> dict:
    """Phase 3f: ``pretrain`` at its defaults on phase 3's 64 images for
    DISTILL_STEPS[precision] steps (with ``teacher``: its weights as
    ``teacher_weights``, the one option set), with every launch counter set
    to 0 just before and read just after. It checkpoints only at the end,
    after the timed steps."""
    import torch

    steps = DISTILL_STEPS[precision]
    tag = precision if teacher is None else f"{precision}_teacher"
    out = work / f"distill_{tag}"
    kwargs = {} if teacher is None else {
        "method_args": {"teacher_weights": str(teacher)}}
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = distill_pretrain(lt, out, work / "images", precision, steps,
                             checkpoint_every=steps, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)}
    by_shape = launches_by_shape(A)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    hp = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])[
        "hyperparams"]
    resolved = {k: hp[k] for k in ("model", "method", "resolved_batch_size")}
    resolved.update(optim=hp["optim_args"]["type"],
                    teacher=hp["method_args"]["teacher"],
                    queue_size=hp["method_args"]["queue_size"])
    print(f"  defaults resolved: {resolved}, lr {hp['resolved_lr']!r}")
    want = {"model": "dinov2/vitb14", "method": "distillation",
            "resolved_batch_size": DISTILL_BATCH, "optim": "lars",
            "teacher": "dinov3/vitb16", "queue_size": DISTILL_QUEUE}
    if resolved != want or not math.isclose(
            hp["resolved_lr"], 1.8 * DISTILL_BATCH / 1536, rel_tol=1e-12):
        fail(f"pretrain defaults resolved to {resolved}, expected {want}")
    logged = logged_steps(out)
    if [r["step"] for r in logged] != list(range(1, steps + 1)):
        fail(f"distillation logged steps {[r['step'] for r in logged]}")
    for r in logged:
        for key in DISTILL_KEYS:
            if not math.isfinite(r[key]):
                fail(f"distillation step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f} (global "
              f"{r['loss_global']:.4f}, local {r['loss_local']:.4f}), "
              f"grad_norm {r['grad_norm']:.4e}, "
              f"{r['profiling/step_time'] * 1e3:.1f} ms, "
              f"{r['profiling/images_per_sec']:.1f} img/s [{card}]")
    ms = state.method_state
    filled = min(steps * DISTILL_BATCH, DISTILL_QUEUE)
    print(f"  queue {tuple(ms['queue'].shape)}: filled {ms['queue_filled']}, "
          f"ptr {ms['queue_ptr']} (expected {filled}, "
          f"{steps * DISTILL_BATCH % DISTILL_QUEUE})")
    if (ms["queue_filled"] != filled
            or ms["queue_ptr"] != steps * DISTILL_BATCH % DISTILL_QUEUE
            or not torch.isfinite(ms["queue"]).all()
            or not (ms["queue"].norm(dim=1) > 0).all()):
        fail("distillation queue state")
    expected, expected_by_library, expected_by_shape = distill_expected(
        A, precision, steps)
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); by library {by_library}; by shape {by_shape}; "
          f"peak memory {peak_gib:.2f} GiB; wall {wall:.1f} s")
    if (launches != expected or by_library != expected_by_library
            or by_shape != expected_by_shape):
        fail(f"distillation launch counts {launches}, {by_library}, "
             f"{by_shape}")
    if teacher is not None:
        # A teacher that tells the images apart: once the queue is full the
        # loss leaves 2 log Q (both terms' value where the queue's rows
        # coincide, as with a random teacher), and the gradient is no
        # longer rounding noise (a random teacher's is ~1e-6).
        uniform = 2 * math.log(DISTILL_QUEUE)
        print(f"  with teacher_weights: losses "
              f"{[r['train_loss'] for r in logged[1:]]} (2 log Q = "
              f"{uniform:.4f}), grad norms "
              f"{[r['grad_norm'] for r in logged]}")
        if (not all(r["grad_norm"] > 1e-2 for r in logged)
                or all(abs(r["train_loss"] - uniform) < 1e-3
                       for r in logged[1:])):
            fail("the exported teacher's run has nothing to learn")
    teacher = ms["teacher"]
    if (teacher.cfg.dtype != torch.float32
            or any(p.requires_grad for p in teacher.parameters())):
        fail("the teacher is not a frozen fp32 model")
    student = state.params["student"]
    check_backbone(student, "dinov2/vitb14", precision, 768)
    check_backbone(teacher, "dinov3/vitb16", "fp32", 768)
    meta = json.loads((out / "exported_models" / "exported_last"
                       / "metadata.json").read_text())
    if meta["model_name"] != "dinov2/vitb14" or meta["steps"] != steps:
        fail(f"distillation exported_last metadata {meta}")
    times = [r["profiling/step_time"] for r in logged]
    ips = [r["profiling/images_per_sec"] for r in logged]
    print(f"distillation {tag}: step ms {[t * 1e3 for t in times]}, "
          f"img/s {ips}, peak {peak_gib:.2f} GiB [{card}]", flush=True)
    return {
        "launches": launches, "by_shape": by_shape,
        "step_ms": [t * 1e3 for t in times], "images_per_sec": ips,
        "peak_gib": peak_gib, "steps": logged, "out": out,
        "student": {k: v.detach().cpu() for k, v in
                    student.state_dict().items()},
    }


def check_grid(out: Path, n_images: int) -> None:
    """Phase 3d, grid: ``augmentations.png`` of the defaults run is a PNG
    of one row per view config of the first 8 images, each at the global
    views' size (no PIL on the card: the header is read by hand)."""
    import struct

    raw = (out / "augmentations.png").read_bytes()
    if raw[:8] != b"\x89PNG\r\n\x1a\n" or raw[12:16] != b"IHDR":
        fail("augmentations.png is not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", raw[16:26])
    n, size, rows = min(n_images, 8), 224, 3  # 2 global configs, 1 local
    expected = (n * size + (n - 1) * 2, rows * size, 8, 2)
    print(f"  augmentations.png: {width} x {height}, bit depth {depth}, "
          f"colour type {color} (expected {expected}), {len(raw)} bytes")
    if (width, height, depth, color) != expected:
        fail(f"augmentations.png header {(width, height, depth, color)}")


def run_embed_path(lt, A, F, card: str, work: Path, artifact: Path) -> int:
    """Phase 3d, embed: ``embed`` on the 64 images with the exported
    artifact of phase 3, fp32, batch 64, counters set to 0 just before and
    read just after: 12 K1 launches on the fp32 wgmma forward (one per
    block, under no grad), no K2, no K3. Two images' CLS against an fp32
    CPU reference loaded from the same artifact. Returns K1's launches."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        load_exported_model,
    )
    from lightly_train_tpu_torch._data.image_dataset import (
        ImageDataset,
        list_image_files,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    kwargs = dict(data=str(work / "images"), checkpoint=str(artifact),
                  image_size=224, batch_size=2 * BATCH, precision="fp32",
                  format="npz")
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    path = lt.embed(out=str(work / "embeddings.npz"), **kwargs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = dict(A.fwd_launches)
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
          f"K4 {launches[3]}, K5 {launches[4]} (expected [12, 0, 0, 0, 0])")
    if launches != [12, 0, 0, 0, 0]:
        fail(f"embed launch counts {launches}")
    check_routes(A, "fp32 embed", {"fwd": by_library}, torch.float32,
                 HEAD_DIM, {"fwd": 12})
    emb = np.load(path)["embeddings"]
    if emb.shape != (2 * BATCH, 768) or not np.isfinite(emb).all():
        fail(f"embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    t0 = time.perf_counter()
    lt.embed(out=str(work / "embeddings_again.npz"), **kwargs)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0

    model = get_wrapped_model("dinov2/vitb14").module
    model.load_state_dict(load_exported_model(artifact)["state_dict"])
    dataset = ImageDataset(list_image_files(work / "images"), (224, 224))
    images = torch.from_numpy(np.stack([dataset[0], dataset[1]]))
    with torch.no_grad():
        ref = model(images.float() / 255.0)["cls_token"].numpy()
    rel = float(np.linalg.norm(emb[:2] - ref) / np.linalg.norm(ref))
    print(f"  embed {emb.shape} finite; CLS of 2 images vs fp32 CPU "
          f"reference: relative L2 {rel:.3e} (tol 1e-2)")
    if not rel <= 1e-2:
        fail(f"embed disagrees with the CPU reference: {rel}")
    print(f"  embed of {2 * BATCH} images (artifact load, PPM decode, "
          f"forward, npz): first call {first_s:.3f} s, second "
          f"{again_s:.3f} s = {2 * BATCH / again_s:.1f} img/s [{card}]")
    return launches[0]


def check_routes(A, tag: str, by_library: dict, dtype, head_dim: int,
                 expected: dict):
    """Fails unless every launch counted in ``by_library`` ({"fwd": {library:
    n}, "bwd": ...}) went to the library ``dtype`` routes to at
    ``head_dim``, with ``expected[direction]`` launches."""
    for direction, n in expected.items():
        route = getattr(A, f"{direction}_library")(dtype, head_dim)
        got = by_library[direction]
        print(f"  {tag}: {direction} launches by library {got} (expected "
              f"all {n} on {route})")
        if got != {**dict.fromkeys(got, 0), route: n}:
            fail(f"{tag}: {direction} launches by library {got}")


def plain_attention(A):
    """The ViT's attention with its kernels' plain version in their place
    (``flat_attention_fwd_plain``: the kernels' arithmetic in PyTorch), for
    holding a model on the card against itself."""

    def attention(q, k, v, num_heads, mask=None):
        if mask is not None:
            return A.dot_product_attention(q, k, v, num_heads, mask)
        hd = q.shape[-1] // num_heads
        return A.flat_attention_fwd_plain(q, k, v, num_heads, hd ** -0.5)[0]

    return attention


def exact_attention_bwd(q, k, v, o, do, lse, num_heads: int, scale: float):
    """K2's function without the TPU kernel's bf16 roundings (p and ds stay
    fp32): from q, k, v, o and do upcast to fp32 and the forward's lse,
    p = exp(q k^T scale - lse), dv = p^T do, dp = do v^T, delta =
    rowsum(do o), ds = p (dp - delta) scale, dq = ds k, dk = ds^T q, one
    head at a time to bound memory, in fp32 (IEEE on the card once
    ``pin_ieee`` has run). Takes and returns K2's flat (B, N, H hd)
    tensors, the gradients in q's dtype; phase 3l's "exact_backward"."""
    import torch

    hd = q.shape[-1] // num_heads
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    for h in range(num_heads):
        cols = slice(h * hd, (h + 1) * hd)
        qh, kh, vh, oh, doh = (x[..., cols].float()
                               for x in (q, k, v, o, do))
        p = torch.exp(qh @ kh.transpose(1, 2) * scale
                      - lse[:, h, :, None].float())
        dp = doh @ vh.transpose(1, 2)
        delta = (doh * oh).sum(-1, keepdim=True)
        ds = p * (dp - delta) * scale
        for grad, x in zip(grads, (ds @ kh, ds.transpose(1, 2) @ qh,
                                   p.transpose(1, 2) @ doh)):
            grad[..., cols] = x.to(grad.dtype)
        del p, dp, ds
    return tuple(grads)


def held_to_plain_attention(A, module, images, keys, tol: float,
                            pool=None) -> dict:
    """``module`` on ``images`` with its attention kernels, then with their
    plain version (``plain_attention``), under IEEE fp32: {key: relative
    L2} of the outputs ``keys`` (or of ``pool`` of them), each within
    ``tol``."""
    import torch

    from lightly_train_tpu_torch.models import vit

    pin_ieee()
    with torch.no_grad():
        got = module(images)
        vit.attention = plain_attention(A)
        try:
            ref = module(images)
        finally:
            vit.attention = A.attention
    if pool is not None:
        got, ref = ({"pooled": pool(x)} for x in (got, ref))
    rel = {}
    for key in keys:
        g, r = got[key].float(), ref[key].float()
        rel[key] = ((g - r).norm() / r.norm()).item()
        if not (torch.isfinite(g).all() and rel[key] <= tol):
            fail(f"{key} with the kernels against the plain attention: "
                 f"relative L2 {rel[key]} (tol {tol})")
    return rel


def timed_saves():
    """Wraps ``CheckpointManager.save`` to record each call's seconds;
    returns (the list they land in, a function that puts it back)."""
    from lightly_train_tpu_torch._checkpoint import checkpoint as C

    seconds = []
    save = C.CheckpointManager.save

    def timed(self, step, *args, **kwargs):
        t0 = time.perf_counter()
        save(self, step, *args, **kwargs)
        seconds.append(time.perf_counter() - t0)

    C.CheckpointManager.save = timed
    return seconds, lambda: setattr(C.CheckpointManager, "save", save)


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in ``obj``: a tensor, a module's state dict,
    an object with ``state_dict()`` (an updater), or dicts, lists and
    tuples of them."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, torch.nn.Module) or hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def counted_writes():
    """Phase 3l's checkpoint counted and not written, its export written
    and timed: ``CheckpointManager.save`` replaced by a recorder of each
    call (its step and the bytes of the tensors it was handed), and
    ``pretrain``'s ``export_model`` wrapped to record its model name, the
    bytes it was handed and its seconds. Phase 3j writes and times a 7B
    checkpoint of the same format; writing 3l's 25 GiB checkpoint as well
    cost 34-40 s of the script's limit. Returns (the records, a function
    that puts both back)."""
    from lightly_train_tpu_torch._checkpoint import checkpoint as C
    from lightly_train_tpu_torch._commands import train as T

    records = {"checkpoint": [], "export": []}
    save, export = C.CheckpointManager.save, T.export_model

    def save_stub(self, step, state, model, method):
        records["checkpoint"].append((step, tensor_bytes(
            [state.params, state.method_state, state.updater])))

    def timed_export(out_path, model_name, backbone_state, *args, **kwargs):
        t0 = time.perf_counter()
        result = export(out_path, model_name, backbone_state, *args,
                        **kwargs)
        records["export"].append((model_name, tensor_bytes(backbone_state),
                                  time.perf_counter() - t0))
        return result

    C.CheckpointManager.save = save_stub
    T.export_model = timed_export

    def restore():
        C.CheckpointManager.save = save
        T.export_model = export

    return records, restore


def two_images(work: Path, size: int = 224):
    """The first two of phase 3's images at ``size``^2, on the card, in
    [0, 1]."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._data.image_dataset import (
        ImageDataset,
        list_image_files,
    )

    dataset = ImageDataset(list_image_files(work / "images"), (size, size))
    images = torch.from_numpy(np.stack([dataset[0], dataset[1]]))
    return images.cuda().float() / 255.0


def run_teacher_7b_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3j: ``pretrain`` distillation v3 of ViT-B/14 from a frozen
    random DINOv3 7B/16 teacher (``method_args={"teacher":
    "dinov3/vit7b16"}``), bf16, batch 64 on phase 3's 64 images, for
    TEACHER_7B_STEPS steps, with every launch counter set to 0 just before
    and read just after. Per step: 40 K1 launches of the teacher on the
    fp32 forward at TEACHER_7B (hd 128), 12 K1 and 12 K2 of the student on
    the bf16 libraries at GLOBAL, no K3 (LARS is unfused). The teacher is
    built on the card and drawn leaf by leaf from the CPU generator; its
    CLS and patch features on 2 images are held against itself with the
    plain attention under IEEE fp32. It checkpoints once, at the end (the
    frozen teacher is in the method state, as in the JAX package). Then one
    more step on a fixed batch under ``torch.profiler``
    (``profiled_step``): the device's busy share, the teacher's K1 (fp32,
    hd 128) device ms and share, and the five kernels that take the most
    device time."""
    import torch

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch.methods import distillationv3 as V3

    steps = TEACHER_7B_STEPS
    out = work / "distill_7b"
    init = V3.DistillationV3.init
    built, methods = [], []

    def timed_init(self, generator, device):
        t0 = time.perf_counter()
        result = init(self, generator, device)
        torch.cuda.synchronize()
        built.append(time.perf_counter() - t0)
        methods.append(self)
        return result

    V3.DistillationV3.init = timed_init
    saves, restore = timed_saves()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    try:
        state = distill_pretrain(
            lt, out, work / "images", "bf16", steps, checkpoint_every=steps,
            method_args={"teacher": "dinov3/vit7b16"})
        torch.cuda.synchronize()
    finally:
        V3.DistillationV3.init = init
        restore()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    teacher_fwd = A.fwd_library(torch.float32, HEAD_DIM_7B)
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    expected = [(DEPTH_7B + DEPTH) * steps, DEPTH * steps, 0, 0, 0]
    expected_by_shape = {(teacher_fwd, TEACHER_7B): DEPTH_7B * steps,
                         (fwd, GLOBAL): DEPTH * steps,
                         (bwd, GLOBAL): DEPTH * steps}
    logged = logged_steps(out)
    for r in logged:
        for key in DISTILL_KEYS:
            if not math.isfinite(r[key]):
                fail(f"7B-teacher step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f}, grad_norm "
              f"{r['grad_norm']:.4e}, {r['profiling/step_time'] * 1e3:.1f} "
              f"ms, {r['profiling/images_per_sec']:.1f} img/s [{card}]")
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
          f"K4 {launches[3]}, K5 {launches[4]} (expected {expected}); by "
          f"shape {by_shape}")
    if ([r["step"] for r in logged] != list(range(1, steps + 1))
            or launches != expected or by_shape != expected_by_shape):
        fail(f"7B-teacher run: steps {[r['step'] for r in logged]}, "
             f"launches {launches}, by shape {by_shape}")
    teacher = state.method_state["teacher"]
    n_params = sum(p.numel() for p in teacher.parameters())
    if (teacher.cfg.dtype != torch.float32 or n_params != 6_716_035_072
            or any(p.requires_grad for p in teacher.parameters())):
        fail("the 7B teacher is not the frozen fp32 DINOv3 7B/16")
    rel = held_to_plain_attention(A, teacher, two_images(work),
                                  ("cls_token", "patch_tokens"), 1e-3)
    ckpt = out / "checkpoints" / f"step_{steps}.pt"
    ckpt_gib = ckpt.stat().st_size / 2 ** 30
    times = [r["profiling/step_time"] * 1e3 for r in logged]
    print(f"  teacher vs itself with the plain attention (IEEE fp32, 2 "
          f"images): relative L2 {rel} (tol 1e-3)")
    images = torch.randint(
        0, 256, (DISTILL_BATCH, 256, 256, 3), dtype=torch.uint8,
        device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 8))
    wall_ms, kernels = profiled_step(
        make_train_step(methods[0], steps, aug_dtype=torch.bfloat16), state,
        images)
    busy_ms = sum(kernels.values())
    k1_ms = sum(ms for name, ms in kernels.items()
                if "attention_fwd_hd128" in name)
    prof = {"wall_ms": wall_ms, "busy_ms": busy_ms, "K1_ms": k1_ms,
            "top": sorted(kernels.items(), key=lambda kv: -kv[1])[:5]}
    print(f"  one profiled step on a fixed batch of {DISTILL_BATCH}: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), the teacher's K1 (fp32, hd "
          f"128) {k1_ms:.2f} ms ({100 * k1_ms / busy_ms:.2f}%) [{card}]")
    for name, ms in prof["top"]:
        print(f"    {ms:9.3f} ms ({100 * ms / busy_ms:5.2f}%)  {name[:110]}")
    print(f"7B teacher: {n_params} parameters, method init (student, heads, "
          f"teacher drawn leaf by leaf) {built[0]:.1f} s; step ms {times}; "
          f"peak {peak_gib:.2f} GiB; checkpoint {ckpt_gib:.2f} GiB saved in "
          f"{saves[-1]:.1f} s; wall {wall:.1f} s [{card}]", flush=True)
    del state, teacher
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    return {"launches": launches, "by_shape": by_shape, "step_ms": times,
            "profile": prof, "peak_gib": peak_gib, "init_s": built[0],
            "checkpoint_gib": ckpt_gib, "checkpoint_save_s": saves[-1],
            "wall_s": wall, "rel_l2": rel}


def seeded_7b14():
    """A DINOv2 7B/14 built on the card and drawn there from a seeded CUDA
    generator, with LayerScale 0.1 so that its 40 blocks tell the images
    apart (at the init's 1e-5 every image's CLS is the learned token's)."""
    import torch

    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    with torch.device("cuda"):
        module = get_wrapped_model("dinov2/vit7b14").module
    module.reset_parameters(torch.Generator("cuda").manual_seed(SEED + 7))
    for name, p in module.named_parameters():
        if name.endswith("gamma"):
            p.data.fill_(0.1)
    return module


def run_embed_7b_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3k: ``embed`` in bf16 at batch 64 over phase 3's 64 images with
    a DINOv2 7B/14 export (30 GiB of fp32, written by ``export_model`` from
    ``seeded_7b14``), counters set to 0 just before and read just after: 40
    K1 launches on the bf16 forward at EMBED_7B (hd 128), no K2, no K3. Two
    images' embeddings held against the same model on the card in bf16 with
    the plain attention. The artifact is deleted afterwards."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
    from lightly_train_tpu_torch._commands import embed as E
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    artifact = work / "vit7b14_export"
    t0 = time.perf_counter()
    module = seeded_7b14()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_model(artifact, "dinov2/vit7b14", module.state_dict())
    write_s = time.perf_counter() - t0
    export_gib = sum(f.stat().st_size for f in artifact.iterdir()) / 2 ** 30
    del module
    torch.cuda.empty_cache()

    load = E.load_exported_model
    loads = []

    def timed_load(path):
        t0 = time.perf_counter()
        result = load(path)
        loads.append(time.perf_counter() - t0)
        return result

    E.load_exported_model = timed_load
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    try:
        path = lt.embed(out=str(work / "embeddings_7b.npz"),
                        data=str(work / "images"), checkpoint=str(artifact),
                        image_size=224, batch_size=DISTILL_BATCH,
                        precision="bf16", format="npz")
        torch.cuda.synchronize()
    finally:
        E.load_exported_model = load
    embed_s = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    shutil.rmtree(artifact)
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM_7B)
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
          f"K4 {launches[3]}, K5 {launches[4]} (expected [{DEPTH_7B}, 0, 0, "
          f"0, 0]); by shape {by_shape}")
    if (launches != [DEPTH_7B, 0, 0, 0, 0]
            or by_shape != {(fwd, EMBED_7B): DEPTH_7B}):
        fail(f"7B embed launch counts {launches}, {by_shape}")
    emb = np.load(path)["embeddings"]
    if emb.shape != (2 * BATCH, 4096) or not np.isfinite(emb).all():
        fail(f"7B embeddings {emb.shape}, finite {np.isfinite(emb).all()}")

    # The same model: drawn again from the same CUDA generator, computing
    # in bf16 on the exported (fp32) parameters.
    with torch.device("meta"):
        wrapped = get_wrapped_model("dinov2/vit7b14", dtype=torch.bfloat16)
    wrapped.module.load_state_dict(seeded_7b14().state_dict(), assign=True)
    # bf16 through 40 blocks: the two attentions round p in other orders
    # and every bf16 GEMM after carries the difference on; held to
    # check_backbone's bf16 tolerance.
    rel = held_to_plain_attention(A, wrapped.module, two_images(work),
                                  ("pooled",), 5e-2, wrapped.forward_pool)
    with torch.no_grad():
        mine = wrapped.forward_pool(wrapped.module(two_images(work)))
    rel_embed = float(np.linalg.norm(emb[:2] - mine.float().cpu().numpy())
                      / np.linalg.norm(mine.float().cpu().numpy()))
    if not rel_embed <= 5e-2:
        fail(f"7B embed's embeddings against the model on the card: "
             f"relative L2 {rel_embed}")
    del wrapped
    torch.cuda.empty_cache()
    ips = 2 * BATCH / (embed_s - loads[0])
    print(f"  embeddings of 2 images: against the model's kernel forward "
          f"relative L2 {rel_embed:.3e}, kernels vs plain attention (bf16) "
          f"{rel['pooled']:.3e} (tol 5e-2 each)")
    print(f"7B embed: export {export_gib:.2f} GiB written in {write_s:.1f} s "
          f"(model drawn on the card in {init_s:.1f} s), embed "
          f"{embed_s:.1f} s of which artifact load {loads[0]:.1f} s: "
          f"{ips:.1f} img/s after the load; peak {peak_gib:.2f} GiB "
          f"[{card}]", flush=True)
    return {"launches": launches, "by_shape": by_shape, "peak_gib": peak_gib,
            "export_gib": export_gib, "write_s": write_s, "load_s": loads[0],
            "embed_s": embed_s, "images_per_sec": ips, "rel_l2": rel}


def refuse_dinov2_7b(lt, work: Path) -> str:
    """Phase 3l: ``pretrain`` DINOv2 with the 7B/16 student must raise
    NotImplementedError naming FSDP (item 7.6) with the card's own
    capacity, before anything is allocated on the card or written, and
    offer no ``adamw8bit``, with which it would not fit either; the same
    student by distillation with AdamW, or with LARS at its default
    momentum 0.9 (75.4 GiB counted, with the refusal's headroom more than
    the card: ``--7b-lars`` runs out of memory there), is refused with the
    offer (``adamw8bit`` brings it to 63 GiB)."""
    import torch

    said = []
    for method, optim in (("dinov2", "auto"), ("distillationv3", "adamw"),
                          ("distillationv3", "lars")):
        out = work / f"{method}_{optim}_7b"
        before = torch.cuda.memory_allocated()
        try:
            lt.pretrain(out=str(out), data=str(work / "images"),
                        model=STUDENT_7B, method=method, optim=optim,
                        batch_size=DISTILL_BATCH, steps=1, precision="bf16")
        except NotImplementedError as err:
            said.append(str(err))
        else:
            fail(f"pretrain {method} with a 7B/16 student and {optim} was "
                 "not refused")
        offered = "optim='adamw8bit'" in said[-1]
        if (torch.cuda.memory_allocated() != before or out.exists()
                or "ROADMAP item 7.6" not in said[-1]
                or offered != (method == "distillationv3")):
            fail(f"the {method} 7B refusal allocated, wrote or said: "
                 f"{said[-1]}")
    return " / ".join(said)


def profiled_step(step, state, images) -> tuple:
    """One train step on ``images`` (uint8, on the card) under
    ``torch.profiler``, the fp32 GEMMs under the precision variable as
    ``pretrain`` runs them, IEEE fp32 pinned back after: (wall ms, {kernel
    name: device ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lightly_train_tpu_torch._system import apply_matmul_precision

    apply_matmul_precision()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, images, torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    del prof
    pin_ieee()
    return wall_ms, kernels


def student_7b_fixed_batch(A, method, state, images, steps: int) -> dict:
    """Phase 3l's fixed batch, on the state the run left: one whole train
    step (forward, backward, the update) under ``torch.profiler``, for the
    device's busy time and the share of it in K1 and K2 at hd 128 (the
    fp32 teacher under the precision variable, as ``pretrain`` runs it);
    then, from the state after it, the loss and the STUDENT_7B_LEAVES
    gradients, from the same images and generator, under IEEE fp32: with
    the attention kernels ("kernels"); with K2's plain version
    (``flat_attention_bwd_plain``) in its place ("plain_backward"); with
    autograd through the plain forward (``plain_attention``,
    "plain_attention"); and with K1's forward and an fp32 backward without
    the TPU kernel's bf16 roundings (``exact_attention_bwd``,
    "exact_backward"). Returns {"profile": {...}, tag: (loss, {leaf:
    gradient})}. Each pass frees its gradients before the next."""
    import torch

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch.models import vit

    step = make_train_step(method, steps, aug_dtype=torch.bfloat16)
    named = dict(state.params.named_parameters())
    wall_ms, kernels = profiled_step(step, state, images)
    results = {"profile": {
        "wall_ms": wall_ms, "busy_ms": sum(kernels.values()),
        "K1_ms": sum(ms for name, ms in kernels.items()
                     if "attention_fwd_hd128" in name),
        "K2_ms": sum(ms for name, ms in kernels.items()
                     if "attention_bwd_hd128" in name),
        "K2_kernels": {name.split("(")[0]: ms for name, ms in kernels.items()
                       if "attention_bwd_hd128" in name}}}
    kernel_bwd = A.flat_attention_bwd
    for tag in ("kernels", "plain_backward", "plain_attention",
                "exact_backward"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        if tag == "plain_backward":
            A.flat_attention_bwd = A.flat_attention_bwd_plain
        if tag == "exact_backward":
            A.flat_attention_bwd = exact_attention_bwd
        if tag == "plain_attention":
            vit.attention = plain_attention(A)
        try:
            loss, grads, _, _ = step.loss_and_grads(state, images, gen)
        finally:
            vit.attention = A.attention
            A.flat_attention_bwd = kernel_bwd
        results[tag] = (float(loss), {
            n: grads[n].detach().float().clone() for n in STUDENT_7B_LEAVES})
        del grads
        for p in named.values():
            p.grad = None
    torch.cuda.empty_cache()
    return results


def run_student_7b_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3l: ``pretrain`` distillation v3 of a full-width, full-depth
    DINOv3 7B/16 student (STUDENT_7B_ARGS: LARS at momentum 0, every block
    recomputed) in bf16 at batch 64 on phase 3's 64 images, for
    STUDENT_7B_STEPS steps, with every launch counter set to 0 just before
    and read just after. Per step: 80 K1 launches of the student on the
    bf16 forward at TEACHER_7B (40 forward, 40 recomputed), 40 K2 on the
    bf16 backward there, 12 K1 of the fp32 ViT-B/16 teacher at TEACHER, no
    K3. The student is built on the card and drawn leaf by leaf from the
    CPU generator. Then: the checkpoint it hands over (of the student's
    size; counted, not written: ``counted_writes``) and the export it
    writes (timed), one
    profiled step and the student's gradients on a fixed batch with the
    kernels against K2's plain version and the plain attention
    (``student_7b_fixed_batch``), and DINOv2 with the same student refused
    (``refuse_dinov2_7b``, run first, on an empty card)."""
    import torch

    from lightly_train_tpu_torch.methods import distillationv3 as V3

    refused = refuse_dinov2_7b(lt, work)
    print(f"  DINOv2, and distillation with AdamW and with LARS at "
          f"momentum 0.9, with the 7B/16 student: "
          f"refused before any allocation: {refused}")
    steps = STUDENT_7B_STEPS
    out = work / "student_7b"
    init = V3.DistillationV3.init
    built, methods = [], []

    def timed_init(self, generator, device):
        t0 = time.perf_counter()
        result = init(self, generator, device)
        torch.cuda.synchronize()
        built.append(time.perf_counter() - t0)
        methods.append(self)
        return result

    V3.DistillationV3.init = timed_init
    writes, restore = counted_writes()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    try:
        state = lt.pretrain(
            out=str(out), data=str(work / "images"), model=STUDENT_7B,
            batch_size=DISTILL_BATCH, steps=steps, precision="bf16",
            log_every=1, seed=SEED, checkpoint_every=steps,
            **STUDENT_7B_ARGS)
        torch.cuda.synchronize()
    finally:
        V3.DistillationV3.init = init
        restore()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM_7B)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM_7B)
    teacher_fwd = A.fwd_library(torch.float32, HEAD_DIM)
    expected = [(2 * DEPTH_7B + DEPTH) * steps, DEPTH_7B * steps, 0, 0, 0]
    expected_by_shape = {(fwd, TEACHER_7B): 2 * DEPTH_7B * steps,
                         (bwd, TEACHER_7B): DEPTH_7B * steps,
                         (teacher_fwd, TEACHER): DEPTH * steps}
    logged = logged_steps(out)
    for r in logged:
        for key in DISTILL_KEYS:
            if not math.isfinite(r[key]):
                fail(f"7B-student step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f}, grad_norm "
              f"{r['grad_norm']:.4e}, {r['profiling/step_time'] * 1e3:.1f} "
              f"ms, {r['profiling/images_per_sec']:.1f} img/s [{card}]")
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
          f"K4 {launches[3]}, K5 {launches[4]} (expected {expected}); by "
          f"shape {by_shape}")
    if ([r["step"] for r in logged] != list(range(1, steps + 1))
            or launches != expected or by_shape != expected_by_shape):
        fail(f"7B-student run: steps {[r['step'] for r in logged]}, "
             f"launches {launches}, by shape {by_shape}")
    student = state.params["student"]
    n_params = sum(p.numel() for p in student.parameters())
    if n_params != 6_716_035_072 or student.cfg.remat_every != 1:
        fail("the student is not the full DINOv3 7B/16 with remat_every 1")
    # One checkpoint, at the end, counted (counted_writes): it holds the
    # student, its heads and the frozen teacher (the updater has no moments
    # at momentum 0). One export of the student, written.
    student_bytes = tensor_bytes(student)
    ckpt = writes["checkpoint"]
    export = out / "exported_models" / "exported_last" / "model.pt"
    if ([step for step, _ in ckpt] != [steps] or ckpt[0][1] <= student_bytes
            or [w[:2] for w in writes["export"]] != [(STUDENT_7B,
                                                      student_bytes)]
            or not export.is_file()
            or export.stat().st_size < student_bytes):
        fail(f"7B-student run's writes: {writes} (student "
             f"{student_bytes} bytes), export {export.is_file()}")
    ckpt_gib = ckpt[0][1] / 2 ** 30
    export_gib = export.stat().st_size / 2 ** 30
    export_s = writes["export"][0][2]
    shutil.rmtree(out)
    times = [r["profiling/step_time"] * 1e3 for r in logged]

    images = torch.randint(
        0, 256, (DISTILL_BATCH, 256, 256, 3), dtype=torch.uint8,
        device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 8))
    fixed = student_7b_fixed_batch(A, methods[0], state, images, steps)
    prof = fixed["profile"]
    print(f"  one profiled step on a fixed batch of {DISTILL_BATCH}: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, "
          f"K1 at hd 128 {prof['K1_ms']:.1f} ms "
          f"({100 * prof['K1_ms'] / prof['busy_ms']:.2f}%), K2 at hd 128 "
          f"{prof['K2_ms']:.1f} ms "
          f"({100 * prof['K2_ms'] / prof['busy_ms']:.2f}%) [{card}]")
    print("  K2's kernels in that step (ms): "
          + ", ".join(f"{n} {ms:.2f}" for n, ms in prof["K2_kernels"].items()))
    # Held: the kernels against the same step with K2's plain version in
    # its place (the same forward), 5e-2 relative L2 a leaf. Written down,
    # not held: against autograd through the plain forward, which changes
    # the forward too. At a random init the loss is that of a uniform
    # prediction and its gradient moves with bf16-sized changes of the
    # forward: leaves whose gradient passes through no attention backward
    # (the final norm, the last block's MLP) differ by a few percent there
    # (PERF.md §6).
    got = fixed["kernels"][1]
    rel = {ref: {n: ((got[n] - fixed[ref][1][n]).norm()
                     / fixed[ref][1][n].norm()).item()
                 for n in STUDENT_7B_LEAVES}
           for ref in ("plain_backward", "plain_attention")}
    for name, r in rel["plain_backward"].items():
        if not (torch.isfinite(got[name]).all() and r <= 5e-2):
            fail(f"7B student's {name} gradient with the kernels against "
                 f"K2's plain version: relative L2 {r} (tol 5e-2)")
    # Written down, not held: each pass against the gradients of K1's
    # forward with an fp32 backward that rounds neither p nor ds to bf16,
    # which parts the backward's formula (kernels, plain_backward) from
    # the forward's bf16 noise (plain_attention).
    exact = fixed["exact_backward"][1]
    rel["exact_backward"] = {
        tag: {n: ((fixed[tag][1][n] - exact[n]).norm()
                  / exact[n].norm()).item() for n in STUDENT_7B_LEAVES}
        for tag in ("kernels", "plain_backward", "plain_attention")}
    print(f"  fixed batch of {DISTILL_BATCH}: losses "
          + ", ".join(f"{t} {fixed[t][0]:.7f}" for t in (
              "kernels", "plain_backward", "plain_attention",
              "exact_backward")))
    for ref, tol in (("plain_backward", "tol 5e-2 each"),
                     ("plain_attention", "written down, not held")):
        print(f"  gradients' relative L2 against {ref} ({tol}): "
              + ", ".join(f"{n} {v:.3e}" for n, v in rel[ref].items()))
    for tag, by_leaf in rel["exact_backward"].items():
        print(f"  {tag} gradients' relative L2 against exact_backward "
              "(written down, not held): "
              + ", ".join(f"{n} {v:.3e}" for n, v in by_leaf.items()))
    print(f"7B student: {n_params} parameters, method init (student drawn "
          f"leaf by leaf on the card, heads, teacher) {built[0]:.1f} s; step "
          f"ms {times}; peak {peak_gib:.2f} GiB; checkpoint "
          f"{ckpt_gib:.2f} GiB handed over (counted, not written), export "
          f"{export_gib:.2f} GiB written in {export_s:.1f} s; "
          f"wall {wall:.1f} s [{card}]", flush=True)
    del state, student, fixed, got, exact
    torch.cuda.empty_cache()
    return {"launches": launches, "by_shape": by_shape, "step_ms": times,
            "profile": prof,
            "peak_gib": peak_gib, "init_s": built[0],
            "checkpoint_gib": ckpt_gib, "export_gib": export_gib,
            "export_s": export_s, "wall_s": wall, "grad_rel_l2": rel}


def run_vmem_path(A, card: str, dtype: str) -> dict:
    """The K4/K5 path: ``vmem_attention`` over (B, N, H, hd) and
    ``vmem_attention_bhnd`` over real (B, H, N, hd) tensors, forward and
    backward through autograd as a user calls them, at the ViT-B/14 global
    shape, with the launch counters set to 0 just before and read just
    after; the results against the plain versions."""
    import torch

    from lightly_train_tpu_torch.ops.kernels import vmem_attention

    B, N, H, hd = GLOBAL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(shape, grad):
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch_dtype(dtype))
        return x.requires_grad_() if grad else x

    api = [randn((B, N, H, hd), i < 3) for i in range(4)]
    bhnd = [randn((B, H, N, hd), i < 3) for i in range(4)]
    counters = (A.vmem_attention_fwd, A.vmem_attention_bwd,
                A.flat_attention_fwd, A.flat_attention_bwd)
    for fn in counters:
        fn.launches = 0
    for by_lib in (A.fwd_launches, A.bwd_launches):
        by_lib.update(dict.fromkeys(by_lib, 0))
    t0 = time.perf_counter()
    out_api = vmem_attention(*api[:3])
    grads_api = torch.autograd.grad((out_api * api[3]).sum(), api[:3])
    out_bhnd = A.vmem_attention_bhnd(*bhnd[:3])
    grads_bhnd = torch.autograd.grad((out_bhnd * bhnd[3]).sum(), bhnd[:3])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = [fn.launches for fn in counters]
    print(f"  {dtype}: launches K4 {launches[0]}, K5 {launches[1]}, K1 "
          f"{launches[2]}, K2 {launches[3]} (expected [2, 2, 0, 0]); "
          f"{wall_ms:.1f} ms for both calls with their backward [{card}]")
    if launches != [2, 2, 0, 0]:
        fail(f"vmem_attention path launches {launches}")
    check_routes(A, f"vmem_attention {dtype}",
                 {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)},
                 torch_dtype(dtype), hd, {"fwd": 2, "bwd": 2})
    scale = hd ** -0.5
    for layout, (q, k, v, co), out, grads in (
            ("bnhd", [x.transpose(1, 2) for x in api],
             out_api.transpose(1, 2), [g.transpose(1, 2) for g in grads_api]),
            ("bhnd", bhnd, out_bhnd, grads_bhnd)):
        q, k, v = (x.detach() for x in (q, k, v))
        o_ref, lse_ref = A.vmem_attention_fwd_plain(q, k, v, scale)
        refs = A.vmem_attention_bwd_plain(q, k, v, out.detach(), co, lse_ref,
                                          scale)
        floors = {"dq": cancel_floor(scale, hd, co, v, k),
                  "dk": cancel_floor(scale, hd, co, v, q)}
        for name, got, ref in zip(("o", "dq", "dk", "dv"), (out, *grads),
                                  (o_ref, *refs)):
            if not torch.isfinite(got).all():
                fail(f"vmem_attention {dtype} {layout} {name} is not finite")
            held(f"vmem_attention {dtype} {layout} {name}", got.detach(), ref,
                 dtype, floors.get(name, 0.0))
    return {"K4": launches[0], "K5": launches[1]}


def run_remat_path(lt, A, F, card: str, work: Path, main: dict) -> dict:
    """Phase 3g: ``pretrain`` DINOv2 ViT-B/14 in bf16 at batch 32 for
    REMAT_STEPS steps with ``model_args`` REMAT (every 2nd block recomputed
    in the backward pass, drop path 0.1) and Sinkhorn centering, every
    launch counter set to 0 just before and read just after: K1 once more
    in each recomputed block of the two student forwards
    (``dinov2_expected``), K2 and K3 as without remat. Finite losses, the
    centers left at 0 (Sinkhorn does not move them), the backbone against
    the fp32 CPU reference, and the peak memory beside phase 3's."""
    import torch

    out = work / "remat"
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = pretrain_main_path(
        lt, out, work / "images", "bf16", steps=REMAT_STEPS,
        checkpoint_every=REMAT_STEPS, model_args=REMAT,
        method_args={"center_method": "sinkhorn"})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hp = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])[
        "hyperparams"]
    if (hp["model_args"] != REMAT
            or hp["method_args"]["center_method"] != "sinkhorn"):
        fail(f"phase 3g ran {hp['model_args']}, {hp['method_args']}")
    steps = logged_steps(out)
    if [r["step"] for r in steps] != list(range(1, REMAT_STEPS + 1)):
        fail(f"remat logged steps {[r['step'] for r in steps]}")
    for r in steps:
        for key in ("train_loss", "dino_loss", "ibot_loss", "koleo_loss",
                    "grad_norm"):
            if not math.isfinite(r[key]):
                fail(f"remat step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f} (dino "
              f"{r['dino_loss']:.4f}, ibot {r['ibot_loss']:.4f}), "
              f"grad_norm {r['grad_norm']:.4f}, "
              f"{r['profiling/step_time'] * 1e3:.1f} ms, "
              f"{r['profiling/images_per_sec']:.1f} img/s [{card}]")
    expected = dinov2_expected(REMAT_STEPS, REMAT["remat_every"])
    recomputed = len(range(0, DEPTH, REMAT["remat_every"]))
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    n = REMAT_STEPS
    expected_by_shape = {(fwd, GLOBAL): (2 * DEPTH + recomputed) * n,
                         (fwd, LOCAL): (DEPTH + recomputed) * n,
                         (bwd, GLOBAL): DEPTH * n, (bwd, LOCAL): DEPTH * n}
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}: K1 {expected[0] // n} a step, {DEPTH * 3} without "
          f"remat plus {recomputed} recomputed blocks x 2 student "
          f"forwards); by shape {by_shape}; peak memory {peak_gib:.2f} GiB "
          f"(phase 3, no remat: {main['peak_gib']:.2f} GiB); wall "
          f"{wall:.1f} s")
    if launches != expected or by_shape != expected_by_shape:
        fail(f"remat launch counts {launches}, {by_shape}")
    centers = [state.method_state[k] for k in ("dino_center", "ibot_center")]
    if any(c.any() for c in centers):
        fail("Sinkhorn centering moved the centers")
    check_backbone(state.params["student"], "dinov2/vitb14", "bf16", 768)
    shutil.rmtree(out)
    return {"launches": launches, "by_shape": by_shape, "peak_gib": peak_gib,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps]}


def remat_step_comparison(A, F, card: str) -> None:
    """Phase 3g, fixed batch: two DINOv2 ViT-B/14 bf16 steps (drop path
    0.1, Sinkhorn) of each REMAT_VARIANTS model from the same initial state,
    batch and generator; the losses and the trained parameters against the
    run without remat (bitwise, or else within the bf16 tolerances: 1e-2
    relative on the losses and relative L2 on every parameter), each
    variant's K1/K2/K3 launches against ``dinov2_expected``, its second
    step's time and its peak memory."""
    import torch

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch._optim import cosine_warmup
    from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    dev = torch.device("cuda")
    images = torch.randint(
        0, 256, (BATCH, 256, 256, 3), dtype=torch.uint8, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 4))
    ref = None
    for tag, args in REMAT_VARIANTS.items():
        wrapped = get_wrapped_model("dinov2/vitb14", dtype=torch.bfloat16,
                                    drop_path_rate=0.1, **args)
        method = DINOv2(wrapped, DINOv2Args(center_method="sinkhorn"))
        params, method_state = method.init(
            torch.Generator().manual_seed(SEED), dev)
        named = dict(params.named_parameters())
        updater = build_fused_updater(method, method.default_optimizer_args(),
                                      cosine_warmup(1e-3, 100), named, 100)
        state = TrainState(0, params, method_state, updater)
        step = make_train_step(method, 100, aug_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters(A, F)
        losses = []
        for i in range(2):
            gen.manual_seed(SEED + 5 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(state, images, gen)["train_loss"]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = [fn.launches for fn in counters]
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = dinov2_expected(2, args.get("remat_every", 0))
        if ref is None:
            ref = {"losses": losses, "params": {
                k: v.detach().clone() for k, v in named.items()}}
            verdict = "the reference"
        else:
            rel = max(((named[k].detach() - v).float().norm()
                       / v.float().norm().clamp_min(1e-30)).item()
                      for k, v in ref["params"].items())
            loss_rel = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref["losses"]))
            bitwise = losses == ref["losses"] and all(
                torch.equal(named[k], v) for k, v in ref["params"].items())
            verdict = (f"losses relative {loss_rel:.3e}, parameters' largest "
                       f"relative L2 {rel:.3e} (tol 1e-2); bitwise equal: "
                       f"{bitwise}")
            if not (bitwise or (loss_rel <= 1e-2 and rel <= 1e-2)):
                fail(f"{tag} step against the run without remat: {verdict}")
        print(f"  {tag}: losses {losses}; {verdict}; launches K1 "
              f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]} (expected "
              f"{expected[:3]}); second step {ms:.1f} ms; peak "
              f"{peak_gib:.2f} GiB [{card}]")
        if launches != expected:
            fail(f"{tag} launches {launches} != {expected}")
        del state, params, method_state, updater, named, step
        torch.cuda.empty_cache()


def run_precision_path(lt, A, F, card: str, work: Path) -> None:
    """Phase 3h: under each LIGHTLY_TRAIN_MATMUL_PRECISION value, the fp32
    DINOv2 ViT-B/14 main path and the fp32 distillation path of phase 3f
    for PRECISION_STEPS steps each, every launch counter set to 0 just
    before each and read just after: the CUDA backend's TF32 switches the
    run leaves, step times, peak memory, and the trained CLS (on the card,
    under those switches) against the fp32 CPU reference. IEEE fp32 is
    pinned back after each run."""
    import os

    import torch

    data = work / "images"
    prior = os.environ.get("LIGHTLY_TRAIN_MATMUL_PRECISION")
    for value, tf32 in PRECISIONS.items():
        os.environ["LIGHTLY_TRAIN_MATMUL_PRECISION"] = value
        try:
            for path in ("dinov2", "distillation"):
                out = work / f"precision_{value}_{path}"
                pin_ieee()  # what the run must move, where tf32 is True
                torch.cuda.reset_peak_memory_stats()
                counters = reset_counters(A, F)
                if path == "dinov2":
                    state = pretrain_main_path(
                        lt, out, data, "fp32", PRECISION_STEPS,
                        checkpoint_every=PRECISION_STEPS)
                    expected = dinov2_expected(PRECISION_STEPS)
                else:
                    state = distill_pretrain(
                        lt, out, data, "fp32", PRECISION_STEPS,
                        checkpoint_every=PRECISION_STEPS)
                    expected = distill_expected(A, "fp32",
                                                PRECISION_STEPS)[0]
                torch.cuda.synchronize()
                flags = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
                launches = [fn.launches for fn in counters]
                peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
                steps = logged_steps(out)
                if flags != (tf32, tf32):
                    fail(f"{value}: the run left the TF32 switches {flags}")
                if launches != expected:
                    fail(f"{value} {path} launches {launches} != {expected}")
                for r in steps:
                    if not (math.isfinite(r["train_loss"])
                            and math.isfinite(r["grad_norm"])):
                        fail(f"{value} {path} step {r['step']} not finite")
                check_backbone(
                    state.params["student"], "dinov2/vitb14", "fp32", 768,
                    f" under {value!r} ({'TF32' if tf32 else 'IEEE fp32'})")
                ms = [r["profiling/step_time"] * 1e3 for r in steps]
                print(f"  {value} {path} fp32: TF32 switches (matmul, cuDNN) "
                      f"{flags}; step ms {ms}; peak {peak_gib:.2f} GiB; "
                      f"launches {launches}; losses "
                      f"{[r['train_loss'] for r in steps]} [{card}]",
                      flush=True)
                del state
                shutil.rmtree(out)
        finally:
            os.environ.pop("LIGHTLY_TRAIN_MATMUL_PRECISION")
            if prior is not None:
                os.environ["LIGHTLY_TRAIN_MATMUL_PRECISION"] = prior
            pin_ieee()


def run_nan_path(lt, A, F, card: str, work: Path) -> None:
    """Phase 3i: ``pretrain`` DINOv2 vittest14 in bf16 at batch 32 for
    NAN_STEPS steps (checkpoint every NAN_STEP), NAN_LEAF set to NaN once
    state step NAN_STEP has run, before that step's checkpoint: the run
    writes ``debug/nan_capture_step<NAN_STEP>.npz`` and raises
    ``NaNDetectedError`` naming step NAN_STEP + 1 once the next step is
    dispatched; then ``replay_nan_capture`` on the card, from the step-NAN_STEP
    checkpoint, reports a non-finite loss and names the poisoned leaf. The
    counters are set to 0 before the run and read after the replay: the
    run's NAN_STEPS steps (K1 6, K2 4, K3 1 each) and the replay's one
    forward and backward (K1 6, K2 4)."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._commands import train as T
    from lightly_train_tpu_torch._debug import replay_nan_capture
    from lightly_train_tpu_torch._debug.nan_guard import replay_capture
    from lightly_train_tpu_torch.errors import NaNDetectedError

    make = T.make_train_step

    def poisoned(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state, images, generator, **kw):
            metrics = step(state, images, generator, **kw)
            if state.step == NAN_STEP:
                with torch.no_grad():
                    dict(state.params.named_parameters())[NAN_LEAF][0, 0] = (
                        float("nan"))
            return metrics

        return train_step

    out = work / "nan"
    counters = reset_counters(A, F)
    T.make_train_step = poisoned
    t0 = time.perf_counter()
    try:
        lt.pretrain(
            out=str(out), data=str(work / "images"),
            model="dinov2/vittest14", method="dinov2", batch_size=BATCH,
            steps=NAN_STEPS, precision="bf16", log_every=50,
            canonical_size=256, seed=SEED, checkpoint_every=NAN_STEP)
        fail("the poisoned run finished without NaNDetectedError")
    except NaNDetectedError as err:
        said = str(err)
    finally:
        T.make_train_step = make
    run_s = time.perf_counter() - t0
    # Every parameter is NaN by then (the NaN gradients went through the
    # update): the error names the first 20 by name, as the JAX package's.
    first, named = said.splitlines()[0], said.splitlines()[2:]
    print(f"  NaNDetectedError: {first} ({len(named)} leaves named, the "
          f"first {named[:1]})")
    if f"at step {NAN_STEP + 1} " not in first or len(named) != 20:
        fail(f"NaNDetectedError names the wrong step or leaves: {said}")
    captures = sorted(p.name for p in (out / "debug").iterdir())
    capture = replay_capture(out / "debug" / f"nan_capture_step{NAN_STEP}.npz")
    print(f"  captures {captures}: step {int(capture['step'])}, batch "
          f"{capture['batch'].shape} {capture['batch'].dtype}, generator "
          f"state {capture['generator'].nbytes} bytes "
          f"({capture['generator_device']})")
    if (captures != [f"nan_capture_step{NAN_STEP}.npz"]
            or int(capture["step"]) != NAN_STEP
            or capture["batch"].shape != (BATCH, 256, 256, 3)
            or capture["batch"].dtype != np.uint8
            or str(capture["generator_device"]) != "cuda"):
        fail("the NaN capture")
    t0 = time.perf_counter()
    report = replay_nan_capture(out)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    expected = [6 * NAN_STEPS + 6, 4 * NAN_STEPS + 4, NAN_STEPS, 0, 0]
    params = [o for o in report["offenders"] if o.startswith("params/")]
    print(f"  replay on the card: step {report['step']}, checkpoint step "
          f"{report['restored_checkpoint_step']}, loss {report['loss']}, "
          f"finite {report['finite']}, {len(report['offenders'])} offenders,"
          f" parameters {params}; run {run_s:.1f} s, replay {replay_s:.1f} s;"
          f" launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
          f"K4 {launches[3]}, K5 {launches[4]} (expected {expected}) "
          f"[{card}]")
    if (report["step"] != NAN_STEP or report["finite"]
            or report["restored_checkpoint_step"] != NAN_STEP
            or math.isfinite(report["loss"])
            or params != [f"params/{NAN_LEAF}"]):
        fail(f"the replay's report {report}")
    if launches != expected:
        fail(f"NaN path launches {launches} != {expected}")
    shutil.rmtree(out)


def profile_steps(card: str, precision: str, method_name: str = "dinov2",
                  steps: int = 3) -> None:
    """Optional (``--profile``): where a main path's step time goes.

    Runs the pretraining step of ``run_main_path`` (``method_name``
    "dinov2": batch BATCH, the fused update) or of
    ``run_distillation_path`` ("distillation": batch DISTILL_BATCH, queue
    DISTILL_QUEUE, LARS on the unfused update) in ``precision``, on one
    fixed uint8 batch on the card (no host data loading), for 2 warm-up
    steps and ``steps`` profiled steps under ``torch.profiler``, and prints
    the device's busy share and the kernels that take the most device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch._optim import cosine_warmup
    from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
    from lightly_train_tpu_torch._optim.update import build_update
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.methods.distillationv3 import (
        DistillationV3,
        DistillationV3Args,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    from lightly_train_tpu_torch._system import apply_matmul_precision

    # The fp32 products as pretrain runs them (LIGHTLY_TRAIN_MATMUL_PRECISION,
    # TF32 by default); IEEE fp32 again after the window.
    apply_matmul_precision()
    dev = torch.device("cuda")
    dtype = torch_dtype(precision)
    wrapped = get_wrapped_model("dinov2/vitb14", dtype=dtype)
    if method_name == "dinov2":
        method, build, batch = DINOv2(wrapped, DINOv2Args()), \
            build_fused_updater, BATCH
    else:
        method, build, batch = DistillationV3(wrapped, DistillationV3Args(
            queue_size=DISTILL_QUEUE)), build_update, DISTILL_BATCH
    params, method_state = method.init(torch.Generator().manual_seed(SEED),
                                       dev)
    named = dict(params.named_parameters())
    updater = build(method, method.default_optimizer_args(),
                    cosine_warmup(1e-3, 1000, 10), named, 1000)
    state = TrainState(0, params, method_state, updater)
    step = make_train_step(method, 1000, aug_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    images = torch.randint(0, 256, (batch, 256, 256, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    for _ in range(2):
        step(state, images, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, images, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3 / steps  # ms/step
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    print(f"profile {method_name} {precision}: {steps} steps, wall {wall_ms:.1f} ms/step, "
          f"device busy "
          f"{busy_ms:.1f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(v[1] for v in kernels.values()) // steps} kernel launches "
          f"per step [{card}]")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:8.3f} ms/step {n // steps:5d} launches  {name[:110]}")
    pin_ieee()


def png_bytes(samples, ctype: int, depth: int, palette=None,
              interlace: bool = False) -> bytes:
    """A PNG (bit depth 8 or 16) of ``samples`` (h, w, channels), every
    scanline filtered Up, in Adam7's seven passes where ``interlace``."""
    import zlib

    import numpy as np

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))

    def scanlines(s) -> bytes:
        rows = s.reshape(s.shape[0], -1)
        rows = (rows.astype(">u2").view(np.uint8).reshape(len(rows), -1)
                if depth == 16 else rows.astype(np.uint8))
        up = rows - np.vstack([np.zeros_like(rows[:1]), rows[:-1]])
        return np.hstack([np.full((len(rows), 1), 2, np.uint8), up]).tobytes()

    h, w, _ = samples.shape
    passes = (((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) if interlace
              else ((0, 0, 1, 1),))
    raw = b"".join(scanlines(samples[y0::dy, x0::dx])
                   for x0, y0, dx, dy in passes
                   if samples[y0::dy, x0::dx].size)
    head = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes(
        [depth, ctype, 0, 0, int(interlace)])
    plte = b"" if palette is None else chunk(b"PLTE", palette.tobytes())
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + plte
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def png_cases(folder: Path) -> list:
    """Phase 3m's PNGs (RGB, RGBA, palette, 16-bit RGB, Adam7) under
    ``folder``, each with what it must decode to: (path, uint8 HWC)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    folder.mkdir(parents=True)
    h, w = 300, 260
    yy, xx = np.mgrid[0:h, 0:w] / w
    field = np.stack([np.sin(2 * np.pi * (c + 1) * (yy + xx) + c)
                      for c in range(4)], axis=-1) * 0.5 + 0.5
    rgba = np.clip(field * 250 + rng.normal(0, 5, field.shape), 0, 255)
    rgba = rgba.astype(np.uint8)
    rgb16 = rgba[..., :3].astype(np.uint16) * 256 + rng.integers(
        0, 256, (h, w, 3), dtype=np.uint16)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    index = rgba[..., :1]
    cases = {
        "rgb.png": (png_bytes(rgba[..., :3], 2, 8), rgba[..., :3]),
        "rgba.png": (png_bytes(rgba, 6, 8), rgba[..., :3]),
        "palette.png": (png_bytes(index, 3, 8, palette),
                        palette[index[..., 0]]),
        "rgb16.png": (png_bytes(rgb16, 2, 16), (rgb16 >> 8).astype(np.uint8)),
        "adam7.png": (png_bytes(rgba[..., :3], 2, 8, interlace=True),
                      rgba[..., :3]),
    }
    out = []
    for name, (data, expected) in cases.items():
        (folder / name).write_bytes(data)
        out.append((folder / name, expected))
    return out


def meta_layout(state: dict) -> dict:
    """A port ViT state dict in the naming of Meta's DINOv2 and DINOv3
    checkpoints: fused qkv (where the key projection has no bias, DINOv3's
    zero k bias and its ``bias_mask``), a zero CLS entry in front of
    ``pos_embed``, register tokens as DINOv3's ``storage_tokens``,
    ``patch_embed.proj``, ``mask_token`` (1, D)."""
    import torch

    out = {}
    for k, v in state.items():
        if ".attn.k." in k or ".attn.v." in k:
            continue
        if ".attn.q." in k:
            parts = [state.get(k.replace(".q.", f".{n}.")) for n in "qkv"]
            if parts[1] is None:
                parts[1] = torch.zeros_like(v)
                out[k.replace(".q.bias", ".qkv.bias_mask")] = torch.cat(
                    [torch.ones_like(v), torch.zeros_like(v),
                     torch.ones_like(v)])
            out[k.replace(".q.", ".qkv.")] = torch.cat(parts)
        elif k == "pos_embed":
            out[k] = torch.cat([torch.zeros_like(v[:, :1]), v], dim=1)
        elif k == "mask_token":
            out[k] = v[None]
        elif k == "register_tokens":
            out["storage_tokens"] = v
        else:
            out[k.replace("patch_embed.", "patch_embed.proj.")] = v
    return out


def write_meta_pth(path: Path, model: str, seed: int) -> dict:
    """Seeded weights of ``model`` (LayerScale 0.5, as ``write_teacher``)
    saved as ``{"model": ...}`` in Meta's naming; returns the port's state
    dict they were written from."""
    import torch

    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    module = get_wrapped_model(model).module
    module.reset_parameters(torch.Generator().manual_seed(seed))
    for name, p in module.named_parameters():
        if name.endswith("gamma"):
            p.data.fill_(0.5)
    state = module.state_dict()
    torch.save({"model": meta_layout(state)}, path)
    return state


def same_tensors(tag: str, got: dict, ref: dict) -> None:
    """Fails unless ``got`` holds ``ref``'s keys with equal values (each
    compared in ``got``'s dtype)."""
    import torch

    if set(got) != set(ref):
        fail(f"{tag}: keys differ: {sorted(set(got) ^ set(ref))[:5]}")
    for k, v in ref.items():
        g = got[k].detach().cpu()
        if not torch.equal(g, v.to(g.dtype)):
            fail(f"{tag}: {k} differs")


def host_cpu() -> str:
    """The host's usable CPUs and its first CPU's description in
    ``/proc/cpuinfo``: model name, vendor, family, model and clock (a
    sandboxed host may give its model name as "unknown")."""
    import os
    import platform

    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip().lower(), value.strip())
    model = ", ".join(f"{k} {fields[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model", "cpu mhz")
        if k in fields)
    return (f"nproc {len(os.sched_getaffinity(0))} (of {os.cpu_count()}), "
            f"{platform.machine()}, {model or 'no /proc/cpuinfo fields'}")


def decode_rate(files: list, threads: int) -> float:
    """Images per second of ``ImageDataset`` at 256^2 over ``files`` on
    ``threads`` threads, as the loader decodes."""
    from concurrent.futures import ThreadPoolExecutor

    from lightly_train_tpu_torch._data.image_dataset import ImageDataset

    dataset = ImageDataset(files, (256, 256))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        for image in pool.map(dataset.__getitem__, range(len(dataset))):
            if image.shape != (256, 256, 3):
                fail(f"decode gave {image.shape}")
    return len(dataset) / (time.perf_counter() - t0)


def print_steps(tag: str, steps: list, card: str) -> None:
    """Each logged step's time, images per second and the time it waited
    for the loader."""
    for r in steps:
        print(f"  {tag} step {r['step']}: {r['profiling/step_time'] * 1e3:.1f}"
              f" ms, {r['profiling/images_per_sec']:.1f} img/s, waited "
              f"{r['profiling/data_time'] * 1e3:.1f} ms for data [{card}]")


def run_files_path(lt, A, F, card: str, work: Path, main: dict) -> dict:
    """Phase 3m: ``pretrain`` and ``embed`` from a folder of JPEG and PNG
    files, decoded by the port's own host decoder, warm-started from Meta
    checkpoints. Every launch counter is set to 0 just before each run and
    read just after."""
    import hashlib
    import importlib.metadata
    import statistics

    import numpy as np
    import torch

    from lightly_train_tpu_torch._commands import train as T
    from lightly_train_tpu_torch._data.image_dataset import decode_image
    from lightly_train_tpu_torch._data.png import decode_png
    from lightly_train_tpu_torch.models.convert import (
        load_torch_checkpoint_for_model,
    )

    try:
        pil = f"Pillow {importlib.metadata.version('pillow')} installed"
    except importlib.metadata.PackageNotFoundError:
        pil = "no Pillow installed"
    print(f"  {pil}; the port's decoder reads PNG, JPEG and PPM with or "
          f"without it")
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    hw = tuple(manifest["canonical_hw"])
    for name, entry in sorted(manifest["files"].items()):
        got = decode_image(str(FIXTURES / name), hw)
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        if not digest == entry["sha256_port"] == entry["sha256_jax"]:
            fail(f"{name}: decode digest {digest} is not the manifest's "
                 f"{entry['sha256_jax']} (the JAX package's PIL decode)")
    print(f"  {len(manifest['files'])} JPEG fixtures decode at {hw} to the "
          f"manifest's digests (the JAX package's PIL decode), draft scales "
          f"{sorted({e['draft_scale'] for e in manifest['files'].values()})}")
    pngs = png_cases(work / "png")
    for path, expected in pngs:
        got = decode_png(path.read_bytes(), str(path))
        if got.shape != expected.shape or not np.array_equal(got, expected):
            fail(f"{path.name} decodes to other pixels than were written")
    print(f"  {len(pngs)} PNGs ({', '.join(p.name for p, _ in pngs)}) "
          f"decode to the pixels written")
    folder = work / "files"
    folder.mkdir()
    sources = [FIXTURES / n for n in sorted(manifest["files"])] + [
        p for p, _ in pngs]
    for i in range(FILES_COUNT):
        src = sources[i % len(sources)]
        shutil.copyfile(src, folder / f"{i:03d}_{src.name}")

    large = [str(FIXTURES / n) for n, e in sorted(manifest["files"].items())
             if e["draft_scale"] > 1]
    batches = large * (FILES_DECODES // len(large))
    folder_files = sorted(str(p) for p in folder.iterdir())
    rates = {(kind, threads): decode_rate(files, threads)
             for kind, files in (("large", batches), ("folder", folder_files))
             for threads in (1, 8)}
    consumed = statistics.median(main["images_per_sec"][1:])
    print(f"  decode to 256^2 on the card's host ({host_cpu()}): large "
          f"fixtures (draft 1/2, 1/4, 1/8; {len(batches)} decodes) "
          f"{rates['large', 1]:.1f} img/s on 1 thread, "
          f"{rates['large', 8]:.1f} on 8; the 64-file folder "
          f"{rates['folder', 1]:.1f} and {rates['folder', 8]:.1f}; phase 3's "
          f"DINOv2 ViT-B/14 bf16 step consumes {consumed:.1f} img/s "
          f"[{card}]", flush=True)

    pth = work / "dinov2_vitb14.pth"
    weights = write_meta_pth(pth, FILES_MODEL, SEED + 2)
    converted = load_torch_checkpoint_for_model(pth, FILES_MODEL)
    same_tensors(f"{pth.name} conversion", converted, weights)
    initial = {}
    real = T._load_pretrained

    def spy(params, method_state, pretrained, config):
        real(params, method_state, pretrained, config)
        initial.update((k, v.detach().clone()) for k, v in
                       params["student"].state_dict().items())

    out = work / "files_dinov2"
    T._load_pretrained = spy
    try:
        counters = reset_counters(A, F)
        pretrain_main_path(lt, out, folder, "bf16", steps=FILES_STEPS,
                           checkpoint=str(pth), checkpoint_every=FILES_STEPS)
        torch.cuda.synchronize()
        launches = [fn.launches for fn in counters]
    finally:
        T._load_pretrained = real
    same_tensors("the warm-started student", initial, converted)
    print_steps("3m DINOv2", logged_steps(out), card)
    losses = [r["train_loss"] for r in logged_steps(out)]
    expected = dinov2_expected(FILES_STEPS)
    print(f"  DINOv2 ViT-B/14 bf16 from the folder, checkpoint= a Meta-named "
          f".pth: initial student = the conversion (every leaf); losses "
          f"{[round(x, 4) for x in losses]}; launches K1 {launches[0]}, K2 "
          f"{launches[1]}, K3 {launches[2]} (expected {expected[:3]})")
    if len(losses) != FILES_STEPS or not all(map(math.isfinite, losses)):
        fail(f"phase 3m losses {losses}")
    if launches != expected:
        fail(f"phase 3m launch counts {launches} != {expected}")

    teacher_pth = work / "dinov3_vitb16.pth"
    teacher = write_meta_pth(teacher_pth, FILES_TEACHER, SEED + 3)
    converted = load_torch_checkpoint_for_model(teacher_pth, FILES_TEACHER)
    same_tensors(f"{teacher_pth.name} conversion", converted, teacher)
    counters = reset_counters(A, F)
    state = distill_pretrain(
        lt, work / "files_distill", folder, "bf16", FILES_DISTILL_STEPS,
        method_args={"teacher_weights": str(teacher_pth)},
        checkpoint_every=FILES_DISTILL_STEPS)
    torch.cuda.synchronize()
    distill_launches = [fn.launches for fn in counters]
    same_tensors("the .pth teacher", state.method_state["teacher"]
                 .state_dict(), converted)
    print_steps("3m distillation", logged_steps(work / "files_distill"),
                card)
    losses = [r["train_loss"] for r in logged_steps(work / "files_distill")]
    expected = distill_expected(A, "bf16", FILES_DISTILL_STEPS)[0]
    print(f"  distillation v3 bf16 from the folder, teacher_weights= a "
          f"DINOv3-named ViT-B/16 .pth (storage_tokens, bias_mask): teacher "
          f"= the conversion; losses {[round(x, 4) for x in losses]}; "
          f"launches K1 {distill_launches[0]}, K2 {distill_launches[1]}, K3 "
          f"{distill_launches[2]} (expected {expected[:3]})")
    if len(losses) != FILES_DISTILL_STEPS or not all(map(math.isfinite,
                                                         losses)):
        fail(f"phase 3m distillation losses {losses}")
    if distill_launches != expected:
        fail(f"phase 3m distillation launches {distill_launches}")

    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    path = lt.embed(out=str(work / "files_embeddings.npz"), data=str(folder),
                    checkpoint=str(out / "exported_models" / "exported_last"),
                    image_size=224, batch_size=FILES_COUNT, precision="bf16",
                    format="npz")
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    embed_launches = [fn.launches for fn in counters]
    emb = np.load(path)["embeddings"]
    print(f"  embed of the folder (bf16, 224^2): {emb.shape}, finite "
          f"{bool(np.isfinite(emb).all())}, {embed_s:.2f} s; launches K1 "
          f"{embed_launches[0]}, K2 {embed_launches[1]} (expected 12, 0)")
    width = weights["cls_token"].shape[-1]
    if emb.shape != (FILES_COUNT, width) or not np.isfinite(emb).all():
        fail(f"phase 3m embeddings {emb.shape}")
    if embed_launches[:2] != [12, 0]:
        fail(f"phase 3m embed launches {embed_launches}")
    for name in ("files_dinov2", "files_distill"):
        shutil.rmtree(work / name)
    pth.unlink()
    teacher_pth.unlink()
    return {"launches": launches, "distill_launches": distill_launches,
            "embed_launches": embed_launches,
            "decode_img_per_s": {f"{k}_{t}": r for (k, t), r in rates.items()},
            "consumed_img_per_s": consumed}


def write_masks(folder: Path, n: int, size: int) -> dict:
    """Region-id PNGs for phase 3n's mask_dir, stems of ``write_images``'
    files: image i gets a palette mask (i % 4 == 0), an 8-bit gray one (1),
    a 16-bit gray one (2) or none (3). Ids 0-19 in 32-pixel blocks (ids
    past DetCon's 16 regions clip to the last). Returns {stem: ids}."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    folder.mkdir(parents=True)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    written = {}
    for i in range(n):
        if i % 4 == 3:
            continue
        blocks = rng.integers(0, 20, (size // 32, size // 32))
        ids = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[..., None]
        if i % 4 == 0:
            data = png_bytes(ids, 3, 8, palette)
        elif i % 4 == 1:
            data = png_bytes(ids, 0, 8)
        else:
            data = png_bytes(ids.astype(np.uint16), 0, 16)
        (folder / f"img_{i:03d}.png").write_bytes(data)
        written[f"img_{i:03d}"] = ids[..., 0]
    return written


class CallCount:
    """Wraps ``owner.name`` to count its calls until :meth:`restore`."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.calls = 0

        def counted(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)

        setattr(owner, name, counted)

    def restore(self) -> None:
        setattr(self.owner, self.name, self.fn)


def first_images(folder: Path, n: int):
    """The first ``n`` images of ``folder`` as a uint8 batch on the card,
    decoded as ``pretrain`` decodes them."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._data.image_dataset import ImageDataset

    files = sorted(str(p) for p in folder.iterdir())[:n]
    dataset = ImageDataset(files, (256, 256))
    return torch.from_numpy(np.stack([dataset[i] for i in range(n)])).cuda()


def exact_attention(A):
    """The ViT's attention as plain PyTorch attention without the TPU
    kernel's bf16 rounding of p (``dot_product_attention``: fp32 softmax,
    p in the input dtype), the reference phase 3n measures both the kernels
    and their plain versions against."""

    def attention(q, k, v, num_heads, mask=None):
        return A.dot_product_attention(q, k, v, num_heads, mask)

    return attention


def gradient_errors(got: tuple, ref: tuple) -> dict:
    """(loss, {leaf: gradient}) against a reference pair: the loss's
    relative error, the whole gradient's relative L2 (every leaf as one
    vector) and per leaf the max-abs error as a share of the reference
    leaf's largest magnitude and the relative L2. The key projection's bias
    is left out: its gradient is exactly zero, its value rounding
    residue."""
    loss, grads = got
    ref_loss, ref_grads = ref
    out = {"loss": abs(loss - ref_loss) / abs(ref_loss), "max_abs": {},
           "rel_l2": {}}
    diff_sq = ref_sq = 0.0
    for name, r in ref_grads.items():
        if name.endswith("attn.k.bias"):
            continue
        d = grads[name] - r
        diff_sq += (d * d).sum().item()
        ref_sq += (r * r).sum().item()
        out["max_abs"][name] = (d.abs().max()
                                / r.abs().max().clamp_min(1e-300)).item()
        out["rel_l2"][name] = (d.norm() / r.norm().clamp_min(1e-300)).item()
    out["whole"] = math.sqrt(diff_sq / max(ref_sq, 1e-300))
    return out


def method_fp32_step(A, tag: str, images, layerscale: Optional[float],
                     hold: bool) -> dict:
    """One fp32 step of run ``tag``'s method (ViT-B/14, full width, IEEE
    fp32, weights from the seed; with ``layerscale``, every LayerScale of
    the student and its teacher set to it) on fixed views of ``images``:
    the loss and every gradient with the attention kernels, with their
    plain versions (``flat_attention_fwd_plain``,
    ``flat_attention_bwd_plain``) in their place, and with the exact
    attention (``exact_attention``), from the same views and generator;
    DenseCL's match pinned to the kernels' pass. Fails on a non-finite
    loss or gradient and, with ``hold``, unless the kernels are within
    METHODS_FP32_TOL of the plain versions (or, where larger, the plain
    versions' own distance from the exact attention); returns the
    errors."""
    import torch

    from lightly_train_tpu_torch._commands.train_loop import (
        make_train_step,
        make_views,
    )
    from lightly_train_tpu_torch._configs.validate import config_validate
    from lightly_train_tpu_torch._scaling import ScalingInfo
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.methods.densecl import dense_match
    from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
    from lightly_train_tpu_torch.models import vit
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    pin_ieee()
    method_name, batch, args, *_ = METHOD_RUNS[tag]
    cls, args_cls = get_method_cls(method_name)
    method_args = config_validate(args_cls, args)
    method_args.resolve_auto(ScalingInfo(dataset_size=2 * BATCH, epochs=1))
    method = cls(get_wrapped_model("dinov2/vitb14", dtype=torch.float32),
                 method_args)
    params, method_state = method.init(
        torch.Generator().manual_seed(SEED + 11), torch.device("cuda"))
    if layerscale is not None:
        for tree in (params, method_state.get("teacher")):
            for name, p in (tree.named_parameters() if tree is not None
                            else ()):
                if name.endswith("gamma"):
                    p.data.fill_(layerscale)
    state = TrainState(0, params, method_state)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    views = make_views(method.view_specs(), images[:batch], gen,
                       torch.float32,
                       needs_geometry=getattr(method, "needs_geometry", False))
    pinned = None
    if method_name == "densecl":
        with torch.no_grad():
            f_s = method.encode(params, views[0], True)[2]
            f_t = method.encode(method_state["teacher"], views[1], False)[2]
            pinned = [dense_match(f_s, f_t)]
    step = make_train_step(method, 10, aug_dtype=torch.float32)
    kernels = (A.flat_attention_fwd, A.flat_attention_bwd)
    passes = {}
    for variant in ("kernels", "plain", "exact"):
        if variant == "plain":
            A.flat_attention_fwd = A.flat_attention_fwd_plain
            A.flat_attention_bwd = A.flat_attention_bwd_plain
        if variant == "exact":
            vit.attention = exact_attention(A)
        try:
            loss, grads, _, _ = step.loss_and_grads(
                state, None, torch.Generator(device="cuda").manual_seed(
                    SEED + 13), views=[views], masks=pinned)
        finally:
            A.flat_attention_fwd, A.flat_attention_bwd = kernels
            vit.attention = A.attention
        passes[variant] = (loss.item(), {
            n: g.detach().double().clone() for n, g in grads.items()
            if g is not None})
        del grads
        for p in params.parameters():
            p.grad = None
    del state, params, method_state
    if not (math.isfinite(passes["kernels"][0]) and all(
            torch.isfinite(g).all() for g in passes["kernels"][1].values())):
        fail(f"phase 3n {tag} fp32: a loss or gradient is not finite")
    if set(passes["kernels"][1]) != set(passes["plain"][1]):
        fail(f"phase 3n {tag} fp32: gradient leaves differ")
    errors = {"kernels_plain": gradient_errors(passes["kernels"],
                                               passes["plain"]),
              "plain_exact": gradient_errors(passes["plain"],
                                             passes["exact"]),
              "kernels_exact": gradient_errors(passes["kernels"],
                                               passes["exact"])}
    del passes
    torch.cuda.empty_cache()
    kp, pe = errors["kernels_plain"], errors["plain_exact"]
    tol_abs, tol_l2 = METHODS_FP32_TOL
    if not hold:
        return errors
    for what, got, bound in (("loss", kp["loss"], max(tol_l2, pe["loss"])),
                             ("gradient", kp["whole"],
                              max(tol_l2, pe["whole"]))):
        if not got <= bound:
            fail(f"phase 3n {tag} fp32: the {what} with the kernels against "
                 f"the plain attention: relative {got} (bound {bound})")
    for name, got in kp["max_abs"].items():
        bound = max(tol_abs, pe["max_abs"][name])
        if not got <= bound:
            fail(f"phase 3n {tag} fp32: gradient {name} with the kernels "
                 f"against the plain attention: max-abs {got} of its "
                 f"largest (bound {bound})")
    return errors


def run_methods_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3n: ``pretrain`` with each run of METHOD_RUNS on ViT-B/14 at
    full width, bf16, METHODS_STEPS steps on phase 3's images, every launch
    counter set to 0 just before and read just after: K1, K2 and K3 a step
    as METHOD_RUNS gives them, every forward and backward on the bf16 hd-64
    wgmma libraries, no call of PyTorch's SDPA and none of the plain
    attention (``dot_product_attention``), finite losses; the mask run
    reads its masks through the port's PNG decoder (held to the ids
    written). Prints one JSON line a run (steps 2-4 in ms, peak GiB,
    launches a step, the losses) and then holds one fp32 step of each
    method with the kernels to the same step with their plain versions
    (``method_fp32_step``)."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._data import image_dataset as D

    masks = work / "masks"
    written = write_masks(masks, 2 * BATCH, 256)
    for stem, ids in written.items():
        got = D.decode_mask(str(masks / f"{stem}.png"), (256, 256))
        if not np.array_equal(got, ids):
            fail(f"phase 3n: mask {stem}.png decodes to other ids")
    print(f"  {len(written)} region-mask PNGs (palette, 8- and 16-bit "
          f"gray) decode on the card's host to the ids written")
    results = {}
    for tag, (method, batch, args, k1, k2, k3) in METHOD_RUNS.items():
        out = work / f"method_{tag}"
        extra = ({"mask_dir": str(masks)} if tag.endswith("mask_dir")
                 else {})
        spies = [CallCount(torch.nn.functional,
                           "scaled_dot_product_attention"),
                 CallCount(A, "dot_product_attention"),
                 CallCount(D, "decode_mask")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters(A, F)
        t0 = time.perf_counter()
        try:
            lt.pretrain(out=str(out), data=str(work / "images"),
                        model="dinov2/vitb14", method=method,
                        method_args=args, batch_size=batch,
                        steps=METHODS_STEPS, precision="bf16", log_every=1,
                        checkpoint_every=METHODS_STEPS, seed=SEED, **extra)
            torch.cuda.synchronize()
        finally:
            for spy in spies:
                spy.restore()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        by_library = {"fwd": dict(A.fwd_launches),
                      "bwd": dict(A.bwd_launches)}
        steps = logged_steps(out)
        loss_keys = sorted(k for k in steps[0] if "loss" in k)
        row = {
            "phase": "3n", "run": tag, "method": method, "batch": batch,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps[1:]],
            "data_wait_ms": [r["profiling/data_time"] * 1e3
                             for r in steps[1:]],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches_per_step": {
                "K1": launches[0] / METHODS_STEPS,
                "K2": launches[1] / METHODS_STEPS,
                "K3": launches[2] / METHODS_STEPS},
            "library_attention_launches": spies[0].calls,
            "plain_attention_calls": spies[1].calls,
            "losses": {k: [r[k] for r in steps] for k in loss_keys},
            "wall_s": wall, "card": card,
        }
        if extra:
            row["masks_decoded"] = spies[2].calls
        print(json.dumps(row), flush=True)
        results[tag] = row
        if [r["step"] for r in steps] != list(range(1, METHODS_STEPS + 1)):
            fail(f"phase 3n {tag}: logged steps {[r['step'] for r in steps]}")
        if not all(math.isfinite(x) for k in loss_keys for x in
                   row["losses"][k] + [r["grad_norm"] for r in steps]):
            fail(f"phase 3n {tag}: a loss is not finite: {row['losses']}")
        expected = [k1 * DEPTH * METHODS_STEPS, k2 * DEPTH * METHODS_STEPS,
                    k3 * METHODS_STEPS, 0, 0]
        if launches[0] == 0 or launches[1] == 0 or launches != expected:
            fail(f"phase 3n {tag}: launches {launches} != {expected}")
        if spies[0].calls or spies[1].calls:
            fail(f"phase 3n {tag}: the step reached a stock attention op "
                 f"(SDPA {spies[0].calls}, plain {spies[1].calls})")
        if extra and not spies[2].calls:
            fail("phase 3n: the mask run read no mask")
        check_routes(A, f"3n {tag}", by_library, torch.bfloat16, HEAD_DIM,
                     {"fwd": expected[0], "bwd": expected[1]})
        shutil.rmtree(out)
    pin_ieee()
    images = first_images(work / "images", 2 * BATCH)
    for tag in METHOD_RUNS:
        if tag.endswith("mask_dir"):
            continue
        # Held at LayerScale 0.5, where every block's attention weighs in
        # the output. At the seeded init (LayerScale 1e-5) every CLS lies
        # within about 1e-5 of the learned token: SimCLR's loss is
        # log(2B - 1), DenseCL's global term alike, DINOv31's KoLeo
        # distances vanish, and such a gradient is the residue of
        # cancelling terms, as much the roundings' as the signal's in both
        # (DINOv31 on an NVIDIA H100 80GB HBM3 at 700 W: kernels against
        # plain 0.19 of the gradient, plain against exact 0.33); printed,
        # not held.
        for layerscale in (None, 0.5):
            t0 = time.perf_counter()
            hold = layerscale is not None
            e = method_fp32_step(A, tag, images, layerscale, hold)
            kp, pe, ke = (e[k] for k in ("kernels_plain", "plain_exact",
                                         "kernels_exact"))

            def worst(d):
                name = max(d, key=d.get)
                return f"{d[name]:.2e} ({name})"

            print(f"  {tag} fp32 step, LayerScale "
                  f"{'1e-5 (init)' if layerscale is None else layerscale}: "
                  f"kernels against plain: loss {kp['loss']:.2e}, gradient "
                  f"{kp['whole']:.2e}, worst leaf max-abs "
                  f"{worst(kp['max_abs'])} rel L2 {worst(kp['rel_l2'])}; "
                  f"plain against exact: loss {pe['loss']:.2e}, gradient "
                  f"{pe['whole']:.2e}, leaf max-abs {worst(pe['max_abs'])}; "
                  f"kernels against exact: gradient {ke['whole']:.2e}; "
                  f"tolerances {METHODS_FP32_TOL} or plain-exact, "
                  f"{'held' if hold else 'not held'}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            results[tag][f"fp32_layerscale_{layerscale}"] = {
                k: {"loss": v["loss"], "whole": v["whole"],
                    "max_abs": max(v["max_abs"].values()),
                    "rel_l2": max(v["rel_l2"].values())}
                for k, v in e.items()}
    shutil.rmtree(masks)
    return results


def student_buffers(state) -> dict:
    """The student's running statistics (its BatchNorm buffers), on the
    CPU."""
    return {k: v.detach().float().cpu()
            for k, v in state.params["student"].named_buffers()}


def cnn_fp32_steps(device: str, teacher: Path, jitter: float = 0.0,
                   model: str = "torchvision/resnet50") -> dict:
    """CNN_FP32_STEPS fp32 steps of ``model``'s distillation v3 (LARS, the
    DINOv3 ViT-B/16 teacher exported at ``teacher``) on one fixed batch on
    ``device``, from the seeded init, with the mixup draw pinned: the
    student's parameters and buffers before and after, and the losses.
    ``jitter`` multiplies every convolution's output by 1 + ``jitter``
    times a seeded normal draw (the steps' sensitivity to rounding)."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch.models import conv

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch._optim import cosine_warmup
    from lightly_train_tpu_torch._optim.update import build_update
    from lightly_train_tpu_torch.methods import distillationv3 as V3
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    method = V3.DistillationV3(get_wrapped_model(model),
                               V3.DistillationV3Args(
                                   queue_size=16, image_size=CNN_FP32_SIZE,
                                   teacher_weights=str(teacher)))
    params, method_state = method.init(
        torch.Generator().manual_seed(SEED), torch.device(device))
    args = method.default_optimizer_args()
    named = dict(params.named_parameters())
    updater = build_update(method, args, cosine_warmup(
        float(args.lr), CNN_FP32_STEPS, 0), named, CNN_FP32_STEPS)
    state = TrainState(0, params, method_state, updater)
    step = make_train_step(method, CNN_FP32_STEPS)
    rng = np.random.default_rng(SEED + 9)
    shape = (CNN_FP32_BATCH, 1, 1, 1)
    before = {k: v.detach().cpu().clone()
              for k, v in params["student"].state_dict().items()}
    losses = []
    forward = conv.Conv.forward
    noise = torch.Generator(device=device).manual_seed(SEED)
    if jitter:
        conv.Conv.forward = lambda self, x: (lambda y: y * (1 + jitter * (
            torch.randn(y.shape, generator=noise, device=y.device))))(
            forward(self, x))
    try:
        for _ in range(CNN_FP32_STEPS):
            view = torch.from_numpy(rng.standard_normal(
                (CNN_FP32_BATCH, CNN_FP32_SIZE, CNN_FP32_SIZE, 3)).astype(
                    np.float32)).to(device)
            lam = torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(
                np.float32)).to(device)
            apply = torch.from_numpy(rng.uniform(0, 1, shape) < 0.5).to(
                device)
            metrics = step(state, None, None, views=[[view]],
                           masks=[(lam, apply)])
            losses.append(float(metrics["train_loss"]))
    finally:
        conv.Conv.forward = forward
    after = {k: v.detach().cpu().clone()
             for k, v in params["student"].state_dict().items()}
    return {"before": before, "after": after, "losses": losses}


def check_cnn_fp32(A, F, card: str, work: Path,
                   model: str = "torchvision/resnet50", label: str = "3o (a)",
                   student_shapes: tuple = ()) -> dict:
    """(a)'s ResNet-50 (phase 3o; or ``model``, phase 3p's ECViT-S+) after
    CNN_FP32_STEPS fp32 steps on the card against the same steps on the
    CPU, within 1e-2 relative L2: the parameters after the steps (every
    leaf as one vector), the running statistics and the losses. Where the
    student attends (``student_shapes``: ECViT-S+), the change of the
    parameters is held within 1e-2 as well: its BatchNorm sits in the patch
    embed alone, and the CPU's own steps with every convolution's output
    moved by 1e-7 relative (printed) move the change far less than that.
    For ResNet-50 the change is printed, not held: in train mode, batch 4
    and a 4 x 4 last stage, the backward through the batch statistics makes
    the gradient move by about 2% when every convolution's output moves by
    one fp32 rounding, and the two devices round differently. The card's
    steps launch K1 fp32 once a block a step at TEACHER_FP32_CHECK (the
    teacher) and K1 and K2 fp32 once a block a step at each of
    ``student_shapes``, counted from 0 just before them. The teacher is
    phase 3f's exported one with LayerScale 0.5 (``write_teacher``): a
    random one makes the loss log Q and its gradient rounding noise, which
    LARS's trust ratio scales to full steps."""
    import torch

    pin_ieee()
    t0 = time.perf_counter()
    teacher = work / "teacher_fp32_check"
    write_teacher(teacher)
    counters = reset_counters(A, F)
    card_run = cnn_fp32_steps("cuda", teacher, model=model)
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    fwd = A.fwd_library(torch.float32, HEAD_DIM)
    bwd = A.bwd_library(torch.float32, HEAD_DIM)
    steps = CNN_FP32_STEPS
    want_shape = {(fwd, TEACHER_FP32_CHECK): DEPTH * steps,
                  **{(lib, shape): DEPTH * steps
                     for shape in student_shapes for lib in (fwd, bwd)}}
    want = [DEPTH * steps * (1 + len(student_shapes)),
            DEPTH * steps * len(student_shapes), 0, 0, 0]
    print(f"  {label} the card's fp32 steps: launches {launches} (expected "
          f"{want}), by shape {by_shape}", flush=True)
    if launches != want or by_shape != want_shape:
        fail(f"phase {label}: launches {launches} != {want}, by shape "
             f"{by_shape} != {want_shape}")
    cpu_run = cnn_fp32_steps("cpu", teacher, model=model)
    jittered = cnn_fp32_steps("cpu", teacher, jitter=1e-7, model=model)
    shutil.rmtree(teacher)
    keys = [k for k in cpu_run["after"]
            if not (k.endswith(".mean") or k.endswith(".var"))]
    stats = [k for k in cpu_run["after"] if k not in keys]

    def flat(run, names, change=False):
        return torch.cat([(run["after"][k] - (run["before"][k] if change
                                               else 0)).reshape(-1)
                          for k in names])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    if any(not torch.equal(card_run["before"][k], cpu_run["before"][k])
           for k in keys):
        fail(f"phase {label}: the card's and the CPU's inits differ")
    errors = {
        "parameters": rel(flat(card_run, keys), flat(cpu_run, keys)),
        "running_stats": rel(flat(card_run, stats), flat(cpu_run, stats)),
        "losses": rel(torch.tensor(card_run["losses"]),
                      torch.tensor(cpu_run["losses"])),
    }
    change = rel(flat(card_run, keys, True), flat(cpu_run, keys, True))
    cpu_change = rel(flat(jittered, keys, True), flat(cpu_run, keys, True))
    moved = rel(flat(cpu_run, keys),
                flat(cpu_run, keys) - flat(cpu_run, keys, True))
    print(f"  {label} {model} distillation, {CNN_FP32_STEPS} fp32 steps "
          f"on a fixed batch of {CNN_FP32_BATCH} at {CNN_FP32_SIZE}^2, card "
          f"against CPU: " + ", ".join(f"{k} {v:.3e}"
                                       for k, v in errors.items())
          + f" (tol 1e-2); the parameters moved {moved:.3e} of their norm, "
          f"the change {change:.3e} apart ("
          + ("held, tol 1e-2" if student_shapes else "printed, not held")
          + f"; the CPU's own change with every convolution's output moved "
          f"by 1e-7 relative: {cpu_change:.3e} apart); losses card "
          f"{card_run['losses']}, CPU {cpu_run['losses']}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    held_errors = {**errors, **({"parameter_change": change}
                                if student_shapes else {})}
    if not all(v <= 1e-2 for v in held_errors.values()) or not moved > 0:
        fail(f"phase {label}: {model} fp32 steps on the card against the "
             f"CPU {held_errors}")
    return {**errors, "parameter_change": change, "moved": moved,
            "cpu_jitter_1e-7_change": cpu_change, "by_shape": by_shape}


def run_cnn_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3o: CNN students and adamw8bit. ``pretrain`` of each run of
    CNN_RUNS (bf16, CNN_STEPS steps on phase 3's images), every launch
    counter set to 0 just before and read just after: K1 by library and
    shape, K2 and K3 exactly as CNN_RUNS gives them a step, no SDPA and no
    plain attention, finite losses, the running statistics finite and
    moved; in (b) the EMA teacher's copy of the backbone takes the
    student's statistics before each step's forwards (its copy ends at the
    statistics of the last step's start, not at the init). Then (a)'s
    fp32 steps against the CPU (``check_cnn_fp32``), ``embed`` of (a)'s
    export (f) against an eval-mode forward of the exported weights, and
    (g) the 7B/16 student with adamw8bit (``run_cnn_7b``). One JSON line a
    run."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        load_exported_model,
    )
    from lightly_train_tpu_torch._data.image_dataset import (
        ImageDataset,
        list_image_files,
    )
    from lightly_train_tpu_torch.methods.base import Method
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    results = {"by_shape": {}}
    for tag, (model, method, batch, extra, k1f, k1b, k2, k3) in \
            CNN_RUNS.items():
        out = work / f"cnn_{tag}"
        spies = [CallCount(torch.nn.functional,
                           "scaled_dot_product_attention"),
                 CallCount(A, "dot_product_attention")]
        synced = []
        sync = Method.sync_teacher_state

        def spy(self, params, method_state, sync=sync, synced=synced):
            sync(self, params, method_state)
            teacher = method_state.get("teacher")
            if self.ema_teacher and teacher is not None:
                synced.append(all(
                    torch.equal(a, b) for a, b in zip(
                        teacher["student"].buffers(),
                        params["student"].buffers())))

        Method.sync_teacher_state = spy
        kwargs = {**extra, **({"method": method} if method else {}),
                  **({"batch_size": batch} if batch else {})}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters(A, F)
        t0 = time.perf_counter()
        try:
            state = lt.pretrain(
                out=str(out), data=str(work / "images"), model=model,
                steps=CNN_STEPS, precision="bf16", log_every=1,
                checkpoint_every=CNN_STEPS, seed=SEED, **kwargs)
            torch.cuda.synchronize()
        finally:
            Method.sync_teacher_state = sync
            for s in spies:
                s.restore()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        by_shape = launches_by_shape(A)
        steps = logged_steps(out)
        loss_keys = sorted(k for k in steps[0] if "loss" in k)
        stats = student_buffers(state)
        row = {
            "phase": "3o", "run": tag, "model": model,
            "method": method or "distillation (the default)",
            "batch": batch or DISTILL_BATCH,
            "optimizer": type(state.updater.args).__name__,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps[1:]],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches_per_step": {
                "K1": launches[0] / CNN_STEPS, "K2": launches[1] / CNN_STEPS,
                "K3": launches[2] / CNN_STEPS},
            "launches_by_shape": {f"{lib} {shape}": n for (lib, shape), n
                                  in by_shape.items()},
            "losses": {k: [r[k] for r in steps] for k in loss_keys},
            "running_stats": len(stats),
            "wall_s": wall, "card": card,
        }
        print(json.dumps(row), flush=True)
        results[tag] = row
        for key, n in by_shape.items():
            results["by_shape"][key] = results["by_shape"].get(key, 0) + n
        if [r["step"] for r in steps] != list(range(1, CNN_STEPS + 1)):
            fail(f"phase 3o {tag}: logged steps {[r['step'] for r in steps]}")
        if not all(math.isfinite(x) for k in loss_keys for x in
                   row["losses"][k] + [r["grad_norm"] for r in steps]):
            fail(f"phase 3o {tag}: a loss is not finite: {row['losses']}")
        expected = [(k1f + k1b) * CNN_STEPS, k2 * CNN_STEPS, k3 * CNN_STEPS,
                    0, 0]
        want_shape = {}
        if k1f:
            want_shape[(A.fwd_library(torch.float32, HEAD_DIM), TEACHER)] = \
                k1f * CNN_STEPS
        if k1b:
            want_shape[(A.fwd_library(torch.bfloat16, HEAD_DIM),
                        (DISTILL_BATCH, 257, HEADS, HEAD_DIM))] = \
                k1b * CNN_STEPS
            want_shape[(A.bwd_library(torch.bfloat16, HEAD_DIM),
                        (DISTILL_BATCH, 257, HEADS, HEAD_DIM))] = \
                k2 * CNN_STEPS
        if launches != expected or by_shape != want_shape:
            fail(f"phase 3o {tag}: launches {launches} != {expected}, by "
                 f"shape {by_shape} != {want_shape}")
        if spies[0].calls or spies[1].calls:
            fail(f"phase 3o {tag}: the step reached a stock attention op "
                 f"(SDPA {spies[0].calls}, plain {spies[1].calls})")
        if model.startswith("dinov3/convnext") or model.startswith("dinov2"):
            if stats:
                fail(f"phase 3o {tag}: {model} holds running statistics")
        else:
            if not stats or not all(torch.isfinite(v).all()
                                    for v in stats.values()):
                fail(f"phase 3o {tag}: running statistics not finite")
            means = [v for k, v in stats.items() if k.endswith(".mean")]
            if not all(v.abs().sum() > 0 for v in means):
                fail(f"phase 3o {tag}: a running mean did not move")
        if tag == "b_dino_resnet50":
            teacher = {k: v.float().cpu() for k, v in state.method_state[
                "teacher"]["student"].named_buffers()}
            moved = sum(not torch.equal(teacher[k], stats[k])
                        for k in stats)
            init = sum(torch.equal(teacher[k], torch.zeros_like(teacher[k]))
                       for k in teacher if k.endswith(".mean"))
            print(f"  (b) the EMA teacher took the student's statistics "
                  f"before each of {len(synced)} losses "
                  f"(equal after each: {all(synced)}); at the end "
                  f"{moved} of {len(stats)} of the student's buffers have "
                  f"moved past the teacher's copy, {init} of the copy's "
                  f"means are still at the init", flush=True)
            if (len(synced) != CNN_STEPS or not all(synced) or not moved
                    or init):
                fail("phase 3o (b): the teacher does not read the "
                     "student's running statistics")
        if tag == "a_resnet50":
            exported = out / "exported_models" / "exported_last"
            art = load_exported_model(exported)
            if art["model_name"] != model or not any(
                    k.endswith(".var") for k in art["state_dict"]):
                fail(f"phase 3o (a): export {art['model_name']} without "
                     "running statistics")
            counters = reset_counters(A, F)
            t0 = time.perf_counter()
            emb_path = lt.embed(out=str(work / "cnn_embed.npz"),
                                data=str(work / "images"),
                                checkpoint=str(exported), batch_size=64)
            embed_wall = time.perf_counter() - t0
            emb = np.load(emb_path)["embeddings"]
            wrapped = get_wrapped_model(model)
            wrapped.module.load_state_dict(art["state_dict"])
            wrapped.module.cuda().eval()
            dataset = ImageDataset(list_image_files(work / "images"),
                                   (224, 224))
            x = torch.from_numpy(np.stack(
                [dataset[i] for i in range(len(dataset))])).cuda()
            with torch.no_grad():
                want = wrapped.forward_pool(wrapped.forward_features(
                    x.float() / 255.0)).cpu().numpy()
            err = float(np.linalg.norm(emb - want) / np.linalg.norm(want))
            print(f"  (f) embed of (a)'s export: {emb.shape} in "
                  f"{embed_wall:.1f} s, against an eval-mode forward of the "
                  f"exported weights: relative L2 {err:.3e} (tol 1e-5); "
                  f"launches {[fn.launches for fn in counters]}", flush=True)
            results["f_embed"] = {"shape": list(emb.shape), "rel_l2": err,
                                  "wall_s": embed_wall}
            if emb.shape != (2 * BATCH, 2048) or not err <= 1e-5:
                fail(f"phase 3o (f): embeddings {emb.shape}, {err}")
            del wrapped
        del state
        shutil.rmtree(out)
        torch.cuda.empty_cache()
    results["g_7b_adamw8bit"] = g = run_cnn_7b(lt, A, F, card, work)
    for key, n in g.pop("by_shape").items():
        results["by_shape"][key] = results["by_shape"].get(key, 0) + n
    results["a_fp32"] = a = check_cnn_fp32(A, F, card, work)
    for key, n in a.pop("by_shape").items():
        results["by_shape"][key] = results["by_shape"].get(key, 0) + n
    return results


def run_cnn_7b(lt, A, F, card: str, work: Path) -> dict:
    """(g) ``pretrain`` of the DINOv3 7B/16 student (CNN_7B_ARGS: adamw8bit,
    every block recomputed), bf16, batch 64, CNN_7B_STEPS steps; launches
    as phase 3l's (K1 80 bf16 and 12 fp32, K2 40 a step, no K3). Its peak
    is printed beside ``refuse_pretraining``'s count of its state. It
    writes no checkpoint and no export: each would be a 25 GiB-plus file
    (phase 3j writes and times a 7B checkpoint, 3k a 7B export;
    adamw8bit's checkpoint and resume are held bitwise on the CPU)."""
    import torch

    from lightly_train_tpu_torch._commands import train as T
    from lightly_train_tpu_torch._optim import AdamW8bitArgs
    from lightly_train_tpu_torch.models.package_registry import (
        _state_need,
        get_wrapped_model,
    )

    with torch.device("meta"):
        leaves = [p.numel() for p in
                  get_wrapped_model(STUDENT_7B).module.parameters()]
        teacher = sum(p.numel() for p in
                      get_wrapped_model("dinov3/vitb16").module.parameters())
    need = _state_need(leaves, AdamW8bitArgs(), False, teacher)
    out = work / "cnn_7b"
    save, export = T.CheckpointManager.save, T.export_model
    T.CheckpointManager.save = lambda *args, **kwargs: None
    T.export_model = lambda *args, **kwargs: None
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    try:
        state = lt.pretrain(
            out=str(out), data=str(work / "images"), model=STUDENT_7B,
            batch_size=DISTILL_BATCH, steps=CNN_7B_STEPS, precision="bf16",
            log_every=1, seed=SEED, checkpoint_every=CNN_7B_STEPS,
            **CNN_7B_ARGS)
        torch.cuda.synchronize()
    finally:
        T.CheckpointManager.save, T.export_model = save, export
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    steps = logged_steps(out)
    steps_ms = [r["profiling/step_time"] * 1e3 for r in steps]
    updater = state.updater
    held = sum(t.numel() * t.element_size()
               for key in ("mu_q", "mu_scale", "nu_q", "nu_scale")
               for t in updater.moments[key].values())
    expected = [(2 * DEPTH_7B + DEPTH) * CNN_7B_STEPS,
                DEPTH_7B * CNN_7B_STEPS, 0, 0, 0]
    row = {"phase": "3o", "run": "g_7b_adamw8bit", "model": STUDENT_7B,
           "step_ms": steps_ms, "peak_gib": peak,
           "refusal_count_gib": need / 2 ** 30,
           "int8_state_gib": held / 2 ** 30,
           "launches": launches, "losses": [r["train_loss"] for r in steps],
           "wall_s": wall, "card": card}
    print(json.dumps(row), flush=True)
    print(f"  (g) 7B/16 student with adamw8bit: peak {peak:.2f} GiB beside "
          f"the refusal's count of its state {need / 2 ** 30:.2f} GiB "
          f"(int8 moments and scales {held / 2 ** 30:.2f} GiB); step ms "
          f"{steps_ms}; wall {wall:.1f} s [{card}]", flush=True)
    if (launches != expected or type(updater.args) is not AdamW8bitArgs
            or not all(math.isfinite(x) for x in row["losses"])
            or [r["step"] for r in steps] != list(
                range(1, CNN_7B_STEPS + 1))):
        fail(f"phase 3o (g): launches {launches} != {expected}, losses "
             f"{row['losses']}")
    del state, updater
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return {**row, "by_shape": by_shape}


def run_7b_lars(lt, A, F, card: str, work: Path) -> dict:
    """``--7b-lars``: the DINOv3 7B/16 student by distillation v3 with LARS
    at its default momentum 0.9 (p, g and the momentum trace: 3 fp32
    copies), every block recomputed, bf16, batch 64, for CNN_7B_STEPS
    steps, with ``refuse_pretraining`` bypassed; no checkpoint or export
    written. Prints its peak (or, where it runs out of memory, the peak
    when it did) beside the refusal's count of its state and the card's
    capacity; then ``pretrain`` with the card's own capacity must refuse
    the run, before it allocates anything, if and only if it did not
    fit."""
    import torch

    from lightly_train_tpu_torch._commands import train as T
    from lightly_train_tpu_torch._optim import LARSArgs
    from lightly_train_tpu_torch.models.package_registry import (
        _state_need,
        get_wrapped_model,
    )

    with torch.device("meta"):
        leaves = [p.numel() for p in
                  get_wrapped_model(STUDENT_7B).module.parameters()]
        teacher = sum(p.numel() for p in
                      get_wrapped_model("dinov3/vitb16").module.parameters())
    need = _state_need(leaves, LARSArgs(), False, teacher)
    capacity = T._device_capacity("cuda")
    args = dict(data=str(work / "images"), model=STUDENT_7B,
                method="distillationv3", batch_size=DISTILL_BATCH,
                steps=CNN_7B_STEPS, precision="bf16", log_every=1, seed=SEED,
                checkpoint_every=CNN_7B_STEPS,
                model_args={"remat_every": 1})
    save, export, cap = (T.CheckpointManager.save, T.export_model,
                         T._device_capacity)
    T.CheckpointManager.save = lambda *a, **kw: None
    T.export_model = lambda *a, **kw: None
    T._device_capacity = lambda accelerator: None
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state, oom = None, None
    try:
        state = lt.pretrain(out=str(work / "lars_7b"), **args)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as err:
        oom = str(err).splitlines()[0]
    finally:
        T.CheckpointManager.save, T.export_model = save, export
        T._device_capacity = cap
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = logged_steps(work / "lars_7b") if state is not None else []
    row = {"phase": "7b-lars", "model": STUDENT_7B, "fits": oom is None,
           "peak_gib": peak, "refusal_count_gib": need / 2 ** 30,
           "capacity_gib": capacity / 2 ** 30,
           "step_ms": [r["profiling/step_time"] * 1e3 for r in steps],
           "losses": [r["train_loss"] for r in steps],
           "launches": [fn.launches for fn in counters], "oom": oom,
           "wall_s": wall, "card": card}
    print(json.dumps(row), flush=True)
    del state
    shutil.rmtree(work / "lars_7b", ignore_errors=True)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    try:
        lt.pretrain(out=str(work / "lars_7b_refused"), **args)
        refused = None
    except NotImplementedError as err:
        refused = str(err)
    print(f"  the 7B/16 student with LARS at momentum 0.9: "
          f"{'fits' if oom is None else 'out of memory'}, peak "
          f"{peak:.2f} GiB, the refusal's count {need / 2 ** 30:.2f} GiB of "
          f"the card's {capacity / 2 ** 30:.2f}; with the card's capacity "
          f"pretrain {'refuses: ' + refused if refused else 'runs'} "
          f"[{card}]", flush=True)
    if (refused is None) != (oom is None) or (
            refused and (torch.cuda.memory_allocated() != before
                         or (work / "lars_7b_refused").exists())):
        fail(f"the 7B LARS refusal ({refused}) disagrees with the run "
             f"({oom or 'fits'})")
    if oom is None and not all(math.isfinite(x) for x in row["losses"]):
        fail(f"the 7B LARS run's losses {row['losses']}")
    shutil.rmtree(work / "lars_7b_refused", ignore_errors=True)
    return row


def user_cnn():
    """Phase 3p (e): a user's own torch CNN (four stride-2 3x3
    convolutions, ``nn.BatchNorm2d`` and ReLU, 64 to 512 channels),
    seeded, returning its feature map in a dict."""
    import torch
    from torch import nn

    class UserCNN(nn.Module):
        def __init__(self):
            super().__init__()
            chans = (3, 64, 128, 256, 512)
            self.body = nn.Sequential(*[
                layer for i in range(4) for layer in (
                    nn.Conv2d(chans[i], chans[i + 1], 3, 2, 1, bias=False),
                    nn.BatchNorm2d(chans[i + 1]), nn.ReLU())])

        def forward(self, x):
            return {"features": self.body(x)}

    torch.manual_seed(SEED)
    return UserCNN()


def run_item10_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3p: ``pretrain`` of each run of ITEM10_RUNS (bf16,
    ITEM10_STEPS steps on phase 3's images), every launch counter set to 0
    just before and read just after: K1 and K2 by library and shape and K3
    exactly as ITEM10_RUNS gives them a step, no SDPA and no plain
    attention, finite losses, the running statistics (the user module's
    ``nn.BatchNorm2d`` buffers too) finite and moved, and each EMA
    teacher's copy of the backbone holding the student's statistics before
    each step's forwards. Then ``embed`` of (a)'s export (f) against an
    eval-mode forward of the exported weights and (g) ECViT-S+'s fp32
    steps on the card against the CPU (``check_cnn_fp32``). One JSON line
    a run."""
    import torch

    from lightly_train_tpu_torch.methods.base import Method

    fwd = {"fp32": A.fwd_library(torch.float32, HEAD_DIM),
           "bf16": A.fwd_library(torch.bfloat16, HEAD_DIM)}
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    results = {"by_shape": {}}
    for tag, (model, method, batch, k1f, k1b, k2, k3) in \
            ITEM10_RUNS.items():
        out = work / f"item10_{tag}"
        model_arg = user_cnn() if model == "module" else model
        spies = [CallCount(torch.nn.functional,
                           "scaled_dot_product_attention"),
                 CallCount(A, "dot_product_attention")]
        synced = []
        sync = Method.sync_teacher_state

        def spy(self, params, method_state, sync=sync, synced=synced):
            sync(self, params, method_state)
            teacher = method_state.get("teacher")
            if self.ema_teacher and teacher is not None:
                synced.append(all(
                    torch.equal(a, b) for a, b in zip(
                        teacher["student"].buffers(),
                        params["student"].buffers())))

        Method.sync_teacher_state = spy
        kwargs = {**({"method": method} if method else {}),
                  **({"batch_size": batch} if batch else {})}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters(A, F)
        t0 = time.perf_counter()
        try:
            state = lt.pretrain(
                out=str(out), data=str(work / "images"), model=model_arg,
                steps=ITEM10_STEPS, precision="bf16", log_every=1,
                checkpoint_every=ITEM10_STEPS, seed=SEED, **kwargs)
            torch.cuda.synchronize()
        finally:
            Method.sync_teacher_state = sync
            for spied in spies:
                spied.restore()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        by_shape = launches_by_shape(A)
        steps = logged_steps(out)
        loss_keys = sorted(k for k in steps[0] if "loss" in k)
        stats = student_buffers(state)
        n = ITEM10_STEPS
        row = {
            "phase": "3p", "run": tag,
            "model": "torch/usercnn" if model == "module" else model,
            "method": method or "distillation (the default)",
            "batch": batch or DISTILL_BATCH,
            "optimizer": type(state.updater.args).__name__,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps[1:]],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches_per_step": {"K1": launches[0] / n,
                                  "K2": launches[1] / n,
                                  "K3": launches[2] / n},
            "launches_by_shape": {f"{lib} {shape}": c for (lib, shape), c
                                  in by_shape.items()},
            "losses": {k: [r[k] for r in steps] for k in loss_keys},
            "running_stats": len(stats), "wall_s": wall, "card": card,
        }
        print(json.dumps(row), flush=True)
        results[tag] = row
        for key, c in by_shape.items():
            results["by_shape"][key] = results["by_shape"].get(key, 0) + c
        if [r["step"] for r in steps] != list(range(1, n + 1)):
            fail(f"phase 3p {tag}: logged steps {[r['step'] for r in steps]}")
        if not all(math.isfinite(x) for k in loss_keys for x in
                   row["losses"][k] + [r["grad_norm"] for r in steps]):
            fail(f"phase 3p {tag}: a loss is not finite: {row['losses']}")
        expected = [(sum(k1f.values()) + sum(k1b.values())) * n,
                    sum(k2.values()) * n, k3 * n, 0, 0]
        want_shape = {
            **{(fwd["fp32"], shape): c * n for shape, c in k1f.items()},
            **{(fwd["bf16"], shape): c * n for shape, c in k1b.items()},
            **{(bwd, shape): c * n for shape, c in k2.items()}}
        if launches != expected or by_shape != want_shape:
            fail(f"phase 3p {tag}: launches {launches} != {expected}, by "
                 f"shape {by_shape} != {want_shape}")
        if spies[0].calls or spies[1].calls:
            fail(f"phase 3p {tag}: the step reached a stock attention op "
                 f"(SDPA {spies[0].calls}, plain {spies[1].calls})")
        if not stats or not all(torch.isfinite(v).all()
                                for v in stats.values()):
            fail(f"phase 3p {tag}: running statistics missing or not "
                 "finite")
        means = [v for k, v in stats.items() if k.endswith("mean")]
        if not means or not all(v.abs().sum() > 0 for v in means):
            fail(f"phase 3p {tag}: a running mean did not move")
        if k3 and (len(synced) != n or not all(synced)):
            fail(f"phase 3p {tag}: the EMA teacher does not read the "
                 f"student's running statistics ({synced})")
        if model == "module":
            inner = state.params["student"].inner
            tracked = [int(m.num_batches_tracked) for m in inner.modules()
                       if isinstance(m, torch.nn.BatchNorm2d)]
            print(f"  (e) the user's module: its BatchNorm2d layers' "
                  f"num_batches_tracked {tracked} after {n} steps",
                  flush=True)
            if tracked != [n] * 4:
                fail(f"phase 3p (e): num_batches_tracked {tracked}")
        if tag == "a_ecvitsplus":
            results["f_embed"] = check_item10_embed(
                lt, A, F, out / "exported_models" / "exported_last", model,
                work)
        del state
        shutil.rmtree(out)
        torch.cuda.empty_cache()
    results["g_fp32"] = g = check_cnn_fp32(A, F, card, work,
                                           "ecvit/ecvitsplus", "3p (g)",
                                           (ECVIT_FP32,))
    for key, c in g.pop("by_shape").items():
        results["by_shape"][key] = results["by_shape"].get(key, 0) + c
    return results


def check_item10_embed(lt, A, F, exported: Path, model: str,
                       work: Path) -> dict:
    """Phase 3p (f): ``embed`` of (a)'s ECViT-S+ export against an
    eval-mode forward of the exported weights, within 1e-5 relative L2;
    the fp32 ``embed`` launches K1 at ECVIT_GLOBAL once a block a batch."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        load_exported_model,
    )
    from lightly_train_tpu_torch._data.image_dataset import (
        ImageDataset,
        list_image_files,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    art = load_exported_model(exported)
    if art["model_name"] != model or not any(
            k.endswith(".var") for k in art["state_dict"]):
        fail(f"phase 3p (a): export {art['model_name']} without running "
             "statistics")
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    emb_path = lt.embed(out=str(work / "item10_embed.npz"),
                        data=str(work / "images"), checkpoint=str(exported),
                        batch_size=DISTILL_BATCH)
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    emb = np.load(emb_path)["embeddings"]
    wrapped = get_wrapped_model(model)
    wrapped.module.load_state_dict(art["state_dict"])
    wrapped.module.cuda().eval()
    dataset = ImageDataset(list_image_files(work / "images"), (224, 224))
    x = torch.from_numpy(np.stack(
        [dataset[i] for i in range(len(dataset))])).cuda()
    with torch.no_grad():
        want = wrapped.forward_pool(wrapped.forward_features(
            x.float() / 255.0)).cpu().numpy()
    err = float(np.linalg.norm(emb - want) / np.linalg.norm(want))
    print(f"  (f) embed of (a)'s export: {emb.shape} in {wall:.1f} s, "
          f"against an eval-mode forward of the exported weights: relative "
          f"L2 {err:.3e} (tol 1e-5); launches {launches}", flush=True)
    if (emb.shape != (2 * BATCH, wrapped.feature_dim) or not err <= 1e-5
            or launches != [DEPTH, 0, 0, 0, 0] or by_shape != {
                (A.fwd_library(torch.float32, HEAD_DIM), ECVIT_GLOBAL):
                DEPTH}):
        fail(f"phase 3p (f): embeddings {emb.shape}, {err}, launches "
             f"{launches} {by_shape}")
    return {"shape": list(emb.shape), "rel_l2": err, "wall_s": wall,
            "launches": launches}


def trace_kernels(out: Path) -> dict:
    """{kernel name: launches} of the one trace ``pretrain`` wrote under
    ``out/profile``."""
    traces = list((out / "profile").glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"phase 3q (a): traces under {out / 'profile'}: {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return kernels


def surface_pretrain(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3q (a): phase 3's bf16 DINOv2 run with ``embed_dim``, the
    trace window over steps 2-3 and the three logger backends, counters
    set to 0 just before and read just after: launches as phase 3's, on the
    bf16 libraries at GLOBAL and LOCAL; the trace naming K1, K2 and K3 and
    no library attention kernel; each absent logger package warned, each
    present one silent (tensorboard writing ``out/tensorboard``, wandb
    with ``WANDB_MODE=disabled``); ``metrics.jsonl`` as before; the file list
    present with one reference while the run reads it and gone after."""
    import logging
    import os

    import torch

    from lightly_train_tpu_torch._commands import train as T

    out = work / "surface"
    seen = []
    real = T.MemoryMappedSequence

    def spy(path):
        seen.append((path, path.exists(),
                     path.with_suffix(".ref_count").read_text()))
        return real(path)

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("lightly_train_tpu_torch")
    spies = [CallCount(torch.nn.functional, "scaled_dot_product_attention"),
             CallCount(A, "dot_product_attention")]
    T.MemoryMappedSequence = spy
    log.addHandler(handler)
    # wandb, where it imports, runs disabled: its calls go to a run object
    # that sends nothing anywhere.
    prior = os.environ.get("WANDB_MODE")
    os.environ["WANDB_MODE"] = "disabled"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    try:
        pretrain_main_path(lt, out, work / "images", "bf16",
                           embed_dim=SURFACE_EMBED_DIM,
                           checkpoint_every=STEPS, loggers=SURFACE_LOGGERS,
                           **SURFACE_PROFILE)
        torch.cuda.synchronize()
    finally:
        if prior is None:
            os.environ.pop("WANDB_MODE", None)
        else:
            os.environ["WANDB_MODE"] = prior
        T.MemoryMappedSequence = real
        log.removeHandler(handler)
        for spied in spies:
            spied.restore()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = logged_steps(out)
    fwd, bwd = (A.fwd_library(torch.bfloat16, HEAD_DIM),
                A.bwd_library(torch.bfloat16, HEAD_DIM))
    # Per step: K1 at GLOBAL in the teacher's and the student's global
    # forwards, at LOCAL in the student's local one; K2 once in each of
    # the student's backwards.
    want = {(fwd, GLOBAL): 2 * DEPTH * STEPS, (fwd, LOCAL): DEPTH * STEPS,
            (bwd, GLOBAL): DEPTH * STEPS, (bwd, LOCAL): DEPTH * STEPS}
    expected = dinov2_expected(STEPS)
    print(f"  (a) pretrain DINOv2 ViT-B/14 bf16, embed_dim "
          f"{SURFACE_EMBED_DIM}, {SURFACE_PROFILE}, loggers "
          f"{sorted(SURFACE_LOGGERS)}: steps "
          f"{[round(r['profiling/step_time'] * 1e3, 1) for r in steps]} ms, "
          f"peak {peak:.2f} GiB, wall {wall:.1f} s; launches {launches} "
          f"(expected {expected}) [{card}]", flush=True)
    if launches != expected or by_shape != want:
        fail(f"phase 3q (a): launches {launches}, by shape {by_shape}")
    if spies[0].calls or spies[1].calls:
        fail(f"phase 3q (a): SDPA {spies[0].calls}, plain attention "
             f"{spies[1].calls}")
    if [r["step"] for r in steps] != list(range(1, STEPS + 1)) or not all(
            math.isfinite(r["train_loss"]) for r in steps):
        fail(f"phase 3q (a): metrics.jsonl {steps}")

    kernels = trace_kernels(out)
    named = {k: {n: c for n, c in kernels.items() if pattern in n}
             for k, pattern in (("K1", "attention_fwd_sm90_kernel"),
                                ("K2", "attention_bwd_"),
                                ("K3", "fused_adamw_ema_kernel"))}
    library = sorted(n for n in kernels if any(
        w in n.lower() for w in ("flash", "fmha", "efficient_attention",
                                 "mem_eff", "sdpa")))
    window = SURFACE_PROFILE["profile_steps"]
    busy = {k: sum(v.values()) for k, v in named.items()}
    print(f"  (a) trace: {len(kernels)} kernel names, "
          f"{sum(kernels.values())} launches over {window} steps; K1 "
          f"{busy['K1']}, K2 {busy['K2']} ({sorted(named['K2'])}), K3 "
          f"{busy['K3']}; library attention kernels {library}", flush=True)
    if (busy["K1"] != 3 * DEPTH * window or not busy["K2"]
            or busy["K3"] != window or library):
        fail(f"phase 3q (a): the trace's kernels {busy}, {library}")

    for name, package in (("tensorboard", "torch.utils.tensorboard"),
                          ("wandb", "wandb"), ("mlflow", "mlflow")):
        warned = any(r.getMessage().startswith(f"{name} logging unavailable")
                     for r in records)
        try:
            __import__(package)
            present = True
        except ImportError:
            present = False
        print(f"  (a) logger {name}: package "
              f"{'imports' if present else 'absent'}, "
              f"{'warned' if warned else 'no warning'}", flush=True)
        if present == warned or (name == "tensorboard" and present
                                 and not (out / "tensorboard").exists()):
            fail(f"phase 3q (a): logger {name}")
    if (len(seen) != 1 or seen[0][1:] != (True, "1") or seen[0][0].exists()
            or seen[0][0].with_suffix(".ref_count").exists()):
        fail(f"phase 3q (a): the file list {seen}")
    print(f"  (a) file list {seen[0][0].name}: present with reference count "
          f"{seen[0][2]} while read, gone after the run", flush=True)
    return {"launches": launches, "by_shape": by_shape, "wall_s": wall,
            "peak_gib": peak, "trace": busy,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps],
            "out": out}


def surface_export(lt, A, F, work: Path, exported: Path) -> None:
    """Phase 3q (b): ``export`` of (a)'s export in the three formats and the
    two parts; ``embed`` of the ``package_default`` re-export (with its
    head) against ``embed`` of the original; the ViT's ``torch_state_dict``
    (Meta's names) given back as ``checkpoint=`` carrying the exported
    weights bitwise, its model's eval forward equal to the original's."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        load_exported_model,
        resolve_pretrained_source,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    t0 = time.perf_counter()
    paths = {}
    for fmt, suffix in (("package_default", ""), ("numpy_state_dict",
                                                  ".npz"),
                        ("torch_state_dict", ".pt")):
        for part in ("model", "embedding_model"):
            paths[fmt, part] = lt.export(
                out=str(work / f"export_{fmt}_{part}{suffix}"),
                checkpoint=str(exported), format=fmt, part=part)
    npz = np.load(paths["numpy_state_dict", "embedding_model"])
    meta = torch.load(paths["torch_state_dict", "model"])
    head = torch.load(paths["torch_state_dict", "embedding_model"])
    print(f"  (b) export: {len(npz.files)} arrays in the npz (with "
          f"embed_head/kernel {npz['embed_head/kernel'].shape}), "
          f"{len(meta)} Meta-named tensors, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if ("blocks.11.attn.qkv.weight" not in meta or "embed_head.weight"
            not in head or npz["embed_head/kernel"].shape
            != (768, SURFACE_EMBED_DIM)):
        fail("phase 3q (b): the exported state dicts")
    kwargs = dict(data=str(work / "images"), image_size=224,
                  batch_size=2 * BATCH)
    embs = [np.load(lt.embed(out=str(work / f"surface_{tag}.npz"),
                             checkpoint=str(ckpt), **kwargs))["embeddings"]
            for tag, ckpt in (("orig", exported), ("again", paths[
                "package_default", "embedding_model"]))]
    rel = float(np.linalg.norm(embs[1] - embs[0]) / np.linalg.norm(embs[0]))
    print(f"  (b) embed of the package_default re-export against the "
          f"original: {embs[0].shape}, relative L2 {rel:.3e}, bitwise "
          f"{np.array_equal(*embs)} (tol 1e-6)", flush=True)
    if embs[0].shape != (2 * BATCH, SURFACE_EMBED_DIM) or not rel <= 1e-6:
        fail(f"phase 3q (b): embed of the re-export {rel}")

    state, name, _ = resolve_pretrained_source(
        str(paths["torch_state_dict", "model"]), "dinov2/vitb14")
    orig = load_exported_model(exported)["state_dict"]
    same = set(state) == set(orig) and all(torch.equal(state[k], v)
                                           for k, v in orig.items())
    images = torch.rand((2, 224, 224, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    outs = []
    for weights in (orig, state):
        model = get_wrapped_model("dinov2/vitb14").module
        model.load_state_dict(weights)
        with torch.no_grad():
            outs.append(model.cuda().eval()(images)["cls_token"])
    print(f"  (b) the Meta-named file as checkpoint=: {name}, the exported "
          f"weights bitwise {same}, eval forward equal "
          f"{torch.equal(*outs)}", flush=True)
    if not (same and torch.equal(*outs)):
        fail("phase 3q (b): the torch_state_dict as checkpoint=")
    for path in paths.values():
        if path.is_dir():
            shutil.rmtree(path)
        else:
            path.unlink()


def surface_knn(lt, A, F, card: str, work: Path, exported: Path) -> dict:
    """Phase 3q (c): ``evaluate_knn`` of (a)'s export on a class folder
    (class c: phase 3's generator, its brightness shifted by 40 c - 60) in
    fp32 under
    ``LIGHTLY_TRAIN_MATMUL_PRECISION=highest`` and at the default (TF32),
    and in bf16, counters set to 0 just before each and read just after:
    12 K1 a batch at KNN_SHAPE, no K2 or K3, no SDPA or plain attention;
    the embeddings of KNN_CPU_IMAGES images against the port's CPU run
    (KNN_TOL; bf16 5e-2, as ``check_backbone``); the accuracy equal to
    the CPU's ``knn_accuracy`` of the card's embeddings."""
    import os

    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        load_exported_model,
    )
    from lightly_train_tpu_torch._commands import eval_knn as K
    from lightly_train_tpu_torch._data.classification_dataset import (
        ImageClassificationDataset,
    )
    from lightly_train_tpu_torch.ops.augment import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from lightly_train_tpu_torch.utils.knn import knn_accuracy

    root = work / "knn"
    for split, n, seed in (("train", KNN_TRAIN, SEED + 1),
                           ("val", KNN_VAL, SEED + 2)):
        for c in range(KNN_CLASSES):
            write_images(root / split / f"class{c}", n // KNN_CLASSES, 256,
                         seed=seed + 10 * c, offset=40.0 * c - 60.0)
    data = {"train": str(root / "train"), "val": str(root / "val")}
    # The CPU's embeddings of KNN_CPU_IMAGES train images, as embed_split
    # computes them (plain attention, IEEE fp32).
    cpu = K.exported_backbone(load_exported_model(exported), torch.float32,
                              torch.device("cpu"))
    per_class = KNN_TRAIN // KNN_CLASSES
    picks = [c * per_class + i for c in range(KNN_CLASSES)
             for i in range(KNN_CPU_IMAGES // KNN_CLASSES)]
    train_set = ImageClassificationDataset(root / "train", (224, 224))
    x = torch.from_numpy(np.stack([train_set[i]["images"] for i in picks]))
    x = ((x.float() / 255.0 - torch.tensor(IMAGENET_MEAN))
         / torch.tensor(IMAGENET_STD))
    with torch.no_grad():
        ref = cpu.forward_pool(cpu.forward_features(x))
    results = {"by_shape": {}}
    prior = os.environ.get("LIGHTLY_TRAIN_MATMUL_PRECISION")
    for tag, precision, matmul in (("fp32_highest", "fp32", "highest"),
                                   ("fp32_default", "fp32", "default"),
                                   ("bf16", "bf16", "default")):
        os.environ["LIGHTLY_TRAIN_MATMUL_PRECISION"] = matmul
        calls = []
        real = K.knn_accuracy

        def recorded(*args, **kwargs):
            calls.append((args, kwargs))
            return real(*args, **kwargs)

        spies = [CallCount(torch.nn.functional,
                           "scaled_dot_product_attention"),
                 CallCount(A, "dot_product_attention")]
        K.knn_accuracy = recorded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters(A, F)
        t0 = time.perf_counter()
        try:
            got = lt.evaluate_knn(data=data, checkpoint=str(exported),
                                  precision=precision)
            torch.cuda.synchronize()
        finally:
            K.knn_accuracy = real
            for spied in spies:
                spied.restore()
            if prior is None:
                os.environ.pop("LIGHTLY_TRAIN_MATMUL_PRECISION", None)
            else:
                os.environ["LIGHTLY_TRAIN_MATMUL_PRECISION"] = prior
            pin_ieee()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        by_shape = launches_by_shape(A)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lib = A.fwd_library(torch_dtype(precision), HEAD_DIM)
        want = {(lib, KNN_SHAPE): DEPTH * KNN_BATCHES}
        (args, kwargs), = calls
        val_z, val_y, train_z, train_y = (a.cpu() for a in args)
        cpu_acc = knn_accuracy(val_z, val_y, train_z, train_y, **kwargs)
        emb = train_z[picks]
        rel = float((emb - ref).norm() / ref.norm())
        centred = float(((emb - emb.mean(0)) - (ref - ref.mean(0))).norm()
                        / (ref - ref.mean(0)).norm())
        tol = 5e-2 if precision == "bf16" else KNN_TOL[matmul]
        row = {"phase": "3q (c)", "run": tag, "knn_top1": got["knn_top1"],
               "cpu_knn_top1": cpu_acc, "launches": launches,
               "k1_per_batch": by_shape.get((lib, KNN_SHAPE), 0)
               / KNN_BATCHES, "precision": precision,
               "wall_s": wall, "ms_per_batch": wall * 1e3 / KNN_BATCHES,
               "peak_gib": peak, "rel_l2_vs_cpu": rel,
               "centred_rel_l2_vs_cpu": centred, "tol": tol, "card": card}
        print(json.dumps(row), flush=True)
        results[tag] = row
        for key, c in by_shape.items():
            results["by_shape"][key] = results["by_shape"].get(key, 0) + c
        if launches != [DEPTH * KNN_BATCHES, 0, 0, 0, 0] or by_shape != want:
            fail(f"phase 3q (c) {tag}: launches {launches}, {by_shape}")
        if spies[0].calls or spies[1].calls:
            fail(f"phase 3q (c) {tag}: SDPA {spies[0].calls}, plain "
                 f"attention {spies[1].calls}")
        if (train_z.shape != (KNN_TRAIN, 768) or val_z.shape
                != (KNN_VAL, 768) or not torch.isfinite(train_z).all()
                or not torch.isfinite(val_z).all()):
            fail(f"phase 3q (c) {tag}: embeddings {train_z.shape}, "
                 f"{val_z.shape}")
        if got["knn_top1"] != cpu_acc or not rel <= tol:
            fail(f"phase 3q (c) {tag}: accuracy {got} against the CPU's "
                 f"{cpu_acc}, embeddings {rel} (tol {tol})")
    return results


def surface_cli(lt, A, card: str, work: Path) -> dict:
    """Phase 3q (d): ``python -m lightly_train_tpu_torch list_models``
    prints ``list_models()``; ``pretrain`` of DINOv2 ViT-B/14 at phase 3's
    batch for CLI_STEPS steps through the CLI (CLI_CHILD, the counts read in
    the subprocess as it ends; the checkpoint only at the end, as phase
    3's) exits 0 on the card with CLI_STEPS finite logged steps and
    launches as phase 3's, on the bf16 libraries at GLOBAL and LOCAL."""
    out = work / "cli_run"
    results = {}
    for tag, child, argv in (
            ("list_models", ["-m", "lightly_train_tpu_torch"],
             ["list_models"]),
            ("pretrain", ["-c", CLI_CHILD],
             ["pretrain", f"out={out}", f"data={work / 'images'}",
              "model=dinov2/vitb14", "method=dinov2",
              f"batch_size={BATCH}", f"steps={CLI_STEPS}", "log_every=1",
              f"checkpoint_every={CLI_STEPS}", "canonical_size=256",
              f"seed={SEED}"])):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, *child, *argv],
                             capture_output=True, text=True, timeout=600,
                             cwd=ROOT)
        wall = time.perf_counter() - t0
        results[f"{tag}_s"] = wall
        print(f"  (d) python -m lightly_train_tpu_torch {argv[0]}: exit "
              f"{run.returncode}, {wall:.1f} s", flush=True)
        if run.returncode != 0:
            fail(f"phase 3q (d) {tag}: {run.stderr[-2000:]}")
        if (tag == "list_models"
                and run.stdout.splitlines() != lt.list_models()):
            fail("phase 3q (d): list_models through the CLI")
    counted = [json.loads(line[len("launches "):])
               for line in run.stdout.splitlines()
               if line.startswith("launches ")]
    if len(counted) != 1:
        fail(f"phase 3q (d): the CLI's counts {run.stdout[-2000:]}")
    launches = counted[0]["launches"]
    by_shape = {(lib, tuple(shape)): c
                for lib, shape, c in counted[0]["by_shape"]}
    steps = logged_steps(out)
    fwd, bwd = (A.fwd_library(torch_dtype("bf16"), HEAD_DIM),
                A.bwd_library(torch_dtype("bf16"), HEAD_DIM))
    want = {(fwd, GLOBAL): 2 * DEPTH * CLI_STEPS,
            (fwd, LOCAL): DEPTH * CLI_STEPS,
            (bwd, GLOBAL): DEPTH * CLI_STEPS, (bwd, LOCAL): DEPTH * CLI_STEPS}
    print(f"  (d) the CLI's pretrain DINOv2 ViT-B/14 bf16, batch {BATCH}: "
          f"steps {[round(r['profiling/step_time'] * 1e3, 1) for r in steps]}"
          f" ms; launches {launches} (expected "
          f"{dinov2_expected(CLI_STEPS)}) [{card}]", flush=True)
    if launches != dinov2_expected(CLI_STEPS) or by_shape != want:
        fail(f"phase 3q (d): launches {launches}, by shape {by_shape}")
    if [r["step"] for r in steps] != list(range(1, CLI_STEPS + 1)) or not all(
            math.isfinite(r["train_loss"]) for r in steps):
        fail(f"phase 3q (d): the CLI's metrics.jsonl {steps}")
    shutil.rmtree(out)
    results.update(launches=launches, by_shape=by_shape,
                   step_ms=[r["profiling/step_time"] * 1e3 for r in steps])
    return results


def run_surface_path(lt, A, F, card: str, work: Path) -> dict:
    """Phase 3q: (a) ``surface_pretrain``, (b) ``surface_export``, (c)
    ``surface_knn``, (d) ``surface_cli``."""
    results = {"a": surface_pretrain(lt, A, F, card, work)}
    exported = results["a"]["out"] / "exported_models" / "exported_last"
    pin_ieee()
    surface_export(lt, A, F, work, exported)
    results["c"] = surface_knn(lt, A, F, card, work, exported)
    results["d"] = surface_cli(lt, A, card, work)
    results["by_shape"] = dict(results["a"]["by_shape"])
    for key, c in [*results["c"].pop("by_shape").items(),
                   *results["d"]["by_shape"].items()]:
        results["by_shape"][key] = results["by_shape"].get(key, 0) + c
    shutil.rmtree(results["a"].pop("out"))
    shutil.rmtree(work / "knn")
    return results

def write_class_folders(root: Path, n_train: int, n_val: int) -> dict:
    """Two class folders of ``n_train`` train and ``n_val`` val images at
    256^2 (``write_images``), the second class 60 levels brighter."""
    for split, n, seed in (("train", n_train, SEED + 40),
                           ("val", n_val, SEED + 41)):
        for c, offset in ((0, -30.0), (1, 30.0)):
            write_images(root / split / f"class_{c}", n, 256,
                         seed=seed + 2 * c, offset=offset)
    return {"train": str(root / "train"), "val": str(root / "val")}


def write_seg_masks(folder: Path, n: int, size: int = 256,
                    classes: int = FT_SEG_CLASSES, block: int = 32) -> None:
    """8-bit gray PNG masks for ``write_images``' first ``n`` stems: ids
    below ``classes`` in ``block``-pixel blocks, the top 16 rows 255 (the
    ignore index)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 42)
    folder.mkdir(parents=True)
    for i in range(n):
        blocks = rng.integers(0, classes, (size // block, size // block))
        ids = np.repeat(np.repeat(blocks, block, 0), block, 1)
        ids[:16] = 255
        (folder / f"img_{i:03d}.png").write_bytes(
            png_bytes(ids[..., None].astype(np.uint8), 0, 8))


class PlainAttentionCount:
    """Wraps the plain attention ``A.dot_product_attention`` to count its
    masked calls (EoMT's joint blocks in training) apart from its unmasked
    ones (none on any path of the card) until :meth:`restore`."""

    def __init__(self, A):
        self.A, self.fn = A, A.dot_product_attention
        self.masked = self.calls = 0

        def counted(q, k, v, num_heads, mask=None, scale=None):
            if mask is None:
                self.calls += 1
            else:
                self.masked += 1
            return self.fn(q, k, v, num_heads, mask, scale)

        A.dot_product_attention = counted

    def restore(self) -> None:
        self.A.dot_product_attention = self.fn


def finetune_run(lt, A, F, entry: str, out: Path, **kwargs) -> dict:
    """``lt.<entry>(out=out, **kwargs)`` with every launch counter set to 0
    just before and read just after, SDPA and the plain attention counted
    (``CallCount``, ``PlainAttentionCount``: unmasked and masked apart),
    each validation step timed to the card's end and its launches by shape
    and masked plain attentions read before and after it, the peak memory
    and what earlier phases left allocated before it; the train and val
    records of ``metrics.jsonl``."""
    import torch

    from lightly_train_tpu_torch._commands import train_task as TT

    val_ms, val_launches, val_masked = [], [], []
    run = TT.run_task_training

    def timed_val(config, train_model, *args):
        inner = train_model.val_step

        def val_step(model, batch):
            before = launches_by_shape(A)
            masked = plain.masked
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = inner(model, batch)
            torch.cuda.synchronize()
            val_ms.append((time.perf_counter() - t0) * 1e3)
            val_launches.append({k: n - before.get(k, 0) for k, n in
                                 launches_by_shape(A).items()
                                 if n != before.get(k, 0)})
            val_masked.append(plain.masked - masked)
            return stats

        train_model.val_step = val_step
        return run(config, train_model, *args)

    TT.run_task_training = timed_val
    plain = PlainAttentionCount(A)
    spies = [CallCount(torch.nn.functional, "scaled_dot_product_attention"),
             plain]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    try:
        state, val = getattr(lt, entry)(out=str(out), **kwargs)
        torch.cuda.synchronize()
    finally:
        TT.run_task_training = run
        for spied in spies:
            spied.restore()
    records = logged_steps(out)
    return {"state": state, "val": val, "wall_s": time.perf_counter() - t0,
            "launches": [fn.launches for fn in counters],
            "by_shape": launches_by_shape(A),
            "stock_calls": [spied.calls for spied in spies],
            "masked_calls": plain.masked, "val_masked": val_masked,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "held_gib": held, "val_ms": val_ms, "val_by_shape": val_launches,
            "train": [r for r in records if "train_loss" in r],
            "val_records": [r for r in records if "train_loss" not in r]}


def check_finetune(tag: str, r: dict, out: Path, steps: int, batch: int,
                   expected: list, by_shape: dict, val_keys: set,
                   card: str, per_step: dict = None,
                   per_val_batch: dict = None, masked_per_step: int = 0,
                   phase_id: str = "3r") -> dict:
    """Phase 3r's (and 3s's) checks of one run: the logged steps with
    finite losses, the val metric keys, both exports with the task's
    metadata, the launches in all and by shape, no SDPA and no unmasked
    plain attention, ``masked_per_step`` masked plain attentions a train
    step and none in validation, K3 0; where given, the launches by shape
    of each val batch (read around it) and of a train step (the rest over
    ``steps``). Returns the step times (ms, from each step's images/s) and
    the run's numbers."""
    train = r["train"]
    step_ms = [batch * 1e3 / x["profiling/images_per_sec"] for x in train]
    in_val = {}
    for launched in r["val_by_shape"]:
        for k, n in launched.items():
            in_val[k] = in_val.get(k, 0) + n
    r["per_step"] = {k: (n - in_val.get(k, 0)) / steps
                     for k, n in r["by_shape"].items()
                     if n != in_val.get(k, 0)}
    print(f"  {tag}: steps {[round(ms, 1) for ms in step_ms]} ms "
          f"({[round(x['profiling/images_per_sec'], 1) for x in train]} "
          f"img/s; waiting on the loader "
          f"{[round(x['profiling/data_time'] * 1e3, 1) for x in train]} ms), "
          f"losses {[round(x['train_loss'], 4) for x in train]}, "
          f"val {r['val']}, val steps "
          f"{[round(ms, 1) for ms in r['val_ms']]} ms, peak "
          f"{r['peak_gib']:.2f} GiB ({r['held_gib']:.2f} GiB held before "
          f"the run), wall {r['wall_s']:.1f} s; launches "
          f"{r['launches']} (expected {expected}), by shape {r['by_shape']}, "
          f"a train step {r['per_step']}, each val batch "
          f"{r['val_by_shape']}; masked plain attentions {r['masked_calls']}"
          f" (expected {masked_per_step} a step), in each val batch "
          f"{r['val_masked']} [{card}]", flush=True)
    where = f"phase {phase_id} {tag}"
    if [x["step"] for x in train] != list(range(1, steps + 1)) or not all(
            math.isfinite(x["train_loss"]) for x in train):
        fail(f"{where}: metrics.jsonl {train}")
    if not val_keys <= set(r["val"]) or not all(
            math.isfinite(v) for v in r["val"].values()):
        fail(f"{where}: val metrics {r['val']}")
    for name in ("exported_best", "exported_last"):
        meta = out / "exported_models" / name / "metadata.json"
        if not (meta.is_file() and "task" in json.loads(meta.read_text())):
            fail(f"{where}: {name} missing")
    if r["launches"] != expected or r["by_shape"] != by_shape:
        fail(f"{where}: launches {r['launches']} != {expected}, by "
             f"shape {r['by_shape']} != {by_shape}")
    if per_step is not None and r["per_step"] != per_step:
        fail(f"{where}: a train step's launches {r['per_step']} != "
             f"{per_step}")
    if per_val_batch is not None and (not r["val_by_shape"] or any(
            launched != per_val_batch for launched in r["val_by_shape"])):
        fail(f"{where}: the val batches' launches "
             f"{r['val_by_shape']} != {per_val_batch} each")
    if any(r["stock_calls"]):
        fail(f"{where}: SDPA and unmasked plain attention calls "
             f"{r['stock_calls']}")
    if r["masked_calls"] != masked_per_step * steps or any(r["val_masked"]):
        fail(f"{where}: masked plain attentions {r['masked_calls']} (in "
             f"validation {r['val_masked']}) != {masked_per_step} a step "
             f"and none in validation")
    return {k: v for k, v in r.items() if k not in ("state", "train",
                                                     "val_records")} | {
        "step_ms": step_ms}


def fp32_step(lt, entry: str, out: Path, patches: tuple = (),
              **kwargs) -> dict:
    """One step of ``lt.<entry>(out=out, steps=1, **kwargs)`` with each
    ``(owner, name, value)`` of ``patches`` set for the call: the loss,
    every parameter before and after the update and its gradient (a spy on
    ``UnfusedUpdate.update_and_apply``)."""
    from lightly_train_tpu_torch._optim.update import UnfusedUpdate

    snaps = []
    update = UnfusedUpdate.update_and_apply

    def spy(self, grads, params, *args, **kw):
        snaps.append({n: g.detach().float().cpu().clone()
                      for n, g in grads.items() if g is not None})
        snaps.append({n: p.detach().float().cpu().clone()
                      for n, p in params.items()})
        norm = update(self, grads, params, *args, **kw)
        snaps.append({n: p.detach().float().cpu().clone()
                      for n, p in params.items()})
        return norm

    patches = ((UnfusedUpdate, "update_and_apply", spy),) + tuple(patches)
    prior = [getattr(owner, name) for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    try:
        getattr(lt, entry)(out=str(out), steps=1, **kwargs)
    finally:
        for (owner, name, _), value in zip(patches, prior):
            setattr(owner, name, value)
    loss = logged_steps(out)[0]["train_loss"]
    shutil.rmtree(out)
    return {"loss": loss, "grads": snaps[0], "before": snaps[1],
            "after": snaps[2]}


def finetune_fp32_step(lt, device: str, export: Path, data: dict,
                       out: Path) -> dict:
    """One fp32 step of (a)'s path on 8 images in a batch of 8 on
    ``device``, from ``export``, with the random transforms off and SGD
    (its first step is the gradient times the learning rate, so the
    parameters' change carries the gradient's rounding and nothing of
    AdamW's sign-like first step): ``fp32_step``'s loss and parameters."""
    return fp32_step(
        lt, "train_image_classification", out, data=data, model=FT_MODEL,
        checkpoint=str(export), batch_size=8, precision="fp32", optim="sgd",
        learning_rate=0.1, transform_args=FT_NO_AUG, log_every=1, seed=SEED,
        accelerator=device)


def card_against_cpu(A, F, where: str, step) -> dict:
    """``step(device)`` (an ``fp32_step``) on the card, its launches
    counted from 0, and on the CPU, under
    ``LIGHTLY_TRAIN_MATMUL_PRECISION=highest`` (IEEE fp32 pinned again
    after): both runs, the card's launches and by shape, the CPU's seconds,
    and the relative errors of the loss, the parameters and their change.
    Fails where the initial parameters differ or nothing changed."""
    import os

    import torch

    prior = os.environ.get("LIGHTLY_TRAIN_MATMUL_PRECISION")
    os.environ["LIGHTLY_TRAIN_MATMUL_PRECISION"] = "highest"
    try:
        counters = reset_counters(A, F)
        on_card = step("cuda")
        torch.cuda.synchronize()
        launches = [fn.launches for fn in counters]
        by_shape = launches_by_shape(A)
        t0 = time.perf_counter()
        on_cpu = step("cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        if prior is None:
            os.environ.pop("LIGHTLY_TRAIN_MATMUL_PRECISION", None)
        else:
            os.environ["LIGHTLY_TRAIN_MATMUL_PRECISION"] = prior
        pin_ieee()
    names = sorted(on_cpu["before"])

    def flat(run, change):
        return torch.cat([(run["after"][n] - (run["before"][n] if change
                                              else 0)).reshape(-1)
                          for n in names])

    if any(not torch.equal(on_card["before"][n], on_cpu["before"][n])
           for n in names):
        fail(f"{where}: the card's and the CPU's initial parameters differ")
    ref_change = flat(on_cpu, True)
    if not ref_change.norm():
        fail(f"{where}: the CPU's step changed no parameter")
    errors = {
        "loss": abs(on_card["loss"] - on_cpu["loss"]) / abs(on_cpu["loss"]),
        "parameters": ((flat(on_card, False) - flat(on_cpu, False)).norm()
                       / flat(on_cpu, False).norm()).item(),
        "parameter_change": ((flat(on_card, True) - ref_change).norm()
                             / ref_change.norm()).item(),
    }
    return {"card": on_card, "cpu": on_cpu, "launches": launches,
            "by_shape": by_shape, "cpu_s": cpu_s, "errors": errors}


def stop_and_resume(lt, A, F, where: str, entry: str, out: Path,
                    straight: list, last_step: int, card: str,
                    **kwargs) -> dict:
    """``lt.<entry>(out=out, **kwargs)`` (``save_every=2``) stopped after
    its step-2 checkpoint (the loader raises before batch 3), then resumed
    with ``resume_interrupted``: both runs' launches counted from 0 and
    read after; the state the resume restores (parameters, buffers, the
    method state, the optimizer, the step) bitwise the checkpoint's; and
    every logged loss bitwise the uninterrupted run's ``straight`` records
    (the runs are deterministic on the card: a resume that read other
    batches, restarted the stream or annealed on another horizon moves
    them)."""
    import torch

    from lightly_train_tpu_torch._checkpoint import checkpoint as CK
    from lightly_train_tpu_torch._commands import train_task as TT

    class StopAfterTwo(TT.PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise KeyboardInterrupt
                yield batch

    def cloned(x):
        if isinstance(x, dict):
            return {k: cloned(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cloned(v) for v in x)
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        return a == b

    counters = reset_counters(A, F)
    loader = TT.PretrainLoader
    TT.PretrainLoader = StopAfterTwo
    try:
        getattr(lt, entry)(out=str(out), **kwargs)
        fail(f"{where}: the stopped run did not stop")
    except KeyboardInterrupt:
        pass
    finally:
        TT.PretrainLoader = loader
    saved = torch.load(out / "checkpoints" / "step_2.pt", map_location="cpu",
                       weights_only=True)
    restored, restore = {}, CK.CheckpointManager.restore

    def spy(self, state, step=None):
        state = restore(self, state, step)
        restored.update(step=state.step,
                        params=cloned(state.params.state_dict()),
                        method_state=cloned(state.method_state),
                        optimizer=cloned(state.updater.state_dict()))
        return state

    CK.CheckpointManager.restore = spy
    try:
        state, _ = getattr(lt, entry)(out=str(out), resume_interrupted=True,
                                      **kwargs)
    finally:
        CK.CheckpointManager.restore = restore
    launches = [fn.launches for fn in counters]
    by_shape = launches_by_shape(A)
    bitwise = {key: key in restored and same(restored[key], saved[key])
               for key in ("step", "params", "method_state", "optimizer")}
    resumed = [x for x in logged_steps(out) if "train_loss" in x]
    gap = max(abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"])
              for a, b in zip(resumed[2:], straight[2:]))
    print(f"  {where}: stopped after step 2's checkpoint and resumed: the "
          f"restored state bitwise the checkpoint's {bitwise}; steps "
          f"{[x['step'] for x in resumed]}, state step {state.step}, losses "
          f"{[x['train_loss'] for x in resumed]} against the uninterrupted "
          f"run's {[x['train_loss'] for x in straight]} (steps 3 on "
          f"{gap:.2e} apart, every step bitwise equal required); launches "
          f"of both runs {launches}, by shape {by_shape} [{card}]",
          flush=True)
    if not all(bitwise.values()) or state.step != last_step or [
            x["step"] for x in resumed] != list(range(1, last_step + 1)) or [
                x["train_loss"] for x in resumed] != [
                x["train_loss"] for x in straight]:
        fail(f"{where}: the resume {bitwise}, {resumed}, step {state.step}, "
             f"against {straight}")
    shutil.rmtree(out)
    return {"gap": gap, "launches": launches, "by_shape": by_shape,
            "bitwise": bitwise}


def run_finetune_path(lt, A, F, card: str, work: Path, export: Path) -> dict:
    """Phase 3r: (a) ``train_image_classification`` and (b) linear
    ``train_semantic_segmentation`` at ViT-B/14 width from ``export`` (phase
    3's bf16 DINOv2 export), bf16, FT_STEPS steps at their default batches
    (128 and 16), validated at the end; (c) both multihead entry points at
    vittest14, batch FT_MH_BATCH, and a stopped and resumed run of the
    classification one; (d) one fp32 step of (a)'s path on the card against
    the port's CPU path. Each run's launches counted from 0 (K1/K2 by
    shape, K3 0, no stock or plain attention) and checked by
    ``check_finetune``."""
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        export_model,
        load_exported_model,
    )

    cls_data = write_class_folders(work / "ft_cls", FT_TRAIN, FT_VAL)
    write_seg_masks(work / "ft_masks", 2 * BATCH)
    write_images(work / "ft_seg_val", FT_SEG_VAL, 256, seed=SEED + 43)
    seg_data = {"num_classes": FT_SEG_CLASSES,
                "train": {"images": str(work / "images"),
                          "masks": str(work / "ft_masks")},
                "val": {"images": str(work / "ft_seg_val"),
                        "masks": str(work / "ft_masks")}}
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    fwd16 = A.fwd_library(torch.bfloat16, 16)
    common = dict(model=FT_MODEL, checkpoint=str(export),
                  steps=FT_STEPS, precision="bf16", log_every=1,
                  val_every=FT_STEPS, seed=SEED)
    results = {}

    # (a) classification, the backbone trained: K1 and K2 12 a step, K1 12
    # a val batch (2 FT_VAL images in one batch of 128).
    out = work / "ft_a"
    val_batches = -(-2 * FT_VAL // FT_CLS[0])
    r = finetune_run(lt, A, F, "train_image_classification", out,
                     data=cls_data, **common)
    results["a"] = check_finetune(
        "(a) train_image_classification ViT-B/14 bf16, batch 128", r, out,
        FT_STEPS, FT_CLS[0],
        [DEPTH * (FT_STEPS + val_batches), DEPTH * FT_STEPS, 0, 0, 0],
        {(fwd, FT_CLS): DEPTH * (FT_STEPS + val_batches),
         (bwd, FT_CLS): DEPTH * FT_STEPS},
        {"val_loss", "val_top1", "val_top5", "val_f1"}, card,
        per_step={(fwd, FT_CLS): DEPTH, (bwd, FT_CLS): DEPTH},
        per_val_batch={(fwd, FT_CLS): DEPTH})
    if not all(p.requires_grad for p in r["state"].params.parameters()):
        fail("phase 3r (a): the backbone does not train")
    shutil.rmtree(out)
    del r

    # (b) the linear probe, frozen: K1 12 a step, none of K2; validation at
    # FT_VAL_SIZE in FT_TILES tiles of 224^2, 12 K1 a tile.
    out = work / "ft_b"
    r = finetune_run(lt, A, F, "train_semantic_segmentation", out,
                     data=seg_data, val_image_size=FT_VAL_SIZE, **common)
    results["b"] = check_finetune(
        f"(b) train_semantic_segmentation ViT-B/14 bf16, batch 16, val "
        f"{FT_VAL_SIZE}^2 tiled", r, out, FT_STEPS, FT_SEG[0],
        [DEPTH * (FT_STEPS + FT_TILES), 0, 0, 0, 0],
        {(fwd, FT_SEG): DEPTH * (FT_STEPS + FT_TILES)}, {"val_loss",
                                                          "val_miou"}, card,
        per_step={(fwd, FT_SEG): DEPTH},
        per_val_batch={(fwd, FT_SEG): DEPTH * FT_TILES})
    if any(p.requires_grad for p in r["state"].params.backbone.parameters()):
        fail("phase 3r (b): the probe's backbone requires gradients")
    shutil.rmtree(out)
    del r

    # (c) the multihead entry points at vittest14 (hd 16), frozen: K1 2 a
    # step and 2 a val batch at HD16_SMALL.
    mh = dict(model="dinov2/vittest14", batch_size=FT_MH_BATCH,
              precision="bf16", log_every=1, seed=SEED)
    out = work / "ft_c_cls"
    cls_val = -(-2 * FT_VAL // FT_MH_BATCH)
    r = finetune_run(lt, A, F, "train_image_classification_multihead", out,
                     data=cls_data, steps=FT_MH_STEPS, save_every=2,
                     val_every=FT_MH_STEPS, **mh)
    results["c_cls"] = check_finetune(
        "(c) train_image_classification_multihead vittest14 bf16", r, out,
        FT_MH_STEPS, FT_MH_BATCH, [2 * (FT_MH_STEPS + cls_val), 0, 0, 0, 0],
        {(fwd16, HD16_SMALL): 2 * (FT_MH_STEPS + cls_val)},
        {"val_top1_head_1x", "val_top1_head_01x", "val_top1_best"}, card)
    straight = r["train"]
    shutil.rmtree(out)
    # Stopped and resumed: steps 3-4 sit near ln 2 with the 2-class heads
    # at chance; both runs launch what the uninterrupted one did.
    resume = stop_and_resume(
        lt, A, F, "phase 3r (c)", "train_image_classification_multihead",
        work / "ft_c_resume", straight, FT_MH_STEPS, card, data=cls_data,
        steps=FT_MH_STEPS, save_every=2, val_every=FT_MH_STEPS, **mh)
    if resume["by_shape"] != results["c_cls"]["by_shape"]:
        fail(f"phase 3r (c): the stopped and resumed runs launched "
             f"{resume['by_shape']}, the uninterrupted one "
             f"{results['c_cls']['by_shape']}")
    results["c_resume"] = resume
    out = work / "ft_c_seg"
    seg_val = -(-FT_SEG_VAL // FT_MH_BATCH)
    r = finetune_run(lt, A, F, "train_semantic_segmentation_multihead", out,
                     data=seg_data, steps=2, val_every=2, **mh)
    results["c_seg"] = check_finetune(
        "(c) train_semantic_segmentation_multihead vittest14 bf16", r, out,
        2, FT_MH_BATCH, [2 * (2 + seg_val), 0, 0, 0, 0],
        {(fwd16, HD16_SMALL): 2 * (2 + seg_val)},
        {"val_miou_head_1x", "val_miou_head_01x", "val_miou_best"}, card)
    shutil.rmtree(out)
    del r

    # (d) one fp32 step on the card against the CPU, LayerScale 0.5 (at
    # phase 3's 1e-5 the blocks barely reach the loss), IEEE fp32 GEMMs.
    art = load_exported_model(export)
    state_dict = {n: (torch.full_like(v, 0.5) if n.endswith("gamma") else v)
                  for n, v in art["state_dict"].items()}
    ls05 = work / "ft_ls05"
    export_model(ls05, art["model_name"], state_dict)
    data8 = {"train": write_class_folders(work / "ft_fp32", 4, 1)["train"]}
    d = card_against_cpu(A, F, "phase 3r (d)", lambda device: (
        finetune_fp32_step(lt, device, ls05, data8, work / f"ft_d_{device}")))
    shutil.rmtree(ls05)
    shutil.rmtree(work / "ft_fp32")
    on_card, on_cpu, errors = d["card"], d["cpu"], d["errors"]
    launches, by_shape, cpu_s = d["launches"], d["by_shape"], d["cpu_s"]
    fwd32 = A.fwd_library(torch.float32, HEAD_DIM)
    bwd32 = A.bwd_library(torch.float32, HEAD_DIM)
    want = {(fwd32, FT_FP32): DEPTH, (bwd32, FT_FP32): DEPTH}
    print(f"  (d) one fp32 step of (a)'s path on 8 images (SGD, LayerScale "
          f"0.5, highest), card against CPU: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errors.items())
          + f" (tol 1e-2); losses card {on_card['loss']:.6f}, CPU "
          f"{on_cpu['loss']:.6f}; the CPU's step {cpu_s:.1f} s; launches "
          f"{launches}, by shape {by_shape} [{card}]", flush=True)
    if not all(v <= 1e-2 for v in errors.values()):
        fail(f"phase 3r (d): card against CPU {errors}")
    if launches != [DEPTH, DEPTH, 0, 0, 0] or by_shape != want:
        fail(f"phase 3r (d): launches {launches}, by shape {by_shape}")
    results["d"] = {**errors, "by_shape": by_shape}
    for name in ("ft_cls", "ft_masks", "ft_seg_val"):
        shutil.rmtree(work / name)
    results["by_shape"] = {}
    for key in ("a", "b", "c_cls", "c_resume", "c_seg", "d"):
        for shape_key, c in results[key]["by_shape"].items():
            results["by_shape"][shape_key] = results["by_shape"].get(
                shape_key, 0) + c
    return results


def rle_string(mask) -> str:
    """pycocotools' compressed RLE counts of a bool (h, w) mask: the runs in
    column-major order from a background run, those after the first two as
    deltas, 5 bits a character from ASCII 48 with a continuation bit."""
    import numpy as np

    flat = mask.T.reshape(-1)
    edges = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    if flat[0]:
        counts = [0] + counts
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not c & 0x10) or (x == -1 and c & 0x10))
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def write_eomt_data(work: Path) -> dict:
    """Phase 3s's instance and panoptic data for phase 3's 2 BATCH images
    (train) and EOMT_VAL more (val, ``work / "eomt_val"``), 256^2, in
    EOMT_CLASSES categories: a COCO instance JSON of EOMT_SHAPES - 1 convex
    octagons and one RLE rectangle an image (later octagons painting over
    parts of earlier ones); a YOLO-seg folder of the same octagons (PNG
    copies of the images); RGB id-encoded panoptic PNGs of EOMT_SHAPES
    rectangles an image, the last a crowd segment, the rest void."""
    import numpy as np

    from lightly_train_tpu_torch._data.image_dataset import read_ppm

    write_images(work / "eomt_val", EOMT_VAL, 256, seed=SEED + 44)
    rng = np.random.default_rng(SEED + 50)
    size = 256
    data = {"coco": {}, "yolo": {"format": "yolo",
                                 "num_classes": EOMT_CLASSES},
            "panoptic": {}}
    for split, folder, n in (("train", work / "images", 2 * BATCH),
                             ("val", work / "eomt_val", EOMT_VAL)):
        yolo = work / "eomt_yolo" / split
        pan = work / "eomt_panoptic" / split
        for d in (yolo / "images", yolo / "labels", pan):
            d.mkdir(parents=True)
        images, anns, pan_anns = [], [], []
        for i in range(n):
            name = f"img_{i:03d}.ppm"
            images.append({"id": i, "file_name": name, "width": size,
                           "height": size})
            (yolo / "images" / f"img_{i:03d}.png").write_bytes(png_bytes(
                read_ppm(str(folder / name)), 2, 8))
            lines = []
            for k in range(EOMT_SHAPES - 1):
                cat = int(rng.integers(0, EOMT_CLASSES))
                c = rng.uniform(30, size - 30, 2)
                angles = np.sort(rng.uniform(0, 2 * np.pi, 8))
                r = rng.uniform(8, 30)
                pts = np.stack([c[0] + r * np.cos(angles),
                                c[1] + r * np.sin(angles)], 1)
                anns.append({"id": len(anns), "image_id": i,
                             "category_id": cat + 1, "iscrowd": 0,
                             "segmentation": [pts.reshape(-1).tolist()]})
                lines.append(f"{cat} " + " ".join(
                    f"{v / size:.5f}" for v in pts.reshape(-1)))
            box = np.zeros((size, size), bool)
            y, x = rng.integers(0, size - 60, 2)
            box[y:y + 50, x:x + 60] = True
            anns.append({"id": len(anns), "image_id": i, "category_id": 2,
                         "iscrowd": 0, "segmentation": {
                             "size": [size, size], "counts": rle_string(box)}})
            (yolo / "labels" / f"img_{i:03d}.txt").write_text(
                "\n".join(lines))
            ids = np.zeros((size, size), np.int64)
            segments = []
            for k in range(EOMT_SHAPES):
                sid = int(rng.integers(1, 2 ** 24))
                y, x = rng.integers(0, size - 20, 2)
                ids[y:y + int(rng.integers(15, 60)),
                    x:x + int(rng.integers(15, 60))] = sid
                segments.append({
                    "id": sid, "iscrowd": int(k == EOMT_SHAPES - 1),
                    "category_id": int(rng.integers(1, EOMT_CLASSES + 1))})
            rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1)
            (pan / f"img_{i:03d}.png").write_bytes(png_bytes(
                rgb.astype(np.uint8), 2, 8))
            pan_anns.append({"image_id": i, "file_name": f"img_{i:03d}.png",
                             "segments_info": segments})
        categories = [{"id": c, "name": str(c)}
                      for c in range(1, EOMT_CLASSES + 1)]
        (work / f"eomt_coco_{split}.json").write_text(json.dumps({
            "images": images, "annotations": anns,
            "categories": categories}))
        (work / f"eomt_panoptic_{split}.json").write_text(json.dumps({
            "images": images, "annotations": pan_anns,
            "categories": categories}))
        data["coco"][split] = {
            "images": str(folder),
            "annotations": str(work / f"eomt_coco_{split}.json")}
        data["yolo"][split] = {"images": str(yolo / "images"),
                               "labels": str(yolo / "labels")}
        data["panoptic"][split] = {
            "images": str(folder), "panoptic": str(pan),
            "annotations": str(work / f"eomt_panoptic_{split}.json")}
    return data


def eomt_fp32_step(lt, device: str, data: dict, out: Path) -> dict:
    """One fp32 EoMT semantic step at vittest14 (one joint block, batch 8,
    random transforms off, SGD with no warmup) on ``device``, every uniform
    drawn from one CPU generator seeded SEED and moved to the device (the
    same on the card and the CPU), the Hungarian matcher: ``fp32_step``'s
    loss and parameters, and each level's assignment."""
    import torch

    from lightly_train_tpu_torch.ops import point_sampling as PS
    from lightly_train_tpu_torch.tasks import eomt_semantic_segmentation as E

    assignments, match = [], E.hungarian_match
    gen = torch.Generator().manual_seed(SEED)

    def cpu_uniform(generator, shape, device_):
        return torch.rand(tuple(shape), generator=gen).to(device_)

    def recorded(cost, valid):
        a = match(cost, valid)
        assignments.append(a.cpu())
        return a

    r = fp32_step(
        lt, "train_semantic_segmentation", out,
        ((PS, "uniform", cpu_uniform), (E, "hungarian_match", recorded)),
        data={k: v for k, v in data.items() if k != "val"},
        model=EOMT_SMALL["model"], batch_size=8, precision="fp32",
        optim="sgd", learning_rate=0.1, transform_args=EOMT_NO_AUG,
        log_every=1, seed=SEED,
        task_args={"num_joint_blocks": 1, "lr_warmup_steps": [0, 0]},
        accelerator=device)
    return {**r, "assignments": assignments}


def run_eomt_path(lt, A, F, card: str, work: Path, export: Path) -> dict:
    """Phase 3s: EoMT's three entry points at ViT-B/14 width from
    ``export`` (phase 3's bf16 DINOv2 export), bf16, batch 16, at the
    default class and slot counts: (a) ``train_semantic_segmentation`` with
    ``-eomt`` on EOMT_SEG_CLASSES-class masks (32 active slots; val at
    FT_VAL_SIZE^2 in FT_TILES tiles), (b) ``train_instance_segmentation``
    on COCO JSON and on YOLO-seg labels, (c) ``train_panoptic_segmentation``
    (EOMT_SLOTS slots; val at 224^2), each run's launches counted from 0
    (K1/K2 by shape, K3 0, no SDPA or unmasked plain attention, EOMT_JOINT
    masked plain attentions a step and none in validation) and checked by
    ``check_finetune``; then a panoptic run at vittest14, and the same run
    stopped after its step-2 checkpoint and resumed (the restored state
    bitwise the checkpoint's, the losses the uninterrupted run's, and its
    launches); (d) one fp32 semantic
    step on the card against the port's CPU path."""
    import torch

    data = write_eomt_data(work)
    write_seg_masks(work / "eomt_masks", 2 * BATCH,
                    classes=EOMT_SEG_CLASSES, block=EOMT_SEG_BLOCK)
    write_seg_masks(work / "eomt_masks8", 2 * BATCH)
    seg_data = {"num_classes": EOMT_SEG_CLASSES,
                "train": {"images": str(work / "images"),
                          "masks": str(work / "eomt_masks")},
                "val": {"images": str(work / "eomt_val"),
                        "masks": str(work / "eomt_masks")}}
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    common = dict(model=EOMT_MODEL, checkpoint=str(export),
                  precision="bf16", log_every=1, seed=SEED)
    per_step = {(fwd, FT_SEG): EOMT_PLAIN, (bwd, FT_SEG): EOMT_PLAIN}
    results = {}

    def run(tag, key, entry, data_, steps, tiles, val_keys, slots,
            **kwargs):
        out = work / f"eomt_{key}"
        r = finetune_run(lt, A, F, entry, out, data=data_, steps=steps,
                         val_every=steps, **common, **kwargs)
        val_batch = {(fwd, FT_SEG): EOMT_PLAIN * tiles,
                     (fwd, EOMT_QUERIES_SHAPE): EOMT_JOINT * tiles}
        results[key] = check_finetune(
            tag, r, out, steps, FT_SEG[0],
            [EOMT_PLAIN * steps + (EOMT_PLAIN + EOMT_JOINT) * tiles,
             EOMT_PLAIN * steps, 0, 0, 0],
            {(fwd, FT_SEG): EOMT_PLAIN * (steps + tiles),
             (bwd, FT_SEG): EOMT_PLAIN * steps,
             (fwd, EOMT_QUERIES_SHAPE): EOMT_JOINT * tiles},
            val_keys, card, per_step=per_step, per_val_batch=val_batch,
            masked_per_step=EOMT_JOINT, phase_id="3s")
        meta = json.loads((out / "exported_models" / "exported_last" /
                           "metadata.json").read_text())
        args = meta["task_args"]
        if meta.get("architecture") != "eomt" or args[
                "num_joint_blocks"] != EOMT_JOINT or args.get(
                    "max_instances", args.get("max_active_slots")) != slots:
            fail(f"phase 3s {tag}: exported metadata {meta}")
        results[key]["slots"] = slots
        shutil.rmtree(out)

    run(f"(a) train_semantic_segmentation {EOMT_MODEL} bf16, batch 16, "
        f"{EOMT_SEG_CLASSES} classes (32 active slots), val {FT_VAL_SIZE}^2 "
        f"in {FT_TILES} tiles", "a", "train_semantic_segmentation", seg_data,
        EOMT_STEPS, FT_TILES, {"val_miou"}, 32, val_image_size=FT_VAL_SIZE)
    for fmt in ("coco", "yolo"):
        run(f"(b) train_instance_segmentation {EOMT_MODEL} bf16 on {fmt}, "
            f"{EOMT_SLOTS} slots", f"b_{fmt}", "train_instance_segmentation",
            data[fmt], EOMT_TASK_STEPS, 1, {"val_mask_map", "val_mask_map50"},
            EOMT_SLOTS)
    run(f"(c) train_panoptic_segmentation {EOMT_MODEL} bf16, {EOMT_SLOTS} "
        f"slots", "c", "train_panoptic_segmentation", data["panoptic"],
        EOMT_TASK_STEPS, 1, {"val_pq"}, EOMT_SLOTS)

    # (c) at vittest14 with one joint block: K1 and K2 once a step at
    # HD16_SMALL (its plain block), one masked plain attention a step, no
    # validation; then stopped after its step-2 checkpoint and resumed.
    train_only = {"train": data["panoptic"]["train"]}
    small = dict(EOMT_SMALL, data=train_only, steps=EOMT_STEPS, save_every=2,
                 precision="bf16", log_every=1, seed=SEED)
    counters = reset_counters(A, F)
    plain = PlainAttentionCount(A)
    try:
        lt.train_panoptic_segmentation(out=str(work / "eomt_straight"),
                                       **small)
    finally:
        plain.restore()
    fwd16 = A.fwd_library(torch.bfloat16, 16)
    bwd16 = A.bwd_library(torch.bfloat16, 16)
    want = {(fwd16, HD16_SMALL): EOMT_STEPS, (bwd16, HD16_SMALL): EOMT_STEPS}
    if [fn.launches for fn in counters] != [EOMT_STEPS, EOMT_STEPS, 0, 0, 0] \
            or launches_by_shape(A) != want or plain.calls or \
            plain.masked != EOMT_STEPS:
        fail(f"phase 3s (c) vittest14: launches "
             f"{[fn.launches for fn in counters]}, by shape "
             f"{launches_by_shape(A)}, plain attention {plain.calls} "
             f"unmasked and {plain.masked} masked")
    results["c_small"] = {"by_shape": launches_by_shape(A)}
    straight = [x for x in logged_steps(work / "eomt_straight")
                if "train_loss" in x]
    shutil.rmtree(work / "eomt_straight")
    resume = stop_and_resume(
        lt, A, F, "phase 3s (c) vittest14 panoptic",
        "train_panoptic_segmentation", work / "eomt_resumed", straight,
        EOMT_STEPS, card, **small)
    if resume["by_shape"] != want:
        fail(f"phase 3s (c): the stopped and resumed runs launched "
             f"{resume['by_shape']}, the uninterrupted one {want}")
    results["c_resume"] = resume

    # (d) one fp32 step on the card against the CPU (8-class masks), IEEE
    # fp32 GEMMs.
    seg8 = {"num_classes": FT_SEG_CLASSES,
            "train": {"images": str(work / "images"),
                      "masks": str(work / "eomt_masks8")}}
    d = card_against_cpu(A, F, "phase 3s (d)", lambda device: (
        eomt_fp32_step(lt, device, seg8, work / f"eomt_d_{device}")))
    on_card, on_cpu, errors = d["card"], d["cpu"], d["errors"]
    same_match = len(on_card["assignments"]) == len(on_cpu["assignments"]) \
        == 2 and all(torch.equal(a, b) for a, b in
                     zip(on_card["assignments"], on_cpu["assignments"]))
    fwd32 = A.fwd_library(torch.float32, 16)
    bwd32 = A.bwd_library(torch.float32, 16)
    want = {(fwd32, HD16_SMALL): 1, (bwd32, HD16_SMALL): 1}
    print(f"  (d) one fp32 EoMT step at vittest14 (SGD, highest, the same "
          f"uniforms, Hungarian), card against CPU: loss "
          f"{errors['loss']:.3e} (tol 1e-4), parameters "
          f"{errors['parameters']:.3e}, their change "
          f"{errors['parameter_change']:.3e} (tol 1e-2); assignments equal "
          f"{same_match}; losses card {on_card['loss']:.6f}, CPU "
          f"{on_cpu['loss']:.6f}; the CPU's step {d['cpu_s']:.1f} s; "
          f"launches {d['launches']}, by shape {d['by_shape']} [{card}]",
          flush=True)
    if not (errors["loss"] <= 1e-4 and errors["parameters"] <= 1e-2
            and errors["parameter_change"] <= 1e-2 and same_match):
        fail(f"phase 3s (d): card against CPU {errors}, assignments equal "
             f"{same_match}")
    if d["launches"] != [1, 1, 0, 0, 0] or d["by_shape"] != want:
        fail(f"phase 3s (d): launches {d['launches']}, by shape "
             f"{d['by_shape']}")
    results["d"] = {**errors, "by_shape": d["by_shape"]}
    for name in ("eomt_masks", "eomt_masks8", "eomt_val", "eomt_yolo",
                 "eomt_panoptic"):
        shutil.rmtree(work / name)
    results["by_shape"] = {}
    for key in ("a", "b_coco", "b_yolo", "c", "c_small", "c_resume", "d"):
        for shape_key, c in results[key]["by_shape"].items():
            results["by_shape"][shape_key] = results["by_shape"].get(
                shape_key, 0) + c
    return results


def write_det_data(work: Path) -> dict:
    """Phase 3t's data for phase 3's 2 BATCH images (train) and DET_VAL
    more (val, ``work / "det_val"``), 256^2: YOLO labels and a COCO JSON
    (with one crowd box an image) of DET_BOXES_MIN to DET_BOXES_MAX boxes
    in DET_CLASSES classes."""
    import numpy as np

    rng = np.random.default_rng(SEED + 60)
    write_images(work / "det_val", DET_VAL, 256, seed=SEED + 61)
    data = {"yolo": {"format": "yolo", "num_classes": DET_CLASSES},
            "coco": {"format": "coco"}}
    for split, folder in (("train", work / "images"),
                          ("val", work / "det_val")):
        labels = work / f"det_labels_{split}"
        labels.mkdir()
        images, anns = [], []
        for i, path in enumerate(sorted(folder.glob("*.ppm"))):
            n = int(rng.integers(DET_BOXES_MIN, DET_BOXES_MAX + 1))
            wh = rng.uniform(0.03, 0.4, (n, 2))
            c = rng.uniform(wh / 2, 1 - wh / 2)
            cls = rng.integers(0, DET_CLASSES, n)
            (labels / f"{path.stem}.txt").write_text("".join(
                f"{k} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n"
                for k, (x, y), (w, h) in zip(cls, c, wh)))
            images.append({"id": i + 1, "file_name": path.name,
                           "width": 256, "height": 256})
            for k, (x, y), (w, h) in zip(cls, c, wh):
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(k) + 1, "iscrowd": 0,
                             "bbox": [(x - w / 2) * 256, (y - h / 2) * 256,
                                      w * 256, h * 256]})
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "iscrowd": 1,
                         "bbox": [0.0, 0.0, 16.0, 16.0]})
        ann = work / f"det_{split}.json"
        ann.write_text(json.dumps({
            "images": images, "annotations": anns,
            "categories": [{"id": k + 1, "name": f"class{k}"}
                           for k in range(DET_CLASSES)]}))
        data["yolo"][split] = {"images": str(folder), "labels": str(labels)}
        data["coco"][split] = {"images": str(folder), "annotations": str(ann)}
    return data


def det_fp32_step(lt, device: str, data: dict, out: Path) -> dict:
    """One fp32 LT-DETR step at vittest14 (batch 8, flip off, SGD) on
    ``device``, its denoising draws from one CPU generator seeded SEED
    (the same on the card and the CPU), the Hungarian matcher:
    ``fp32_step``'s loss, parameters and gradients. The learning rate is 1,
    so the first step is the gradient clipped to norm 0.1: at 0.01 the
    change sits near the fp32 spacing of the parameters it is added to,
    and rounding the sum moves it by 2.4e-4 relative between two CPU runs
    whose gradients are 1.1e-5 apart (2.5e-5 at 1)."""
    import torch

    from lightly_train_tpu_torch.tasks.detection import ltdetr as L

    gen = torch.Generator().manual_seed(SEED)

    def dn_draws(self, generator, shape, device_):
        u = lambda s: torch.rand(s, generator=gen).to(device_)  # noqa: E731
        return (u(shape + (2,)), u(shape + (2,)), torch.randint(
            0, self.args.num_classes, shape, generator=gen).to(device_),
            u(shape))

    return fp32_step(
        lt, "train_object_detection", out,
        ((L.ObjectDetectionTrainModel, "dn_draws", dn_draws),),
        data={k: v for k, v in data.items() if k != "val"},
        model="dinov2/vittest14-ltdetr", batch_size=8, precision="fp32",
        optim="sgd", learning_rate=1.0, hflip_prob=0.0, log_every=1,
        seed=SEED, accelerator=device)


def held_change(d: dict) -> tuple:
    """``card_against_cpu``'s parameters' change held where the CPU's
    gradient is not 0 to rounding (below 1e-7 of its largest element, the
    rule of the CPU tests): a bias right before a train-mode BatchNorm or
    an attention key bias has an exact gradient of 0, and each device's
    value there is its own rounding. Returns (the change's relative error
    there, the elements left out, the four leaves furthest off, the
    gradient's relative error there, the CPU's change there)."""
    import torch

    grads = d["cpu"]["grads"]
    top = max(float(g.abs().max()) for g in grads.values())
    names = sorted(grads)
    kept = {n: grads[n].abs() >= 1e-7 * top for n in names}

    def change(run, n):
        return (run["after"][n] - run["before"][n])[kept[n]]

    ref = torch.cat([change(d["cpu"], n) for n in names])
    held = ((torch.cat([change(d["card"], n) for n in names]) - ref).norm()
            / ref.norm()).item()
    dropped = sum(int((~k).sum()) for k in kept.values())
    leaf_errors = {n: ((change(d["card"], n) - change(d["cpu"], n)).norm()
                       / change(d["cpu"], n).norm()).item()
                   for n in names if change(d["cpu"], n).norm()}
    worst = sorted(leaf_errors.items(), key=lambda kv: -kv[1])[:4]
    g_ref = torch.cat([grads[n][kept[n]] for n in names])
    g_err = ((torch.cat([d["card"]["grads"][n][kept[n]] for n in names])
              - g_ref).norm() / g_ref.norm()).item()
    return held, dropped, worst, g_err, ref


def run_detection_path(lt, A, F, card: str, work: Path,
                       export: Path) -> dict:
    """Phase 3t: (a) train_object_detection dinov2/vitb14-ltdetr from
    ``export`` at the JAX defaults on YOLO and COCO data, (b) ltdetrv2-s,
    (c) vittest14 with the RT-DETRv2 decoder and every window on, stopped
    and resumed, each run's launches counted from 0 and checked by
    ``check_finetune`` (K1/K2 by shape, K3 0, no SDPA or plain attention);
    the host's matcher and GO-union syncs a step; (d) one fp32 step on the
    card against the port's CPU path."""
    import torch

    from lightly_train_tpu_torch.tasks.detection import criterion as CR

    data = write_det_data(work)
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    results = {}

    def run(tag, key, data_, steps, shape, blocks, batch, **kwargs):
        out = work / f"det_{key}"
        syncs = dict(CR.HOST_SYNCS)
        r = finetune_run(lt, A, F, "train_object_detection", out,
                         data=data_, steps=steps, val_every=steps,
                         batch_size=batch, precision="bf16", log_every=1,
                         seed=SEED, **kwargs)
        n_val = len(r["val_ms"])
        lib_f = A.fwd_library(torch.bfloat16, shape[3])
        lib_b = A.bwd_library(torch.bfloat16, shape[3])
        results[key] = check_finetune(
            tag, r, out, steps, batch,
            [blocks * (steps + n_val), blocks * steps, 0, 0, 0],
            {(lib_f, shape): blocks * (steps + n_val),
             (lib_b, shape): blocks * steps},
            {"val_map", "val_map50"}, card,
            per_step={(lib_f, shape): blocks, (lib_b, shape): blocks},
            per_val_batch={(lib_f, shape): blocks}, phase_id="3t")
        syncs = {k: (CR.HOST_SYNCS[k] - syncs[k]) / steps for k in syncs}
        meta = json.loads((out / "exported_models" / "exported_last" /
                           "metadata.json").read_text())
        print(f"  {tag}: host syncs a step {syncs}; step ms from step 2 on "
              f"{[round(ms, 1) for ms in results[key]['step_ms'][1:]]}",
              flush=True)
        if meta.get("architecture") != "ltdetr":
            fail(f"phase 3t {tag}: exported metadata {meta}")
        results[key]["host_syncs_per_step"] = syncs
        shutil.rmtree(out)

    for fmt in ("yolo", "coco"):
        run(f"(a) train_object_detection {DET_MODEL} bf16 on {fmt}, batch "
            f"16, D-FINE, 300 queries, dn_groups 2, EMA", f"a_{fmt}",
            data[fmt], DET_STEPS, FT_SEG, DEPTH, 16, model=DET_MODEL,
            checkpoint=str(export))
    run("(b) train_object_detection ltdetrv2-s (ECViT-T, random init) bf16 "
        "on yolo, batch 16", "b", data["yolo"], 3, DET_ECVIT, 12, 16,
        model="ltdetrv2-s")

    # (c) vittest14 with every window on and rotate-90, no validation;
    # then stopped after its step-2 checkpoint and resumed.
    train_only = {k: v for k, v in data["yolo"].items() if k != "val"}
    small = dict(model="dinov2/vittest14-ltdetr", batch_size=8,
                 data=train_only, steps=DET_STEPS, save_every=2,
                 precision="bf16", log_every=1, seed=SEED,
                 task_args=DET_WINDOWS)
    counters = reset_counters(A, F)
    lt.train_object_detection(out=str(work / "det_straight"), **small)
    fwd16 = A.fwd_library(torch.bfloat16, 16)
    bwd16 = A.bwd_library(torch.bfloat16, 16)
    want = {(fwd16, HD16_SMALL): 2 * DET_STEPS,
            (bwd16, HD16_SMALL): 2 * DET_STEPS}
    if [fn.launches for fn in counters] != [2 * DET_STEPS] * 2 + [0] * 3 \
            or launches_by_shape(A) != want:
        fail(f"phase 3t (c) vittest14: launches "
             f"{[fn.launches for fn in counters]}, by shape "
             f"{launches_by_shape(A)}")
    results["c"] = {"by_shape": launches_by_shape(A)}
    straight = [x for x in logged_steps(work / "det_straight")
                if "train_loss" in x]
    print(f"  (c) vittest14-ltdetr bf16, RT-DETRv2, every window on, "
          f"rotate90_prob 0.5, batch 8: losses "
          f"{[round(x['train_loss'], 4) for x in straight]} [{card}]",
          flush=True)
    shutil.rmtree(work / "det_straight")
    # The step repeats bitwise on the card: the adapter resizes by products
    # and its stem convolves by unfold and product, whose backwards add in
    # a fixed order.
    resume = stop_and_resume(
        lt, A, F, "phase 3t (c)", "train_object_detection",
        work / "det_resumed", straight, DET_STEPS, card, **small)
    if resume["by_shape"] != want or resume["launches"] != [
            2 * DET_STEPS] * 2 + [0] * 3:
        fail(f"phase 3t (c): the stopped and resumed runs launched "
             f"{resume['launches']}, by shape {resume['by_shape']}, the "
             f"uninterrupted one {want}")
    results["c_resume"] = resume

    # (d) one fp32 step on the card against the CPU, IEEE fp32 GEMMs.
    d = card_against_cpu(A, F, "phase 3t (d)", lambda device: (
        det_fp32_step(lt, device, data["yolo"], work / f"det_d_{device}")))
    errors = d["errors"]
    fwd32 = A.fwd_library(torch.float32, 16)
    bwd32 = A.bwd_library(torch.float32, 16)
    want = {(fwd32, HD16_SMALL): 2, (bwd32, HD16_SMALL): 2}
    held, dropped, worst, g_err, ref = held_change(d)
    print(f"  (d) one fp32 LT-DETR step at vittest14 (SGD at lr 1, highest, "
          f"the same denoising draws, Hungarian), card against CPU: loss "
          f"{errors['loss']:.3e} (tol 1e-5), parameters "
          f"{errors['parameters']:.3e}, their change {held:.3e} (tol 1e-3; "
          f"{dropped} of {ref.numel() + dropped} elements left out, whose "
          f"CPU gradient is 0 to rounding; the gradient there {g_err:.3e}; "
          f"every element "
          f"{errors['parameter_change']:.3e}; the leaves furthest off "
          f"{[(n, f'{e:.2e}') for n, e in worst]}); losses card "
          f"{d['card']['loss']:.6f}, CPU {d['cpu']['loss']:.6f}; the CPU's "
          f"step {d['cpu_s']:.1f} s; launches {d['launches']}, by shape "
          f"{d['by_shape']} [{card}]", flush=True)
    if not (errors["loss"] <= 1e-5 and held <= 1e-3):
        fail(f"phase 3t (d): card against CPU {errors}, the change where the "
             f"gradient is not 0 to rounding {held:.3e}, tolerance 1e-3")
    if d["launches"] != [2, 2, 0, 0, 0] or d["by_shape"] != want:
        fail(f"phase 3t (d): launches {d['launches']}, by shape "
             f"{d['by_shape']}")
    results["d"] = {**errors, "held_change": held, "gradient": g_err,
                    "left_out": dropped,
                    "by_shape": d["by_shape"]}
    for name in ("det_val", "det_labels_train", "det_labels_val"):
        shutil.rmtree(work / name)
    results["by_shape"] = {}
    for key in ("a_yolo", "a_coco", "b", "c", "c_resume", "d"):
        for shape_key, c in results[key]["by_shape"].items():
            results["by_shape"][shape_key] = results["by_shape"].get(
                shape_key, 0) + c
    return results


def seg_fp32_step(lt, device: str, data: dict, out: Path) -> dict:
    """One fp32 LT-DETR segmentation step at vittest14 (the EdgeCrafter
    head, batch 8, flip off, SGD at lr 1, as 3t (d)) on ``device``, every
    point draw from one CPU generator seeded SEED (the same on the card
    and the CPU), the Hungarian matcher: ``fp32_step``'s loss, parameters
    and gradients."""
    import torch

    from lightly_train_tpu_torch.ops import point_sampling as PS

    gen = torch.Generator().manual_seed(SEED)

    def cpu_uniform(generator, shape, device_):
        return torch.rand(tuple(shape), generator=gen).to(device_)

    return fp32_step(
        lt, "train_instance_segmentation", out,
        ((PS, "uniform", cpu_uniform),), data={"train": data["train"]},
        model="dinov2/vittest14-ltdetr", batch_size=8, precision="fp32",
        optim="sgd", learning_rate=1.0, hflip_prob=0.0, log_every=1,
        seed=SEED, accelerator=device)


def pico_fp32_step(lt, device: str, data: dict, out: Path,
                   running_stats: bool) -> dict:
    """One fp32 ``picodet-s`` step at PICO_TEST_SIZE^2 (batch 8, flip off,
    SGD at lr 1) on ``device``: ``fp32_step``'s loss, parameters and
    gradients; with ``running_stats`` its BatchNorms normalize by their
    running statistics (the train-mode forward is ill-conditioned: the JAX
    package's own moves by up to 1.4e-3 when only the batch order
    changes, ``tests/test_torch_picodet.py``)."""
    from lightly_train_tpu_torch.tasks.detection import picodet as P

    forward = P.PicoDetTrainModel._forward
    patches = ((P.PicoDetTrainModel, "_forward",
                lambda self, model, images, train: forward(
                    self, model, images, False)),) if running_stats else ()
    return fp32_step(
        lt, "train_object_detection", out, patches,
        data={k: v for k, v in data.items() if k != "val"},
        model="picodet-s", image_size=PICO_TEST_SIZE, batch_size=8,
        precision="fp32", learning_rate=1.0, hflip_prob=0.0, log_every=1,
        seed=SEED, accelerator=device)


def pico_stem_cost(model_size: str, hw: int) -> dict:
    """ms of one PicoDet loss and backward (batch 16, ``hw``^2, train
    mode, 40 boxes an image) with the stem by unfold (the path's, which
    repeats bitwise) and by cuDNN (whose weight gradient of this strided
    convolution does not), alternated twice; and whether the unfold
    stem's gradients repeat bitwise."""
    import torch

    from lightly_train_tpu_torch.models.conv import Conv
    from lightly_train_tpu_torch.tasks.detection import picodet as P

    device = torch.device("cuda")
    m = P.PicoDetTrainModel(None, P.PicoDetArgs(model_size=model_size))
    module = m.init(torch.Generator().manual_seed(SEED), device)
    g = torch.Generator().manual_seed(SEED)
    wh = torch.rand(16, 40, 2, generator=g) * 0.3 + 0.03
    c = torch.rand(16, 40, 2, generator=g) * (1 - wh) + wh / 2
    batch = {"images": torch.randn(16, hw, hw, 3, generator=g).to(device),
             "boxes": torch.cat([c, wh], -1).to(device),
             "labels": torch.randint(0, 80, (16, 40), generator=g).to(device),
             "box_valid": torch.ones(16, 40, dtype=torch.bool).to(device)}
    state = {k: v.clone() for k, v in module.state_dict().items()}

    def step():
        for p in module.parameters():
            p.grad = None
        m.loss_fn(module, batch, None, 0)[0].backward()

    def grads():
        module.load_state_dict(state)
        step()
        return [p.grad.clone() for p in module.parameters()]

    repeat = all(torch.equal(a, b) for a, b in zip(grads(), grads()))
    stem = module.backbone.backbone.conv1
    unfold = stem.conv
    cudnn = Conv(3, unfold.weight.shape[0], 3, 2, ((1, 1), (1, 1)),
                 bias=False).to(device)
    cudnn.weight = unfold.weight
    out = {"unfold_ms": [], "cudnn_ms": [], "bitwise": repeat}
    for _ in range(2):
        for key, conv in (("unfold_ms", unfold), ("cudnn_ms", cudnn)):
            stem.conv = conv
            out[key].append(time_ms(step, iters=10))
    stem.conv = unfold
    return out


def ec_head_repeats() -> bool:
    """Whether the EdgeCrafter head's gradients at ViT-B/14's shapes (P3
    (16, 28, 28, 256) to 56^2, 300 queries, 3 layers, seeded weights)
    repeat bitwise on the card."""
    import torch

    from lightly_train_tpu_torch.tasks.detection import ltdetr_seg as S
    from lightly_train_tpu_torch.tasks.detection.components import (
        reset_detr_parameters,
    )

    device = torch.device("cuda")
    head = S.ECSegMaskHead(256, 3)
    reset_detr_parameters(head, torch.Generator().manual_seed(SEED))
    head = head.to(device)
    g = torch.Generator().manual_seed(SEED)
    spatial = torch.randn(16, 28, 28, 256, generator=g).to(device)
    queries = [torch.randn(16, 300, 256, generator=g).to(device)
               for _ in range(3)]

    def grads():
        for p in head.parameters():
            p.grad = None
        head(spatial, queries, (224, 224), all_levels=False)[-1].square(
            ).mean().backward()
        return [p.grad.clone() for p in head.parameters()]

    return all(torch.equal(a, b) for a, b in zip(grads(), grads()))


def run_seg_picodet_path(lt, A, F, card: str, work: Path,
                         export: Path) -> dict:
    """Phase 3u: (a) train_instance_segmentation dinov2/vitb14-ltdetr from
    ``export`` at the JAX defaults on phase 3s's COCO instance JSON, (b)
    ecvit/ecvitt-ltdetr, (c) picodet-s and picodet-l on phase 3t's YOLO
    boxes, each run's launches counted from 0 and checked by
    ``check_finetune`` (K1/K2 by shape, none for PicoDet, K3 0, no SDPA
    or plain attention), the host's matcher syncs a step; (d) a
    vittest14-ltdetr segmentation run with the linear head and a PicoDet
    run at its test preset, each stopped and resumed, bitwise; (e) one
    fp32 step of each new model on the card against the port's CPU
    path."""
    import torch

    from lightly_train_tpu_torch.tasks.detection import criterion as CR

    seg = write_eomt_data(work)["coco"]
    det = write_det_data(work)["yolo"]
    fwd = A.fwd_library(torch.bfloat16, HEAD_DIM)
    bwd = A.bwd_library(torch.bfloat16, HEAD_DIM)
    results = {}

    def run(tag, key, entry, data_, steps, shape, blocks, val_keys,
            architecture, **kwargs):
        out = work / f"u_{key}"
        syncs = dict(CR.HOST_SYNCS)
        r = finetune_run(lt, A, F, entry, out, data=data_, steps=steps,
                         val_every=steps, batch_size=16, log_every=1,
                         seed=SEED, **kwargs)
        n_val = len(r["val_ms"])
        if shape is None:
            launches, by_shape, per_step, per_val = [0] * 5, {}, {}, {}
        else:
            lib_f = A.fwd_library(torch.bfloat16, shape[3])
            lib_b = A.bwd_library(torch.bfloat16, shape[3])
            launches = [blocks * (steps + n_val), blocks * steps, 0, 0, 0]
            by_shape = {(lib_f, shape): blocks * (steps + n_val),
                        (lib_b, shape): blocks * steps}
            per_step = {(lib_f, shape): blocks, (lib_b, shape): blocks}
            per_val = {(lib_f, shape): blocks}
        results[key] = check_finetune(
            tag, r, out, steps, 16, launches, by_shape, val_keys, card,
            per_step=per_step, per_val_batch=per_val, phase_id="3u")
        syncs = {k: (CR.HOST_SYNCS[k] - syncs[k]) / steps for k in syncs}
        meta = json.loads((out / "exported_models" / "exported_last" /
                           "metadata.json").read_text())
        print(f"  {tag}: host syncs a step {syncs}; step ms from step 2 on "
              f"{[round(ms, 1) for ms in results[key]['step_ms'][1:]]}",
              flush=True)
        if meta.get("architecture") != architecture:
            fail(f"phase 3u {tag}: exported metadata {meta}")
        results[key]["host_syncs_per_step"] = syncs
        shutil.rmtree(out)

    mask_keys = {"val_mask_map", "val_mask_map50"}
    run(f"(a) train_instance_segmentation {SEG_MODEL} bf16 on COCO, batch "
        f"16, D-FINE, 300 queries, the EdgeCrafter head, {EOMT_SLOTS} slots,"
        f" EMA", "a", "train_instance_segmentation", seg, SEG_STEPS, FT_SEG,
        DEPTH, mask_keys, "ltdetr", model=SEG_MODEL, checkpoint=str(export),
        precision="bf16")
    repeats = ec_head_repeats()
    print(f"  (a) the EdgeCrafter head's gradients at ViT-B/14's shapes "
          f"repeat bitwise on the card: {repeats} [{card}]", flush=True)
    results["a"]["ec_head_bitwise"] = repeats
    run(f"(b) train_instance_segmentation {SEG_ECVIT} (ECViT-T, random "
        f"init) bf16 on COCO, batch 16", "b", "train_instance_segmentation",
        seg, SEG_STEPS, DET_ECVIT, 12, mask_keys, "ltdetr", model=SEG_ECVIT,
        precision="bf16")
    for model, hw in PICO_RUNS.items():
        key = f"c_{model}"
        run(f"(c) train_object_detection {model} at {hw}^2 (fp32 in every "
            f"precision), batch 16, SGD, EMA", key, "train_object_detection",
            det, PICO_STEPS, None, 0, {"val_map", "val_map50"}, "picodet",
            model=model, image_size=hw, precision="bf16")
        cost = pico_stem_cost(model[-1], hw)
        print(f"  (c) {model} at {hw}^2, batch 16: a loss and backward with "
              f"the stem by unfold {[round(ms, 2) for ms in cost['unfold_ms']]}"
              f" ms, by cuDNN {[round(ms, 2) for ms in cost['cudnn_ms']]} "
              f"ms; the unfold stem's gradients repeat bitwise: "
              f"{cost['bitwise']} [{card}]", flush=True)
        if not cost["bitwise"]:
            fail(f"phase 3u (c) {model}: the gradients do not repeat")
        results[key]["stem"] = cost

    # (d) stopped after the step-2 checkpoint and resumed, bitwise.
    fwd16 = A.fwd_library(torch.bfloat16, 16)
    bwd16 = A.bwd_library(torch.bfloat16, 16)
    small_runs = {
        "d_seg": ("train_instance_segmentation", dict(
            model="dinov2/vittest14-ltdetr", data={"train": seg["train"]},
            task_args={"mask_head_arch": "linear"}),
            {(fwd16, HD16_SMALL): 2 * DET_STEPS,
             (bwd16, HD16_SMALL): 2 * DET_STEPS}),
        "d_picodet": ("train_object_detection", dict(
            model="picodet-s",
            data={k: v for k, v in det.items() if k != "val"},
            task_args={"model_size": "test"}, image_size=PICO_TEST_SIZE),
            {}),
    }
    for key, (entry, args, want) in small_runs.items():
        small = dict(args, batch_size=8, steps=DET_STEPS, save_every=2,
                     precision="bf16", log_every=1, seed=SEED)
        counters = reset_counters(A, F)
        getattr(lt, entry)(out=str(work / "u_straight"), **small)
        n = sum(want.values()) // 2
        if [fn.launches for fn in counters] != [n, n, 0, 0, 0] or \
                launches_by_shape(A) != want:
            fail(f"phase 3u {key}: launches "
                 f"{[fn.launches for fn in counters]}, by shape "
                 f"{launches_by_shape(A)}")
        straight = [x for x in logged_steps(work / "u_straight")
                    if "train_loss" in x]
        print(f"  {key} {args['model']} {args['task_args']} bf16, batch 8: "
              f"losses {[round(x['train_loss'], 4) for x in straight]} "
              f"[{card}]", flush=True)
        shutil.rmtree(work / "u_straight")
        resume = stop_and_resume(lt, A, F, f"phase 3u {key}", entry,
                                 work / "u_resumed", straight, DET_STEPS,
                                 card, **small)
        if resume["by_shape"] != want or resume["launches"] != [
                n, n, 0, 0, 0]:
            fail(f"phase 3u {key}: the stopped and resumed runs launched "
                 f"{resume['launches']}, by shape {resume['by_shape']}, the "
                 f"uninterrupted one {want}")
        results[key] = {**resume, "by_shape": want}

    # (e) one fp32 step of each new model on the card against the CPU,
    # IEEE fp32 GEMMs, held as 3t (d).
    fwd32 = A.fwd_library(torch.float32, 16)
    bwd32 = A.bwd_library(torch.float32, 16)
    # The segmentation loss is held to 1e-4, as 3s (d) holds EoMT's: the
    # uncertainty top-k of the point sampling ranks candidates whose
    # logits the two devices round apart (1.19e-5 in a trial run). None:
    # printed, not held.
    steps_e = {
        "e_seg": ("vittest14-ltdetr segmentation, the EdgeCrafter head, the "
                  "same point draws, Hungarian", lambda device: seg_fp32_step(
                      lt, device, seg, work / f"u_e_{device}"),
                  {(fwd32, HD16_SMALL): 2, (bwd32, HD16_SMALL): 2}, 1e-4),
        "e_picodet": (f"picodet-s at {PICO_TEST_SIZE}^2, the BatchNorms on "
                      "their running statistics",
                      lambda device: pico_fp32_step(
                          lt, device, det, work / f"u_e_{device}", True),
                      {}, 1e-5),
        "e_picodet_train": (f"picodet-s at {PICO_TEST_SIZE}^2, train-mode "
                            "BatchNorms (printed, not held)",
                            lambda device: pico_fp32_step(
                                lt, device, det, work / f"u_e_{device}",
                                False), {}, None),
    }
    for key, (what, step, want, loss_tol) in steps_e.items():
        d = card_against_cpu(A, F, f"phase 3u {key}", step)
        errors = d["errors"]
        held, dropped, worst, g_err, ref = held_change(d)
        n = sum(want.values()) // 2
        print(f"  ({key}) one fp32 step of {what} (SGD at lr 1, highest), "
              f"card against CPU: loss {errors['loss']:.3e} (tol "
              f"{loss_tol}), parameters {errors['parameters']:.3e}, their "
              f"change {held:.3e} (tol {loss_tol and 1e-3}; {dropped} of "
              f"{ref.numel() + dropped} "
              f"elements left out, whose CPU gradient is 0 to rounding; the "
              f"gradient there {g_err:.3e}; every element "
              f"{errors['parameter_change']:.3e}; the leaves furthest off "
              f"{[(n_, f'{e:.2e}') for n_, e in worst]}); losses card "
              f"{d['card']['loss']:.6f}, CPU {d['cpu']['loss']:.6f}; the "
              f"CPU's step {d['cpu_s']:.1f} s; launches {d['launches']}, by "
              f"shape {d['by_shape']} [{card}]", flush=True)
        if loss_tol is not None and not (errors["loss"] <= loss_tol
                                         and held <= 1e-3):
            fail(f"phase 3u ({key}): card against CPU {errors}, the change "
                 f"where the gradient is not 0 to rounding {held:.3e}, "
                 f"tolerance 1e-3")
        if d["launches"] != [n, n, 0, 0, 0] or d["by_shape"] != want:
            fail(f"phase 3u ({key}): launches {d['launches']}, by shape "
                 f"{d['by_shape']}")
        results[key] = {**errors, "held_change": held, "gradient": g_err,
                        "left_out": dropped, "by_shape": d["by_shape"]}
    for name in ("eomt_val", "eomt_yolo", "eomt_panoptic", "det_val",
                 "det_labels_train", "det_labels_val"):
        shutil.rmtree(work / name)
    results["by_shape"] = {}
    for key, r in results.items():
        if key == "by_shape":
            continue
        for shape_key, c in r["by_shape"].items():
            results["by_shape"][shape_key] = results["by_shape"].get(
                shape_key, 0) + c
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import lightly_train_tpu_torch as lt
    except ImportError as err:
        print(f"chip_smoke: the port is not here: {err}", file=sys.stderr)
        return 1
    if Path(lt.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    from lightly_train_tpu_torch import _native
    from lightly_train_tpu_torch._optim import fused_update as F
    from lightly_train_tpu_torch.ops.kernels import attention as A

    if not A.use_vmem_attention():
        fail("LIGHTLY_TRAIN_VMEM_ATTENTION disables the attention kernels; "
             "this check runs them")
    # The plain versions' fp32 products in full fp32, not TF32.
    pin_ieee()

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _native.build()
    print(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    _native.build_host("image_decode")
    print(f"  csrc/image_decode.c (the image decoder) built with "
          f"{_native.host_compiler()} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in _native.LIBRARIES:
        log = (_native.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "Compiling entry")):
                print(f"  {name}: {line.strip()}")
        if name in SM90_LIBRARIES and any(w in log for w in SERIALIZED):
            fail(f"ptxas serialized the wgmma products of {name}")
    for name in _native.LIBRARIES:
        sass = _native.sass(name)
        required = SM90_LIBRARIES.get(name, ())
        print(f"  {name}: {sass.count('HGMMA')} HGMMA, "
              f"{sass.count('LDGSTS')} LDGSTS (cp.async), "
              f"{sass.count('UTMALDG')} UTMALDG (TMA loads) and "
              f"{sass.count(WARP_MMA)} {WARP_MMA} (mma.sync) instructions in "
              f"its SASS (required: {', '.join(required) or 'none'}; "
              f"{WARP_MMA} none)", flush=True)
        missing = [op for op in required if op not in sass]
        if missing:
            fail(f"{name}'s SASS lacks {missing}")
        if WARP_MMA in sass:
            fail(f"{name}'s SASS holds {WARP_MMA} (mma.sync)")

    if "--7b-lars" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            write_images(Path(tmp) / "images", 2 * BATCH, 256)
            phase("the 7B/16 student with LARS at momentum 0.9", flush=True)
            run_7b_lars(lt, A, F, card, Path(tmp))
            end_phase()
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    only = {"--only-3t": ("phase 3t: LT-DETR detection", run_detection_path),
            "--only-3u": ("phase 3u: LT-DETR instance segmentation and "
                          "PicoDet", run_seg_picodet_path)}
    for flag, (title, path) in only.items():
        if flag not in sys.argv[1:]:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            write_images(Path(tmp) / "images", 2 * BATCH, 256)
            phase("phase 3: main path (pretrain DINOv2 ViT-B/14, bf16)",
                  flush=True)
            main_run = run_main_path(lt, A, F, card, "bf16", Path(tmp))
            pin_ieee()
            phase(title, flush=True)
            ran = path(lt, A, F, card, Path(tmp), main_run["out"]
                       / "exported_models" / "exported_last")
            end_phase()
        covered = {(route(torch_dtype(dtype), shape[3]), tuple(shape))
                   for kernels, dtype, shape, _ in ATTENTION_CASES
                   if kernels == "flat"
                   for route in (A.fwd_library, A.bwd_library)}
        if set(ran["by_shape"]) - covered:
            fail(f"{title} launched at shapes phase 2 does not hold: "
                 f"{sorted(set(ran['by_shape']) - covered)}")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    phase("phase 2: kernels against their plain versions", flush=True)
    attn = check_attention(A, card)
    upd = check_fused_update(F, card)

    work_dir = tempfile.TemporaryDirectory()
    work = Path(work_dir.name)
    write_images(work / "images", 2 * BATCH, 256)
    paths = {}
    for label, precision in zip(("3", "3b"), DTYPES):
        phase(f"phase {label}: main path (pretrain DINOv2 ViT-B/14, batch "
              f"{BATCH}, {precision})", flush=True)
        paths[precision] = run_main_path(lt, A, F, card, precision, work)
        r = paths[precision]
        print(f"main path {precision}: step ms {r['step_ms']}, img/s "
              f"{r['images_per_sec']}, peak {r['peak_gib']:.2f} GiB [{card}]")
    shutil.rmtree(paths["fp32"]["out"])
    pin_ieee()
    phase("phase 3c: the K4/K5 path (vmem_attention, ViT-B/14 global shape)",
          flush=True)
    vmem = {dtype: run_vmem_path(A, card, dtype) for dtype in DTYPES}
    phase("phase 3d: resume, augmentation grid and embed", flush=True)
    bf16_out = paths["bf16"]["out"]
    check_grid(bf16_out, 2 * BATCH)
    shutil.rmtree(bf16_out / "checkpoints")  # only its metrics serve now
    run_resume_path(
        lt, A, F, card, work, paths["bf16"],
        lambda out, **kw: pretrain_main_path(lt, out, work / "images",
                                             "bf16", **kw),
        STEPS, ("train_loss", "dino_loss", "ibot_loss", "koleo_loss"),
        [36 * STEPS, 24 * STEPS, STEPS, 0, 0],
        {"fwd": {**dict.fromkeys(A.fwd_launches, 0),
                 A.fwd_library(torch.bfloat16, HEAD_DIM): 36 * STEPS},
         "bwd": {**dict.fromkeys(A.bwd_launches, 0),
                 A.bwd_library(torch.bfloat16, HEAD_DIM): 24 * STEPS}},
        "dinov2")
    embed_k1 = run_embed_path(
        lt, A, F, card, work, bf16_out / "exported_models" / "exported_last")
    vittest = {}
    for precision in DTYPES:
        phase(f"phase 3e: pretrain DINOv2 vittest14 (hd 16), batch {BATCH}, "
              f"{VITTEST_STEPS} steps, {precision}", flush=True)
        vittest[precision] = run_vittest_path(lt, A, F, card, precision,
                                              work)
    distill = {}
    for precision in DTYPES:
        phase(f"phase 3f: pretrain at its defaults (distillation, ViT-B/14 "
              f"from DINOv3 ViT-B/16, LARS), batch {DISTILL_BATCH}, "
              f"{DISTILL_STEPS[precision]} steps, {precision}", flush=True)
        distill[precision] = run_distillation_path(lt, A, F, card, precision,
                                                   work)
    shutil.rmtree(distill["fp32"]["out"])
    teacher = work / "teacher"
    write_teacher(teacher)
    phase(f"phase 3f: the same with teacher_weights (an exported DINOv3 "
          f"ViT-B/16, LayerScale 0.5), bf16", flush=True)
    distill["bf16_teacher"] = run_distillation_path(lt, A, F, card, "bf16",
                                                    work, teacher)
    steps = DISTILL_STEPS["bf16"]
    expected, by_library, _ = distill_expected(A, "bf16", steps)
    for key, args in (("bf16", {}), ("bf16_teacher", {
            "method_args": {"teacher_weights": str(teacher)}})):
        phase(f"phase 3f: resume of the {key} distillation run", flush=True)
        run_resume_path(
            lt, A, F, card, work, distill[key],
            lambda out, args=args, **kw: distill_pretrain(
                lt, out, work / "images", "bf16", steps, **args, **kw),
            steps, DISTILL_KEYS[:3], expected, by_library,
            f"distillation_{key}")
    phase(f"phase 3g: pretrain DINOv2 ViT-B/14 bf16, batch {BATCH}, "
          f"{REMAT_STEPS} steps, model_args {REMAT}, Sinkhorn centering",
          flush=True)
    remat = run_remat_path(lt, A, F, card, work, paths["bf16"])
    phase("phase 3g: one fixed batch, two steps, with and without remat",
          flush=True)
    remat_step_comparison(A, F, card)
    phase(f"phase 3h: LIGHTLY_TRAIN_MATMUL_PRECISION, fp32 DINOv2 and "
          f"distillation, {PRECISION_STEPS} steps each", flush=True)
    run_precision_path(lt, A, F, card, work)
    phase(f"phase 3i: the NaN capture and its replay (vittest14 bf16, "
          f"{NAN_LEAF} set to NaN after state step {NAN_STEP})", flush=True)
    run_nan_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3m: pretrain and embed from JPEG and PNG files with .pth "
          f"warm starts (DINOv2 ViT-B/14 bf16, {FILES_STEPS} steps; "
          f"distillation from a DINOv3 ViT-B/16 .pth teacher, "
          f"{FILES_DISTILL_STEPS} steps)", flush=True)
    run_files_path(lt, A, F, card, work, paths["bf16"])
    pin_ieee()
    phase(f"phase 3n: pretrain with the other methods (DINO, SimCLR, "
          f"DenseCL, DetCon-B/S, DINOv31; DetCon-B with mask_dir), "
          f"ViT-B/14 bf16, {METHODS_STEPS} steps each, and one fp32 step "
          f"of each against the plain attention", flush=True)
    run_methods_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3o: CNN students and adamw8bit (ResNet-50 by "
          f"distillation and by DINO, ConvNeXt-tiny, RT-DETR R50vd, ViT-B/14 "
          f"with adamw8bit, embed, the 7B/16 student with adamw8bit), bf16, "
          f"{CNN_STEPS} steps each", flush=True)
    cnn = run_cnn_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3p: ECViT-S+ at pretrain's defaults, DINO on ECViT-S, "
          f"YOLOv8x, YOLOv5x and YOLO11x by distillation, DINO on "
          f"YOLO-NAS-L, a user's torch module, embed, ECViT-S+ fp32 against "
          f"the CPU; bf16, {ITEM10_STEPS} steps each", flush=True)
    item10 = run_item10_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3q: the run surface and item 11 (pretrain DINOv2 "
          f"ViT-B/14 bf16 with embed_dim, profile and the logger backends; "
          f"export; evaluate_knn fp32 and bf16; the CLI)", flush=True)
    surface = run_surface_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3r: fine-tuning at ViT-B/14 width from phase 3's export "
          f"(train_image_classification, batch 128, and linear "
          f"train_semantic_segmentation, batch 16, val {FT_VAL_SIZE}^2 "
          f"tiled; bf16, {FT_STEPS} steps each), the multihead entry points "
          f"at vittest14, a resume, one fp32 step against the CPU",
          flush=True)
    finetune = run_finetune_path(
        lt, A, F, card, work,
        paths["bf16"]["out"] / "exported_models" / "exported_last")
    pin_ieee()
    phase(f"phase 3s: EoMT at ViT-B/14 width from phase 3's export "
          f"(train_semantic_segmentation -eomt, {EOMT_SEG_CLASSES} classes, "
          f"{EOMT_STEPS} steps, val {FT_VAL_SIZE}^2 tiled; "
          f"train_instance_segmentation on COCO and YOLO-seg and "
          f"train_panoptic_segmentation, {EOMT_SLOTS} slots, "
          f"{EOMT_TASK_STEPS} steps; bf16, batch 16), a panoptic resume at "
          f"vittest14, one fp32 step against the CPU", flush=True)
    eomt = run_eomt_path(
        lt, A, F, card, work,
        paths["bf16"]["out"] / "exported_models" / "exported_last")
    pin_ieee()
    phase(f"phase 3t: LT-DETR detection from phase 3's export "
          f"(train_object_detection {DET_MODEL} on YOLO and COCO, "
          f"{DET_STEPS} steps; ltdetrv2-s; bf16, batch 16), vittest14 with "
          f"every window on and a resume, one fp32 step against the CPU",
          flush=True)
    detection = run_detection_path(
        lt, A, F, card, work,
        paths["bf16"]["out"] / "exported_models" / "exported_last")
    pin_ieee()
    phase(f"phase 3u: LT-DETR instance segmentation from phase 3's export "
          f"(train_instance_segmentation {SEG_MODEL} on COCO, {SEG_STEPS} "
          f"steps; {SEG_ECVIT}; bf16, batch 16), PicoDet ("
          f"{', '.join(f'{m} at {hw}^2' for m, hw in PICO_RUNS.items())}, "
          f"batch 16), two resumes, one fp32 step of each against the CPU",
          flush=True)
    seg_pico = run_seg_picodet_path(
        lt, A, F, card, work,
        paths["bf16"]["out"] / "exported_models" / "exported_last")
    # Each (library, shape) that phases 3o, 3p, 3q, 3r, 3s, 3t and 3u
    # launched K1 or K2 at was held against the plain version in phase 2.
    covered = {(route(torch_dtype(dtype), shape[3]), tuple(shape))
               for kernels, dtype, shape, _ in ATTENTION_CASES
               if kernels == "flat"
               for route in (A.fwd_library, A.bwd_library)}
    for label, ran in (("3o", cnn), ("3p", item10), ("3q", surface),
                       ("3r", finetune), ("3s", eomt), ("3t", detection),
                       ("3u", seg_pico)):
        if set(ran["by_shape"]) - covered:
            fail(f"phase {label} launched at shapes phase 2 does not hold: "
                 f"{sorted(set(ran['by_shape']) - covered)}")
    pin_ieee()
    phase(f"phase 3j: pretrain distillation v3 of ViT-B/14 from a frozen "
          f"random DINOv3 7B/16 teacher (hd 128, fp32), bf16, batch "
          f"{DISTILL_BATCH}, {TEACHER_7B_STEPS} steps", flush=True)
    teacher_7b = run_teacher_7b_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3k: embed with a DINOv2 7B/14 export (hd 128), bf16, "
          f"batch {DISTILL_BATCH}", flush=True)
    embed_7b = run_embed_7b_path(lt, A, F, card, work)
    pin_ieee()
    phase(f"phase 3l: pretrain distillation v3 of a DINOv3 7B/16 student "
          f"(hd 128, K2 at hd 128), bf16, batch {DISTILL_BATCH}, "
          f"{STUDENT_7B_STEPS} steps, {STUDENT_7B_ARGS}", flush=True)
    student_7b = run_student_7b_path(lt, A, F, card, work)
    end_phase()
    work_dir.cleanup()

    # Launches: each wrapper's count over the path that runs it (K1/K2: the
    # pretrain path of the row's dtype, at the global and local shapes of
    # ViT-B/14 (phases 3, 3b) and of vittest14 (phase 3e); K4/K5: phase 3c,
    # at the global shape), 0 for shapes no path runs.
    def ft_per_step(kernel: str, dtype: str, shape: tuple) -> dict:
        """Measured in phase 3r (a) at FT_CLS and (b) at FT_SEG (bf16): the
        launches of each val batch, counted around it, and of a train step
        (the run's launches less the val batches', over its steps)."""
        if kernel not in ("K1", "K2") or dtype != "bf16" or shape not in (
                FT_CLS, FT_SEG):
            return {}
        ft_run = finetune["a" if shape == FT_CLS else "b"]
        key = (getattr(A, f"{KERNELS[kernel][1]}_library")(torch.bfloat16,
                                                           shape[3]), shape)
        return {"launches_3r_per_step": ft_run["per_step"].get(key, 0),
                "launches_3r_per_val_batch": [
                    launched.get(key, 0)
                    for launched in ft_run["val_by_shape"]]}

    def eomt_per_step(kernel: str, dtype: str, shape: tuple) -> dict:
        """Measured in phase 3s (a) (bf16): the launches of a train step
        and of each val batch at FT_SEG and EOMT_QUERIES_SHAPE."""
        if kernel not in ("K1", "K2") or dtype != "bf16" or shape not in (
                FT_SEG, EOMT_QUERIES_SHAPE):
            return {}
        key = (getattr(A, f"{KERNELS[kernel][1]}_library")(torch.bfloat16,
                                                           shape[3]), shape)
        return {"launches_3s_per_step": eomt["a"]["per_step"].get(key, 0),
                "launches_3s_per_val_batch": [
                    launched.get(key, 0)
                    for launched in eomt["a"]["val_by_shape"]]}

    kernels = []
    for (kernel, dtype), rows in attn.items():
        name, direction, line = KERNELS[kernel]
        route = getattr(A, f"{direction}_library")
        if kernel in ("K4", "K5"):
            by_shape = {tuple(GLOBAL): vmem[dtype][kernel]}
        else:
            i = ("K1", "K2").index(kernel)
            by_shape = dict.fromkeys((GLOBAL, LOCAL),
                                     paths[dtype]["launches"][i])
            by_shape.update(dict.fromkeys((VITTEST_GLOBAL, VITTEST_LOCAL),
                                          vittest[dtype]["launches"][i]))
            # hd 128: the 7B teacher's fp32 forwards (phase 3j), 7B
            # embed's bf16 ones (phase 3k), the 7B student's bf16 forwards
            # and backwards (phase 3l) at TEACHER_7B.
            lib7 = route(torch_dtype(dtype), HEAD_DIM_7B)
            by_shape.update({
                TEACHER_7B: sum(r["by_shape"].get((lib7, TEACHER_7B), 0)
                                for r in (teacher_7b, student_7b)),
                EMBED_7B: embed_7b["by_shape"].get((lib7, EMBED_7B), 0),
                # Phase 3p's ECViT students (bf16; fp32 in (g)) and the
                # teacher of the fp32 checks of 3o (a) and 3p (g).
                **{shape: sum(r["by_shape"].get(
                    (route(torch_dtype(dtype), HEAD_DIM), shape), 0)
                    for r in (cnn, item10))
                   for shape in (ECVIT_GLOBAL, ECVIT_LOCAL, ECVIT_FP32,
                                 TEACHER_FP32_CHECK)},
                # Phase 3q (c)'s evaluate_knn runs (fp32 twice, bf16 once).
                KNN_SHAPE: surface["by_shape"].get(
                    (route(torch_dtype(dtype), HEAD_DIM), KNN_SHAPE), 0),
                # Phase 3r's fine-tuning runs: (a) at FT_CLS, (b) at FT_SEG
                # (bf16), (c)'s multihead runs at HD16_SMALL, (d) at FT_FP32
                # (fp32); phase 3s's EoMT runs at FT_SEG (the plain blocks)
                # and EOMT_QUERIES_SHAPE (the joint blocks in validation),
                # bf16, and at HD16_SMALL (vittest14, bf16 and fp32).
                **{shape: sum(r["by_shape"].get(
                    (route(torch_dtype(dtype), shape[3]), shape), 0)
                    for r in (finetune, eomt, detection, seg_pico))
                   for shape in (FT_CLS, FT_SEG, FT_FP32, HD16_SMALL,
                                 EOMT_QUERIES_SHAPE, DET_ECVIT)},
            })
        # Phase 3f's launches of this kernel's library at each shape, per
        # run: the teacher's K1 at TEACHER (fp32 in both runs), the
        # student's K1/K2 at GLOBAL (in its run's dtype).
        library = {"fwd": A.fwd_library, "bwd": A.bwd_library}[direction]
        lib = library(torch_dtype(dtype), HEAD_DIM)
        distill_runs = {
            shape: {p: distill[p]["by_shape"].get((lib, shape), 0)
                    for p in DTYPES}
            for shape in (TEACHER, GLOBAL)} if kernel in ("K1", "K2") else {}
        by_shape[TEACHER] = sum(distill_runs.get(TEACHER, {}).values())
        # At TEACHER_7B the fp32 K1 launches are phase 3j's teacher's, the
        # bf16 K1 and K2 ones phase 3l's student's.
        per_step_7b = {TEACHER_7B: ("launches_per_step", TEACHER_7B_STEPS
                                    if dtype == "fp32" else STUDENT_7B_STEPS),
                       EMBED_7B: ("launches_per_batch", 1)}
        kernels += [{
            "name": name, "route": "cuda",
            "source": "lightly_train_tpu_torch/csrc/" + kernel_source(
                direction, dtype, row["shape"][3], row["shape"][1],
                route(torch_dtype(dtype), row["shape"][3])),
            "replaces": f"lightly_train_tpu/ops/pallas/attention.py:{line}",
            "launches": by_shape.get(tuple(row["shape"]), 0),
            # embed's fp32 forwards (phase 3d) run at the global shape,
            # those of 3p (f)'s ECViT-S+ at ECVIT_GLOBAL.
            **({"launches_embed": embed_k1}
               if (kernel, dtype) == ("K1", "fp32")
               and row["shape"] == list(GLOBAL) else {}),
            **({"launches_embed": item10["f_embed"]["launches"][0]}
               if (kernel, dtype) == ("K1", "fp32")
               and row["shape"] == list(ECVIT_GLOBAL) else {}),
            **({"launches_distillation": distill_runs[tuple(row["shape"])],
                "launches_distillation_per_step": {
                    p: n / DISTILL_STEPS[p] for p, n in
                    distill_runs[tuple(row["shape"])].items()}}
               if tuple(row["shape"]) in distill_runs else {}),
            # Phase 3g's launches (remat every 2nd block, bf16) at the row's
            # shape, K1's recomputed blocks included.
            **({per_step_7b[tuple(row["shape"])][0]:
                by_shape.get(tuple(row["shape"]), 0)
                / per_step_7b[tuple(row["shape"])][1]}
               if kernel in ("K1", "K2")
               and tuple(row["shape"]) in per_step_7b else {}),
            # Phase 3o's launches at the row's shape: the distillation
            # teacher's K1 in (a), (c), (d) and (e), (e)'s ViT-B/14 student,
            # (g)'s 7B/16 student.
            **({"launches_3o": cnn["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            # Phase 3p's at the row's shape: the distillation teacher's K1
            # in (a), (c) and (e); the ECViT students' K1 and K2.
            **({"launches_3p": item10["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            # Phase 3q's: (a)'s and (d)'s DINOv2 runs at GLOBAL and LOCAL,
            # (c)'s evaluate_knn at KNN_SHAPE (12 a batch).
            **({"launches_3q": surface["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            # Phase 3r's at the row's shape: (a)'s and (b)'s K1 and K2 a
            # train step, K1 a val batch ((b): FT_TILES tiles), and the
            # multihead runs' at HD16_SMALL.
            **({"launches_3r": finetune["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            **ft_per_step(kernel, dtype, tuple(row["shape"])),
            # Phase 3s's at the row's shape, and (a)'s a train step and a
            # val batch (FT_TILES tiles).
            **({"launches_3s": eomt["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            **eomt_per_step(kernel, dtype, tuple(row["shape"])),
            # Phase 3t's at the row's shape: (a)'s ViT-B/14 at FT_SEG
            # (DEPTH a train step and a val batch), (b)'s ECViT-T at
            # DET_ECVIT, (c)'s and (d)'s vittest14 at HD16_SMALL.
            **({"launches_3t": detection["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            # Phase 3u's: (a)'s ViT-B/14 at FT_SEG (DEPTH a train step and
            # a val batch), (b)'s ECViT-T at DET_ECVIT, (d)'s and (e)'s
            # vittest14 at HD16_SMALL; PicoDet none.
            **({"launches_3u": seg_pico["by_shape"].get(
                (route(torch_dtype(dtype), row["shape"][3]),
                 tuple(row["shape"])), 0)}
               if kernel in ("K1", "K2") else {}),
            # Each evaluate_knn run's K1 a batch in the row's dtype.
            **({"launches_per_batch": {
                tag: r["k1_per_batch"] for tag, r in surface["c"].items()
                if r["precision"] == dtype}}
               if kernel == "K1" and tuple(row["shape"]) == KNN_SHAPE
               else {}),
            **({"launches_remat": remat["by_shape"].get(
                (lib, tuple(row["shape"])), 0),
                "launches_remat_per_step": remat["by_shape"].get(
                    (lib, tuple(row["shape"])), 0) / REMAT_STEPS}
               if (kernel in ("K1", "K2") and dtype == "bf16"
                   and tuple(row["shape"]) in (GLOBAL, LOCAL)) else {}),
            **row,
        } for row in rows]
    kernels.append({
        "name": "fused_adamw_ema", "route": "cuda",
        "source": "lightly_train_tpu_torch/csrc/fused_adamw_ema.cu",
        "replaces": "lightly_train_tpu/_optim/fused_update.py:95",
        "launches": paths["bf16"]["launches"][2],
        "launches_fp32": paths["fp32"]["launches"][2],
        "launches_per_step": paths["bf16"]["launches"][2] / STEPS,
        "launches_distillation": {p: distill[p]["launches"][2]
                                  for p in DTYPES},
        "launches_remat": remat["launches"][2],
        "launches_3q": surface["a"]["launches"][2]
        + surface["d"]["launches"][2],
        "launches_3r": sum(finetune[k]["launches"][2]
                           for k in ("a", "b", "c_cls", "c_seg")),
        "launches_3o_dino_resnet50": cnn["b_dino_resnet50"][
            "launches_per_step"]["K3"] * CNN_STEPS,
        **{f"launches_3p_{tag}": item10[tag]["launches_per_step"]["K3"]
           * ITEM10_STEPS for tag in ("b_dino_ecvits", "d_dino_yolo_nas_l")},
        **upd,
    })
    if "--profile" in sys.argv[1:]:
        for method in ("dinov2", "distillation"):
            for precision in DTYPES:
                phase(f"phase 4: profile of the {method} pretraining step "
                      f"({precision})", flush=True)
                profile_steps(card, precision, method)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
