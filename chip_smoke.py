#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, phase by phase.

    python3 chip_smoke.py        # from the root of the repository

The main path is MI-FGSM on a full-width ResNet-50 at 224², batch 128,
10 iterations, bf16 compute with fp32 delta, momentum and loss, on seeded
random weights.  Phases:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from ``transferattack_torch/ops/csrc``
   (three sources), one nvcc per source, all started together;
3. kernel: ``fused_sign_update`` bit-exact with its plain PyTorch version at
   the main-path shape, at batch 32 (phases 9 and 11) and at a ragged one,
   and both timed at the main-path shape;
4. fp32 parity: MI-FGSM on the card (TF32 off) against the same model on the
   CPU, 2 images, 3 iterations: deltas agree in sign on > 99% of elements;
5. main path: bounds, a loss that rose, exactly 10 kernel launches per call,
   white-box ASR and images per second;
6. kernels 2-3: the fused backward-input kernels ``fused_bwd_1x1`` (with and
   without skip, and with ``g · mask`` as a second output, which must be bit
   for bit ``g * mask``) and ``fused_bwd_3x3``, bf16, within one bf16 rounding
   of their plain versions: the 1×1 at ResNet-50 stage-1 shapes (batch 128,
   56²) and at ragged, partial-k, partial-N and stage-4 shapes, each with
   its tiling printed, the 3×3 at the stride-1 3×3 shapes of stages 1-4
   (batch 128) and at shapes whose blocks cross images, with a
   partial chunk and N block, and wider than a block; kernel, plain and
   library call timed at the stage shapes; an image too wide for the 3×3's
   halo raises;
7. chain: ``bottleneck_bwd_input`` on a BN-folded ``Bottleneck(256, 64)``
   at batch 128, 56², bf16, against the plain chain and against autograd
   of the block, with exactly 2 + 1 launches per call, and timed;
8. eval models: each of the eight paper eval models at full width, 2
   images, fp32 with TF32 off on the card and on the CPU, each held
   against a CPU fp64 copy of the model: the card's logits no further from
   fp64 than the CPU's, plus ``1e-3·max|ref|`` (the card-vs-CPU distance
   is printed beside them);
9. the CLI (``transferattack_torch.main``) in a temporary working
   directory: it writes 64 seeded 299² PNGs, labelled with the ResNet-50
   surrogate's own predictions; the attack (MI-FGSM, ResNet-50, bf16,
   batch 32) must write 64 PNGs at 224², each within 16 levels of its
   clean image, with exactly 20 update-kernel launches, once cold and once
   more warm (the cuDNN plans for batch 32 chosen); ``--eval`` over the
   eight models must print eight ``{model}: {asr:.1f}`` lines with a
   white-box ResNet-50 ASR of at least 90; and the PNG decode is timed
   (``scripts/bench_png.py``);
10. bench: the line of ``python -m transferattack_torch.bench``;
11. the gradient family, 25 keys: (a) each on the card and on the CPU, fp32
    with TF32 off, ResNet-18 at 64², batch 2, 2 iterations and few draws,
    its random draws from one numpy bank through its seams: deltas agree in
    sign on > 99% of elements; (b) each at full width, ResNet-50 bf16, 224²,
    batch 32, official hyperparameters (RAP capped, printed as ``reduced``),
    labels the surrogate's own predictions: bounds, a finite delta, a loss
    that rose, exactly the update-kernel launches the code implies (0 where
    the attack has its own clip), and its gradient evaluations, images per
    second and peak memory;
12. the image ops and the input-transformation keys with ANDA and MUMODIG, 19
    keys: (a) each on the card and on the CPU, fp32 with TF32 off, ResNet-18
    at 64², batch 2, 2 iterations and few copies, every draw from one seeded
    CPU generator handed to both calls (the port draws on the generator's
    device and moves the values): deltas agree in sign on > 99% of elements
    (DeCowA at rho 0, since its map step differentiates bilinear sampling
    across its kinks; at its official rho 0.01, each step from the CPU's
    state, the gradients agree to a cosine > 0.99);
    (b) each at full width, ResNet-50 bf16, 224², batch 32, official
    hyperparameters (OPS cut to one iteration, printed as ``reduced``),
    labels the surrogate's own predictions (SU, targeted, a shifted class):
    bounds, a finite delta, a loss that moved the attack's way, exactly the
    update-kernel launches the code implies (0 for ANDA, which clips on its
    own), and its gradient evaluations, images per second and peak memory;
13. the feature-tap API and the 24 advanced-objective keys: (a) each on the
    card and on the CPU, fp32 with TF32 off, ResNet-18 at 64², batch 2, 2
    iterations, few copies, taps at layer2/layer3, one seeded CPU generator
    handed to both calls: deltas agree in sign on > 99% of elements; (b)
    each at full width, ResNet-50 bf16, 224², batch 32, official
    hyperparameters, labels the surrogate's own predictions (the targeted
    keys a shifted class; AA's anchors seeded PNGs in a temporary
    ``input_dir``): bounds, a finite delta, the objective the key optimises
    moved its way (its loss, logit or feature objective; CE printed beside
    it), exactly the update-kernel launches its code implies (0 for P2FA
    and YAILA, whose steps clip on their own, and on TRAP's second phase,
    BFA's warm-up and FFT's fine-tune), and its gradient evaluations,
    images per second and peak memory;
14. the ResNet gradient surgery and the 18 CNN keys of model_related: (a)
    each on the card and on the CPU, fp32 with TF32 off, ResNet-18 at 64²,
    batch 2, 2 iterations, short inner loops, one seeded CPU generator
    handed to both calls: deltas agree in sign on > 99% of elements (MUP
    by its conv masks and with the CPU's masks, AWT step by step by
    gradient cosine > 0.99); (b) each at full width on its own default
    surrogate (ResNet-50 bf16, ResNet-18 for MTA and DSM, Ghost once more
    on Inception-v3 at 299²), batch 32, official hyperparameters but AWT's
    SAM rate (printed as ``reduced``), labels each surrogate's own
    predictions: bounds, a finite delta, its objective risen (CE, AGS's
    feature dissimilarity), exactly the update-kernel launches its code
    implies, and its gradient evaluations, images per second and peak
    memory;
15. the ViT gradient surgery and the ten ViT keys of model_related: (a) each
    on the card and on the CPU, fp32 with TF32 off, a narrow ViT of the
    official depth (dim 64, 12 blocks, 2 heads) at 32², TGR once more on a
    narrow CaiT (its class attention hooked), batch 2, 2 iterations, few
    draws, one seeded CPU generator handed to both calls: deltas agree in
    sign on at least 99% of elements; (b) each at full width on its own
    default surrogate (ViT-B/16 bf16, 224²; TGR once more on CaiT-S24;
    Ghost and DHF on Inception-ResNet-v2 at 299²), batch 32, official
    hyperparameters, labels each surrogate's own predictions: bounds (ATA-
    ViT, a patch attack, [0, 1] only), a finite delta, its objective risen
    (CE; ATA-ViT's log(1 − p_y)), exactly the update-kernel launches its
    code implies (none for ATA-ViT's Adam), and its gradient evaluations,
    images per second, ms an evaluation and peak memory;
16. IDAA, Everywhere and ODI with their field warps and the mesh rasterizer:
    (a) on the card against the CPU, fp32 with TF32 off: each of IDAA's ten
    ops (its field within ``1e-5·max``, its warp forward and input gradient
    within the same), the rasterizer on each of ODI's three meshes at 64²
    (hit masks equal on at least 99.9% of pixels, colours within 1e-5
    where the face ids agree), ``grid_sample``'s and the texture gather's
    backwards against fp64 on the CPU in both memory formats, and each key
    on ResNet-18 at 64², batch 2, 2 iterations, one seeded CPU generator
    handed to both calls: deltas agree in sign on at least 99% of elements;
    (b) each at full width, ResNet-50 bf16, 224², batch 32, official
    hyperparameters (Everywhere and ODI capped, printed as ``reduced``; ODI
    once on each mesh, the object pinned through its draw seam), targeted
    at the prediction shifted by 500: bounds, a finite delta, the objective
    moved its way, exactly the update-kernel launches its code implies
    (IDAA 0, Everywhere epoch − 1, ODI epoch), and its gradient
    evaluations, images per second, peak memory and, for ODI, render ms an
    image;
17. the ensemble surrogate, DenseNet-121/201 and the five ensemble keys:
    (a) on the card against the CPU, fp32 with TF32 off: DenseNet-121's
    logits and input gradient at 64² (``channels_last`` and NCHW) no further
    from a CPU fp64 copy than the CPU's fp32 plus ``1e-3·max|ref|``, and each
    key on a two-member ensemble (ResNet-18 and ``toy_cnn2``, ten classes)
    at 64², batch 2, 2 iterations, one seeded CPU generator handed to both
    calls: deltas agree in sign on at least 99% of elements; (b) at full
    width, bf16, batch 32, official hyperparameters, labels the ensemble's
    own predictions: ENS on the paper's four CNNs (299², its largest
    member's), SVRE, CWA, AdaEA and SMER on their four ResNets at 224²,
    MI-FGSM on DenseNet-121 and -201, ENS on RFCoA's ResNet-50, VGG-16 and
    DenseNet-121: bounds, a finite delta, the ensemble's CE risen, exactly
    the update-kernel launches and member passes (backward, and forward
    only) its code implies, and seconds, images per second and peak memory;
    (c) the CLI, ``--attack ens --model resnet50,vgg16 --bf16`` with and
    without ``--ensemble``, over 8 of phase 9's PNGs: 8 PNGs within 16
    levels of their inputs, 1 batch and 10 launches each;
18. the rest of ensemble/ (LGV, MBA, SASD-WS, RFCoA) and the learned
    transformations (ATTA, STM, PAM, AITL, LPM): (a) on the card against
    the CPU, fp32 with TF32 off: each auxiliary network (RFCoA's encoder and
    decoder, StyleNet, the SemanticPredictor, AITL's three) on seeded
    weights within ``1e-3·max|ref|``, and each key on ResNet-18 at 64²
    (LPM at 56², batch 1, its search on small gray models with the CPU's
    scores, the card's own within ``1e-3·max|ref|``), batch 2, 2 iterations,
    one seeded CPU generator handed to both calls: deltas agree in sign on
    more than 99% of elements (RFCoA by its delta's cosine, > 0.99); (b) each
    at full width on its default surrogate, bf16, batch 32 (LPM 1), official
    hyperparameters (RFCoA on its three members for one target class, printed
    as ``reduced``), labels the surrogate's own predictions (SASD-WS targeted
    at the prediction + 500): bounds (eps but for RFCoA, [0, 1] for all), a
    finite delta, its objective moved its way, exactly the update-kernel
    launches its code implies (10, SASD-WS 300, RFCoA 0, LPM 230), and its
    gradient evaluations, seconds, images per second and peak memory; (c)
    the CLI on 2 PNGs: ``rfcoa`` writes one subdirectory a target class,
    ``lpm --batchsize 4`` runs at batch 1.
19. the generators, the TTP family and FAP: (a) on the card against the
    CPU, fp32 with TF32 off: GeneratorResnet and AdvGAN at 64² (AdvGAN also
    at 65², its crop path) and ADA at 67² on seeded weights, raw output
    within ``1e-3·max|ref|``; FAP on ResNet-18 at 64², 2 images, deltas
    agreeing in sign on more than 99% of elements, and its gate at 224²
    within 1e-5; (b) at full width, batch 32, on seeded fallbacks (fp32
    generators, ``--bf16`` ignored as in JAX): TTP and M3D with all ten class
    generators (``idx`` 0-9), CDTP, LTP, DSVA, GE-AdvGAN at 224², ADA at 224²
    (edge-padded to 227²) and 299²: bounds, a finite non-zero delta, one
    generator forward a call, 0 update-kernel launches, ms a forward by CUDA
    events, images per second, peak memory; FAP on ResNet-50 bf16 at 224², 20
    iterations on the zigzag mask: eps 48/255, exactly 20 launches, CE risen;
    (c) the CLI: ``--attack ttp`` on 2 PNGs writes one subdirectory a target
    class, each PNG within 16 levels of its clean image, and ``--eval``
    prints one row, the mean over the ten classes.
20. AIM, the guided-diffusion UNet, DiffPure and DiffAttack: (a) on the card
    against the CPU, fp32 with TF32 off, on seeded nonzero weights: the tiny
    UNet at 32² (output and attention maps) and AIM's generator at 64²
    within ``1e-3·max|ref|``, ``purify_sde`` and ``purify_ddpm`` with fixed
    noises within 1e-4, DiffAttack's loss on ``toy_cnn`` at its inverted
    latent within 1e-4 relative and its latent gradient at cosine 0.9999;
    (b) at full width: AIM's ten class generators at 224², batch 32 (bounds,
    0 launches, ms a forward); the ImageNet-256 UNet (553M parameters, its
    operations counted on the meta device), built and seeded on the card,
    under both samplers at 256², batch 4, t* 150 (150 UNet forwards each)
    and under DiffAttack on ResNet-50 at 224², batch 1, 20 steps from 15, 5
    of its 30 iterations (printed as ``reduced``; 195 UNet forwards):
    seconds a call, ms a UNet forward by CUDA events, peak memory, a finite
    delta with x + delta in [0, 1]; (c) the CLI: ``--attack aim`` writes one
    subdirectory a target class, and ``--attack diffattack --model toy_cnn``
    runs on the tiny fallback at 32².
21. the training entry points and DiffAttack's Stable Diffusion backend:
    (a) on the card against the CPU, fp32 with TF32 off, on seeded weights:
    a tiny SDUNet attending at three resolutions (output and its 14 maps),
    a tiny SDVAE (encode, decode) and CLIP within ``1e-3·max|ref|``; SD
    DiffAttack on ``toy_cnn`` at 32²: ``keep`` the same strict subset on
    both, the loss off the clean latent within 1e-4 relative and its latent
    gradient at cosine 0.9999; one generator training step against
    ResNet-18 at 64² and one ``train_sp`` step the same way; the writer's
    round trip of the card-trained generator bit for bit; (b) at full width:
    ``train_generator`` on GeneratorResnet against ResNet-50 at 224², batch
    16, 20 of JAX's 2000 steps (``reduced``): ms a step by CUDA events, its
    operations, img/s, peak memory, the target CE fallen, the written
    checkpoint loaded strictly by TTP, which runs on it; ``PAM.train_sp`` on
    ResNet-50 for one epoch of 15 over 8 images (``reduced``); SD DiffAttack
    at SD-1.5 widths (UNet, VAE, CLIP seeded on the card), 512², batch 1,
    20 steps from 15, 10 of its 30 iterations (``reduced``; 675 UNet
    forwards with those recomputed in the backward): seconds, ms a UNet
    forward by CUDA events,
    peak memory, the loss fallen, x + delta in [0, 1]; (c) the training CLI
    (``--steps 2``) on 4 PNGs, then ``--attack ttp`` reading its checkpoint.
22. the defense suite: (a) on the card against the CPU, fp32 with TF32 off:
    HGD's DUNet at 75² (its enlargements not 2×) and NRP at nb 2 against fp64
    within ``1e-3·max|ref|``, RS's votes from one noise bank (a vote may flip
    only where the CPU's top-two logits tie within ``1e-3·max``),
    ``run_diffpure`` on the tiny fallback with the same noises (the same
    CSV); (b) at full width on seeded weights: the six lines of
    ``scripts.bench_defense`` (RS at N 1000, AT, HGD with Inception-v3 and
    the four-member chain, NRP, DiffPure's 150 forwards of the full UNet),
    ``Smooth.predict`` and ``certify`` on 8 images at N 1000, ``run_nrp`` in
    dynamic mode, ``run_diffpure`` on 4 PNGs with the full UNet seeded on the
    card and written as ``diffpure_unet.npz``; (c) the defense CLI for all
    five on 4 of phase 9's PNGs, each printing its ASR line, and NRP's
    purified PNGs scored by ``--eval``; 0 update-kernel launches throughout.
23. the weights converter and the scripts: (a) seeded reference-named
    ``state_dict``s of ResNet-50, MobileNet-V2, DenseNet-121 and ViT-B/16
    written as ``.pth`` and converted by ``utils.convert --all`` (host
    seconds a model), each then built by ``make_model`` on the card with no
    fallback recorded, its fp32 logits (TF32 off) within ``1e-6·max|ref|``
    of the same module loaded straight from the ``state_dict``, and
    ``--list`` showing them present; (b) the sweep's ``--smoke`` through
    the CLI on the card with the converted ResNet-50 (10 launches, no
    fallback); (c) the family bench for MI-FGSM and SSM at batch 32, bf16,
    its calibration cut to ``TOOLS_TARGET_S`` (printed as ``reduced``);
    (d) ``profile_vit`` at batch 32 for MI-FGSM and TGR on ViT-B/16, with a
    ``torch.profiler`` trace; (e) the ASR gate for ``--rows mifgsm
    --columns cnn`` over the converted weights less the CNN surrogate: every
    cell SKIP, exit 0.  The ``kernels`` line's row 1 gains ``launches_tools``.
24. resume and the data-parallel runner: (a) the main path through
    ``Attack.call_resumable`` in segments of 3 iterations, and a run stopped
    after its second segment's checkpoint and resumed, each bit for bit the
    uninterrupted call (or within the distance between two uninterrupted
    calls, printed first), 10 launches, the checkpoint's MiB and the ms to
    save one; (b) the CLI, targeted MI-FGSM, 300 iterations, batch 32, with
    ``--checkpoint_every 50`` in a subprocess killed (SIGKILL) once its first
    checkpoint exists, then run again: its PNGs byte for byte those of an
    uninterrupted run, ``_ckpt`` gone, the launches of each run (300, and
    300 less the step it resumed at); (c) ``ShardedAttackRunner`` on NCCL at
    a world of 1: the main path bit for bit the attack's, 10 launches, its
    img/s beside phase 5's; the sharded eval's ASR that of the plain eval;
    (d) through the same runner, one key for each rule of the split
    (VMI-FGSM, Foolmix, Admix, POTRIP on ResNet-50 and TGR on ViT-B/16, bf16,
    batch 32, official hyperparameters, cuDNN's deterministic algorithms):
    each delta bit for bit its own call's from the same seed, the
    update-kernel launches ``expected_launches`` gives, and its img/s
    beside its own call's.  The ``kernels`` line's row 1 gains
    ``launches_parallel``.

Each phase prints its seconds (``[time]``).  Any failed phase ends the run
with a non-zero exit.  Without a card it fails
at once.  Before the ``kernels`` line a ``summary`` JSON line holds the
main path's and the bench's img/s and each phase's seconds; the last line
is the JSON ``ok`` line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

import transferattack_torch as tt
from transferattack_torch import bench
from transferattack_torch import attack as tattack
from transferattack_torch import main as cli
from transferattack_torch.attack import Attack, softmax_cross_entropy
from transferattack_torch.config import official_defaults
from transferattack_torch.gradient.mef import MEF
from transferattack_torch.input_transformation import idaa as tidaa
from transferattack_torch.gradient.mifgsm import MIFGSM
from transferattack_torch.models import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Surrogate,
    WrappedModel,
    init_weights,
    make_ensemble,
    make_model,
)
from transferattack_torch.models.cait import Cait
from transferattack_torch.models.resnet import Bottleneck, fold_bn
from transferattack_torch.models.vit import VisionTransformer, ViTSurgery
from transferattack_torch.ops import _build
from transferattack_torch.ops import fused_bwd as fb
from transferattack_torch.ops import image as timage
from transferattack_torch.ops import render3d
from transferattack_torch.ops.fused_update import (
    fused_sign_update,
    fused_sign_update_plain,
)
from transferattack_torch.scripts.bench_png import decode_ms
from transferattack_torch.utils import (cnn_model_paper, generation_target_classes,
                                        vit_model_paper)
from transferattack_torch.parallel import ShardedAttackRunner
from transferattack_torch.utils.data import AdvDataset, load_image, save_images
from transferattack_torch.utils.timing import bound_ms, card, median_ms

REPO = Path(__file__).resolve().parent
KERNEL_SOURCES = ("fused_update", "fused_bwd", "fused_bwd_3x3")
EPS, ALPHA = 16 / 255, 1.6 / 255
MAIN_SHAPE = (128, 224, 224, 3)
STAGE1 = (128, 56, 56)  # ResNet-50 stage 1 at batch 128
BWD_TOL = 1e-2    # max|out - ref| / max|ref|: one bf16 rounding
CHAIN_TOL = 2e-2  # three roundings, in another order than cuBLAS/cuDNN/autograd
# fp32 logits: how much further from fp64 the card may be than the CPU is
EVAL_TOL = 1e-3
EVAL_MODELS = cnn_model_paper + vit_model_paper
CLI_IMAGES, CLI_BATCH = 64, 32
FUSED_BWD = "transferattack_tpu/ops/fused_bwd.py"
FUSED_BWD_CU = "transferattack_torch/ops/csrc/fused_bwd.cu"
FUSED_BWD_3X3_CU = "transferattack_torch/ops/csrc/fused_bwd_3x3.cu"
# the 3x3: ResNet-50's stride-1 3x3s at batch 128 (stage 1 first, the
# headline), then blocks across images; a partial chunk and N block; W wider
# than a block.  (shape of g, output channels)
STAGES_3X3 = tuple(((128, s, s, c), c) for s, c in ((56, 64), (28, 128), (14, 256), (7, 512)))
EDGES_3X3 = (((3, 13, 17, 64), 64), ((5, 4, 5, 48), 16), ((1, 3, 300, 64), 64))
# phase 11: the gradient family
GRADIENT_KEYS = ("pifgsm", "vmifgsm", "vnifgsm", "emifgsm", "aifgtm", "ifgssm", "smifgrm",
                 "vaifgsm", "rap", "pcifgsm", "iefgsm", "gra", "gnp", "mig", "dta", "pgn",
                 "mef", "gifgsm", "rgmifgsm", "dual_mifgsm", "ens_mifgsm", "fgsra", "gaa",
                 "foolmix", "adamsi_fgm")
# the keys with a clip of their own: the update kernel is not on their path
OWN_CLIP = ("pifgsm", "aifgtm", "ifgssm", "adamsi_fgm", "gra", "fgsra", "foolmix", "vaifgsm")
# 11a: few draws and short loops (two points a batch where a key stacks them)
GRADIENT_SMALL = {
    "vmifgsm": {"num_neighbor": 2, "sample_chunk": 2},
    "vnifgsm": {"num_neighbor": 2, "sample_chunk": 2},
    "gra": {"num_neighbor": 2, "sample_chunk": 2}, "gaa": {"N": 2, "sample_chunk": 2},
    "pgn": {"num_neighbor": 2, "sample_chunk": 2}, "mef": {"num_neighbor": 2},
    "fgsra": {"max_iter": 2}, "smifgrm": {"num_neighbor": 2},
    "rap": {"transpoint": 1, "adv_steps": 2}, "dta": {"K": 2}, "gifgsm": {"pre_epoch": 2},
    "rgmifgsm": {"pre_epoch": 2, "num_directions": 2}, "ens_mifgsm": {"num_d": 2},
}
# 11b: the official hyperparameters, but where a call would take well over
# 5 s: RAP's 400 iterations (100 + 300 x 9 gradients) at a tenth
GRADIENT_CAPS = {"rap": {"epoch": 40, "transpoint": 10}}
GRADIENT_BATCH = 32
# phase 12: the input-transformation keys, ANDA and MUMODIG
INPUT_KEYS = ("dim", "dem", "tim", "sim", "admix", "usmm", "ssm", "ssm_h", "ssm_p", "maskblock",
              "sia", "bsr", "mfi", "decowa", "ops", "su", "l2t", "anda", "mumodig")
# 12a: few copies and draws (two points a batch where a key stacks them)
INPUT_SMALL = {
    "admix": {"num_scale": 2}, "usmm": {"num_scale": 2},
    "ssm": {"num_spectrum": 2, "sample_chunk": 2}, "ssm_h": {"num_spectrum": 2, "sample_chunk": 2},
    "maskblock": {"patch_size": 16}, "sia": {"num_scale": 4}, "bsr": {"num_scale": 4},
    "mfi": {"mask_radius": 16},
    # DeCowA's map step differentiates bilinear sampling across its kinks:
    # a sample point within rounding of a pixel center takes the slope of
    # one side on the card and of the other on the CPU, so the map, the warp
    # and the signs after it part.  At rho 0 the warp is held by the sign bar;
    # the step at rho 0.01 by its gradient's cosine (map_step_cosine).
    "decowa": {"num_warping": 2, "rho": 0.0},
    "ops": {"num_sample_neighbor": 2, "num_sample_operator": 2}, "anda": {"n_ens": 4},
    "mumodig": {"N_trans": 3},
}
# 12b: the official hyperparameters, but OPS's 10 iterations of 901 gradient
# evaluations (about 100 s) cut to one
INPUT_CAPS = {"ops": {"epoch": 1}}
# phase 13: the advanced-objective keys
OBJECTIVE_KEYS = ("logit", "logit_margin", "potrip", "taig", "tap", "fuzziness_tuned", "ila",
                  "ilpd", "fia", "rpa", "fmaa", "bfa", "naa", "danaa", "aa", "ir", "p2fa",
                  "trap", "ata", "mfaa", "yaila", "cfm", "ftm", "fft")
# 13a: few copies and short loops on ResNet-18 at 64², taps at layer2/layer3
# (MFAA's five at ResNet-18's blocks)
OBJECTIVE_SMALL = {
    "taig": {"steps": 4}, "tap": {"epoch": 2}, "ila": {"feature_layer": "layer2.1"},
    "ilpd": {"feature_layer": "layer2.1"}, "fia": {"num_ens": 2}, "rpa": {"num_ens": 4},
    "fmaa": {"num_ens": 2}, "bfa": {"num_ens": 2, "warmup_epoch": 2}, "naa": {"N": 2},
    "danaa": {"N": 2}, "p2fa": {"num_ens": 2, "inner_steps": 2},
    "trap": {"epoch": 4, "baseline_epoch": 2}, "ata": {"layer_name": "layer3"},
    "mfaa": {"num_ens": 2, "taps": ("layer4_1", "layer3_1", "layer3_0", "layer2_1", "layer2_0")},
    "yaila": {"ila_epoch": 2}, "fft": {"num_ens": 2, "ft_epoch": 2},
}
OBJECTIVE_TARGETED = ("logit", "logit_margin", "potrip", "aa", "cfm", "ftm", "fft")
# phase 14: the CNN keys of model_related
MODEL_RELATED_KEYS = ("sgm", "linbp", "iaa", "bpa", "ghost", "dhf", "mup", "awt", "faug", "dra",
                      "mta", "dsm", "ags", "ma", "ana", "qaa", "metassa", "llta")
# the keys whose constructor builds its surrogate from a name (surgery,
# checkpoint, LLTA's decay net); the others take the shared one in 14b
OWN_SURROGATE = ("sgm", "linbp", "iaa", "bpa", "ghost", "dra", "mta", "dsm", "ags", "ma",
                 "qaa", "llta")
# 14a: ResNet-18 at 64², 2 iterations, short inner loops
MODEL_RELATED_SMALL = {
    "awt": {"num_neighbor": 2, "sample_chunk": 2}, "metassa": {"n_sample": 2},
    "llta": {"inner_iters": 1, "nsample": 2, "task_num": 1, "spt_size": 3, "qry_size": 2},
}
# 14b: the official hyperparameters but AWT's SAM rate, printed as
# ``reduced``: on a seeded random ResNet-50 the loss's weight gradient has a
# norm near 280, so one SAM step at the official 0.002 lifts the logits about
# twentyfold, the softmax saturates and the input gradient is exactly 0
# (JAX's arithmetic is the same; ``awt_at_official_rate`` shows it each run)
MODEL_RELATED_CAPS = {"awt": {"sam_lr": 2e-4}}
# phase 15: the ViT keys of model_related
VIT_KEYS = ("tgr", "pna_patchout", "sapr", "fdap", "vdc", "fpr", "att", "setr", "ll2s",
            "ata_vit")
# 15a: a narrow ViT of the official depth (dim 64, 12 blocks, 2 heads, patch 16,
# 32²: FDAP's blocks 5-9 and FPR's 0, 1, 4, 9, 11 exist), a narrow CaiT for
# TGR's class attention; 2 iterations (ATA-ViT: 2 Adam steps), few draws
VIT_NARROW = {"patch_size": 16, "dim": 64, "depth": 12, "num_heads": 2}
CAIT_NARROW = {"patch_size": 16, "dim": 64, "depth": 2, "depth_token_only": 2, "num_heads": 2}
VIT_SMALL = {"pna_patchout": {"sample_num_patches": 2}, "att": {"sample_num_patches": 2},
             "ll2s": {"num_scale": 2, "ops_num": 1, "num_robust_tokens": 3}}
# phase 16: IDAA, Everywhere and ODI
IDAA_KEYS = ("idaa", "everywhere", "odi")
# 16a: ResNet-18 at 64², 2 iterations (Everywhere: 2 steps after its recording)
IDAA_SMALL = {"idaa": {"num_scale": 4, "epoch": 2}, "everywhere": {"epoch": 3},
              "odi": {"epoch": 2}}
# 16b: the official hyperparameters, but Everywhere's 299 steps of 160 images
# and ODI's 300 renders of 32 images a mesh (about 0.5–1 s a step) capped;
# ODI at 5 keeps the whole script under 1,000 s
IDAA_CAPS = {"everywhere": {"epoch": 20}, "odi": {"epoch": 5}}
FIELD_TOL = 1e-5  # of max|ref|: fields, warps and their gradients, card vs CPU
# phase 17: the ensemble surrogate, DenseNet and the ensemble keys
ENSEMBLE_KEYS = ("ens", "svre", "cwa", "adaea", "smer")
# 17a: two distinct members (seeded alike, two ResNet-18s would be one
# model twice), ten classes, at 64²
ENSEMBLE_PAIR = {"model_name": ["resnet18", "toy_cnn2"], "num_classes": 10, "input_size": 64,
                 "pretrained": False}
# 17b: the four ResNets SVRE, CWA, AdaEA and SMER take for a model name, and
# RFCoA's default set, which puts a DenseNet inside an ensemble
RESNETS = ["resnet18", "resnet34", "resnet50", "resnet101"]
RFCOA_SET = ["resnet50", "vgg16", "densenet121"]
CLI_ENSEMBLE_IMAGES = 8
# phase 18: the rest of ensemble/ and the learned transformations
LEARNED_KEYS = ("lgv", "mba", "sasd_ws", "rfcoa", "atta", "stm", "pam", "aitl", "lpm")
# 18a: ResNet-18 at 64² (LPM at 56², a multiple of its 7×7 grid), short loops,
# few draws; RFCoA on ResNet-18 + toy_cnn2 (ten classes, label pairs), LPM's
# search cut to one generation of four on small gray models
LEARNED_SMALL = {
    "lgv": {}, "mba": {}, "sasd_ws": {}, "atta": {}, "pam": {}, "aitl": {},
    "stm": {"num_style": 4, "sample_chunk": 2},
    "rfcoa": {"model_name": ["resnet18", "toy_cnn2"], "num_classes": 10, "epoch": 3},
    "lpm": {"gray_models": ("resnet18", "toy_cnn", "toy_cnn2"), "pop_size": 4, "de_iters": 1,
            "score_chunk": 4, "m_num": 3, "inner_epoch": 3},
}
# 18a: LGV and MBA step by step from the CPU's state: on LGV's inputs here
# the seeded fallback draws jittered set 8 twice, whose fp32 gradient parts
# card from CPU on 0.14% of signs in the first step, and the second step on
# the same set compounds that (0.989746 over the whole run on an H100)
STEPWISE = ("lgv", "mba")
CLI_LEARNED_IMAGES = 2
# phase 19: the generators, the TTP family and FAP
GENERATOR_KEYS = ("ttp", "m3d", "cdtp", "ltp", "dsva", "ge_advgan", "ada")
GEN_TOL = 1e-3   # fp32 raw output, card vs CPU: max|d| / max|cpu|
GATE_TOL = 1e-5  # FAP's gate, card vs CPU: max|d|
FAP_EPS = 48 / 255  # 16/255 scaled by 192/top_n at the official top_n 64
CLI_GENERATION_IMAGES = 2
# phase 20: AIM, the guided-diffusion UNet, DiffPure and DiffAttack
DIFF_TOL = 1e-3     # fp32 card vs CPU: max|d| / max|cpu| (the UNet, AIM's generator)
PURIFY_TOL = 1e-4   # fp32 card vs CPU, absolute, on images in [0, 1]
LOSS_TOL = 1e-4     # DiffAttack's loss, card vs CPU, relative
GRAD_COSINE = 0.9999  # DiffAttack's latent gradient, card vs CPU
DIFFPURE_SIZE, DIFFPURE_BATCH, DIFFPURE_T_STAR = 256, 4, 150  # run_diffpure's defaults
DIFFATTACK_KW = dict(diffusion_steps=20, start_step=15, iterations=30)  # the official ones
# 20b: DiffAttack on the guided-diffusion UNet cut to 5 of its 30 iterations
# (printed as ``reduced``), to leave phase 21 room in the time budget
DIFFATTACK_GD_KW = dict(DIFFATTACK_KW, iterations=5)
DIFF_SMALL = dict(diffusion_steps=4, start_step=3)  # 20a: DiffAttack on toy_cnn at 32²
DIFF_TWO_RES = dict(channel_mult=(1, 2, 2), attention_ds=(2, 4))  # 20a: its UNet
# phase 21: the training entry points and DiffAttack's Stable Diffusion backend
# 21a: a UNet attending at 8², 4² and 2² tokens of an 8² latent (self maps of
# 64, 16, 4, 16, 16, 64, 64 tokens: ``keep`` is the 16s and the 4), a
# one-stage VAE (16² images), a two-layer CLIP, DiffAttack on toy_cnn at 32²
SD_TINY = dict(unet=dict(block_out_channels=(32, 64, 64), layers_per_block=1, heads=2,
                         cross_attention_dim=16, norm_groups=8),
               vae=dict(block_out_channels=(32, 64), layers_per_block=1, groups=8),
               text=dict(width=16, layers=2, heads=2))
SD_SMALL = dict(diffusion_steps=4, start_step=2, image_size=16)
# 21b: JAX's training defaults but 20 of its 2000 steps; train_sp one epoch
# of its 15 over 8 images; SD DiffAttack at the official hyperparameters but
# 5 of its 30 iterations (the 30 took 167.7 s on an H100 and 10 took 73 s,
# which with phase 22 took the script past 1,000 s)
SD_DIFFATTACK_KW = dict(DIFFATTACK_KW, iterations=5)
TRAIN_KW = dict(batchsize=16, lr=2e-4, eps=16 / 255)
TRAIN_STEPS, TRAIN_IMAGES, TRAIN_TARGET = 20, 32, generation_target_classes[0]
SP_IMAGES = 8
CLI_TRAIN_IMAGES = 4
# phase 22: the defense suite
DEFENSE_TOL = 1e-5   # fp32 on the card against fp64 on the CPU: max|d| / max|ref|
MARGIN_TOL = 1e-3    # RS: a vote may flip only where the top-two logit margin is below this · max
DUNET_SIDE = 75      # an odd side: the encoder halves it to 38, 19, 10, 5
RS_IMAGES, RS_N = 8, 1000  # Smooth.predict and certify at the official N
DEFENSE_IMAGES = 4   # 22b's run_nrp and run_diffpure, 22c's CLI
# phase 23: the weights converter and the scripts
CONVERT_MODELS = ("resnet50", "mobilenet_v2", "densenet121", "vit_base_patch16_224")
CONVERT_TOL = 1e-6   # converted vs straight from the state_dict: max|d| / max|ref|
TOOLS_TARGET_S = 2.0  # the family bench's and the ViT profile's calibration (10 s in full)
# phase 24: segments of the main path; the CLI's targeted run and its segments
RESUME_EVERY = 3
CLI_RESUME_EPOCH, CLI_RESUME_EVERY, CLI_RESUME_IMAGES = 300, 50, 32
# 24d: a key for each rule of the runner's split, at official hyperparameters
SPLIT_KEYS = (("vmifgsm", "rule 1, draws shaped by the batch on axis 0"),
              ("foolmix", "rule 1, draws shaped by the batch on axis 1"),
              ("admix", "rule 2, partners from the whole batch"),
              ("potrip", "rule 3, a clamped mean over the batch"),
              ("tgr", "a key no earlier run held against one process"))
SPLIT_SEED = 24
# three calls a key keep 24d within a minute: POTRIP at a third of its 300
SPLIT_CAPS = {"potrip": {"epoch": 100}}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def update_inputs(shape, gen, dev):
    """delta in and out of the eps-ball, momentum with exact zeros, x with
    pixels on both bounds."""
    d = torch.randn(shape, generator=gen, device=dev) * 0.05
    m = torch.randn(shape, generator=gen, device=dev)
    m[torch.rand(shape, generator=gen, device=dev) < 0.05] = 0.0
    x = torch.rand(shape, generator=gen, device=dev)
    x[torch.rand(shape, generator=gen, device=dev) < 0.05] = 0.0
    x[torch.rand(shape, generator=gen, device=dev) < 0.05] = 1.0
    return d, m, x


def errors(out, ref):
    """max|out - ref| and its ratio to max|ref|, in fp64."""
    ref = ref.double()
    err = float((out.double() - ref).abs().max())
    return err, err / (float(ref.abs().max()) or 1.0)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bank_seams(atk, rng) -> None:
    """Route every random draw of ``atk`` through its seams to the numpy
    stream ``rng``: two attacks given streams of one seed draw the same
    values, on any device."""
    dev = atk.device

    def uniform(shape, r):
        return torch.from_numpy(rng.uniform(-r, r, shape).astype(np.float32)).to(dev)

    def start(x):  # a box-clipped uniform(-eps, eps) random start
        return torch.clamp(x + uniform(x.shape, atk.eps), 0, 1) - x

    def aux_labels(y, num_classes):  # distinct, none the true class
        scores = rng.rand(y.shape[0], num_classes)
        scores[np.arange(y.shape[0]), y.cpu().numpy()] = np.inf
        return torch.from_numpy(scores.argsort(axis=1)[:, :atk.aux_num].T.copy()).to(dev)

    seams = {
        # MEF draws all its neighbours at once
        "neighbor_noise": lambda gen, x, state: uniform(
            ((atk.num_neighbor,) if isinstance(atk, MEF) else ()) + x.shape, 2 * EPS),
        "spectral_draws": lambda gen, x, state: (
            uniform((atk.max_iter,) + x.shape, 2 * EPS),
            1 + uniform((atk.max_iter,) + x.shape, 0.7)),
        "pixel_blocks": lambda gen, x, step: uniform((atk.n,) + x.shape, 0.2),
        "other_labels": lambda gen, batch, step: torch.from_numpy(
            rng.randint(0, atk.model.num_classes, (atk.n, atk.z, batch))).to(dev),
        "sample_aux_labels": lambda gen, y, num_classes: aux_labels(y, num_classes),
        "restart_delta": lambda gen, x, *where: start(x),
        "init_n_rap": lambda gen, point: uniform(point.shape, atk.epsilon_n),
    }
    for name, seam in seams.items():
        if hasattr(atk, name):
            setattr(atk, name, seam)


def expected_launches(key: str, atk) -> int:
    """The update-kernel launches of one call of ``key``, as its code
    implies them."""
    if key in OWN_CLIP:
        return 0
    if key == "dta":  # each of K inner steps, then the outer one
        return atk.epoch * (atk.K + 1)
    if key == "gifgsm":
        return atk.pre_epoch + atk.epoch
    if key == "rgmifgsm":
        return atk.num_directions * atk.pre_epoch + atk.epoch
    return atk.epoch


def run_gradient_family(dev, smi) -> dict:
    """Phase 11; returns each key's update-kernel launches in its 11b call."""
    # (a) the card against the CPU
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(11)
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    models = {where: make_model("resnet18", pretrained=False, input_size=64, device=where)
              for where in ("cuda", "cpu")}
    for key in GRADIENT_KEYS:
        deltas = {}
        for where, model in models.items():
            atk = tt.load_attack_class(key)(model_name=model, epoch=2, device=where,
                                            **GRADIENT_SMALL.get(key, {}))
            bank_seams(atk, np.random.RandomState(12))
            deltas[where] = atk(xs, ys).cpu().numpy()
        agree = float((np.sign(deltas["cuda"]) == np.sign(deltas["cpu"])).mean())
        check(agree > 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
        check(0 < np.abs(deltas["cuda"]).max() <= EPS + 1e-6, f"{key}: |delta|inf on the card")
        print(f"[11a gradient] {key}: ResNet-18 64², batch 2, 2 iterations, fp32: delta "
              f"sign agreement card vs CPU {agree:.6f}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del models

    # (b) full width
    surrogate = make_model("resnet50", device="cuda")
    surrogate.module.to(torch.bfloat16)
    surrogate.compute_dtype = torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(13).rand(GRADIENT_BATCH, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        logits0 = surrogate.apply(x)
    y = logits0.argmax(-1)
    ce0 = float(softmax_cross_entropy(logits0, y).mean())
    launches = {}
    for key in GRADIENT_KEYS:
        atk = tt.load_attack_class(key)(model_name=surrogate, compute_dtype="bfloat16",
                                        device="cuda", **GRADIENT_CAPS.get(key, {}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[key] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = expected_launches(key, atk)
        check(launches[key] == want,
              f"{key}: {launches[key]} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{key}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        check(0.0 < linf <= EPS + 1e-6, f"{key}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{key}: x + delta leaves [0, 1]")
        with torch.no_grad():
            ce1 = float(softmax_cross_entropy(surrogate.apply(adv), y).mean())
        check(ce1 > ce0, f"{key}: cross-entropy did not rise: {ce0} -> {ce1}")
        caps = GRADIENT_CAPS.get(key)
        reduced = ("; reduced: " + ", ".join(
            f"{k} {official_defaults(key)[k]} -> {v}" for k, v in caps.items())
            if caps else "")
        print(f"[11b gradient] {key}: ResNet-50 bf16, batch {GRADIENT_BATCH}, 224²: "
              f"{atk.grad_evals} gradient evaluations (batches of {GRADIENT_BATCH}), "
              f"{launches[key]} update-kernel launches, {secs:.3f} s, "
              f"{GRADIENT_BATCH / secs:.2f} img/s, peak memory {peak:.2f} GiB, "
              f"|delta|inf*255 = {linf * 255:.4f}, CE {ce0:.4f} -> {ce1:.4f} on {smi}"
              f"{reduced}")
        print(json.dumps({"gradient_key": key, "grad_evals": atk.grad_evals,
                          "launches": launches[key], "seconds": secs,
                          "img_per_s": GRADIENT_BATCH / secs, "peak_gib": peak,
                          "ce": [ce0, ce1], "reduced": caps or {}}))
        del atk, delta, adv
    return launches


def on_device(state, dev):
    """``state`` with every tensor, those in its ``extra`` dicts too, on ``dev``."""
    def move(v):
        if isinstance(v, dict):
            return {k: move(u) for k, u in v.items()}
        return v.to(dev) if torch.is_tensor(v) else v

    return dataclasses.replace(state, delta=state.delta.to(dev),
                               momentum=state.momentum.to(dev), extra=move(state.extra))


def step_cosine(atks, xs, ys, seed: int, step_seed: int) -> float:
    """The least cosine over two steps between the card's and the CPU's
    gradient, each card step from the CPU's state, with the same draws."""
    x = {w: torch.from_numpy(xs).to(w) for w in atks}
    y = {w: torch.from_numpy(ys).to(w) for w in atks}
    gen = torch.Generator().manual_seed(seed)
    state = atks["cpu"].init_state(x["cpu"], y["cpu"], gen)
    cos = 1.0
    for t in range(2):
        g = {w: atks[w].get_grad(x[w], y[w], on_device(state, w),
                                 torch.Generator().manual_seed(step_seed + t))[0].cpu()
             for w in atks}
        cos = min(cos, float((g["cuda"] * g["cpu"]).sum() / g["cuda"].norm() / g["cpu"].norm()))
        state = atks["cpu"].step(x["cpu"], y["cpu"], state, gen)
    return cos


def map_step_cosine(models, xs, ys) -> float:
    """DeCowA at its official rho, card against CPU (``step_cosine``)."""
    atks = {w: tt.load_attack_class("decowa")(model_name=m, epoch=2, device=w, num_warping=2)
            for w, m in models.items()}
    return step_cosine(atks, xs, ys, 22, 50)


def run_input_family(dev, smi) -> dict:
    """Phase 12; returns each key's update-kernel launches in its 12b call."""
    # (a) the card against the CPU, one seeded CPU generator for both
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(21)
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    models = {where: make_model("resnet18", pretrained=False, input_size=64, device=where)
              for where in ("cuda", "cpu")}
    for key in INPUT_KEYS:
        deltas = {}
        for where, model in models.items():
            atk = tt.load_attack_class(key)(model_name=model, epoch=2, device=where,
                                            **INPUT_SMALL.get(key, {}))
            deltas[where] = atk(xs, ys, generator=torch.Generator().manual_seed(22)).cpu().numpy()
        agree = float((np.sign(deltas["cuda"]) == np.sign(deltas["cpu"])).mean())
        check(agree > 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
        check(0 < np.abs(deltas["cuda"]).max() <= EPS + 1e-6, f"{key}: |delta|inf on the card")
        print(f"[12a input] {key}: ResNet-18 64², batch 2, 2 iterations, fp32: delta "
              f"sign agreement card vs CPU {agree:.6f}")
    cos = map_step_cosine(models, xs, ys)
    check(cos > 0.99, f"decowa at rho 0.01: gradient cosine card vs CPU {cos}")
    print(f"[12a input] decowa at its official rho 0.01, each step from the CPU's state: "
          f"gradient cosine card vs CPU {cos:.8f} (at least)")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del models

    # (b) full width
    surrogate = make_model("resnet50", device="cuda")
    surrogate.module.to(torch.bfloat16)
    surrogate.compute_dtype = torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(23).rand(GRADIENT_BATCH, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        logits0 = surrogate.apply(x)
    y = logits0.argmax(-1)
    launches = {}
    for key in INPUT_KEYS:
        atk = tt.load_attack_class(key)(model_name=surrogate, compute_dtype="bfloat16",
                                        device="cuda", **INPUT_CAPS.get(key, {}))
        # a targeted key attacks a class the surrogate does not predict
        labels = (y + 500) % 1000 if atk.targeted else y
        ce0 = float(softmax_cross_entropy(logits0, labels).mean())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[key] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = 0 if key == "anda" else atk.epoch
        check(launches[key] == want,
              f"{key}: {launches[key]} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{key}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        check(0.0 < linf <= EPS + 1e-6, f"{key}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{key}: x + delta leaves [0, 1]")
        with torch.no_grad():
            ce1 = float(softmax_cross_entropy(surrogate.apply(adv), labels).mean())
        way = "fell" if atk.targeted else "rose"
        check(ce1 < ce0 if atk.targeted else ce1 > ce0,
              f"{key}: cross-entropy to its labels did not move the attack's way: "
              f"{ce0} -> {ce1}")
        caps = INPUT_CAPS.get(key)
        reduced = ("; reduced: " + ", ".join(
            f"{k} {official_defaults(key)[k]} -> {v}" for k, v in caps.items())
            if caps else "")
        print(f"[12b input] {key}: ResNet-50 bf16, batch {GRADIENT_BATCH}, 224²: "
              f"{atk.grad_evals} gradient evaluations (batches of {GRADIENT_BATCH}), "
              f"{launches[key]} update-kernel launches, {secs:.3f} s, "
              f"{GRADIENT_BATCH / secs:.2f} img/s, peak memory {peak:.2f} GiB, "
              f"|delta|inf*255 = {linf * 255:.4f}, CE {ce0:.4f} -> {ce1:.4f} ({way}) on {smi}"
              f"{reduced}")
        print(json.dumps({"input_key": key, "grad_evals": atk.grad_evals,
                          "launches": launches[key], "seconds": secs,
                          "img_per_s": GRADIENT_BATCH / secs, "peak_gib": peak,
                          "ce": [ce0, ce1], "targeted": atk.targeted,
                          "reduced": caps or {}}))
        del atk, delta, adv
        torch.cuda.empty_cache()
    return launches


def write_anchors(root: str, classes) -> str:
    """AA's ``input_dir``: one seeded 224² PNG a class and a 1-indexed
    ``labels.csv``."""
    names = [f"anchor_{c:04d}.png" for c in classes]
    save_images(os.path.join(root, "images"),
                np.random.RandomState(31).rand(len(names), 224, 224, 3).astype(np.float32),
                names)
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("filename,label\n" + "".join(f"{n},{c + 1}\n" for n, c in zip(names, classes)))
    return root


def objective_launches(key: str, atk) -> int:
    """The update-kernel launches of one call of ``key``, as its code
    implies them: none where every step clips on its own (P2FA, YAILA), the
    main loop only where another phase does (TRAP's second phase, BFA's
    warm-up, FFT's fine-tune; for TRAP ``epoch`` is its baseline's), and
    ILA's two loops."""
    if key in ("p2fa", "yaila"):
        return 0
    return 2 * atk.epoch if key == "ila" else atk.epoch


def objective_of(key: str, atk, x, y, gen):
    """(what, f(adv) -> float, way): the quantity ``key`` optimises, read at
    an adversarial batch, and +1 where it rises, -1 where it falls.  Where
    the key weighs features by an estimate of its own (FIA's family, NAA,
    DANAA, P2FA, MFAA), the estimate is drawn afresh from ``gen``; where it
    follows a baseline (ILA, TRAP), the baseline is run again."""
    model = atk.model
    labels = y[:, 1] if y.ndim == 2 else y

    def feat(a, layer):
        return model.feature(a, layer)[1]

    def mean_logit(a):
        return float(model.apply(a).gather(1, labels[:, None]).mean())

    if key in ("logit", "cfm", "ftm", "fft"):
        return "mean target logit", mean_logit, 1
    if key == "taig":
        return "mean label logit", mean_logit, -1
    if key == "logit_margin":
        # its loss is CE at a temperature of the top-2 margin, which a tie
        # of bf16 logits at the clean image leaves undefined
        return "CE to the target", lambda a: float(
            softmax_cross_entropy(model.apply(a), labels).mean()), -1
    if key in ("potrip", "fuzziness_tuned"):
        return "its loss", lambda a: float(atk.get_loss(model.apply(a)[None], y)), 1
    if key == "tap":
        with torch.no_grad():
            orig = model.apply_with_feats(x, "stage")[1]
        return "TAP loss", lambda a: float(atk.tap_loss(x, y, a - x, orig)), 1
    if key in ("ir", "ilpd", "yaila"):
        # IR: -CE minus the interaction, descended; ILPD: CE through its
        # tap; YAILA: the projection on the CE its ridge fit regresses
        return "CE", lambda a: float(softmax_cross_entropy(model.apply(a), y).mean()), 1
    if key in ("fia", "rpa", "fmaa", "bfa"):
        w = atk.aggregate_grad(x, y, gen)
        return ("sum feature * weight", lambda a: float((feat(a, atk.feature_layer) * w).sum()),
                int(atk.step_sign))
    if key in ("naa", "danaa"):
        w, base = atk.baseline_and_agg(x, y, gen)
        return ("attribution", lambda a: float(atk.attribution_loss(
            feat(a, atk.feature_layer), base, w)), int(atk.step_sign))
    if key == "p2fa":
        g = atk._aggregate_grad(x, y)
        return "sum feature * aggregate", lambda a: float((feat(a, atk.feature_layer) * g).sum()), 1
    if key == "aa":
        with torch.no_grad():
            f_t = feat(atk._tar_data, atk.feature_layer)
        return ("feature distance to the anchors", lambda a: float(
            (f_t - feat(a, atk.feature_layer)).reshape(len(a), -1).norm(dim=1).mean()), -1)
    if key == "ata":
        cam0 = atk._cam(x, y, False)[0].detach()
        return ("CE + CAM term", lambda a: float(
            softmax_cross_entropy(model.apply(a), y).mean()
            + atk.lamda * ((atk._cam(a, y, False)[0] - cam0) ** 2).sum()), 1)
    if key == "mfaa":
        last = atk._taps[-1]
        g = atk._guidance(x, y, gen)[last]
        return f"sum {last} * guidance", lambda a: float((feat(a, last) * g).sum()), 1
    if key == "ila":
        base = Attack.run(atk, x, y, gen)
        with torch.no_grad():
            f0 = feat(x, atk.feature_layer)
            xdir = (feat(x + base, atk.feature_layer) - f0).reshape(-1)
        return ("projection on the baseline's direction", lambda a: float(
            ((feat(a, atk.feature_layer) - f0).reshape(-1) * xdir).sum() / xdir.norm() ** 2), 1)
    if key == "trap":
        base = MIFGSM.run(atk, x, y, gen)
        with torch.no_grad():
            h_x = feat(x, atk.feature_layer)
            xdir = (feat(x + base, atk.feature_layer) - h_x).reshape(-1)

        def angle_and_ratio(a):
            ydir = (feat(a, atk.feature_layer) - h_x).reshape(-1)
            return float((xdir * ydir).sum() / (xdir.norm() * ydir.norm() + 1e-12)
                         + atk.coeff * ydir.norm() / xdir.norm())
        return "angle + ratio to the baseline's displacement", angle_and_ratio, 1
    raise KeyError(key)


def run_objective_family(dev, smi) -> dict:
    """Phase 13; returns each key's update-kernel launches in its 13b call."""
    work = tempfile.mkdtemp()
    try:
        return _objective_family(dev, smi, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _objective_family(dev, smi, work) -> dict:
    # (a) the card against the CPU, one seeded CPU generator for both
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(41)
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    pairs = np.stack([ys, (ys + 500) % 1000], axis=1)
    anchors_a = write_anchors(os.path.join(work, "anchors_a"), sorted(set(pairs[:, 1])))
    models = {where: make_model("resnet18", pretrained=False, input_size=64, device=where)
              for where in ("cuda", "cpu")}
    for key in OBJECTIVE_KEYS:
        kw = {"epoch": 2, **OBJECTIVE_SMALL.get(key, {})}
        if key == "aa":
            kw["input_dir"] = anchors_a
        labels = pairs if key in OBJECTIVE_TARGETED else ys
        deltas = {}
        for where, model in models.items():
            atk = tt.load_attack_class(key)(model_name=model, device=where, **kw)
            deltas[where] = atk(xs, labels,
                                generator=torch.Generator().manual_seed(42)).cpu().numpy()
        agree = float((np.sign(deltas["cuda"]) == np.sign(deltas["cpu"])).mean())
        check(agree > 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
        check(0 < np.abs(deltas["cuda"]).max() <= atk.eps + 1e-6,
              f"{key}: |delta|inf on the card")
        print(f"[13a objective] {key}: ResNet-18 64², batch 2, fp32: delta sign agreement "
              f"card vs CPU {agree:.6f}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del models

    # (b) full width
    surrogate = make_model("resnet50", device="cuda")
    surrogate.module.to(torch.bfloat16)
    surrogate.compute_dtype = torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(43).rand(GRADIENT_BATCH, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        logits0 = surrogate.apply(x)
    y = logits0.argmax(-1)
    pairs = torch.stack([y, (y + 500) % 1000], dim=1)
    anchors_b = write_anchors(os.path.join(work, "anchors_b"),
                              sorted(set(pairs[:, 1].tolist())))
    launches, total = {}, 0.0
    for key in OBJECTIVE_KEYS:
        kw = {"input_dir": anchors_b} if key == "aa" else {}
        atk = tt.load_attack_class(key)(model_name=surrogate, compute_dtype="bfloat16",
                                        device="cuda", **kw)
        labels = pairs if atk.targeted else y
        ce_labels = pairs[:, 1] if atk.targeted else y
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total += secs
        launches[key] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        grad_evals = atk.grad_evals
        want = objective_launches(key, atk)
        check(launches[key] == want,
              f"{key}: {launches[key]} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{key}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        check(0.0 < linf <= atk.eps + 1e-6, f"{key}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{key}: x + delta leaves [0, 1]")
        what, value, way = objective_of(key, atk, x, atk.prepare_labels(labels),
                                        torch.Generator(device=dev).manual_seed(44))
        before, after = value(x), value(adv)
        with torch.no_grad():
            ce0 = float(softmax_cross_entropy(logits0, ce_labels).mean())
            ce1 = float(softmax_cross_entropy(surrogate.apply(adv), ce_labels).mean())
        check((after - before) * way > 0,
              f"{key}: its objective ({what}) did not {'rise' if way > 0 else 'fall'}: "
              f"{before} -> {after}")
        print(f"[13b objective] {key}: ResNet-50 bf16, batch {GRADIENT_BATCH}, 224²: "
              f"{grad_evals} gradient evaluations (batches of {GRADIENT_BATCH}), "
              f"{launches[key]} update-kernel launches, {secs:.3f} s, "
              f"{GRADIENT_BATCH / secs:.2f} img/s, peak memory {peak:.2f} GiB, "
              f"|delta|inf*255 = {linf * 255:.4f}, {what} {before:.6g} -> {after:.6g} "
              f"({'rose' if way > 0 else 'fell'}), CE {ce0:.4f} -> {ce1:.4f} on {smi}")
        print(json.dumps({"objective_key": key, "grad_evals": grad_evals,
                          "launches": launches[key], "seconds": secs,
                          "img_per_s": GRADIENT_BATCH / secs, "peak_gib": peak,
                          "objective": what, "value": [before, after], "ce": [ce0, ce1],
                          "targeted": atk.targeted, "reduced": {}}))
        del atk, delta, adv
        torch.cuda.empty_cache()
    print(f"[13b objective] {len(OBJECTIVE_KEYS)} keys in {total:.1f} s of attack")
    return launches


def model_related_launches(key: str, atk) -> int:
    """The update-kernel launches of one call of ``key``, as its code
    implies them: MetaSSA's n_sample inner steps and its outer one an
    iteration, one an iteration for the rest."""
    if key == "metassa":
        return atk.epoch * (atk.n_sample + 1)
    return atk.epoch


def mup_card_vs_cpu(atks, xs, ys) -> tuple:
    """MUP, card against CPU: the least mask agreement over the conv kernels
    at the CPU's state after one step, and the delta sign agreement with the
    card's masks taken from the CPU's at the card's own state.  A mask is an
    order statistic of |w·∂L/∂w|, so a last-bit difference in a parameter
    gradient can move an element across it, and a pruned ResNet-18 feels it."""
    cpu, on_card = atks["cpu"], atks["cuda"]
    x = {w: torch.from_numpy(xs).to(w) for w in atks}
    y = {w: torch.from_numpy(ys).to(w) for w in atks}
    state = cpu.step(x["cpu"], y["cpu"], cpu.init_state(x["cpu"], y["cpu"], None), None)
    want = cpu._pruned_params(x["cpu"], y["cpu"], state)
    got = on_card._pruned_params(x["cuda"], y["cuda"], dataclasses.replace(
        state, delta=state.delta.cuda()))
    masks = min(float(((got[k] != 0).cpu() == (want[k] != 0)).float().mean()) for k in want)

    def cpu_masks(self, a, b, st):
        ref = cpu._pruned_params(a.cpu(), b.cpu(), dataclasses.replace(st, delta=st.delta.cpu()))
        return {k: w * (ref[k] != 0).to(a.device, w.dtype)
                for k, w in self.model.parameters().items() if k in ref}

    on_card._pruned_params = cpu_masks.__get__(on_card)
    d = {w: atks[w](xs, ys, generator=torch.Generator().manual_seed(52)).cpu().numpy()
         for w in atks}
    return masks, float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())


def awt_at_official_rate(atk, x, y) -> str:
    """One SAM update of ``atk`` at AWT's official rate from the surrogate's
    weights: the logits' largest magnitude before and after it, and the
    input gradient's through the tuned weights."""
    official = official_defaults("awt")["sam_lr"]
    rate, atk.sam_lr = atk.sam_lr, official
    try:
        state = atk.init_state(x, y, None)
        params = atk._sam_update(state.extra["params"], state.extra["sgd_buf"],
                                 state.extra["grad_residue"], x, state.delta, y)[0]
        with torch.no_grad():
            before = float(atk.model.apply(x).abs().max())
            after = float(atk.model.apply(x, params=params).abs().max())
        grad = float(atk._grads_at(params, x[None], y).abs().max())
    finally:
        atk.sam_lr = rate
    return (f"one SAM step at the official sam_lr {official:g}: max|logit| {before:.4g} -> "
            f"{after:.4g}, max|input gradient| through the tuned weights {grad:.4g}")


def run_model_related_family(dev, smi) -> dict:
    """Phase 14; returns each key's update-kernel launches in its 14b call."""
    # (a) the card against the CPU, one seeded CPU generator for both
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(51)
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    for key in MODEL_RELATED_KEYS:
        kw = {"epoch": 2, "input_size": 64, **MODEL_RELATED_SMALL.get(key, {})}
        kw.update({"base_arch": "resnet18"} if key == "ags" else {"model_name": "resnet18"})
        with warnings.catch_warnings():  # no checkpoints here: the base weights
            warnings.simplefilter("ignore")
            atks = {w: tt.load_attack_class(key)(device=w, **kw) for w in ("cuda", "cpu")}
        if key == "mup":
            masks, agree = mup_card_vs_cpu(atks, xs, ys)
            check(masks >= 1 - 1e-4, f"mup: conv masks card vs CPU agree on {masks}")
            extra = f"; conv masks agree on at least {masks:.6f} (with the CPU's masks:)"
        elif key == "awt":
            # a whole AWT run amplifies rounding (on the CPU alone, weights
            # moved by 1e-6 part its 2-iteration delta to a sign agreement of
            # 0.991), so it is held step by step, each from the CPU's state
            cos = step_cosine(atks, xs, ys, 52, 53)
            check(cos > 0.99, f"awt: gradient cosine card vs CPU {cos}")
            print(f"[14a model_related] awt: ResNet-18 64², batch 2, fp32, each step from the "
                  f"CPU's state: gradient cosine card vs CPU {cos:.8f} (at least)")
            continue
        else:
            d = {w: atks[w](xs, ys, generator=torch.Generator().manual_seed(52)).cpu().numpy()
                 for w in atks}
            agree, extra = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean()), ""
        check(agree > 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
        print(f"[14a model_related] {key}: ResNet-18 64², batch 2, 2 iterations, fp32{extra} "
              f"delta sign agreement card vs CPU {agree:.6f}")
        del atks
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # (b) full width, each key at its own default model
    shared = make_model("resnet50", device="cuda")
    shared.module.to(torch.bfloat16)
    shared.compute_dtype = torch.bfloat16
    x224 = torch.from_numpy(np.random.RandomState(53).rand(GRADIENT_BATCH, 224, 224, 3)
                            .astype(np.float32)).to(dev)
    x299 = torch.from_numpy(np.random.RandomState(54).rand(GRADIENT_BATCH, 299, 299, 3)
                            .astype(np.float32)).to(dev)
    launches, total = {}, 0.0
    runs = [(k, {}) for k in MODEL_RELATED_KEYS] + [("ghost", {"model_name": "inc_v3"})]
    for key, kw in runs:
        kw = {**kw, **MODEL_RELATED_CAPS.get(key, {})}
        if key not in OWN_SURROGATE:
            kw["model_name"] = shared
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            atk = tt.load_attack_class(key)(compute_dtype="bfloat16", device="cuda", **kw)
        x = x299 if kw.get("model_name") == "inc_v3" else x224
        model = atk.model
        with torch.no_grad():
            logits0 = model.apply(x)
        y = logits0.argmax(-1)
        if key == "awt":
            print(f"[14b model_related] awt: {awt_at_official_rate(atk, x, y)} on {smi}")
            atk.grad_evals = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total += secs
        n = launches[key if x is x224 else f"{key}_inc_v3"] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = model_related_launches(key, atk)
        check(n == want, f"{key}: {n} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{key}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        check(0.0 < linf <= atk.eps + 1e-6, f"{key}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{key}: x + delta leaves [0, 1]")
        with torch.no_grad():
            ce0 = float(softmax_cross_entropy(logits0, y).mean())
            ce1 = float(softmax_cross_entropy(model.apply(adv), y).mean())
            if key == "ags":
                mid0 = model.feature(x, atk.feature_layer)[1]
                what = f"feature dissimilarity at {atk.feature_layer}"
                before = float(atk.dissimilarity(x, mid0).mean())
                after = float(atk.dissimilarity(adv, mid0).mean())
            else:
                what, before, after = "CE", ce0, ce1
        check(after > before, f"{key}: its objective ({what}) did not rise: {before} -> {after}")
        arch = ("Inception-v3 bf16, 299²" if x is x299 else
                f"{'ResNet-18' if key in ('mta', 'dsm') else 'ResNet-50'} bf16, 224²")
        caps = MODEL_RELATED_CAPS.get(key)
        reduced = ("; reduced: " + ", ".join(
            f"{k} {official_defaults(key)[k]} -> {v}" for k, v in caps.items()) if caps else "")
        print(f"[14b model_related] {key}: {arch}, batch {GRADIENT_BATCH}: {atk.grad_evals} "
              f"gradient evaluations (batches of {GRADIENT_BATCH}), {n} update-kernel launches, "
              f"{secs:.3f} s, {GRADIENT_BATCH / secs:.2f} img/s, peak memory {peak:.2f} GiB, "
              f"|delta|inf*255 = {linf * 255:.4f}, {what} {before:.6g} -> {after:.6g} (rose), "
              f"CE {ce0:.4f} -> {ce1:.4f} on {smi}{reduced}")
        print(json.dumps({"model_related_key": key, "model": arch, "grad_evals": atk.grad_evals,
                          "launches": n, "seconds": secs, "img_per_s": GRADIENT_BATCH / secs,
                          "peak_gib": peak, "objective": what, "value": [before, after],
                          "ce": [ce0, ce1], "reduced": caps or {}}))
        del atk, model, delta, adv, logits0
        torch.cuda.empty_cache()
    print(f"[14b model_related] {len(runs)} calls in {total:.1f} s of attack")
    return launches


def vit_launches(key: str, atk) -> int:
    """The update-kernel launches of one call of ``key``, as its code
    implies them: ATA-ViT steps by its own Adam (none), the others one an
    iteration."""
    return 0 if key == "ata_vit" else atk.epoch


def narrow_surrogate(builder, kw, dev):
    """A narrow ViT-family surrogate at 32², seeded weights, on ``dev``."""
    module = WrappedModel(builder(num_classes=1000, img_size=32, **kw), 32,
                          IMAGENET_MEAN, IMAGENET_STD)
    init_weights(module, torch.Generator().manual_seed(61))
    module.eval().requires_grad_(False).to(dev)
    return Surrogate(name="narrow", module=module, input_size=32)


def plain_view(model):
    """``model`` with no surgery in its forward (SAPR's draws a generator)."""
    return dataclasses.replace(model, forward_kwargs=(
        {"surgery": ViTSurgery()} if hasattr(model.module.backbone, "surgery") else {}))


def vit_objective(key: str, atk, x, y, adv) -> tuple:
    """(what, before, after) of the objective ``key`` raises, on the plain
    surrogate: log(1 − p_y) for ATA-ViT (its Adam lowers −log(1 − p_y)), CE
    for the rest."""
    plain = plain_view(atk.model)
    with torch.no_grad():
        if key == "ata_vit":
            ones = torch.ones_like(x[..., :1])
            return ("log(1 - p_y)", -float(atk._patch_loss(x, x, ones, y)),
                    -float(atk._patch_loss(x, adv, ones, y)))
        return ("CE", float(softmax_cross_entropy(plain.apply(x), y).mean()),
                float(softmax_cross_entropy(plain.apply(adv), y).mean()))


def run_vit_family(dev, smi) -> dict:
    """Phase 15; returns each call's update-kernel launches in 15b."""
    # (a) the card against the CPU, one seeded CPU generator for both
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(61)
    xs = rng.rand(2, 32, 32, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    narrow = {w: {"vit": narrow_surrogate(VisionTransformer, VIT_NARROW, w),
                  "cait": narrow_surrogate(Cait, CAIT_NARROW, w)} for w in ("cuda", "cpu")}
    for key, arch in [(k, "vit") for k in VIT_KEYS] + [("tgr", "cait")]:
        kw = {"epoch": 2, **VIT_SMALL.get(key, {})}
        with warnings.catch_warnings():  # SETR: no TRM checkpoint here
            warnings.simplefilter("ignore")
            atks = {w: tt.load_attack_class(key)(model_name=narrow[w][arch], device=w, **kw)
                    for w in narrow}
        d = {w: atks[w](xs, ys, generator=torch.Generator().manual_seed(62)).cpu().numpy()
             for w in atks}
        agree = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
        check(agree >= 0.99, f"{key} on the narrow {arch}: fp32 delta sign agreement card vs "
              f"CPU {agree}")
        print(f"[15a vit] {key}: narrow {'CaiT (class attention hooked)' if arch == 'cait' else 'ViT'} "
              f"at 32², batch 2, 2 iterations, fp32: delta sign agreement card vs CPU {agree:.6f}")
        del atks
    del narrow
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # (b) full width, each key at its own default surrogate
    shared = make_model("vit_base_patch16_224", device="cuda")
    x224 = torch.from_numpy(np.random.RandomState(63).rand(GRADIENT_BATCH, 224, 224, 3)
                            .astype(np.float32)).to(dev)
    x299 = torch.from_numpy(np.random.RandomState(64).rand(GRADIENT_BATCH, 299, 299, 3)
                            .astype(np.float32)).to(dev)
    launches, total, incres = {}, 0.0, None
    runs = ([(k, {}) for k in VIT_KEYS] + [("tgr", {"model_name": "cait_s24_224"})]
            + [("ghost", {"model_name": "inc_res"}), ("dhf", {"model_name": "inc_res"})])
    for key, kw in runs:  # official hyperparameters: no cap is needed
        kw = dict(kw)
        name = kw.get("model_name", "vit_base_patch16_224")
        if key == "dhf":  # the Ghost call's Inception-ResNet-v2, without ghost draws
            kw["model_name"] = incres
        elif "model_name" not in kw:
            kw["model_name"] = shared
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            atk = tt.load_attack_class(key)(compute_dtype="bfloat16", device="cuda", **kw)
        if key == "ghost":
            incres = atk.model
        x = x299 if name == "inc_res" else x224
        with torch.no_grad():
            y = plain_view(atk.model).apply(x).argmax(-1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total += secs
        tag = key if name == "vit_base_patch16_224" else f"{key}_{name}"
        n = launches[tag] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = vit_launches(key, atk)
        check(n == want, f"{tag}: {n} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{tag}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        bound = 1.0 if key == "ata_vit" else atk.eps  # a patch attack: unbounded in its mask
        check(0.0 < linf <= bound + 1e-6, f"{tag}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{tag}: x + delta leaves [0, 1]")
        what, before, after = vit_objective(key, atk, x, y, adv)
        check(after > before, f"{tag}: its objective ({what}) did not rise: {before} -> {after}")
        arch = {"vit_base_patch16_224": "ViT-B/16 bf16, 224²", "cait_s24_224": "CaiT-S24 bf16, "
                "224²", "inc_res": "Inception-ResNet-v2 bf16, 299²"}[name]
        print(f"[15b vit] {tag}: {arch}, batch {GRADIENT_BATCH}: {atk.grad_evals} gradient "
              f"evaluations (batches of {GRADIENT_BATCH}), {n} update-kernel launches, "
              f"{secs:.3f} s, {GRADIENT_BATCH / secs:.2f} img/s, "
              f"{1e3 * secs / max(atk.grad_evals, 1):.1f} ms an evaluation, peak memory "
              f"{peak:.2f} GiB, |delta|inf*255 = {linf * 255:.4f}, {what} {before:.6g} -> "
              f"{after:.6g} (rose) on {smi}")
        print(json.dumps({"vit_key": tag, "model": arch, "grad_evals": atk.grad_evals,
                          "launches": n, "seconds": secs, "img_per_s": GRADIENT_BATCH / secs,
                          "ms_per_eval": 1e3 * secs / max(atk.grad_evals, 1),
                          "peak_gib": peak, "objective": what, "value": [before, after],
                          "reduced": {}}))
        del atk, delta, adv
        torch.cuda.empty_cache()
    print(f"[15b vit] {len(runs)} calls in {total:.1f} s of attack")
    return launches


def rel_err(out, ref) -> float:
    """max|out - ref| / max|ref|, in fp64, on the CPU."""
    return errors(out.detach().cpu(), ref.detach().cpu())[1]


def op_card_vs_cpu(op: str) -> tuple:
    """IDAA's op ``op`` on 4 images at 64², one CPU generator's draws on
    both: (field error, warp error, input-gradient error), card vs CPU."""
    gen = torch.Generator().manual_seed(71 + tidaa.IDAA_OPS.index(op))
    x = torch.rand(4, 64, 64, 3, generator=gen)
    ct = torch.randn(4, 64, 64, 3, generator=gen)
    d = tidaa.op_draws(gen, op, 4, 64, 64)
    fields = {"perspective": lambda dd: tidaa.perspective_field(dd["d"], 64, 64),
              "tps": lambda dd: timage.tps_field(dd["offsets"], 64, 64),
              "elastic": lambda dd: (timage.gaussian_blur_sep(dd["noise"], 27, 33.0, 31.0),),
              "fisheye": lambda dd: timage.fisheye_field(dd["cx"], dd["cy"], dd["g"], 64, 64)}
    out, grads, field = {}, {}, {}
    for where in ("cuda", "cpu"):
        dd = {k: v.to(where) for k, v in d.items()}
        xs = x.to(where).requires_grad_(True)
        out[where] = tidaa.apply_op(op, xs, **dd)
        (grads[where],) = torch.autograd.grad((out[where] * ct.to(where)).sum(), xs)
        if op in fields:
            field[where] = fields[op](dd)
    f_err = max((rel_err(a, b) for a, b in zip(field.get("cuda", ()), field.get("cpu", ()))),
                default=0.0)
    return f_err, rel_err(out["cuda"], out["cpu"]), rel_err(grads["cuda"], grads["cpu"])


def backward_vs_fp64() -> dict:
    """``grid_sample``'s and the texture gather's input gradients on the card
    (fp32) against the CPU's in fp64, with the input in NCHW and in
    channels_last (the gather: a contiguous NHWC texture and a permuted NCHW
    one): max|d| / max|ref| each."""
    gen = torch.Generator().manual_seed(81)
    x = torch.rand(4, 3, 64, 64, generator=gen, dtype=torch.float64)
    grid = torch.rand(4, 64, 64, 2, generator=gen, dtype=torch.float64) * 2.4 - 1.2
    ct = torch.randn(4, 3, 64, 64, generator=gen, dtype=torch.float64)

    def sample_grad(inp, g, c):
        inp = inp.detach().requires_grad_(True)
        out = F.grid_sample(inp, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        return torch.autograd.grad((out * c).sum(), inp)[0]

    ref = sample_grad(x, grid, ct)
    res = {}
    for fmt, layout in (("NCHW", torch.contiguous_format), ("channels_last", torch.channels_last)):
        xc = x.float().cuda().contiguous(memory_format=layout)
        res[f"grid_sample {fmt}"] = rel_err(sample_grad(xc, grid.float().cuda(),
                                                        ct.float().cuda()), ref)
    tex = torch.rand(2, 96, 80, 3, generator=gen, dtype=torch.float64)
    v = torch.randint(0, 96, (2, 4096), generator=gen)
    u = torch.randint(0, 80, (2, 4096), generator=gen)
    w = torch.rand(2, 4096, 1, generator=gen, dtype=torch.float64)
    ctg = torch.randn(2, 4096, 3, generator=gen, dtype=torch.float64)
    b = torch.arange(2)[:, None]

    def gather_grad(t, bb, vv, uu, ww, cc):
        t = t.detach().requires_grad_(True)
        return torch.autograd.grad((t[bb, vv, uu] * ww * cc).sum(), t)[0]

    ref = gather_grad(tex, b, v, u, w, ctg)
    for fmt in ("NHWC", "channels_last"):
        t = tex.float().cuda()
        if fmt == "channels_last":  # an NHWC view of a channels_last NCHW tensor
            t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last) \
                .permute(0, 2, 3, 1)
        res[f"texture gather {fmt}"] = rel_err(gather_grad(
            t, b.cuda(), v.cuda(), u.cuda(), w.float().cuda(), ctg.float().cuda()), ref)
    return res


def raster_card_vs_cpu(mesh: str, seed: int) -> tuple:
    """ODI's render geometry and shading of 4 draws at 64² on ``mesh``, card
    against CPU: (share of equal hit masks, share of equal face ids where
    both hit, max colour difference where the face ids agree, share of
    pixels covered).  The image is smooth (bilinear from 8², so that a
    last-bit difference in a pixel's UV, times the canvas side, moves its
    colour by far less than the bar)."""
    gen = torch.Generator().manual_seed(seed)
    img = F.interpolate(torch.rand(4, 3, 8, 8, generator=gen), size=(64, 64), mode="bilinear",
                        align_corners=True).permute(0, 2, 3, 1).contiguous()
    draws = {"solid": torch.rand(4, 3, generator=gen),
             "elev": torch.randint(-35, 36, (4,), generator=gen),
             "azim": torch.randint(-35, 36, (4,), generator=gen),
             "dist": torch.rand(4, generator=gen),
             "angle": torch.randint(-35, 36, (4,), generator=gen),
             "light": torch.rand(4, 3, generator=gen), "ambient": torch.rand(4, generator=gen),
             "diffuse": torch.rand(4, generator=gen),
             "background": torch.rand(4, 64, 64, 3, generator=gen)}
    settings, tex_size = render3d.ODI_MODEL_SETTINGS[mesh], render3d.ODI_TEXTURE_SIZES[mesh]
    geo, col = {}, {}
    R, T = render3d.odi_camera(settings, draws)
    for where in ("cuda", "cpu"):
        m = render3d.load_mesh(mesh, device=where)
        geo[where] = [t.cpu() for t in render3d.rasterize(m, R, T, 64, 64)]
        col[where] = render3d.render_odi(img.to(where), m, settings, tex_size,
                                         draws, 64, 64).cpu()
    (hc, fc, _), (hp, fp, _) = geo["cuda"], geo["cpu"]
    both = hc & hp
    same = (fc == fp) & both
    agree_hit = float((hc == hp).float().mean())
    agree_fid = float(same.float().sum() / both.float().sum().clamp(min=1))
    diff = (col["cuda"] - col["cpu"]).abs().amax(-1).reshape(4, -1)
    col_err = float(diff[same].max()) if bool(same.any()) else 0.0
    return agree_hit, agree_fid, col_err, float(hp.float().mean())


def idaa_objective(key: str, atk, x, y2, adv) -> tuple:
    """(what, before, after, want) of the objective ``key`` optimizes, read
    on the plain surrogate at x and at x + delta (ODI: on its first
    iteration's render of both, the draws replayed from the call's seed):
    IDAA's CE(target) − γ·CE(source) falls; Everywhere's and ODI's summed
    target logit rises."""
    src, tgt = y2[:, 0], y2[:, 1]
    with torch.no_grad():
        if key == "idaa":
            def obj(a):
                lf = atk.model.apply(a).float()
                return float(softmax_cross_entropy(lf, tgt).mean()
                             - atk.gamma * softmax_cross_entropy(lf, src).mean())
            return "CE(target) - 0.1 CE(source)", obj(x), obj(adv), "fell"
        if key == "everywhere":
            def obj(a):
                return float(atk.model.apply(a).float().gather(1, tgt[:, None]).sum())
            return "summed target logit", obj(x), obj(adv), "rose"
        draws = atk.render_draws(torch.Generator(device=x.device).manual_seed(atk.seed),
                                 x.shape[0], 0, x.shape[1], x.shape[2])

        def obj(a):
            lf = atk.model.apply(atk.render(a, draws)).float()
            return float(lf.gather(1, tgt[:, None]).sum())
        return "summed target logit of its first render", obj(x), obj(adv), "rose"


def run_idaa_family(dev, smi) -> dict:
    """Phase 16; returns each call's update-kernel launches in 16b."""
    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for op in tidaa.IDAA_OPS:
        f_err, w_err, g_err = op_card_vs_cpu(op)
        check(max(f_err, w_err, g_err) <= FIELD_TOL,
              f"idaa op {op}: card vs CPU field {f_err}, warp {w_err}, gradient {g_err}")
        print(f"[16a idaa] op {op}, 4 images at 64², fp32, card vs CPU max|d|/max|ref|: "
              f"field {f_err:.3e}, warp {w_err:.3e}, input gradient {g_err:.3e}")
    for name, err in backward_vs_fp64().items():
        check(err <= FIELD_TOL, f"{name} backward on the card vs CPU fp64: {err}")
        print(f"[16a idaa] {name} backward, card fp32 vs CPU fp64: max|d|/max|ref| {err:.3e}")
    for i, mesh in enumerate(tt.load_attack_class("odi").SOURCE_OBJECTS):
        hit, fid, col, cover = raster_card_vs_cpu(mesh, 91 + i)
        check(hit >= 0.999 and fid >= 0.999 and col <= 1e-5,
              f"rasterizer on {mesh}: hit masks {hit}, face ids {fid}, colours {col}")
        print(f"[16a idaa] rasterizer on {mesh}, 4 renders at 64², card vs CPU: hit masks equal "
              f"on {hit:.6f} of pixels ({cover:.3f} covered), face ids on {fid:.6f} where both "
              f"hit, colours within {col:.3e} where they agree")
    rng = np.random.RandomState(72)
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    ys2 = np.stack([ys, (ys + 500) % 1000], 1)
    models = {w: make_model("resnet18", pretrained=False, input_size=64, device=w)
              for w in ("cuda", "cpu")}
    for key in IDAA_KEYS:
        d = {w: tt.load_attack_class(key)(model_name=m, device=w, **IDAA_SMALL[key])(
            xs, ys2, generator=torch.Generator().manual_seed(73)).cpu().numpy()
            for w, m in models.items()}
        agree = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
        check(agree >= 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
        check(0 < np.abs(d["cuda"]).max() <= EPS + 1e-6, f"{key}: |delta|inf on the card")
        print(f"[16a idaa] {key}: ResNet-18 64², batch 2, {IDAA_SMALL[key]}, fp32: delta sign "
              f"agreement card vs CPU {agree:.6f}")
    del models
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # (b) full width
    surrogate = make_model("resnet50", device="cuda")
    surrogate.module.to(torch.bfloat16)
    surrogate.compute_dtype = torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(74).rand(GRADIENT_BATCH, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        y = surrogate.apply(x).argmax(-1)
    y2 = torch.stack([y, (y + 500) % 1000], 1)
    launches = {}
    runs = [("idaa", None), ("everywhere", None)] + [
        ("odi", i) for i in range(len(tt.load_attack_class("odi").SOURCE_OBJECTS))]
    for key, obj in runs:
        caps = IDAA_CAPS.get(key)
        atk = tt.load_attack_class(key)(model_name=surrogate, compute_dtype="bfloat16",
                                        device="cuda", **(caps or {}))
        tag = key
        if obj is not None:  # one object for the whole call, through the draw seam
            tag = f"odi_{atk.SOURCE_OBJECTS[obj]}"
            draws = atk.render_draws

            def render_draws(gen, B, step, H, W, draws=draws, obj=obj):
                return {**draws(gen, B, step, H, W), "obj": obj}
            atk.render_draws = render_draws
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, y2)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches[tag] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = 0 if key == "idaa" else atk.epoch
        check(n == want, f"{tag}: {n} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{tag}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        check(0.0 < linf <= EPS + 1e-6, f"{tag}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{tag}: x + delta leaves [0, 1]")
        what, before, after, way = idaa_objective(key, atk, x, y2, adv)
        check(after < before if way == "fell" else after > before,
              f"{tag}: {what} did not move its way: {before} -> {after}")
        extra = {}
        if obj is not None:  # render ms an image: one batch's render, timed alone
            d0 = atk.render_draws(torch.Generator(device=dev).manual_seed(5), GRADIENT_BATCH, 0,
                                  224, 224)
            with torch.no_grad():
                atk.render(x, d0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                atk.render(x, d0)
                torch.cuda.synchronize()
            extra = {"render_ms_per_image": 1e3 * (time.perf_counter() - t1) / GRADIENT_BATCH,
                     "faces": int(atk._meshes[obj].tri_pos.shape[0])}
        reduced = ("; reduced: " + ", ".join(
            f"{k} {official_defaults(key)[k]} -> {v}" for k, v in caps.items()) if caps else "")
        render = (f", render {extra['render_ms_per_image']:.2f} ms an image "
                  f"({extra['faces']} faces, padded)" if extra else "")
        print(f"[16b idaa] {tag}: ResNet-50 bf16, batch {GRADIENT_BATCH}, 224², targeted: "
              f"{atk.grad_evals} gradient evaluations (batches of {GRADIENT_BATCH}), {n} "
              f"update-kernel launches, {secs:.3f} s, {GRADIENT_BATCH / secs:.2f} img/s, peak "
              f"memory {peak:.2f} GiB{render}, |delta|inf*255 = {linf * 255:.4f}, {what} "
              f"{before:.6g} -> {after:.6g} ({way}) on {smi}{reduced}")
        print(json.dumps({"input_key": tag, "grad_evals": atk.grad_evals, "launches": n,
                          "seconds": secs, "img_per_s": GRADIENT_BATCH / secs,
                          "peak_gib": peak, "objective": what, "value": [before, after],
                          "targeted": True, "reduced": caps or {}, **extra}))
        del atk, delta, adv
        torch.cuda.empty_cache()
    return launches


def ensemble_launches(key: str, atk) -> int:
    """The update-kernel launches of one call: SVRE's and SMER's inner steps
    each step ``update_delta``, then the outer step; the others only the
    outer one (CWA's inner sweep clips by itself)."""
    inner = {"svre": "M", "smer": "m_smer"}.get(key)
    return atk.epoch * (getattr(atk, inner) + 1 if inner else 1)


def ensemble_passes(key: str, atk) -> tuple:
    """(member backward passes, forward-only member passes) of one call, as
    the code implies them: an ensemble pass is one a member."""
    K = len(atk.model.members) or 1
    if key == "svre":  # the ensemble pass, then two member passes an inner step
        per_step = (K + 2 * atk.M, 0)
    elif key == "smer":  # a member pass and K weight forwards an inner step
        per_step = (atk.m_smer, atk.m_smer * K)
    else:
        per_step = {"ens": (K, 0), "mifgsm": (1, 0), "cwa": (2 * K, 0),
                    "adaea": (2 * K, K * K)}[key]
    return tuple(atk.epoch * n for n in per_step)


def densenet_vs_fp64() -> dict:
    """DenseNet-121 at 64², 2 images: the card's fp32 logits and input
    gradients (``channels_last``, the port's layout, and NCHW) and the CPU's,
    each against a CPU fp64 copy: {what: (card, CPU) max|d|/max|ref|}."""
    cpu = make_model("densenet121", pretrained=False, input_size=64, device="cpu")
    exact = copy.deepcopy(cpu.module).double()
    gen = torch.Generator().manual_seed(77)
    x = torch.rand(2, 64, 64, 3, generator=gen)
    y = torch.randint(0, 1000, (2,), generator=gen)

    def grad(module, xx, yy, nchw=False):
        xx = xx.clone().requires_grad_(True)
        inp = module.preprocess(xx).permute(0, 3, 1, 2)
        logits = module.backbone(inp.contiguous() if nchw else inp)
        return logits, torch.autograd.grad(F.cross_entropy(logits, yy), xx)[0]

    ref_logits, ref = grad(exact, x.double(), y)
    cpu_logits, on_cpu = grad(cpu.module, x, y)
    res = {}
    for layout in ("channels_last", "NCHW"):
        card = copy.deepcopy(cpu.module).cuda()
        if layout == "NCHW":
            card = card.to(memory_format=torch.contiguous_format)
        logits, on_card = grad(card, x.cuda(), y.cuda(), nchw=layout == "NCHW")
        if layout == "channels_last":
            res["logits"] = (rel_err(logits, ref_logits), rel_err(cpu_logits, ref_logits))
        res[f"input gradient {layout}"] = (rel_err(on_card, ref), rel_err(on_cpu, ref))
    return res


def write_cli_data(data: str, n: int):
    """The first ``n`` of phase 9's seeded 299² PNGs under ``data/images``,
    labelled (1-indexed, ``data/labels.csv``) by the ResNet-50 surrogate's
    own predictions on the images as the attack sees them, resized to 224².
    Returns their names and the clean images."""
    rng = np.random.RandomState(9)
    names = [f"img_{i:04d}.png" for i in range(n)]
    save_images(os.path.join(data, "images"), rng.rand(n, 299, 299, 3).astype(np.float32),
                names)
    clean = np.stack([load_image(os.path.join(data, "images", m)) for m in names])
    surrogate = make_model("resnet50", device="cuda")
    with torch.inference_mode():
        pred = surrogate.apply(torch.from_numpy(clean).cuda()).argmax(-1).cpu().numpy()
    del surrogate
    with open(os.path.join(data, "labels.csv"), "w") as f:
        f.write("filename,label\n" + "".join(f"{m},{p + 1}\n" for m, p in zip(names, pred)))
    return names, clean


def check_cli_outputs(out_dir: str, names, clean) -> float:
    """The CLI wrote one 224² PNG for each input, each within 16 levels of
    its clean image; returns the largest distance in levels."""
    written = sorted(m for m in os.listdir(out_dir) if m.endswith(".png"))
    check(written == names, f"the CLI wrote {len(written)} PNGs, expected {len(names)}")
    worst = 0.0
    for i, m in enumerate(names):
        img = load_image(os.path.join(out_dir, m))
        check(img.shape == (224, 224, 3), f"{m}: shape {img.shape}")
        worst = max(worst, float(np.abs(np.round(img * 255) - np.round(clean[i] * 255)).max()))
    check(worst <= 16, f"an adversarial PNG is {worst} levels from its clean image")
    return worst


def run_ensemble_family(dev, smi) -> dict:
    """Phase 17; returns each call's update-kernel launches in 17b and 17c."""
    check(all(k in tt.attack_zoo for k in ENSEMBLE_KEYS), "an ensemble key is not registered")
    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for what, (card64, cpu64) in densenet_vs_fp64().items():
        check(card64 <= cpu64 + EVAL_TOL, f"densenet121 {what}: card fp32 vs fp64 "
              f"max|d|/max|ref| = {card64}, CPU fp32 vs fp64 {cpu64}")
        print(f"[17a ensemble] densenet121 at 64², 2 images, {what} max|d|/max|ref|: card fp32 "
              f"vs fp64 {card64:.3e}, CPU fp32 vs fp64 {cpu64:.3e} (the card's bound: that + "
              f"{EVAL_TOL:g})")
    rng = np.random.RandomState(75)
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 10, size=2)
    for key in ENSEMBLE_KEYS:
        d = {w: tt.load_attack_class(key)(epoch=2, device=w, **ENSEMBLE_PAIR)(
            xs, ys, generator=torch.Generator().manual_seed(76)).cpu().numpy()
            for w in ("cuda", "cpu")}
        agree = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
        check(agree >= 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
        check(0 < np.abs(d["cuda"]).max() <= EPS + 1e-6, f"{key}: |delta|inf on the card")
        print(f"[17a ensemble] {key}: ResNet-18 + toy_cnn2 at 64², ten classes, batch 2, 2 "
              f"iterations, fp32: delta sign agreement card vs CPU {agree:.6f}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # (b) full width, bf16, batch 32, official hyperparameters
    resnets = make_ensemble(RESNETS, device="cuda")  # built once for the four keys
    runs = [("ens", "cnn_model_paper", cnn_model_paper)] + [
        (k, "+".join(RESNETS), resnets) for k in ("svre", "cwa", "adaea", "smer")] + [
        ("mifgsm", "densenet121", "densenet121"), ("mifgsm", "densenet201", "densenet201"),
        ("ens", "+".join(RFCOA_SET), RFCOA_SET)]
    launches = {}
    for i, (key, label, model) in enumerate(runs):
        atk = tt.load_attack_class(key)(model_name=model, compute_dtype="bfloat16",
                                        device="cuda")
        tag = key if model is resnets else f"{key}_{label}"
        size = atk.model.input_size
        x = torch.from_numpy(np.random.RandomState(78 + i).rand(GRADIENT_BATCH, size, size, 3)
                             .astype(np.float32)).to(dev)
        with torch.no_grad():
            logits0 = atk.model.apply(x)
        y = logits0.argmax(-1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        delta = atk(x, y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches[tag] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = ensemble_launches(key, atk)
        check(n == want, f"{tag}: {n} update-kernel launches, its code implies {want}")
        passes = (atk.grad_evals, atk.forward_evals)
        check(passes == ensemble_passes(key, atk), f"{tag}: (backward, forward-only) member "
              f"passes {passes}, its code implies {ensemble_passes(key, atk)}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{tag}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        check(0.0 < linf <= EPS + 1e-6, f"{tag}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{tag}: x + delta leaves [0, 1]")
        with torch.no_grad():
            logits1 = atk.model.apply(adv)
        ce0 = float(softmax_cross_entropy(logits0, y).mean())
        ce1 = float(softmax_cross_entropy(logits1, y).mean())
        check(ce1 > ce0, f"{tag}: the ensemble's CE did not rise: {ce0} -> {ce1}")
        members = len(atk.model.members) or 1
        print(f"[17b ensemble] {tag}: {label} ({members} member(s)) bf16, batch "
              f"{GRADIENT_BATCH}, {size}²: {passes[0]} member backward passes and {passes[1]} "
              f"forward-only (batches of {GRADIENT_BATCH}), {n} update-kernel launches, "
              f"{secs:.3f} s, {GRADIENT_BATCH / secs:.2f} img/s, peak memory {peak:.2f} GiB, "
              f"|delta|inf*255 = {linf * 255:.4f}, ensemble CE {ce0:.6g} -> {ce1:.6g} on {smi}")
        print(json.dumps({"ensemble_key": tag, "model": label, "members": members,
                          "size": size, "grad_evals": passes[0], "forward_evals": passes[1],
                          "launches": n, "seconds": secs, "img_per_s": GRADIENT_BATCH / secs,
                          "peak_gib": peak, "ce": [ce0, ce1]}))
        del atk, delta, adv, logits0, logits1, x
        torch.cuda.empty_cache()
    del resnets
    torch.cuda.empty_cache()

    # (c) the CLI on an ensemble, with and without --ensemble
    with tempfile.TemporaryDirectory() as work:
        data = os.path.join(work, "data")
        names, clean = write_cli_data(data, CLI_ENSEMBLE_IMAGES)
        for tag, flags in (("cli_ensemble", ["--ensemble"]), ("cli_comma_list", [])):
            out_dir = os.path.join(work, tag)
            fused_sign_update.launches = 0
            cli.main(["--attack", "ens", "--model", "resnet50,vgg16", *flags, "--bf16",
                      "--batchsize", str(CLI_BATCH), "--input_dir", data,
                      "--output_dir", out_dir])
            torch.cuda.synchronize()
            n = launches[tag] = fused_sign_update.launches
            check(n == 10, f"{tag}: {n} update-kernel launches, expected 10 (1 batch of 10 "
                  f"iterations)")
            worst = check_cli_outputs(out_dir, names, clean)
            with open(os.path.join(out_dir, "attack_meta.json")) as f:
                meta = json.load(f)
            check(meta["model"] == "resnet50,vgg16" and meta["n_images"] == len(names),
                  f"{tag}: attack_meta.json {meta}")
            argv = " ".join(["--attack ens --model resnet50,vgg16", *flags, "--bf16"])
            print(f"[17c ensemble] `{argv}` over {len(names)} PNGs: 1 batch, {n} update-kernel "
                  f"launches, "
                  f"at most {worst:.0f} levels from their clean images (eps 16/255)")
    return launches


def learned_launches(key: str, atk) -> int:
    """The update-kernel launches of one call, as the code implies them:
    RFCoA steps through its own Adam; LPM's candidates' inner attacks take a
    launch an inner iteration a chunk (its chunks: the population, then its
    offspring each generation), then its final loop one an iteration."""
    if key == "rfcoa":
        return 0
    if key == "lpm":
        chunk = -(-atk.pop_size // atk.score_chunk)
        offspring = max(int(0.3 * atk.pop_size), 1) + max(int(0.7 * atk.pop_size), 1)
        chunks = chunk + atk.de_iters * -(-offspring // atk.score_chunk)
        return chunks * atk.inner_epoch + atk.epoch
    return atk.epoch


def learned_steps_card_vs_cpu(atks, xs, ys) -> list:
    """Each iteration's delta sign agreement, the card's step taken from the
    CPU's state and both drawing from one seeded CPU generator each."""
    from transferattack_torch.attack import AttackState

    x = {w: torch.from_numpy(xs).to(w) for w in atks}
    y = {w: torch.from_numpy(ys).to(w) for w in atks}
    gen = {w: torch.Generator().manual_seed(86) for w in atks}
    state = atks["cpu"].init_state(x["cpu"], y["cpu"], gen["cpu"])
    agree = []
    for t in range(atks["cpu"].epoch):
        card = atks["cuda"].step(x["cuda"], y["cuda"], AttackState(
            delta=state.delta.cuda(), momentum=state.momentum.cuda(), step=t), gen["cuda"])
        state = atks["cpu"].step(x["cpu"], y["cpu"], state, gen["cpu"])
        agree.append(float((torch.sign(card.delta.cpu()) == torch.sign(state.delta))
                           .float().mean()))
    return agree


def aux_nets_card_vs_cpu() -> dict:
    """Each auxiliary network on seeded weights, fp32, on the card and on
    the CPU: {name: max|card - CPU| / max|CPU|}."""
    from transferattack_torch.ensemble import rfcoa
    from transferattack_torch.input_transformation import learned

    gen = torch.Generator().manual_seed(18)
    img = lambda size: torch.rand(2, 3, size, size, generator=gen)  # noqa: E731
    nets = {"rfcoa encoder": (rfcoa.VGGEncoder(), (img(224),)),
            "rfcoa decoder": (rfcoa.VGGDecoder(), (torch.rand(2, 512, 7, 7, generator=gen),)),
            "atta": (learned.ATTAModel(), (img(224),)),
            "stylenet": (learned.StyleNet(), (img(224), torch.randn(2, 100, generator=gen))),
            "semantic predictor": (learned.SemanticPredictor(), (img(224),)),
            "aitl encoder": (learned.AITLEncoder(), (torch.rand(5, 80, generator=gen),)),
            "aitl decoder": (learned.AITLDecoder(), (torch.randn(5, 128, generator=gen),)),
            "aitl predictor": (learned.AITLPredictor(),
                               (img(224)[:1], torch.randn(5, 128, generator=gen)))}
    out = {}
    for name, (net, inputs) in nets.items():
        init_weights(net, gen)
        net.eval()
        with torch.no_grad():
            ref = net(*inputs)
            card = copy.deepcopy(net).cuda()(*(t.cuda() for t in inputs)).cpu()
        out[name] = rel_err(card, ref)
    return out


def learned_objective(key: str, atk, x, y, y_tgt, delta) -> tuple:
    """(the objective before, after, which way it must move, its name) of a
    18b call: the surrogate's CE at the label (untargeted keys; LGV and MBA
    on the base weights), at the target (SASD-WS, lower), and RFCoA's own
    loss at its first and its last Adam step (lower)."""
    if key == "rfcoa":
        return (*atk.losses, "down", "its loss, first and last Adam step")
    label = y_tgt if atk.targeted else y
    with torch.no_grad():
        ce0 = float(softmax_cross_entropy(atk.model.apply(x), label).mean())
        ce1 = float(softmax_cross_entropy(atk.model.apply(x + delta), label).mean())
    return ce0, ce1, "down" if atk.targeted else "up", "CE at the target" if atk.targeted \
        else "CE at the label"


def run_learned_family(dev, smi) -> dict:
    """Phase 18; returns each call's update-kernel launches in 18b."""
    check(all(k in tt.attack_zoo for k in LEARNED_KEYS), "a phase-18 key is not registered")
    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for name, err in aux_nets_card_vs_cpu().items():
        check(err <= EVAL_TOL, f"{name}: fp32 output card vs CPU max|d|/max|ref| = {err}")
        print(f"[18a learned] {name}, seeded, fp32: output card vs CPU max|d|/max|ref| "
              f"{err:.3e} (bound {EVAL_TOL:g})")
    rng = np.random.RandomState(85)
    for key in LEARNED_KEYS:
        size = 56 if key == "lpm" else 64
        batch = 1 if key == "lpm" else 2
        xs = rng.rand(batch, size, size, 3).astype(np.float32)
        ys = rng.randint(0, 10, size=batch)
        if key in ("sasd_ws", "rfcoa"):  # targeted: (label, target) pairs
            ys = np.stack([ys, (ys + 3) % 10], axis=1)
        kw = {"model_name": "resnet18", "pretrained": False, "input_size": size, "epoch": 2,
              **LEARNED_SMALL[key]}
        atks = {w: tt.load_attack_class(key)(device=w, **kw) for w in ("cpu", "cuda")}
        if key == "lpm":  # the card scores each chunk; the search takes the CPU's scores
            scored, seen = [], {}
            cpu_score = atks["cpu"].score_all

            def record(x_, y_, bits):
                scored.append(cpu_score(x_, y_, bits))
                return scored[-1]

            def replay(x_, y_, bits, own=atks["cuda"].score_all):
                card_scores, ref = own(x_, y_, bits), scored.pop(0)
                seen["err"] = max(seen.get("err", 0.0), float(np.abs(card_scores - ref).max()
                                                              / np.abs(ref).max()))
                return ref

            atks["cpu"].score_all, atks["cuda"].score_all = record, replay
        d = {w: atks[w](xs, ys, generator=torch.Generator().manual_seed(86)).cpu().numpy()
             for w in ("cpu", "cuda")}
        if key in STEPWISE:
            whole = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
            agree = min(learned_steps_card_vs_cpu(atks, xs, ys))
            check(agree > 0.99, f"{key}: fp32 step delta sign agreement card vs CPU {agree}")
            print(f"[18a learned] {key}: resnet18 at {size}², batch {batch}, fp32: each step "
                  f"from the CPU's state, delta sign agreement card vs CPU at least {agree:.6f} "
                  f"(the whole run {whole:.6f}, printed, not held: see STEPWISE)")
            continue
        if key == "rfcoa":  # a continuous composite, not a sign step
            a, b = d["cuda"].ravel().astype(np.float64), d["cpu"].ravel().astype(np.float64)
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            check(cos > 0.99, f"rfcoa: fp32 delta cosine card vs CPU {cos}")
            adv = xs + d["cuda"]
            check(adv.min() >= -1e-6 and adv.max() <= 1 + 1e-6, "rfcoa: x + delta leaves [0, 1]")
            what = f"delta cosine card vs CPU {cos:.6f}"
        else:
            agree = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
            check(agree > 0.99, f"{key}: fp32 delta sign agreement card vs CPU {agree}")
            check(0 < np.abs(d["cuda"]).max() <= EPS + 1e-6, f"{key}: |delta|inf on the card")
            what = f"delta sign agreement card vs CPU {agree:.6f}"
        if key == "lpm":
            check(seen["err"] <= 1e-3, f"lpm: chunk scores card vs CPU {seen['err']}")
            what += f"; chunk scores card vs CPU max|d|/max|ref| {seen['err']:.3e}"
        print(f"[18a learned] {key}: {kw['model_name']} at {size}², batch {batch}, fp32: {what}")
        del atks
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()

    # (b) full width, bf16, batch 32 (LPM 1), official hyperparameters
    launches = {}
    for i, key in enumerate(LEARNED_KEYS):
        atk = tt.load_attack_class(key)(compute_dtype="bfloat16", device="cuda")
        size = atk.model.input_size
        batch = 1 if key == "lpm" else GRADIENT_BATCH
        x = torch.from_numpy(np.random.RandomState(87 + i).rand(batch, size, size, 3)
                             .astype(np.float32)).to(dev)
        with torch.no_grad():
            y = atk.model.apply(x).argmax(-1)
        y_tgt = (y + 500) % 1000
        labels = torch.stack([y, y_tgt], 1) if atk.targeted and key != "rfcoa" else y
        reduced = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        if key == "rfcoa":  # one call a target class, each 300 Adam steps: the first class
            delta = atk(x, labels, idx=0)
            reduced.append("1 of its 10 target classes (class 24)")
        else:
            delta = atk(x, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches[key] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = learned_launches(key, atk)
        check(n == want, f"{key}: {n} update-kernel launches, its code implies {want}")
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
              f"{key}: delta not finite or of shape {tuple(delta.shape)}")
        linf = float(delta.abs().max())
        if key != "rfcoa":  # RFCoA's composite holds [0, 1] only
            check(0.0 < linf <= EPS + 1e-6, f"{key}: |delta|inf = {linf}")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"{key}: x + delta leaves [0, 1]")
        if key == "rfcoa":
            y_tgt = torch.full_like(y, 24)
        before, after, way, what = learned_objective(key, atk, x, y, y_tgt, delta)
        check(after < before if way == "down" else after > before,
              f"{key}: {what} did not move {way}: {before} -> {after}")
        members = len(atk.model.members) or 1
        tag = f"{key}{' (reduced: ' + '; '.join(reduced) + ')' if reduced else ''}"
        print(f"[18b learned] {tag}: {atk.model.name} bf16, batch {batch}, {size}²: "
              f"{atk.grad_evals} gradient evaluations, {atk.forward_evals} forward-only, "
              f"{n} update-kernel launches, {secs:.3f} s, {batch / secs:.2f} img/s, peak "
              f"memory {peak:.2f} GiB, |delta|inf*255 = {linf * 255:.4f}, {what} "
              f"{before:.6g} -> {after:.6g} on {smi}")
        print(json.dumps({"learned_key": key, "model": atk.model.name, "members": members,
                          "batch": batch, "size": size, "grad_evals": atk.grad_evals,
                          "forward_evals": atk.forward_evals, "launches": n,
                          "seconds": secs, "img_per_s": batch / secs, "peak_gib": peak,
                          "objective": [before, after], "reduced": reduced}))
        del atk, delta, adv, x
        torch.cuda.empty_cache()

    # (c) the CLI: RFCoA once a target class, LPM at batch 1
    with tempfile.TemporaryDirectory() as work:
        data = os.path.join(work, "data")
        names, clean = write_cli_data(data, CLI_LEARNED_IMAGES)
        out_dir = os.path.join(work, "rfcoa")
        cli.main(["--attack", "rfcoa", "--epoch", "2", "--bf16", "--input_dir", data,
                  "--output_dir", out_dir])
        classes = sorted(int(c) for c in os.listdir(out_dir) if c.isdigit())
        check(classes == sorted(generation_target_classes),
              f"rfcoa: the CLI wrote the subdirectories {classes}")
        for c in classes:
            written = sorted(os.listdir(os.path.join(out_dir, str(c))))
            check(written == names, f"rfcoa: {c}/ holds {written}")
        print(f"[18c learned] `--attack rfcoa --epoch 2 --bf16` over {len(names)} PNGs: one "
              f"subdirectory for each of the {len(classes)} target classes, {len(names)} PNGs "
              f"each")
        from transferattack_torch.input_transformation import learned
        sizes, call = [], learned.LPM.__call__
        learned.LPM.__call__ = lambda self, data_, *a, **k: sizes.append(len(data_)) or call(
            self, data_, *a, **k)
        try:
            out_dir = os.path.join(work, "lpm")
            fused_sign_update.launches = 0
            cli.main(["--attack", "lpm", "--bf16", "--batchsize", "4", "--input_dir", data,
                      "--output_dir", out_dir])
        finally:
            learned.LPM.__call__ = call
        check(sizes == [1] * len(names), f"lpm: the CLI ran batches of {sizes}")
        check_cli_outputs(out_dir, names, clean)
        n = launches["cli_lpm"] = fused_sign_update.launches
        check(n == len(names) * launches["lpm"], f"lpm: the CLI launched the update kernel "
              f"{n} times, expected {launches['lpm']} an image")
        print(f"[18c learned] `--attack lpm --bf16 --batchsize 4` over {len(names)} PNGs: "
              f"batches of {sizes}, {n} update-kernel launches")
    return launches


def seeded_generator(net, gen):
    """``init_weights`` from ``gen``, then BatchNorm's statistics off the
    identity; in eval mode."""
    init_weights(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    return net.eval()


def generators_card_vs_cpu() -> dict:
    """Each generator on seeded weights (BatchNorm off the identity), fp32,
    on the card and on the CPU at 64² (AdvGAN also at 65², its crop path;
    ADA at 67², a side ≡ 3 mod 4): {name: max|card - CPU| / max|CPU|} of
    the raw output."""
    from transferattack_torch.generation import generators as tgen

    gen = torch.Generator().manual_seed(19)
    out = {}
    for name, net, size in (("GeneratorResnet", tgen.GeneratorResnet(), 64),
                            ("AdvGANGenerator", tgen.AdvGANGenerator(), 64),
                            ("AdvGANGenerator", tgen.AdvGANGenerator(), 65),
                            ("ADAGenerator", tgen.ADAGenerator(), 67)):
        seeded_generator(net, gen)
        args = (torch.rand(2, 3, size, size, generator=gen),) + (
            (torch.randn(2, 16, generator=gen),) if name == "ADAGenerator" else ())
        with torch.no_grad():
            ref = net(*args)
            card = copy.deepcopy(net).cuda()(*(a.cuda() for a in args)).cpu()
        check(card.shape == ref.shape, f"{name} at {size}²: card shape {tuple(card.shape)}")
        out[f"{name} at {size}²"] = rel_err(card, ref)
    return out


def run_generation_family(dev, smi) -> dict:
    """Phase 19; returns each call's update-kernel launches in 19b."""
    check(all(k in tt.attack_zoo for k in GENERATOR_KEYS + ("fap",)),
          "a phase-19 key is not registered")
    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for name, err in generators_card_vs_cpu().items():
        check(err <= GEN_TOL, f"{name}: fp32 raw output card vs CPU max|d|/max|ref| = {err}")
        print(f"[19a generation] {name}, seeded, fp32: raw output card vs CPU max|d|/max|ref| "
              f"{err:.3e} (bound {GEN_TOL:g})")
    kw = {"model_name": "resnet18", "pretrained": False, "input_size": 64}
    atks = {w: tt.load_attack_class("fap")(device=w, **kw) for w in ("cpu", "cuda")}
    rng = np.random.RandomState(190)
    delta = ((rng.rand(2, 224, 224, 3) - 0.5) * 0.4).astype(np.float32)  # negative entries too
    gated = {w: atks[w].gate_delta(torch.from_numpy(delta).to(w)).cpu() for w in atks}
    gate_err = float((gated["cuda"] - gated["cpu"]).abs().max())
    gate_max = float(gated["cpu"].max())
    check(gate_err <= GATE_TOL, f"fap: gate_delta card vs CPU max|d| = {gate_err}")
    check(gate_max > 0, "fap: the gate passed nothing")
    xs = rng.rand(2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    d = {w: atks[w](xs, ys).cpu().numpy() for w in atks}
    agree = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
    check(agree > 0.99, f"fap: fp32 delta sign agreement card vs CPU {agree}")
    print(f"[19a generation] fap: resnet18 at 64², batch 2, 20 iterations, fp32: delta sign "
          f"agreement card vs CPU {agree:.6f}; gate_delta at 224² card vs CPU max|d| "
          f"{gate_err:.3e} (bound {GATE_TOL:g}; the gated delta's max {gate_max:.4f})")
    del atks
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()

    # (b) full width, batch 32: each generator key on its fallbacks, then FAP
    print(f"[19b generation] torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    launches = {}
    cases = [(k, 224) for k in GENERATOR_KEYS] + [("ada", 299)]
    for i, (key, size) in enumerate(cases):
        atk = tt.load_attack_class(key)(compute_dtype="bfloat16", device="cuda")
        x = torch.from_numpy(np.random.RandomState(191 + i).rand(GRADIENT_BATCH, size, size, 3)
                             .astype(np.float32)).to(dev)
        # TTP and M3D: one generator a target class, each called once
        idxs = range(len(generation_target_classes)) if key in cli.GENERATION_TARGETED else (0,)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        deltas = [atk(x, None, idx=idx) for idx in idxs]  # cold: each generator's first call
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches[f"{key}_{size}"] = fused_sign_update.launches
        check(n == 0, f"{key}: {n} update-kernel launches, a generator key makes none")
        forwards = atk.forwards
        check(forwards == len(idxs), f"{key}: {forwards} generator forwards")
        for idx, delta in zip(idxs, deltas):
            what = f"{key} at {size}², class index {idx}"
            check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
                  f"{what}: delta not finite or of shape {tuple(delta.shape)}")
            linf = float(delta.abs().max())
            check(0.0 < linf <= EPS + 1e-6, f"{what}: |delta|inf = {linf}")
            adv = x + delta
            check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
                  f"{what}: x + delta leaves [0, 1]")
        check(key not in cli.GENERATION_TARGETED or not torch.equal(deltas[0], deltas[1]),
              f"{key}: classes 0 and 1 gave one delta")
        forward_ms = median_ms(lambda: atk(x, None, idx=0), reps=5, burst=2, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        padded = " (edge-padded to 227²)" if key == "ada" and size == 224 else ""
        print(f"[19b generation] {key} at {size}²{padded}: batch {GRADIENT_BATCH}, fp32 "
              f"generator (--bf16 ignored, as in JAX), {forwards} generator forwards over "
              f"{len(idxs)} generator(s), {n} update-kernel "
              f"launches, cold calls {secs:.3f} s; {forward_ms:.3f} ms a forward (CUDA events, "
              f"warm), {GRADIENT_BATCH / forward_ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, "
              f"|delta|inf*255 = {float(deltas[-1].abs().max()) * 255:.4f} on {smi}")
        print(json.dumps({"generation_key": key, "size": size, "batch": GRADIENT_BATCH,
                          "generators": len(idxs), "forwards": forwards, "launches": n,
                          "cold_seconds": secs, "forward_ms": forward_ms,
                          "img_per_s": GRADIENT_BATCH / forward_ms * 1e3, "peak_gib": peak,
                          "reduced": []}))
        del atk, deltas, x
        torch.cuda.empty_cache()

    atk = tt.load_attack_class("fap")(compute_dtype="bfloat16", device="cuda")
    check(abs(atk.eps - FAP_EPS) < 1e-9 and atk.epoch == 20, f"fap: eps {atk.eps}, "
          f"epoch {atk.epoch}")
    x = torch.from_numpy(np.random.RandomState(199).rand(GRADIENT_BATCH, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        y = atk.model.apply(x).argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    delta = atk(x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = launches["fap"] = fused_sign_update.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(n == atk.epoch == 20, f"fap: {n} update-kernel launches, expected 20")
    check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
          f"fap: delta not finite or of shape {tuple(delta.shape)}")
    linf = float(delta.abs().max())
    check(0.0 < linf <= FAP_EPS + 1e-6, f"fap: |delta|inf = {linf}")
    adv = x + delta
    check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
          "fap: x + delta leaves [0, 1]")
    with torch.no_grad():
        ce0 = float(softmax_cross_entropy(atk.model.apply(x), y).mean())
        ce1 = float(softmax_cross_entropy(atk.model.apply(adv), y).mean())
    check(ce1 > ce0, f"fap: CE did not rise: {ce0} -> {ce1}")
    evals = atk.grad_evals
    t0 = time.perf_counter()  # once more, warm
    atk(x, y)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"[19b generation] fap: {atk.model.name} bf16, batch {GRADIENT_BATCH}, 224², 20 "
          f"iterations, zigzag mask: {evals} gradient evaluations, {n} update-kernel "
          f"launches (eps {FAP_EPS * 255:.0f}/255, alpha {atk.alpha * 255:.1f}/255), {secs:.3f} s "
          f"cold ({GRADIENT_BATCH / secs:.2f} img/s), {warm:.3f} s warm ({GRADIENT_BATCH / warm:.2f} "
          f"img/s, {warm / atk.epoch * 1e3:.2f} ms a step), peak memory {peak:.2f} GiB, |delta|inf*255 = "
          f"{linf * 255:.4f}, CE at the label {ce0:.6g} -> {ce1:.6g} on {smi}")
    print(json.dumps({"generation_key": "fap", "model": atk.model.name, "size": 224,
                      "batch": GRADIENT_BATCH, "grad_evals": evals, "launches": n,
                      "seconds": secs, "img_per_s": GRADIENT_BATCH / secs,
                      "warm_seconds": warm, "peak_gib": peak, "objective": [ce0, ce1],
                      "reduced": []}))
    del atk, delta, adv, x
    torch.cuda.empty_cache()

    # (c) the CLI: TTP once a target class, then eval's mean over the classes
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            data, out_dir = os.path.join(work, "data"), os.path.join(work, "ttp")
            names, clean = write_cli_data(data, CLI_GENERATION_IMAGES)
            common = ["--attack", "ttp", "--batchsize", str(CLI_GENERATION_IMAGES),
                      "--input_dir", data, "--output_dir", out_dir]
            fused_sign_update.launches = 0
            cli.main([*common, "--model", "resnet50"])
            launches["cli_ttp"] = fused_sign_update.launches
            check(launches["cli_ttp"] == 0, f"ttp: the CLI launched the update kernel "
                  f"{launches['cli_ttp']} times")
            classes = sorted(int(c) for c in os.listdir(out_dir) if c.isdigit())
            check(classes == sorted(generation_target_classes),
                  f"ttp: the CLI wrote the subdirectories {classes}")
            worst = max(check_cli_outputs(os.path.join(out_dir, str(c)), names, clean)
                        for c in classes)
            print(f"[19c generation] `--attack ttp --model resnet50 --batchsize "
                  f"{CLI_GENERATION_IMAGES}` over {len(names)} PNGs: one subdirectory for each "
                  f"of the {len(classes)} target classes, {len(names)} PNGs each, at most "
                  f"{worst:.0f} levels from their clean images")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                cli.main([*common, "--eval", "--eval_models", "resnet50"])
            print(text.getvalue(), end="")
            rows = re.findall(r"^resnet50: (\d+\.\d)$", text.getvalue(), re.M)
            check(len(rows) == 1, f"ttp: --eval printed {len(rows)} resnet50 rows")
            table = open(os.path.join(work, "results_eval.txt")).read().splitlines()
            check(len(table) == 1 and table[0].count("|") == 2,
                  f"ttp: results_eval.txt holds {table}")
            print(f"[19c generation] `--eval --eval_models resnet50`: one row, the mean over "
                  f"the ten classes' folders: {table[0]}")
        finally:
            os.chdir(cwd)
    return launches


def diffusion_card_vs_cpu() -> dict:
    """20a, fp32 with TF32 off, the same seeded weights on both: {check:
    (value, bound)}."""
    from transferattack_torch.defense import diffpure as tdp
    from transferattack_torch.defense.gd_unet import GuidedDiffusionUNet, init_nonzero
    from transferattack_torch.generation.aim import AIMGenerator

    out = {}
    gen = torch.Generator().manual_seed(200)
    unet = init_nonzero(GuidedDiffusionUNet(**tdp._TINY_UNET), gen).requires_grad_(False)
    x = torch.randn(2, 3, 32, 32, generator=gen)
    t = torch.tensor([7.0, 640.0])
    with torch.no_grad():
        cpu_maps, card_maps = [], []
        ref = unet(x, t, cpu_maps)
        card_unet = copy.deepcopy(unet).to("cuda", memory_format=torch.channels_last)
        card = card_unet(x.cuda().contiguous(memory_format=torch.channels_last), t.cuda(),
                         card_maps)
    out["tiny UNet at 32², output"] = (rel_err(card.cpu(), ref), DIFF_TOL)
    out["tiny UNet at 32², attention maps"] = (
        max(rel_err(c.cpu(), r) for c, r in zip(card_maps, cpu_maps)), DIFF_TOL)

    aim = seeded_generator(AIMGenerator(), gen)
    with torch.no_grad():
        xa, guide = torch.rand(2, 3, 64, 64, generator=gen), torch.rand(1, 3, 64, 64, generator=gen)
        ref = aim(xa, guide)
        card = copy.deepcopy(aim).cuda()(xa.cuda(), guide.cuda()).cpu()
    out["AIM generator at 64², raw output"] = (rel_err(card, ref), DIFF_TOL)

    rng = np.random.RandomState(200)
    xs = rng.rand(2, 32, 32, 3).astype(np.float32)
    for kind, t_star in (("sde", 4), ("ddpm", 5)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dps = {w: tdp.DiffPure(t_star=t_star, diffusion_type=kind, device=w)
                   for w in ("cpu", "cuda")}
        n = len(dps["cpu"].time_grid()[0]) if kind == "sde" else t_star
        noises = [rng.randn(*xs.shape).astype(np.float32) for _ in range(n + 1)]
        pure = {}
        for w, dp in dps.items():
            dp.unet.load_state_dict(unet.state_dict())
            pure[w] = dp(xs, noises=noises).cpu()
        out[f"purify_{kind}, t* {t_star}, fixed noises"] = (
            float((pure["cuda"] - pure["cpu"]).abs().max()), PURIFY_TOL)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        atks = {w: tt.load_attack_class("diffattack")(model_name="toy_cnn", device=w,
                                                      **DIFF_SMALL) for w in ("cpu", "cuda")}
    # a UNet attending at 16² and 8² tokens, so the self-attention term's
    # ``keep`` is a strict subset of the maps, as at full width
    unet2 = init_nonzero(GuidedDiffusionUNet(**{**tdp._TINY_UNET, **DIFF_TWO_RES}),
                         gen).requires_grad_(False)
    y = torch.tensor([3, 7])
    far = torch.randn(xs.shape, generator=gen)
    found, keeps = {}, {}  # (part, device): (value, latent gradient)
    for w, atk in atks.items():
        atk.dp.unet = copy.deepcopy(unet2).to(w, memory_format=torch.channels_last)
        x = torch.from_numpy(xs).to(w)
        with torch.no_grad():
            latent0 = atk.invert(x * 2.0 - 1.0)
            base = atk.decode(latent0, with_maps=True)[1]
        keeps[w] = keep = atk.attn_keep(base)
        latent = latent0.clone().requires_grad_(True)
        loss = atk.loss(latent, x, y.to(w), base, keep)
        found["loss", w] = loss.item(), torch.autograd.grad(loss, latent)[0]
        # the self-attention term alone, at a latent away from the clean one
        latent = (latent0 + 0.5 * far.to(w)).requires_grad_(True)
        term = atk.self_attn(atk.decode(latent, with_maps=True)[1], base, keep)
        found["term", w] = term.item(), torch.autograd.grad(term, latent)[0]
    check(keeps["cuda"] == keeps["cpu"] == [1, 2, 3, 4],
          f"DiffAttack: the maps kept, {keeps['cuda']} on the card and {keeps['cpu']} on the CPU")
    for part, what in (("loss", "loss at the inverted latent"),
                       ("term", "self-attention term over the 4 kept of 7 maps, off the clean "
                        "latent")):
        (v, g), (ref, r) = found[part, "cuda"], found[part, "cpu"]
        g, r = g.cpu().double().flatten(), r.cpu().double().flatten()
        out[f"DiffAttack on toy_cnn, {what}"] = (abs(v - ref) / abs(ref), LOSS_TOL)
        out[f"DiffAttack on toy_cnn, {what}, 1 - cosine of the latent gradients"] = (
            1 - float(g @ r / (g.norm() * r.norm())), 1 - GRAD_COSINE)
    return out


def run_diffusion_family(dev, smi) -> dict:
    """Phase 20; returns each call's update-kernel launches (none)."""
    from transferattack_torch.defense.diffpure import DiffPure
    from transferattack_torch.defense.gd_unet import GuidedDiffusionUNet, init_nonzero

    check(all(k in tt.attack_zoo for k in ("aim", "diffattack")) and len(tt.attack_zoo) == 127,
          "aim or diffattack is not registered")
    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for what, (value, bound) in diffusion_card_vs_cpu().items():
        check(value <= bound, f"{what}: card vs CPU {value} (bound {bound})")
        print(f"[20a diffusion] {what}, seeded, fp32: card vs CPU {value:.3e} (bound {bound:g})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()

    # (b) full width: AIM's ten class generators, then the full UNet under
    # DiffPure's two samplers and DiffAttack
    print(f"[20b diffusion] torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    launches = {}
    atk = tt.load_attack_class("aim")(compute_dtype="bfloat16", device="cuda")
    x = torch.from_numpy(np.random.RandomState(201).rand(GRADIENT_BATCH, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    idxs = range(len(generation_target_classes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    deltas = [atk(x, None, idx=idx) for idx in idxs]  # cold: each generator's first call
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = launches["aim"] = fused_sign_update.launches
    check(n == 0 and atk.forwards == len(idxs), f"aim: {n} update-kernel launches, "
          f"{atk.forwards} generator forwards")
    for idx, delta in zip(idxs, deltas):
        check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape)
              and 0.0 < float(delta.abs().max()) <= EPS + 1e-6,
              f"aim, class index {idx}: delta not finite, of shape {tuple(delta.shape)} or "
              f"beyond eps")
        adv = x + delta
        check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
              f"aim, class index {idx}: x + delta leaves [0, 1]")
    check(not torch.equal(deltas[0], deltas[1]), "aim: classes 0 and 1 gave one delta")
    forward_ms = median_ms(lambda: atk(x, None, idx=0), reps=5, burst=2, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[20b diffusion] aim at 224²: batch {GRADIENT_BATCH}, fp32 generators (--bf16 "
          f"ignored, as in JAX), {len(idxs)} generator forwards over {len(idxs)} class "
          f"generators, {n} update-kernel launches, cold calls {secs:.3f} s; {forward_ms:.3f} "
          f"ms a forward (CUDA events, warm), {GRADIENT_BATCH / forward_ms * 1e3:.2f} img/s, "
          f"peak memory {peak:.2f} GiB on {smi}")
    print(json.dumps({"diffusion_key": "aim", "size": 224, "batch": GRADIENT_BATCH,
                      "generators": len(idxs), "forwards": len(idxs), "launches": n,
                      "cold_seconds": secs, "forward_ms": forward_ms,
                      "img_per_s": GRADIENT_BATCH / forward_ms * 1e3, "peak_gib": peak,
                      "reduced": []}))
    del atk, deltas, x, adv
    torch.cuda.empty_cache()

    # the ImageNet-256 configuration (JAX's ``unet_config={}``), built and
    # seeded on the card: a host init of 553M parameters takes a minute
    t0 = time.perf_counter()
    with torch.device(dev):
        unet = GuidedDiffusionUNet()
    init_nonzero(unet, torch.Generator(device=dev).manual_seed(202)).requires_grad_(False)
    unet = unet.to(memory_format=torch.channels_last)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in unet.parameters())
    print(f"[20b diffusion] GuidedDiffusionUNet(), the ImageNet-256 configuration: "
          f"{params / 1e6:.1f}M parameters, built and seeded on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    flops = {}  # a forward's operations an image, counted on the meta device
    with torch.device("meta"):
        shape = GuidedDiffusionUNet()
        for side in (DIFFPURE_SIZE, 224):
            with FlopCounterMode(display=False) as counter:
                shape(torch.empty(1, 3, side, side), torch.zeros(1))
            flops[side] = counter.get_total_flops()
    del shape
    print(f"[20b diffusion] a UNet forward: {flops[DIFFPURE_SIZE] / 1e12:.4f} TFLOP an image at "
          f"{DIFFPURE_SIZE}², {flops[224] / 1e12:.4f} at 224² (torch.utils.flop_counter)")

    def unet_ms(batch, side):
        xt = torch.randn(batch, 3, side, side, device=dev).contiguous(
            memory_format=torch.channels_last)
        tt_ = torch.full((batch,), 100.0, device=dev)
        with torch.no_grad():
            return median_ms(lambda: unet(xt, tt_), reps=5, burst=2, warmup=1)

    x = torch.from_numpy(np.random.RandomState(203).rand(
        DIFFPURE_BATCH, DIFFPURE_SIZE, DIFFPURE_SIZE, 3).astype(np.float32)).to(dev)
    fwd_ms = unet_ms(DIFFPURE_BATCH, DIFFPURE_SIZE)
    for kind in ("sde", "ddpm"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the tiny fallback, replaced at once
            dp = DiffPure(t_star=DIFFPURE_T_STAR, diffusion_type=kind, device=dev)
        dp.unet = unet
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        out = dp(x, torch.Generator(device=dev).manual_seed(204))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches[f"diffpure_{kind}"] = fused_sign_update.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(n == 0 and dp.forwards == DIFFPURE_T_STAR,
              f"diffpure {kind}: {dp.forwards} UNet forwards, {n} update-kernel launches")
        check(bool(torch.isfinite(out).all()) and tuple(out.shape) == tuple(x.shape)
              and float(out.min()) >= 0 and float(out.max()) <= 1,
              f"diffpure {kind}: output not finite, of shape {tuple(out.shape)} or out of [0, 1]")
        moved = float((out - x).abs().mean())
        check(moved > 0, f"diffpure {kind}: the purification changed nothing")
        print(f"[20b diffusion] purify_{kind}: full UNet, batch {DIFFPURE_BATCH}, "
              f"{DIFFPURE_SIZE}², t* {DIFFPURE_T_STAR}: {dp.forwards} UNet forwards, {n} "
              f"update-kernel launches, {secs:.3f} s a call ({DIFFPURE_BATCH / secs:.2f} img/s), "
              f"{fwd_ms:.3f} ms a UNet forward (CUDA events, warm; "
              f"{DIFFPURE_BATCH * flops[DIFFPURE_SIZE] / fwd_ms / 1e9:.1f} TFLOP/s), peak memory "
              f"{peak:.2f} GiB, mean |out - x| {moved:.4f} on {smi}")
        print(json.dumps({"diffusion_key": f"diffpure_{kind}", "size": DIFFPURE_SIZE,
                          "batch": DIFFPURE_BATCH, "t_star": DIFFPURE_T_STAR,
                          "unet_forwards": dp.forwards, "launches": n, "seconds": secs,
                          "forward_ms": fwd_ms, "img_per_s": DIFFPURE_BATCH / secs,
                          "peak_gib": peak, "reduced": []}))
        del dp, out
    del x
    torch.cuda.empty_cache()

    atk = tt.load_attack_class("diffattack")(model_name="resnet50", compute_dtype="bfloat16",
                                             device="cuda", **DIFFATTACK_GD_KW)
    atk.dp.unet = unet
    x = torch.from_numpy(np.random.RandomState(205).rand(1, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        y = atk.surrogate.apply(x).argmax(-1)
    fwd_ms = unet_ms(1, 224)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    delta = atk(x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = launches["diffattack"] = fused_sign_update.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps, its = DIFFATTACK_GD_KW["start_step"], DIFFATTACK_GD_KW["iterations"]
    reduced = [f"iterations {DIFFATTACK_KW['iterations']} -> {its}"]
    # inversion, the clean maps, each step's decode and its recomputation in
    # the backward, the last decode
    expected = steps + steps + its * 2 * steps + steps
    check(n == 0 and atk.dp.forwards == expected,
          f"diffattack: {atk.dp.forwards} UNet forwards (expected {expected}), {n} launches")
    check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
          f"diffattack: delta not finite or of shape {tuple(delta.shape)}")
    adv = x + delta
    check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
          "diffattack: x + delta leaves [0, 1]")
    loss0, loss1 = atk.losses
    check(loss1 < loss0, f"diffattack: the loss went from {loss0} at the first iteration to "
          f"{loss1} at the last")
    with torch.no_grad():
        ce0 = float(softmax_cross_entropy(atk.surrogate.apply(x), y).mean())
        ce1 = float(softmax_cross_entropy(atk.surrogate.apply(adv), y).mean())
    print(f"[20b diffusion] diffattack: resnet50 fp32 (--bf16 ignored, as in JAX), full UNet, "
          f"batch 1, 224², {steps} of {DIFFATTACK_GD_KW['diffusion_steps']} DDIM steps, {its} "
          f"AdamW iterations: {atk.dp.forwards} UNet forwards, {n} update-kernel launches, "
          f"{secs:.3f} s a call, {fwd_ms:.3f} ms a UNet forward (CUDA events, warm; "
          f"{flops[224] / fwd_ms / 1e9:.1f} TFLOP/s), peak "
          f"memory {peak:.2f} GiB, |delta|inf*255 = {float(delta.abs().max()) * 255:.2f}, loss "
          f"{loss0:.6g} at the first iteration -> {loss1:.6g} at the last, CE at the label "
          f"{ce0:.6g} -> {ce1:.6g} on {smi}; reduced: {', '.join(reduced)}")
    print(json.dumps({"diffusion_key": "diffattack", "model": "resnet50", "size": 224,
                      "batch": 1, **DIFFATTACK_GD_KW, "unet_forwards": atk.dp.forwards,
                      "launches": n, "seconds": secs, "forward_ms": fwd_ms, "peak_gib": peak,
                      "objective": [loss0, loss1], "ce": [ce0, ce1], "reduced": reduced}))
    del atk, unet, delta, adv, x
    torch.cuda.empty_cache()

    # (c) the CLI: AIM once a target class; DiffAttack on the tiny fallback
    # at 32² (at 224² its attention at 112² tokens is out of any card's reach)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            data = os.path.join(work, "data")
            names, clean = write_cli_data(data, CLI_GENERATION_IMAGES)
            common = ["--batchsize", str(CLI_GENERATION_IMAGES), "--input_dir", data]
            out_dir = os.path.join(work, "aim")
            fused_sign_update.launches = 0
            cli.main(["--attack", "aim", *common, "--output_dir", out_dir])
            n = launches["cli_aim"] = fused_sign_update.launches
            check(n == 0, f"aim: the CLI launched the update kernel {n} times")
            classes = sorted(int(c) for c in os.listdir(out_dir) if c.isdigit())
            check(classes == sorted(generation_target_classes),
                  f"aim: the CLI wrote the subdirectories {classes}")
            worst = max(check_cli_outputs(os.path.join(out_dir, str(c)), names, clean)
                        for c in classes)
            print(f"[20c diffusion] `--attack aim --batchsize {CLI_GENERATION_IMAGES}` over "
                  f"{len(names)} PNGs: one subdirectory for each of the {len(classes)} target "
                  f"classes, {len(names)} PNGs each, at most {worst:.0f} levels from their "
                  f"clean images")
            out_dir = os.path.join(work, "diffattack")
            with open(os.path.join(data, "labels.csv")) as f:
                header, *rows = f.read().splitlines()
            with open(os.path.join(data, "labels.csv"), "w") as f:  # toy_cnn has ten classes
                f.write(header + "\n" + "".join(f"{m},{(int(c) - 1) % 10 + 1}\n"
                                                for m, c in (r.split(",") for r in rows)))
            dataset = cli.AdvDataset
            cli.AdvDataset = functools.partial(dataset, size=(32, 32))
            try:
                fused_sign_update.launches = 0
                t0 = time.perf_counter()
                cli.main(["--attack", "diffattack", "--model", "toy_cnn", *common,
                          "--output_dir", out_dir])
                secs = time.perf_counter() - t0
            finally:
                cli.AdvDataset = dataset
            n = launches["cli_diffattack"] = fused_sign_update.launches
            check(n == 0, f"diffattack: the CLI launched the update kernel {n} times")
            written = sorted(m for m in os.listdir(out_dir) if m.endswith(".png"))
            check(written == names, f"diffattack: the CLI wrote {written}")
            imgs = [load_image(os.path.join(out_dir, m), (32, 32)) for m in names]
            check(all(np.isfinite(i).all() for i in imgs), "diffattack: a PNG is not finite")
            print(f"[20c diffusion] `--attack diffattack --model toy_cnn` over {len(names)} "
                  f"PNGs at 32² (the tiny fallback UNet, official steps and iterations): "
                  f"{len(written)} PNGs in {secs:.2f} s")
        finally:
            os.chdir(cwd)
    return launches


@contextlib.contextmanager
def weights_dir(path: str):
    """``$TA_TPU_WEIGHTS_DIR`` set to ``path`` inside."""
    old = os.environ.get("TA_TPU_WEIGHTS_DIR")
    os.environ["TA_TPU_WEIGHTS_DIR"] = path
    try:
        yield path
    finally:
        if old is None:
            del os.environ["TA_TPU_WEIGHTS_DIR"]
        else:
            os.environ["TA_TPU_WEIGHTS_DIR"] = old


def cosine_of(a, b) -> float:
    a, b = a.detach().cpu().double().flatten(), b.detach().cpu().double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def write_pngs(root: str, n: int, seed: int, side: int = 224):
    """``n`` seeded PNGs under ``root/images`` and a ``labels.csv``."""
    rng = np.random.RandomState(seed)
    names = [f"img_{i:04d}.png" for i in range(n)]
    save_images(os.path.join(root, "images"), rng.rand(n, side, side, 3).astype(np.float32),
                names)
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("filename,label\n" + "".join(f"{m},{rng.randint(1, 1001)}\n" for m in names))


def sd_card_vs_cpu() -> dict:
    """21a, fp32 with TF32 off, the same seeded weights on both: {check:
    (value, bound)}."""
    from transferattack_torch.defense.gd_unet import init_nonzero
    from transferattack_torch.generation import sd_text, sd_unet, sd_vae
    from transferattack_torch.generation import train as ttrain
    from transferattack_torch.generation.generators import GeneratorResnet
    from transferattack_torch.input_transformation.learned import SemanticPredictor
    from transferattack_torch.utils.bridge import load_flat_variables, state_dict_to_flat

    out = {}
    gen = torch.Generator().manual_seed(210)
    mods = {"unet": init_nonzero(sd_unet.SDUNet(**SD_TINY["unet"]), gen),
            "vae": init_nonzero(sd_vae.SDVAE(**SD_TINY["vae"]), gen),
            "text": init_nonzero(sd_text.CLIPTextEncoder(**SD_TINY["text"]), gen)}
    z, t = torch.randn(2, 4, 8, 8, generator=gen), torch.tensor([5.0, 641.0])
    ctx, img = torch.randn(2, 77, 16, generator=gen), torch.rand(2, 3, 16, 16, generator=gen)
    ids = torch.randint(0, 49408, (2, 77), generator=gen)
    res = {}
    for w in ("cpu", "cuda"):
        m = {k: copy.deepcopy(v).to(w, memory_format=torch.channels_last) for k, v in mods.items()}
        maps = {"attn": [], "cross_attn": []}
        cl = dict(memory_format=torch.channels_last)
        with torch.no_grad():
            eps = m["unet"](z.to(w).contiguous(**cl), t.to(w), ctx.to(w), maps)
            lat = m["vae"].encode((img.to(w) * 2 - 1).contiguous(**cl))
            res[w] = (eps, maps["attn"] + maps["cross_attn"], lat, m["vae"].decode(lat),
                      m["text"](ids.to(w)), [s.shape[-1] for s in maps["attn"]])
    (eps, maps, lat, dec, txt, tokens), (r_eps, r_maps, r_lat, r_dec, r_txt, r_tokens) = (
        res["cuda"], res["cpu"])
    check(tokens == r_tokens == [64, 16, 4, 16, 16, 64, 64],
          f"tiny SDUNet: self maps of {tokens} tokens on the card, {r_tokens} on the CPU")
    out["tiny SDUNet (attention at 8², 4², 2² tokens), output"] = (rel_err(eps, r_eps), DIFF_TOL)
    out["tiny SDUNet, its 7 self and 7 cross attention maps"] = (
        max(rel_err(a, b) for a, b in zip(maps, r_maps)), DIFF_TOL)
    out["tiny SDVAE at 16², encode"] = (rel_err(lat, r_lat), DIFF_TOL)
    out["tiny SDVAE, decode"] = (rel_err(dec, r_dec), DIFF_TOL)
    out["tiny CLIPTextEncoder, 77 tokens"] = (rel_err(txt, r_txt), DIFF_TOL)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fallbacks, replaced at once; hashed token ids
        atks = {w: tt.load_attack_class("diffattack")(
            backend="sd", model_name="toy_cnn", device=w, **SD_SMALL,
            **{k: (sd_unet.SDUNet, sd_vae.SDVAE, sd_text.CLIPTextEncoder)[i](**SD_TINY[k])
               for i, k in enumerate(("unet", "vae", "text"))}) for w in ("cpu", "cuda")}
    xs, y = torch.rand(2, 32, 32, 3, generator=gen), np.array([3, 7])
    far = 0.5 * torch.randn(2, 4, 8, 8, generator=gen)
    found, keeps = {}, {}
    for w, atk in atks.items():
        for k, module in mods.items():
            getattr(atk, k).load_state_dict(module.state_dict())
        state = atk.prepare(xs.to(w), y)
        keeps[w] = state["keep"]
        latent = (state["latent0"] + far.to(w)).requires_grad_(True)
        loss = atk.loss(latent, xs.to(w), torch.from_numpy(y).to(w), state)
        found[w] = loss.item(), torch.autograd.grad(loss, latent)[0]
    check(keeps["cuda"] == keeps["cpu"] == [1, 2, 3, 4],
          f"SD DiffAttack: the maps kept, {keeps['cuda']} on the card, {keeps['cpu']} on the CPU")
    (v, g), (ref, r) = found["cuda"], found["cpu"]
    what = "SD DiffAttack on toy_cnn at 32², 2 of 4 steps, loss off the clean latent"
    out[what] = (abs(v - ref) / abs(ref), LOSS_TOL)
    out[f"{what}, 1 - cosine of the latent gradients"] = (1 - cosine_of(g, r), 1 - GRAD_COSINE)

    # one generator training step against ResNet-18 at 64², and the writer's
    # round trip of the card's trained state
    net = GeneratorResnet()
    init_weights(net, torch.Generator().manual_seed(211))
    x64, target = torch.rand(2, 64, 64, 3, generator=gen), torch.full((2,), TRAIN_TARGET)
    steps = {}
    for w in ("cpu", "cuda"):
        surrogate = make_model("resnet18", pretrained=False, input_size=64, device=w)
        g = copy.deepcopy(net).to(w, memory_format=torch.channels_last)
        g.eval().requires_grad_(True)
        loss = ttrain.generator_loss(g, surrogate, x64.to(w), target.to(w), EPS)
        loss.backward()
        steps[w] = loss.item(), torch.cat([p.grad.flatten() for p in g.parameters()]), g, surrogate
    (v, gr, card_net, card_surrogate), (ref, r, _, _) = steps["cuda"], steps["cpu"]
    out["generator training at 64² on ResNet-18, loss"] = (abs(v - ref) / abs(ref), LOSS_TOL)
    out["generator training, 1 - cosine of the parameter gradients"] = (
        1 - cosine_of(gr, r), 1 - GRAD_COSINE)
    _, step = ttrain.make_train_step(card_net, card_surrogate, EPS, TRAIN_KW["lr"])
    step(x64.cuda(), target.cuda())
    back = GeneratorResnet()
    load_flat_variables(back, state_dict_to_flat(card_net))
    differ = sum(int(not torch.equal(a, b.cpu())) for a, b in zip(
        back.state_dict().values(), card_net.state_dict().values()))
    out["the writer's round trip of the card-trained generator, tensors not bit-exact"] = (
        differ, 0)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pams = {w: tt.load_attack_class("pam")(model_name="resnet18", device=w)
                for w in ("cpu", "cuda")}
    sp = SemanticPredictor()
    init_weights(sp, torch.Generator().manual_seed(212))
    x224 = torch.rand(1, 224, 224, 3, generator=gen)
    sps = {}
    for w, pam in pams.items():
        s = copy.deepcopy(sp).to(w).requires_grad_(True)
        loss = pam.sp_loss(s, x224.to(w), torch.tensor([5], device=w))
        loss.backward()
        sps[w] = loss.item(), torch.cat([p.grad.flatten() for p in s.parameters()])
    (v, gr), (ref, r) = sps["cuda"], sps["cpu"]
    out["train_sp step on ResNet-18 at 224², loss"] = (abs(v - ref) / abs(ref), LOSS_TOL)
    out["train_sp step, 1 - cosine of the predictor's gradients"] = (
        1 - cosine_of(gr, r), 1 - GRAD_COSINE)
    return out


def run_sd_family(dev, smi) -> dict:
    """Phase 21; returns each run's update-kernel launches (none)."""
    from transferattack_torch.generation import train as ttrain
    from transferattack_torch.generation.generators import GeneratorResnet
    from transferattack_torch.models import load_npz
    from transferattack_torch.utils.bridge import state_dict_to_flat
    from transferattack_torch.utils.data import AdvDataset

    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for what, (value, bound) in sd_card_vs_cpu().items():
        check(value <= bound, f"{what}: card vs CPU {value} (bound {bound})")
        print(f"[21a sd/train] {what}, seeded, fp32: card vs CPU {value:.3e} (bound {bound:g})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    launches = {}

    # (b) full width
    print(f"[21b sd/train] torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    with tempfile.TemporaryDirectory() as work, weights_dir(os.path.join(work, "weights")):
        data = os.path.join(work, "data")
        write_pngs(data, TRAIN_IMAGES, seed=213)
        net = GeneratorResnet()
        init_weights(net, torch.Generator().manual_seed(0))  # train_generator's own draw
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        path = ttrain.train_generator(data, TRAIN_TARGET, steps=TRAIN_STEPS, generator=net,
                                      log_every=10, device=dev, losses=losses, **TRAIN_KW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = launches["train_generator"] = fused_sign_update.launches
        ce = [float(v) for v in losses]
        check(n == 0 and len(ce) == TRAIN_STEPS, f"train_generator: {len(ce)} steps, {n} launches")
        check(all(np.isfinite(ce)) and ce[-1] < ce[0],
              f"train_generator: the target CE went from {ce[0]} to {ce[-1]}")
        written = load_npz(path)
        ttp = tt.load_attack_class("ttp")(device="cuda")
        idx = generation_target_classes.index(TRAIN_TARGET)
        loaded = state_dict_to_flat(ttp.generator(idx))  # a strict load of the file
        check(set(loaded) == set(written) and all(np.array_equal(loaded[k], written[k])
                                                  for k in written),
              f"ttp: the generator of class {TRAIN_TARGET} is not the trained file")
        xs, _, _ = next(AdvDataset(data).as_batches(TRAIN_KW["batchsize"]))
        x = torch.from_numpy(xs).to(dev)
        delta = ttp(x, None, idx=idx)
        check(bool(torch.isfinite(delta).all()) and 0 < float(delta.abs().max()) <= EPS + 1e-6,
              "ttp on the trained generator: delta not finite, zero or beyond eps")
        # a warm step's device time, and its operations, on the first batch
        surrogate = make_model("resnet50", device=dev)
        _, step = ttrain.make_train_step(net, surrogate, TRAIN_KW["eps"], TRAIN_KW["lr"])
        target = torch.full((len(xs),), TRAIN_TARGET, device=dev)
        with FlopCounterMode(display=False) as counter:
            step(x, target)
        tflop = counter.get_total_flops() / 1e12
        step_ms = median_ms(lambda: step(x, target), reps=5, burst=2, warmup=1)
        reduced = [f"steps 2000 -> {TRAIN_STEPS}"]
        batch = TRAIN_KW["batchsize"]
        print(f"[21b sd/train] train_generator: GeneratorResnet against resnet50 fp32, 224², "
              f"batch {batch}, {TRAIN_STEPS} Adam steps over {TRAIN_IMAGES} PNGs: {secs:.3f} s "
              f"(PNG reads and the surrogate's build included), {step_ms:.3f} ms a step (CUDA "
              f"events, warm; {tflop:.4f} TFLOP a step, {tflop / step_ms * 1e3:.1f} TFLOP/s), "
              f"{batch / step_ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, {n} update-kernel "
              f"launches, target CE {ce[0]:.6g} at the first step -> {ce[-1]:.6g} at the last; "
              f"{os.path.basename(path)} loads strictly into TTP, which runs on it, on {smi}; "
              f"reduced: {', '.join(reduced)}")
        print(json.dumps({"train_key": "train_generator", "model": "resnet50", "size": 224,
                          "batch": batch, "steps": TRAIN_STEPS, "seconds": secs,
                          "step_ms": step_ms, "tflop_per_step": tflop,
                          "img_per_s": batch / step_ms * 1e3, "peak_gib": peak, "launches": n,
                          "ce": [ce[0], ce[-1]], "reduced": reduced}))
        del ttp, surrogate, step, net, x, delta
        torch.cuda.empty_cache()

        sp_data = os.path.join(work, "sp_data")
        write_pngs(sp_data, SP_IMAGES, seed=214)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the predictor's own absence
            pam = tt.load_attack_class("pam")(model_name="resnet50", device=dev)
        pam.train_epoch = 1
        torch.cuda.synchronize()
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        sp = pam.train_sp(sp_data)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches["train_sp"] = fused_sign_update.launches
        x1 = torch.from_numpy(next(AdvDataset(sp_data).as_batches(1))[0]).to(dev)
        ratios = pam.ratios(x1)
        check(n == 0 and os.path.exists(os.path.join(work, "weights",
                                                     "pam_semantic_predictor.npz")),
              f"train_sp: {n} launches, or no pam_semantic_predictor.npz")
        check(pam.sp is sp and bool(((ratios >= 0.9) & (ratios <= 1.0)).all()),
              f"train_sp: ratios {ratios.tolist()} out of [0.9, 1]")
        s = copy.deepcopy(sp).requires_grad_(True)
        opt = ttrain.adam(s.parameters(), 1e-4)
        y1 = torch.tensor([1], device=dev)

        def sp_step():
            loss = pam.sp_loss(s, x1, y1)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

        sp_ms = median_ms(sp_step, reps=5, burst=2, warmup=1)
        reduced = ["train_epoch 15 -> 1", f"{SP_IMAGES} images"]
        print(f"[21b sd/train] PAM.train_sp on resnet50 fp32, 224², batch 1 (8 baseline-mixed "
              f"copies a step): {SP_IMAGES} steps in {secs:.3f} s (PNG reads included), "
              f"{sp_ms:.3f} ms a step (CUDA events, warm), {n} update-kernel launches, "
              f"pam_semantic_predictor.npz written and read, on {smi}; reduced: "
              f"{', '.join(reduced)}")
        print(json.dumps({"train_key": "train_sp", "model": "resnet50", "size": 224, "batch": 1,
                          "steps": SP_IMAGES, "seconds": secs, "step_ms": sp_ms, "launches": n,
                          "reduced": reduced}))
        del pam, sp, s, opt
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the three SD fallbacks, hashed token ids
        atk = tt.load_attack_class("diffattack")(backend="sd", model_name="resnet50",
                                                 compute_dtype="bfloat16", device=dev,
                                                 **SD_DIFFATTACK_KW)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    params = {k: sum(p.numel() for p in getattr(atk, k).parameters()) / 1e6
              for k in ("unet", "vae", "text")}
    print(f"[21b sd/train] SD-1.5 stack built and seeded on the card in {build:.2f} s: UNet "
          f"{params['unet']:.1f}M, VAE {params['vae']:.1f}M, CLIP text {params['text']:.1f}M "
          f"parameters")
    x = torch.from_numpy(np.random.RandomState(215).rand(1, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        y = atk.surrogate.apply(x).argmax(-1)
        ctx = atk.text(torch.from_numpy(atk.prompt_ids(y.cpu().numpy())[0]).long().to(dev))
        z = torch.randn(1, 4, 64, 64, device=dev).contiguous(memory_format=torch.channels_last)
        t = torch.full((1,), 500.0, device=dev)
        with FlopCounterMode(display=False) as counter:
            atk.unet(z, t, ctx)
        unet_tflop = counter.get_total_flops() / 1e12
        fwd_ms = median_ms(lambda: atk.unet(z, t, ctx), reps=5, burst=2, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    atk.forwards = 0
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    delta = atk(x, y.cpu().numpy())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = launches["diffattack_sd"] = fused_sign_update.launches
    steps, its = SD_DIFFATTACK_KW["start_step"], SD_DIFFATTACK_KW["iterations"]
    reduced = [f"iterations {DIFFATTACK_KW['iterations']} -> {its}"]
    # inversion, the clean trajectory, each iteration's decode (2 forwards a
    # step) and its recomputation in the backward, the last decode
    expected = steps + 2 * steps + its * 4 * steps + 2 * steps
    check(n == 0 and atk.forwards == expected,
          f"diffattack (SD): {atk.forwards} UNet forwards (expected {expected}), {n} launches")
    check(bool(torch.isfinite(delta).all()) and tuple(delta.shape) == tuple(x.shape),
          f"diffattack (SD): delta not finite or of shape {tuple(delta.shape)}")
    adv = x + delta
    check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
          "diffattack (SD): x + delta leaves [0, 1]")
    loss0, loss1 = atk.losses
    check(loss1 < loss0, f"diffattack (SD): the loss went from {loss0} at the first iteration "
          f"to {loss1} at the last")
    with torch.no_grad():
        ce0 = float(softmax_cross_entropy(atk.surrogate.apply(x), y).mean())
        ce1 = float(softmax_cross_entropy(atk.surrogate.apply(adv), y).mean())
    print(f"[21b sd/train] diffattack (SD backend): resnet50 fp32 (--bf16 ignored, as in JAX), "
          f"SD-1.5 widths, 512² (latent 64²), batch 1, {steps} of "
          f"{SD_DIFFATTACK_KW['diffusion_steps']} DDIM steps, {its} AdamW iterations: "
          f"{atk.forwards} UNet forwards, {n} update-kernel launches, {secs:.3f} s a call, "
          f"{fwd_ms:.3f} ms a UNet forward (CUDA events, warm; {unet_tflop:.4f} TFLOP, "
          f"{unet_tflop / fwd_ms * 1e3:.1f} TFLOP/s), peak memory {peak:.2f} GiB, "
          f"|delta|inf*255 = {float(delta.abs().max()) * 255:.2f}, loss {loss0:.6g} at the "
          f"first iteration -> {loss1:.6g} at the last, CE at the label {ce0:.6g} -> "
          f"{ce1:.6g} on {smi}; reduced: {', '.join(reduced)}")
    print(json.dumps({"sd_key": "diffattack_sd", "model": "resnet50", "size": 224,
                      "sd_size": 512, "batch": 1, **SD_DIFFATTACK_KW,
                      "params_m": params, "unet_forwards": atk.forwards, "launches": n,
                      "seconds": secs, "forward_ms": fwd_ms, "unet_tflop": unet_tflop,
                      "peak_gib": peak, "objective": [loss0, loss1], "ce": [ce0, ce1],
                      "reduced": reduced}))
    del atk, delta, adv, x, z, ctx
    torch.cuda.empty_cache()

    # (c) the CLIs: train a generator, then attack with it
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work, weights_dir(os.path.join(work, "weights")):
        os.chdir(work)
        try:
            data = os.path.join(work, "data")
            names, clean = write_cli_data(data, CLI_TRAIN_IMAGES)
            fused_sign_update.launches = 0
            t0 = time.perf_counter()
            path = ttrain.main(["--input_dir", data, "--target_class", str(TRAIN_TARGET),
                                "--steps", "2"])
            train_secs = time.perf_counter() - t0
            check(os.path.exists(path), f"the training CLI wrote no {path}")
            out_dir = os.path.join(work, "ttp")
            t0 = time.perf_counter()
            cli.main(["--attack", "ttp", "--batchsize", str(CLI_TRAIN_IMAGES), "--input_dir",
                      data, "--output_dir", out_dir])
            attack_secs = time.perf_counter() - t0
            n = launches["cli_train_ttp"] = fused_sign_update.launches
            check(n == 0, f"train -> ttp: {n} update-kernel launches")
            classes = sorted(int(c) for c in os.listdir(out_dir) if c.isdigit())
            check(classes == sorted(generation_target_classes),
                  f"ttp: the CLI wrote the subdirectories {classes}")
            worst = check_cli_outputs(os.path.join(out_dir, str(TRAIN_TARGET)), names, clean)
            ttp = tt.load_attack_class("ttp")(device="cuda")
            written, loaded = load_npz(path), state_dict_to_flat(ttp.generator(0))
            check(all(np.array_equal(loaded[k], written[k]) for k in written),
                  "ttp: class 24's generator is not the CLI-trained file")
            print(f"[21c sd/train] `python -m transferattack_torch.generation.train "
                  f"--target_class {TRAIN_TARGET} --steps 2` over {len(names)} PNGs "
                  f"({train_secs:.2f} s) wrote {os.path.basename(path)}; `--attack ttp` read "
                  f"it ({attack_secs:.2f} s): {len(classes)} subdirectories, class "
                  f"{TRAIN_TARGET}'s PNGs at most {worst:.0f} levels from their clean images")
        finally:
            os.chdir(cwd)
    return launches


def defense_card_vs_cpu(dev) -> dict:
    """22a, fp32 with TF32 off: {check: (value, bound)}."""
    from transferattack_torch.defense import at as tat
    from transferattack_torch.defense import diffpure as tdp
    from transferattack_torch.defense import nrp as tnrp
    from transferattack_torch.defense import rs as trs
    from transferattack_torch.defense.gd_unet import init_nonzero
    from transferattack_torch.models import nhwc

    out = {}
    gen = torch.Generator().manual_seed(220)
    for what, net, side in (("DUNet", tat.DUNet(), DUNET_SIDE), ("NRP nb 2", tnrp.NRPNet(nb=2), 64)):
        init_nonzero(net, gen)
        with torch.no_grad():  # BatchNorm's statistics off the identity too
            for m in net.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.05, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        x = torch.rand(2, side, side, 3, generator=gen)
        with torch.no_grad():
            ref = nhwc(copy.deepcopy(net).double(), x.double())
            card_out = nhwc(copy.deepcopy(net).to(dev, memory_format=torch.channels_last),
                            x.to(dev))
        out[f"{what} at {side}², fp32 card vs fp64 CPU"] = (rel_err(card_out, ref), DEFENSE_TOL)

    # Smooth's votes from one noise bank: equal, but where the CPU's top-two
    # logits nearly tie
    surrogates = {w: make_model("resnet18", pretrained=False, input_size=64, device=w)
                  for w in ("cpu", "cuda")}
    x = np.random.RandomState(221).rand(2, 64, 64, 3).astype(np.float32)
    bank = [np.random.RandomState(222 + i).randn(50, *x.shape).astype(np.float32)
            for i in range(2)]
    counts = {w: trs.Smooth(s, sigma=0.5)._count_votes(torch.from_numpy(x).to(w), None, 100, 50,
                                                        noises=bank)
              for w, s in surrogates.items()}
    with torch.no_grad():
        pts = torch.cat([torch.clamp(torch.from_numpy(x)[None] + 0.5 * torch.from_numpy(z), 0, 1)
                         .reshape(-1, 64, 64, 3) for z in bank])
        top2 = surrogates["cpu"].apply(pts).topk(2, -1).values
    margins = ((top2[:, 0] - top2[:, 1]) / top2.abs().max()).sort().values
    flips = int(np.abs(counts["cuda"] - counts["cpu"]).sum()) // 2
    near = float(margins[flips - 1]) / MARGIN_TOL if flips else 0.0
    out[f"Smooth votes, resnet18 64², 2 images x 100 draws: {flips} flipped, the flips' "
        f"largest CPU margin / {MARGIN_TOL:g}"] = (near, 1.0)

    # run_diffpure on the tiny fallback (ε is 0), the same noises on both
    with tempfile.TemporaryDirectory() as work, weights_dir(os.path.join(work, "weights")):
        data = os.path.join(work, "data")
        write_pngs(data, 2, seed=223)
        noises = [[np.random.RandomState(224 + i).randn(2, 64, 64, 3).astype(np.float32)
                   for i in range(6)]]  # t* 5: the diffusion's noise and 5 steps
        rows = {}
        for w in ("cpu", "cuda"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                path = tdp.run_diffpure(data, os.path.join(data, "images"), batchsize=2, t_star=5,
                                        model_name="resnet18", out_csv=f"dp_{w}.csv", device=w,
                                        noises=noises)
            with open(path) as f:
                rows[w] = f.read()
        out["run_diffpure, tiny fallback, t* 5, the same noises: CSVs differ"] = (
            float(rows["cuda"] != rows["cpu"]), 0.0)
    return out


def run_defense_family(dev, smi) -> dict:
    """Phase 22; returns each defense run's update-kernel launches (none)."""
    from transferattack_torch.defense import at as tat
    from transferattack_torch.defense import diffpure as tdp
    from transferattack_torch.defense import nrp as tnrp
    from transferattack_torch.defense import rs as trs
    from transferattack_torch.defense import run as trun
    from transferattack_torch.defense.gd_unet import GuidedDiffusionUNet, init_nonzero
    from transferattack_torch.scripts import bench_defense
    from transferattack_torch.utils.bridge import save_flat_variables

    # (a) the card against the CPU, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for what, (value, bound) in defense_card_vs_cpu(dev).items():
        check(value <= bound, f"{what}: {value} (bound {bound})")
        print(f"[22a defense] {what}: {value:.3e} (bound {bound:g})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    launches = {}

    # (b) full width: the bench's lines, then each defense's entry point
    print(f"[22b defense] torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    lines = bench_defense.main([])
    print(f"[22b defense] bench_defense: {time.perf_counter() - t0:.2f} s with its builds")
    launches["bench"] = fused_sign_update.launches
    check([ln["defense"] for ln in lines] == list(bench_defense.DEFENSES)
          and all(np.isfinite(ln["sec_per_image"]) and ln["sec_per_image"] > 0 for ln in lines),
          f"bench_defense printed {lines}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded fallbacks
        smooth = trs.Smooth(make_model("resnet50", device=dev), sigma=0.5)
    x = torch.from_numpy(np.random.RandomState(225).rand(RS_IMAGES, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    preds = smooth.predict(x, gen, n=RS_N)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cert, radii = smooth.certify(x, gen, n=RS_N)
    certify_s = time.perf_counter() - t0
    launches["rs"] = fused_sign_update.launches
    check(preds.shape == cert.shape == radii.shape == (RS_IMAGES,)
          and all(-1 <= int(p) < 1000 for p in np.concatenate([preds, cert]))
          and bool((radii >= 0).all()) and all(r == 0 for p, r in zip(cert, radii) if p == -1),
          f"Smooth: predictions {preds}, certified {cert}, radii {radii}")
    print(f"[22b defense] Smooth on resnet50 fp32, 224², {RS_IMAGES} images, sigma 0.5, N {RS_N} "
          f"in chunks of 50: predict {predict_s:.3f} s ({RS_IMAGES * RS_N / predict_s:.0f} "
          f"noisy images/s; predictions {preds.tolist()}), certify (n0 100, n {RS_N}) "
          f"{certify_s:.3f} s (classes {cert.tolist()}, radii max {radii.max():.4f}) on {smi}")
    del smooth, x
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work, weights_dir(os.path.join(work, "weights")):
        data = os.path.join(work, "data")
        write_pngs(data, DEFENSE_IMAGES, seed=226)
        images = os.path.join(data, "images")
        purified = os.path.join(work, "purified")
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tnrp.run_nrp(data, images, purified, batchsize=DEFENSE_IMAGES, dynamic=True,
                         device=dev)
        nrp_s = time.perf_counter() - t0
        launches["nrp"] = fused_sign_update.launches
        written = sorted(os.listdir(purified))
        check(len(written) == DEFENSE_IMAGES, f"run_nrp wrote {written}")
        moved = max(float(np.abs(load_image(os.path.join(purified, m))
                                 - load_image(os.path.join(images, m))).max()) for m in written)
        print(f"[22b defense] run_nrp, 23 RRDBs fp32, dynamic (x + 0.05·N(0, 1) within ±16/255), "
              f"{DEFENSE_IMAGES} PNGs at 224²: {nrp_s:.3f} s with the build and PNG IO, "
              f"purified PNGs up to {moved * 255:.0f} levels from the input")

        # the ImageNet-256 UNet seeded on the card and written as
        # diffpure_unet.npz, so that run_diffpure takes its 256² path
        t0 = time.perf_counter()
        with torch.device(dev):
            unet = GuidedDiffusionUNet()
        init_nonzero(unet, torch.Generator(device=dev).manual_seed(227))
        save_flat_variables(unet, os.path.join(work, "weights", "diffpure_unet.npz"))
        del unet
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        fused_sign_update.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        path = tdp.run_diffpure(data, images, batchsize=DEFENSE_IMAGES, device=dev)
        torch.cuda.synchronize()
        diffpure_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches["diffpure"] = fused_sign_update.launches
        with open(path) as f:
            rows = f.read().splitlines()
        check(len(rows) == DEFENSE_IMAGES + 1, f"run_diffpure wrote {rows}")
        print(f"[22b defense] run_diffpure, the full UNet ({write_s:.2f} s to seed it on the card "
              f"and write diffpure_unet.npz), resnet101, sde t* 150 at 256², batch "
              f"{DEFENSE_IMAGES}: {diffpure_s:.3f} s with the load and PNG reads (150 UNet "
              f"forwards), peak memory {peak:.2f} GiB; predictions {rows[1:]} on {smi}")
    torch.cuda.empty_cache()

    # (c) the CLI on phase 9's PNGs; NRP's purified PNGs scored by --eval
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work, weights_dir(os.path.join(work, "weights")):
        os.chdir(work)
        try:
            data = os.path.join(work, "data")
            names, _ = write_cli_data(data, DEFENSE_IMAGES)
            images = os.path.join(data, "images")
            for defense in ("at", "hgd", "rs", "nrp", "diffpure"):
                out = io.StringIO()
                fused_sign_update.launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    trun.main(["--defense", defense, "--input_dir", data, "--output_dir", images,
                               "--purified_dir", os.path.join(work, "purified"),
                               "--batchsize", str(DEFENSE_IMAGES)])
                secs = time.perf_counter() - t0
                n = launches[f"cli_{defense}"] = fused_sign_update.launches
                last = out.getvalue().strip().splitlines()[-1]
                print(f"[22c defense] --defense {defense} ({secs:.2f} s, {n} launches): {last}")
                if defense == "nrp":
                    check(last.startswith("Purified images written to") and
                          "python -m transferattack_torch.main --eval" in last, f"nrp: {last!r}")
                    out = io.StringIO()
                    with contextlib.redirect_stdout(out):
                        cli.main(["--eval", "--eval_models", "resnet50", "--input_dir", data,
                                  "--output_dir", os.path.join(work, "purified")])
                    scored = re.findall(r"^resnet50: (\d+\.\d)$", out.getvalue(), re.M)
                    check(len(scored) == 1, f"--eval on the purified PNGs: {out.getvalue()!r}")
                    print(f"[22c defense] --eval --eval_models resnet50 on NRP's purified PNGs: "
                          f"resnet50: {scored[0]}")
                else:
                    check(re.fullmatch(rf"{defense.upper()} ASR: \d+\.\d\d%", last) is not None,
                          f"{defense}: {last!r}")
        finally:
            os.chdir(cwd)
    check(not any(launches.values()), f"the defenses launched the update kernel: {launches}")
    return launches


def seeded_state_dict(module, seed: int) -> dict:
    """``module``'s ``state_dict`` (the reference's names) filled from a
    seed: kernels at lecun-normal scale, norms and statistics off the
    identity, small biases, tokens and embeddings."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = rng.normal(0, 0.05, shape)
        elif k.endswith("weight") and len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
        elif k.endswith("weight"):
            a = rng.normal(1.0, 0.1, shape)
        else:
            a = rng.normal(0, 0.05, shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def run_tools_family(dev, smi) -> dict:
    """Phase 23; returns the update-kernel launches of the sweep's attack,
    and of one call of each bench and profile case."""
    from transferattack_torch.models import build_module
    from transferattack_torch.scripts import asr_gate, bench_families, profile_vit, sweep
    from transferattack_torch.utils import convert
    from transferattack_torch.utils.weights_manifest import fallback_weights_used, reset_fallbacks

    launches = {}
    with tempfile.TemporaryDirectory() as work, weights_dir(os.path.join(work, "weights")):
        # (a) conversion, then the converted weights on the card
        downloads = os.path.join(work, "downloads")
        os.makedirs(downloads)
        states = {}
        for i, name in enumerate(CONVERT_MODELS):
            states[name] = seeded_state_dict(build_module(name).backbone, seed=230 + i)
            torch.save(states[name], os.path.join(downloads, f"{name}.pth"))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            done = convert.convert_all(downloads)
        all_s = time.perf_counter() - t0
        check(sorted(n for n, _, _ in done) == sorted(CONVERT_MODELS) and "✗" not in
              out.getvalue().split("# weights manifest")[0], f"--all: {out.getvalue()[:2000]}")
        for name, path, secs in done:
            print(f"[23a tools] utils.convert --all: {name} → {os.path.basename(path)} "
                  f"({os.path.getsize(path) / 2**20:.1f} MiB) in {secs:.2f} host s")
        print(f"[23a tools] --all over {len(done)} checkpoints: {all_s:.2f} host s")
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for i, name in enumerate(CONVERT_MODELS):
            reset_fallbacks()
            converted = make_model(name, device=dev)
            check(fallback_weights_used() == [], f"{name}: fallback {fallback_weights_used()}")
            straight = build_module(name)
            straight.backbone.load_state_dict(states[name])
            straight = straight.eval().to(device=dev, memory_format=torch.channels_last)
            size = converted.input_size
            x = torch.from_numpy(np.random.RandomState(240 + i).rand(2, size, size, 3)
                                 .astype(np.float32)).to(dev)
            with torch.inference_mode():
                out_c, ref = converted.apply(x), straight(x)
            err, rel = errors(out_c, ref)
            check(rel <= CONVERT_TOL, f"{name}: converted vs state_dict max|d|/max|ref| = {rel}")
            print(f"[23a tools] {name}: make_model on the card, no fallback; fp32 logits "
                  f"{'bit-equal to' if err == 0 else f'{rel:.3e} of max from'} the module loaded "
                  f"straight from the state_dict (bound {CONVERT_TOL:g})")
            del converted, straight
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        del states
        torch.cuda.empty_cache()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            convert.main(["--list"])
        listed = out.getvalue()
        check(all(f" ✓ {n} " in listed for n in CONVERT_MODELS), f"--list: {listed[:1500]}")
        print(f"[23a tools] --list: {listed.splitlines()[0]}")

        # (b) the sweep's --smoke through the CLI, the converted ResNet-50 in place
        fused_sign_update.launches = 0
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rec = sweep.run_smoke(os.path.join(work, "smoke"), device="cuda",
                                  cli=sweep.inprocess_cli)
        torch.cuda.synchronize()
        smoke_s = time.perf_counter() - t0
        n = launches["sweep"] = fused_sign_update.launches
        check(rec["ok"] and n == 10 and "resnet50" not in rec["fallback_weights_used"],
              f"sweep --smoke: {rec}, {n} launches")
        print(f"[23b tools] sweep --smoke ({smoke_s:.2f} s with the eval): {json.dumps(rec)}; "
              f"{n} update-kernel launches; attack_meta.json fallbacks "
              f"{rec['fallback_weights_used']}")

        # (c) the family bench, its calibration cut
        print(f"[23c tools] bench_families --only mifgsm,ssm --batch 32: reduced, calibrated to "
              f"{TOOLS_TARGET_S:g} s of calls (10 s in full), on {smi}")
        for line in bench_families.main(["--only", "mifgsm,ssm", "--batch", "32", "--reps", "2",
                                         "--target_s", str(TOOLS_TARGET_S)]):
            check("error" not in line and line["img_per_sec"] > 0 and line["launches"] == 10,
                  f"bench_families: {line}")
            launches[f"bench_{line['attack']}"] = line["launches"]
            print(f"[23c tools] {line['attack']}: {line['img_per_sec']} img/s over {line['reps']} "
                  f"calls, cold call {line['compile_s']} s, {line['launches']} launches a call, "
                  f"peak memory {line['peak_gib']} GiB")
        torch.cuda.empty_cache()

        # (d) the ViT profile at batch 32, with a trace
        trace_dir = os.path.join(work, "traces")
        for line in profile_vit.main(["--batches", "32", "--target_s", str(TOOLS_TARGET_S),
                                      "--trace-dir", trace_dir]):
            check("error" not in line and line["launches"] == 10 and os.path.getsize(
                line["trace"]) > 0, f"profile_vit: {line}")
            launches[f"profile_{line['case'].split('/')[0]}"] = line["launches"]
            print(f"[23d tools] profile_vit {line['case']} batch {line['batch']}: "
                  f"{line['ms_per_iter']} ms an iteration, {line['img_per_sec']} img/s over "
                  f"{line['reps']} calls (reduced: calibrated to {TOOLS_TARGET_S:g} s), peak "
                  f"{line['peak_gib']} GiB, trace {os.path.getsize(line['trace']) / 2**20:.1f} "
                  f"MiB on {smi}")
        torch.cuda.empty_cache()

        # (e) the gate over the converted weights less the CNN surrogate
        gate_weights = os.path.join(work, "gate_weights")
        os.makedirs(gate_weights)
        for name in CONVERT_MODELS[1:]:
            os.symlink(os.path.join(work, "weights", f"{name}.npz"),
                       os.path.join(gate_weights, f"{name}.npz"))
        out = io.StringIO()
        with weights_dir(gate_weights), contextlib.redirect_stdout(out):
            rc = asr_gate.main(["--rows", "mifgsm", "--columns", "cnn", "--input_dir",
                                os.path.join(work, "smoke", "data"),
                                "--out_root", os.path.join(work, "gate")])
        lines = out.getvalue().splitlines()
        check(rc == 0 and sum(ln.startswith("[SKIP]") for ln in lines) == 4,
              f"asr_gate: rc {rc}, {lines}")
        print(f"[23e tools] asr_gate --rows mifgsm --columns cnn (no resnet50.npz): exit {rc}; "
              + "; ".join(ln for ln in lines if ln.startswith("ASR gate: 0 ok")))
    return launches


def resume_cli(work: str) -> dict:
    """24b in ``work``: a targeted MI-FGSM run of ``CLI_RESUME_EPOCH``
    iterations through the CLI, uninterrupted, then in a subprocess with
    ``--checkpoint_every`` killed once its first checkpoint exists and run
    again to its end.  Returns the launches and the data's paths."""
    data = os.path.join(work, "data")
    rng = np.random.RandomState(24)
    names = [f"img_{i:04d}.png" for i in range(CLI_RESUME_IMAGES)]
    save_images(os.path.join(data, "images"),
                rng.rand(CLI_RESUME_IMAGES, 224, 224, 3).astype(np.float32), names)
    with open(os.path.join(data, "labels.csv"), "w") as f:
        f.write("filename,label,targeted_label\n" + "".join(
            f"{m},{rng.randint(1, 1001)},{rng.randint(1, 1001)}\n" for m in names))
    common = ["--attack", "mifgsm", "--model", "resnet50", "--bf16", "--targeted",
              "--epoch", str(CLI_RESUME_EPOCH), "--batchsize", str(CLI_RESUME_IMAGES),
              "--input_dir", data]
    plain_dir, resumed_dir = os.path.join(work, "plain"), os.path.join(work, "resumed")
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    cli.main([*common, "--output_dir", plain_dir])
    torch.cuda.synchronize()
    plain_s, plain_launches = time.perf_counter() - t0, fused_sign_update.launches
    check(plain_launches == CLI_RESUME_EPOCH, f"the uninterrupted run launched the update "
          f"kernel {plain_launches} times, expected {CLI_RESUME_EPOCH}")

    resumed = [*common, "--output_dir", resumed_dir, "--checkpoint_every", str(CLI_RESUME_EVERY)]
    ckpt = os.path.join(resumed_dir, "_ckpt", "batch_00000")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
    log = os.path.join(work, "killed_run.log")
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "transferattack_torch.main", *resumed],
                                cwd=work, env=env, stdout=err, stderr=subprocess.STDOUT)
        try:
            while not os.path.exists(ckpt) and proc.poll() is None \
                    and time.perf_counter() - t0 < 300:
                time.sleep(0.02)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    check(os.path.exists(ckpt), f"no checkpoint appeared before the run ended (exit "
          f"{proc.returncode}): {Path(log).read_text()[-2000:]}")
    killed_s = time.perf_counter() - t0
    saved = int(torch.load(ckpt, map_location="cpu", weights_only=True)["step"])
    check(saved % CLI_RESUME_EVERY == 0 and 0 < saved < CLI_RESUME_EPOCH,
          f"checkpoint at step {saved}")
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    cli.main(resumed)
    torch.cuda.synchronize()
    resumed_s, resumed_launches = time.perf_counter() - t0, fused_sign_update.launches
    check(resumed_launches == CLI_RESUME_EPOCH - saved,
          f"the resumed run launched the update kernel {resumed_launches} times, expected "
          f"{CLI_RESUME_EPOCH - saved} (resumed at step {saved})")
    differ = sum(Path(plain_dir, m).read_bytes() != Path(resumed_dir, m).read_bytes()
                 for m in names)
    check(differ == 0, f"{differ} of {len(names)} PNGs of the resumed run differ from "
          "the uninterrupted run's")
    check(not os.path.exists(os.path.join(resumed_dir, "_ckpt")), "_ckpt left behind")
    print(f"[24b resume] CLI, targeted MI-FGSM ResNet-50 bf16, {CLI_RESUME_EPOCH} iterations, "
          f"batch {CLI_RESUME_IMAGES}, --checkpoint_every {CLI_RESUME_EVERY}: uninterrupted "
          f"{plain_s:.2f} s, {plain_launches} launches; a subprocess killed (SIGKILL) after "
          f"{killed_s:.2f} s with its checkpoint at step {saved}, then resumed in "
          f"{resumed_s:.2f} s with {resumed_launches} launches: {len(names)} PNGs byte for "
          f"byte the uninterrupted run's, _ckpt removed")
    return {"data": data, "adv": resumed_dir,
            "launches": {"cli_uninterrupted": plain_launches, "cli_resumed": resumed_launches}}


def run_parallel_family(dev, smi, main_img_s: float) -> dict:
    """Phase 24: (a) the main path in segments, resumed; (b) the CLI killed
    and resumed; (c) the runner and the sharded eval on NCCL at a world of
    1.  Returns the update-kernel launches of each run."""
    launches = {}
    # (a) the main path in segments of RESUME_EVERY, and a run stopped
    # after its second segment's checkpoint, then resumed
    attack = tt.load_attack_class("mifgsm")(model_name="resnet50",
                                            compute_dtype="bfloat16", device="cuda")
    x = torch.from_numpy(np.random.RandomState(2).rand(*MAIN_SHAPE).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = attack.model.apply(x).argmax(-1)
    want = attack(x, y)
    again = attack(x, y)
    torch.cuda.synchronize()
    spread = float((want - again).abs().max())
    print(f"[24a resume] two uninterrupted main-path calls: max|d1 - d2| = {spread:g}")
    with tempfile.TemporaryDirectory() as work:
        ckpt_dir = os.path.join(work, "ckpt")
        fused_sign_update.launches = 0
        got = attack.call_resumable(x, y, ckpt_dir, every=RESUME_EVERY)
        torch.cuda.synchronize()
        launches["resume_main_path"] = fused_sign_update.launches
        check(launches["resume_main_path"] == 10, f"resumable call launched the update "
              f"kernel {launches['resume_main_path']} times, expected 10")
        gap = float((got - want).abs().max())
        check(gap <= spread, f"segments of {RESUME_EVERY} vs one call: max|d| = {gap}, two "
              f"calls {spread}")
        save, saved = tattack.save_state, []

        def save_then_stop(path, state, gen):
            save(path, state, gen)
            saved.append(path)
            if len(saved) == 2:
                raise InterruptedError("stopped after the second segment")

        tattack.save_state = save_then_stop
        try:
            attack.call_resumable(x, y, ckpt_dir, every=RESUME_EVERY)
            check(False, "the stopped run did not stop")
        except InterruptedError:
            pass
        finally:
            tattack.save_state = save
        path = saved[-1]
        mib = os.path.getsize(path) / 2 ** 20
        gen = torch.Generator(device=dev).manual_seed(0)
        state = tattack.load_state(path, gen, dev)
        torch.cuda.synchronize()
        save_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            save(os.path.join(work, "timed"), state, gen)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        resumed = attack.call_resumable(x, y, ckpt_dir, every=RESUME_EVERY)
        torch.cuda.synchronize()
        gap_resumed = float((resumed - want).abs().max())
        check(gap_resumed <= spread, f"stopped at step {state.step} and resumed vs one call: "
              f"max|d| = {gap_resumed}, two calls {spread}")
        check(not os.path.exists(ckpt_dir), "the resumed call left its checkpoint")
    print(f"[24a resume] MI-FGSM ResNet-50 bf16, {MAIN_SHAPE}, segments of {RESUME_EVERY}: "
          f"max|d| against one call {gap:g}, stopped at step {state.step} and resumed "
          f"{gap_resumed:g} (bound {spread:g}); {launches['resume_main_path']} launches; a "
          f"checkpoint (delta, momentum, step, generator) is {mib:.1f} MiB, saved in "
          f"{statistics.median(save_ms):.1f} ms (median of 3, the host's temporary "
          f"directory) on {smi}")
    del got, resumed, again, state

    # (b) the CLI killed and resumed, in a working directory of its own
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            cli_run = resume_cli(work)
            launches.update(cli_run["launches"])

            # (c) the runner and the sharded eval on NCCL at a world of 1
            dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous", rank=0,
                                    world_size=1, device_id=dev)
            try:
                runner = ShardedAttackRunner(attack)
                check(runner.shard, "the main path's key does not shard")
                fused_sign_update.launches = 0
                got = runner(x, y)
                torch.cuda.synchronize()
                launches["runner_world1"] = fused_sign_update.launches
                check(launches["runner_world1"] == 10, f"the runner launched the update "
                      f"kernel {launches['runner_world1']} times, expected 10")
                check(torch.equal(got, want) or float((got - want).abs().max()) <= spread,
                      f"runner vs the attack: max|d| = {float((got - want).abs().max())}")
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runner(x, y)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                runner_img_s = MAIN_SHAPE[0] / statistics.median(times)
                eval_model = make_model("resnet50", device=dev)
                ds = AdvDataset(input_dir=cli_run["data"], output_dir=cli_run["adv"],
                                targeted=True, eval_mode=True)
                sharded_asr = cli.evaluate_model(eval_model, ds, CLI_RESUME_IMAGES, True, dev)
                launches.update(run_split_keys(dev, smi)["launches"])
            finally:
                dist.destroy_process_group()
            plain_asr = cli.evaluate_model(eval_model, ds, CLI_RESUME_IMAGES, True, dev)
            check(sharded_asr == plain_asr, f"sharded eval ASR {sharded_asr}, plain {plain_asr}")
        finally:
            os.chdir(cwd)
    print(f"[24c parallel] ShardedAttackRunner on NCCL, world 1, main path: bit-exact "
          f"{torch.equal(got, want)}, {launches['runner_world1']} launches, "
          f"{runner_img_s:.2f} img/s (calls {', '.join(f'{t:.4f}' for t in times)} s) "
          f"beside phase 5's {main_img_s:.2f}; sharded eval ASR {sharded_asr:.2f} = plain "
          f"{plain_asr:.2f} (ResNet-50 on 24b's PNGs, targeted) on {smi}")
    del attack, x, y, want, got, eval_model
    torch.cuda.empty_cache()
    return {"launches": launches, "runner_img_s": runner_img_s}


def run_split_keys(dev, smi) -> dict:
    """Phase 24d, inside 24c's process group (NCCL, a world of 1): each key
    of :data:`SPLIT_KEYS` through ``ShardedAttackRunner`` and through its own
    call, from one seed.  At a world of 1 a rank's rows of a one-process
    draw are the whole draw, its share of a batch mean the mean and a
    gathered batch the batch, so the split path must give the attack's own
    delta bit for bit.  Returns the runner's update-kernel launches and each
    path's img/s."""
    check(dist.is_initialized() and dist.get_world_size() == 1, "24d needs 24c's group")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # two calls of a key, the same bits
    launches, img_s = {}, {}
    try:
        resnet = make_model("resnet50", device="cuda")
        vit = make_model("vit_base_patch16_224", device="cuda")
        x = torch.from_numpy(np.random.RandomState(SPLIT_SEED).rand(GRADIENT_BATCH, 224, 224, 3)
                             .astype(np.float32)).to(dev)
        for key, rule in SPLIT_KEYS:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                atk = tt.load_attack_class(key)(model_name=vit if key == "tgr" else resnet,
                                                compute_dtype="bfloat16", device="cuda",
                                                **SPLIT_CAPS.get(key, {}))
            reduced = {k: [official_defaults(key)[k], v]
                       for k, v in SPLIT_CAPS.get(key, {}).items()}
            with torch.no_grad():  # the labels: the plain surrogate's predictions
                y = (plain_view(atk.model) if key == "tgr" else atk.model).apply(x).argmax(-1)
            labels = torch.stack([y, (y + 500) % 1000], dim=1) if atk.targeted else y
            runner = ShardedAttackRunner(atk)
            check(runner.shard, f"{key}: the runner does not split it")

            def call(fn):
                gen = torch.Generator(device=dev).manual_seed(SPLIT_SEED)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                delta = fn(x, labels, generator=gen)
                torch.cuda.synchronize()
                return delta, time.perf_counter() - t0

            want, cold_s = call(atk)  # the reference, and the warm-up
            fused_sign_update.launches = 0
            got, split_s = call(runner)
            n = launches[f"split_{key}"] = fused_sign_update.launches
            again, own_s = call(atk)
            exact = torch.equal(got, want)
            check(torch.equal(again, want), f"{key}: two calls of its own differ by "
                  f"{float((again - want).abs().max())}")
            check(exact, f"{key}: the runner's delta differs from its own call's by "
                  f"{float((got - want).abs().max())}")
            expect = expected_launches(key, atk)
            check(n == expect, f"{key}: the runner launched the update kernel {n} times, "
                  f"its code implies {expect}")
            linf = float(got.abs().max())
            check(bool(torch.isfinite(got).all()) and 0 < linf <= atk.eps + 1e-6,
                  f"{key}: |delta|inf = {linf}")
            img_s[key] = {"runner": GRADIENT_BATCH / split_s, "own": GRADIENT_BATCH / own_s}
            arch = "ViT-B/16" if key == "tgr" else "ResNet-50"
            print(f"[24d split] {key} ({rule}): {arch} bf16, batch {GRADIENT_BATCH}, "
                  f"{atk.epoch} iterations, through the runner on NCCL at a world of 1: "
                  f"bit-exact {exact} against its own call, {n} update-kernel launches "
                  f"(expected {expect}), {img_s[key]['runner']:.2f} img/s ({split_s:.3f} s) "
                  f"beside its own call's {img_s[key]['own']:.2f} ({own_s:.3f} s; the "
                  f"first, cold, {cold_s:.3f} s)"
                  f"{f', reduced {reduced}' if reduced else ''} on {smi}")
            print(json.dumps({"split_key": key, "rule": rule, "model": f"{arch} bf16",
                              "batch": GRADIENT_BATCH, "epoch": atk.epoch,
                              "bit_exact": exact, "launches": n,
                              "runner_seconds": split_s, "own_seconds": own_s,
                              "runner_img_per_s": img_s[key]["runner"],
                              "own_img_per_s": img_s[key]["own"], "reduced": reduced}))
            del atk, runner, want, got, again
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del resnet, vit, x
    torch.cuda.empty_cache()
    return {"launches": launches, "img_s": img_s}


def run_cli(work: str):
    """Phase 9 in ``work``: seeded PNGs labelled by the surrogate, the
    attack, then the eval.  Returns the update-kernel launches of the
    attack's first run."""
    data, adv = os.path.join(work, "data"), os.path.join(work, "adv")
    names, clean = write_cli_data(data, CLI_IMAGES)

    # the attack cold, then once more warm: the second run's rate is free
    # of the first calls at batch 32 (cuDNN's choice of plans, the
    # allocator's growth)
    for run, out_dir in (("cold", adv), ("warm", adv + "_warm")):
        print(f"[9 cli] attack, {run}:")
        fused_sign_update.launches = 0
        cli.main(["--attack", "mifgsm", "--model", "resnet50", "--bf16", "--batchsize",
                  str(CLI_BATCH), "--input_dir", data, "--output_dir", out_dir])
        torch.cuda.synchronize()
        launches = fused_sign_update.launches
        check(launches == 2 * 10, f"the CLI launched the update kernel {launches} "
              f"times in its {run} run, expected 20 (2 batches of 10 iterations)")
        worst = check_cli_outputs(out_dir, names, clean)
        print(f"[9 cli] {run}: {CLI_IMAGES} PNGs at 224², at most {worst:.0f} levels "
              f"from their clean images (eps 16/255); {launches} update-kernel launches")

    out = io.StringIO()  # the eval's lines, printed and parsed
    with contextlib.redirect_stdout(out):
        cli.main(["--eval", "--batchsize", str(CLI_BATCH), "--input_dir", data,
                  "--output_dir", adv])
    print(out.getvalue(), end="")
    asr = dict(re.findall(r"^(\S+): (\d+\.\d)$", out.getvalue(), re.M))
    check(list(asr) == EVAL_MODELS, f"eval lines for {list(asr)}, expected {EVAL_MODELS}")
    check(float(asr["resnet50"]) >= 90, f"white-box ResNet-50 ASR {asr['resnet50']} < 90")
    check(os.path.exists(os.path.join(work, "results_eval.txt")), "no results_eval.txt")
    return launches


def phase_seconds(n: int, clock: list) -> None:
    """Print phase ``n``'s seconds and the script's so far."""
    now = time.perf_counter()
    print(f"[time] phase {n}: {now - clock[-1]:.1f} s; {now - clock[0]:.1f} s since phase 1")
    clock.append(now)


def main() -> None:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this script runs on a CUDA card")
    dev = torch.device("cuda", 0)

    clock = [time.perf_counter()]  # each phase's seconds, for the time budget

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = card()
    print(f"[1 device] torch.cuda.get_device_name(0): {name}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    phase_seconds(1, clock)

    # 2. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.build, KERNEL_SOURCES))
    for src in KERNEL_SOURCES:
        _build.load_library(src)
    built = ", ".join(str(_build.library_path(s).relative_to(REPO)) for s in KERNEL_SOURCES)
    print(f"[2 build] {built} built and loaded in {time.perf_counter() - t0:.2f} s")
    phase_seconds(2, clock)

    # 3. kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    # the main path's shape, phase 11's and the CLI's (batch 32), a ragged one
    for shape in (MAIN_SHAPE, (GRADIENT_BATCH, 224, 224, 3), (3, 37, 41, 3)):
        d, m, x = update_inputs(shape, gen, dev)
        out = fused_sign_update(d, m, x, ALPHA, EPS, 0.0, 1.0)
        ref = fused_sign_update_plain(d, m, x, ALPHA, EPS, 0.0, 1.0)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(out, ref), f"kernel differs from plain at {shape}: {err}")
        print(f"[3 kernel] {shape}: bit-exact with the plain version")
    d, m, x = update_inputs(MAIN_SHAPE, gen, dev)
    kernel_ms = median_ms(lambda: fused_sign_update(d, m, x, ALPHA, EPS, 0.0, 1.0))
    plain_ms = median_ms(lambda: fused_sign_update_plain(d, m, x, ALPHA, EPS, 0.0, 1.0))
    update_bound, update_bound_by = bound_ms(4 * nbytes(d))  # d, m, x in; out
    print(f"[3 kernel] {MAIN_SHAPE} fp32, median of 20 bursts of 10 on {smi}: kernel "
          f"{kernel_ms:.4f} ms ({4 * nbytes(d) / kernel_ms / 1e9:.1f} TB/s of 16 B/element), "
          f"plain {plain_ms:.4f} ms, bound {update_bound:.4f} ms")
    del d, m, x
    phase_seconds(3, clock)

    # 4. fp32 slice: the card against the CPU
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    xs = rng.rand(2, 224, 224, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    deltas = {}
    for where in ("cuda", "cpu"):
        attack = tt.load_attack_class("mifgsm")(model_name="resnet50", epoch=3,
                                                device=where)
        deltas[where] = attack(xs, ys).cpu().numpy()
    agree = float((np.sign(deltas["cuda"]) == np.sign(deltas["cpu"])).mean())
    check(agree > 0.99, f"fp32 delta sign agreement card vs CPU {agree}")
    print(f"[4 fp32] ResNet-50 MI-FGSM, 2 x 224², 3 iterations: delta sign "
          f"agreement card vs CPU {agree:.6f}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    phase_seconds(4, clock)

    # 5. main path
    attack = tt.load_attack_class("mifgsm")(model_name="resnet50",
                                            compute_dtype="bfloat16", device="cuda")
    x = torch.from_numpy(np.random.RandomState(2).rand(*MAIN_SHAPE).astype(np.float32))
    x = x.to(dev)
    with torch.no_grad():
        logits0 = attack.model.apply(x)
    y = logits0.argmax(-1)
    fused_sign_update.launches = fb.fused_bwd_1x1.launches = fb.fused_bwd_3x3.launches = 0
    delta = attack(x, y)
    torch.cuda.synchronize()
    launches = fused_sign_update.launches
    check(launches == attack.epoch == 10, f"{launches} kernel launches, expected 10")
    check(bool(torch.isfinite(delta).all()), "delta is not finite")
    check(tuple(delta.shape) == MAIN_SHAPE, f"delta shape {tuple(delta.shape)}")
    linf = float(delta.abs().max())
    check(0.0 < linf <= EPS + 1e-6, f"|delta|inf = {linf}")
    adv = x + delta
    check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
          "x + delta leaves [0, 1]")
    with torch.no_grad():
        logits1 = attack.model.apply(adv)
    ce0 = float(softmax_cross_entropy(logits0, y).mean())
    ce1 = float(softmax_cross_entropy(logits1, y).mean())
    check(ce1 > ce0, f"cross-entropy did not rise: {ce0} -> {ce1}")
    asr = float((logits1.argmax(-1) != y).float().mean())
    print(f"[5 main path] MI-FGSM ResNet-50 bf16, batch 128, 224², 10 iterations: "
          f"{launches} kernel launches, |delta|inf*255 = {linf * 255:.4f}, "
          f"CE {ce0:.4f} -> {ce1:.4f}, white-box ASR {asr:.4f}")
    times = []  # the checked call above was the warm-up
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attack(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    main_img_s = MAIN_SHAPE[0] / statistics.median(times)
    print(f"[5 main path] {main_img_s:.2f} img/s "
          f"(calls {', '.join(f'{t:.4f}' for t in times)} s) on {smi}")
    del attack, x, y, delta, adv, logits0, logits1
    torch.cuda.empty_cache()
    phase_seconds(5, clock)

    # 6. kernels 2-3 against their plain versions, bf16
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def relu_mask(shape):
        return (torch.rand(shape, generator=gen, device=dev) > 0.5).to(torch.bfloat16)

    b, h, w = STAGE1
    m1 = b * h * w
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ragged = 128 * 133 + 5  # 134 and 268 tiles: not a multiple of the grid
    cases_1x1 = []
    # (M, Cout, Cin, skip, g·mask out); at stage 1 the chain's first launch is
    # 256 -> 64 with g·mask out, its last 64 -> 256 with the skip
    for m, cout, cin, skip, with_gm in (
            (m1, 256, 64, False, False), (m1, 256, 64, False, True), (m1, 64, 256, True, False),
            (1031, 256, 64, False, True), (1031, 64, 256, True, False),
            (ragged, 256, 64, False, True), (ragged, 64, 256, True, True),
            (1031, 48, 64, True, True), (1031, 64, 80, True, False),  # partial k-step, N tile
            (98, 2048, 512, False, False), (98, 512, 2048, True, True)):
        args = (randn((m, cout)), relu_mask((m, cout)), randn((cout, cin), 0.05),
                randn((m, cin)) if skip else None)
        label = (f"fused_bwd_1x1 ({m}, {cout}) -> {cin}{' + skip' if skip else ''}"
                 f"{' + gm_out' if with_gm else ''}")
        if with_gm:
            out, gm = fb.fused_bwd_1x1(*args, return_gm=True)
            check(torch.equal(gm, args[0] * args[1]), f"{label}: gm_out is not g * mask")
        else:
            out = fb.fused_bwd_1x1(*args)
        err, rel = errors(out, fb.fused_bwd_1x1_plain(*args))
        check(rel <= BWD_TOL, f"{label}: max|out-ref|/max|ref| = {rel}")
        plan = fb.plan_1x1(m, cout, cin, skip)
        print(f"[6 kernels] {label}: max|out-ref|/max|ref| = {rel:.3e} "
              f"(bound {BWD_TOL:g}){'; gm_out bit-exact with g * mask' if with_gm else ''}; "
              f"plan BN {plan.bn}, {plan.stages} stages of {plan.stage_bytes} B, "
              f"{plan.smem} B shared memory, grid {min(plan.tiles, sms)} blocks over "
              f"{plan.tiles} tiles")
        if m == m1:
            g, mk, wt, sk = args
            work = (nbytes(*args, out, gm if with_gm else None), 2 * m * cout * cin)
            case = {
                "shape": label, "replaces": f"{FUSED_BWD}:{50 if skip else 56}",
                "in_chain": skip or with_gm, "bytes": work[0], "flops": work[1],
                "plan": {**plan._asdict(), "grid": min(plan.tiles, sms)},
                "max_abs_err": err, "max_rel_err": rel,
                "ms": median_ms(lambda: fb.fused_bwd_1x1(g, mk, wt, sk, return_gm=with_gm)),
                "plain_ms": median_ms(
                    lambda: fb.fused_bwd_1x1_plain(g, mk, wt, sk, return_gm=with_gm)),
                "library_ms": median_ms(lambda: torch.matmul(g, wt)),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(*work))),
            }
            cases_1x1.append(case)
            print(f"[6 kernels] {label}: kernel {case['ms']:.4f} ms, plain "
                  f"{case['plain_ms']:.4f} ms, torch.matmul(g, wt) {case['library_ms']:.4f} ms "
                  f"(reads neither mask nor skip: not the same function), bound "
                  f"{case['bound_ms']:.4f} ms ({case['bound_by']}) on {smi}")
        del args, out
    cases_3x3, err_3x3 = [], 0.0
    for shape, cin in STAGES_3X3 + EDGES_3X3:
        w_col = fb.flip_3x3_for_bwd(randn((3, 3, cin, shape[3]), 0.05))  # from HWIO
        g, mk = randn(shape), relu_mask(shape)
        out = fb.fused_bwd_3x3(g, mk, w_col)
        err, rel = errors(out, fb.fused_bwd_3x3_plain(g, mk, w_col))
        err_3x3 = max(err_3x3, err)
        label = f"fused_bwd_3x3 {shape} -> {cin}"
        check(rel <= BWD_TOL, f"{label}: max|out-ref|/max|ref| = {rel}")
        print(f"[6 kernels] {label}: max|out-ref|/max|ref| = {rel:.3e} "
              f"(bound {BWD_TOL:g})")
        if (shape, cin) in STAGES_3X3:
            # the library yardstick, without the mask: one cuDNN convolution
            # of g with the flipped kernel (w_col seen as OIHW)
            g_nchw = g.permute(0, 3, 1, 2)
            flipped = w_col.view(3, 3, shape[3], cin).permute(3, 2, 0, 1)
            work = (nbytes(g, mk, w_col, out), 2 * out.numel() * 9 * shape[3])
            case = {
                "shape": label, "max_abs_err": err, "max_rel_err": rel,
                "ms": median_ms(lambda: fb.fused_bwd_3x3(g, mk, w_col)),
                "plain_ms": median_ms(lambda: fb.fused_bwd_3x3_plain(g, mk, w_col)),
                "library_ms": median_ms(lambda: F.conv2d(g_nchw, flipped, padding=1)),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(*work))),
            }
            cases_3x3.append(case)
            print(f"[6 kernels] {label}: kernel {case['ms']:.4f} ms, plain "
                  f"{case['plain_ms']:.4f} ms, F.conv2d with the flipped kernel "
                  f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
                  f"({case['bound_by']}) on {smi}")
        del g, mk, w_col, out
    wide = torch.zeros((1, 1, fb.BWD_3X3_MAX_W + 1, 16), device=dev, dtype=torch.bfloat16)
    try:
        fb.fused_bwd_3x3(wide, wide, torch.zeros((144, 16), device=dev, dtype=torch.bfloat16))
        check(False, f"fused_bwd_3x3 took an image {wide.shape[2]} pixels wide")
    except ValueError as e:
        print(f"[6 kernels] fused_bwd_3x3 {tuple(wide.shape)}: ValueError: {e}")
    # the 3x3 row: stage 1 as its headline
    row_3x3 = {k: cases_3x3[0][k] for k in
               ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    phase_seconds(6, clock)

    # 7. the chain (kernel 4) on a BN-folded Bottleneck, the shape of layer1.1
    blk = Bottleneck(256, 64)
    init_weights(blk, torch.Generator().manual_seed(7))
    cpu_gen = torch.Generator().manual_seed(7)
    with torch.no_grad():  # BN off the identity, so that folding matters
        for norm in (blk.bn1, blk.bn2, blk.bn3):
            c = norm.num_features
            norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=cpu_gen))
            norm.bias.copy_(0.05 * torch.randn(c, generator=cpu_gen))
            norm.running_mean.copy_(0.05 * torch.randn(c, generator=cpu_gen))
            norm.running_var.copy_(0.5 + torch.rand(c, generator=cpu_gen))
    fold_bn(blk)
    blk = blk.eval().requires_grad_(False).to(dev, torch.bfloat16,
                                              memory_format=torch.channels_last)
    x = torch.relu(torch.randn((b, 256, h, w), generator=gen, device=dev))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g = randn((b, h, w, 256))

    def nhwc(t):  # a channels_last NCHW tensor as contiguous NHWC
        return t.permute(0, 2, 3, 1).contiguous()

    with torch.no_grad():  # the block's forward, keeping its three ReLU inputs
        a1 = blk.bn1(blk.conv1(x))
        a2 = blk.bn2(blk.conv2(F.relu(a1)))
        a3 = blk.bn3(blk.conv3(F.relu(a2))) + x
    masks = {k: nhwc((a > 0).to(torch.bfloat16)) for k, a in
             (("out", a3), ("c2", a2), ("c1", a1))}
    del a1, a2, a3
    weights = {k: conv.weight.permute(2, 3, 1, 0) for k, conv in  # OIHW -> HWIO
               (("w1", blk.conv1), ("w2", blk.conv2), ("w3", blk.conv3))}
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        auto = nhwc(torch.autograd.grad(blk(xg), xg, grad_outputs=g.permute(0, 3, 1, 2))[0])
    fb.fused_bwd_1x1.launches = fb.fused_bwd_3x3.launches = 0
    dx = fb.bottleneck_bwd_input(g, masks, weights)
    torch.cuda.synchronize()
    n_1x1, n_3x3 = fb.fused_bwd_1x1.launches, fb.fused_bwd_3x3.launches
    check((n_1x1, n_3x3) == (2, 1),
          f"chain launched the 1x1 {n_1x1} and the 3x3 {n_3x3} times, expected 2 and 1")
    check(bool(torch.isfinite(dx).all()) and tuple(dx.shape) == (b, h, w, 256),
          f"chain output not finite or of shape {tuple(dx.shape)}")
    chain_err, rel_plain = errors(dx, fb.bottleneck_bwd_input_plain(g, masks, weights))
    rel_auto = errors(dx, auto)[1]
    check(rel_plain <= CHAIN_TOL, f"chain vs plain chain: {rel_plain}")
    check(rel_auto <= CHAIN_TOL, f"chain vs autograd of the folded block: {rel_auto}")
    print(f"[7 chain] Bottleneck(256, 64) BN folded, {STAGE1} bf16: {n_1x1} + {n_3x3} "
          f"launches; max|dx-ref|/max|ref| = {rel_plain:.3e} against the plain chain, "
          f"{rel_auto:.3e} against autograd (bound {CHAIN_TOL:g})")
    chain = {
        "max_abs_err": chain_err, "max_rel_err": rel_plain,
        "ms": median_ms(lambda: fb.bottleneck_bwd_input(g, masks, weights)),
        "plain_ms": median_ms(lambda: fb.bottleneck_bwd_input_plain(g, masks, weights)),
        "library_ms": None,
    }
    chain["bound_ms"], chain["bound_by"] = bound_ms(
        nbytes(g, *masks.values(), *weights.values(), dx),
        2 * b * h * w * 64 * (256 + 9 * 64 + 256))
    jax_floor = bound_ms(2 * b * h * w * (256 * 3 + 64 * 3 + 256))[0]
    print(f"[7 chain] kernels {chain['ms']:.4f} ms, plain {chain['plain_ms']:.4f} ms, "
          f"bound {chain['bound_ms']:.4f} ms ({chain['bound_by']}; inputs and output "
          f"once), floor of the JAX bench's byte count {jax_floor:.4f} ms, on {smi}")
    phase_seconds(7, clock)

    # 8. the eval models at full width: the card and the CPU in fp32, each
    # against the same model in fp64 on the CPU.  A random init can be ill
    # conditioned in fp32 (Visformer's BatchNorms, with identity statistics,
    # normalise nothing), so the card is held to the CPU's distance from
    # fp64, not to the CPU's logits
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    x8 = torch.from_numpy(np.random.RandomState(8).rand(2, 224, 224, 3).astype(np.float32))
    for model_name in EVAL_MODELS:
        ref_model = make_model(model_name, pretrained=False, device="cpu")
        exact = copy.deepcopy(ref_model.module).double()
        on_card = copy.deepcopy(ref_model.module).to(dev)
        with torch.inference_mode():
            ref64 = exact(x8.double())
            ref = ref_model.module(x8)
            out = on_card(x8.to(dev)).cpu()
        check(tuple(out.shape) == (2, 1000) and bool(torch.isfinite(out).all()),
              f"{model_name}: logits of shape {tuple(out.shape)} or not finite")
        card64, cpu64, card_cpu = (errors(out, ref64)[1], errors(ref, ref64)[1],
                                   errors(out, ref)[1])
        check(card64 <= cpu64 + EVAL_TOL, f"{model_name}: card fp32 vs fp64 "
              f"max|d|/max|ref| = {card64}, CPU fp32 vs fp64 {cpu64}")
        print(f"[8 eval models] {model_name} at {ref_model.input_size}², logits "
              f"max|d|/max|ref|: card fp32 vs fp64 {card64:.3e}, CPU fp32 vs fp64 "
              f"{cpu64:.3e} (the card's bound: that + {EVAL_TOL:g}), card vs CPU "
              f"{card_cpu:.3e}")
        del ref_model, exact, on_card
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    phase_seconds(8, clock)

    # 9. the CLI, attack then eval, in a working directory of its own
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            cli_launches = run_cli(work)
        finally:
            os.chdir(cwd)
    png_ms = decode_ms()
    print(f"[9 cli] PNG decode per 299² image on the host ({png_ms['host_cpus']} CPUs): "
          f"the port's (filter 0) {png_ms['filter0_decode_ms']:.2f} ms, with the resize "
          f"to 224² {png_ms['filter0_load_image_ms']:.2f} ms; Paeth-filtered (the sweep "
          f"PIL's filtered files take) {png_ms['paeth_decode_ms']:.2f} ms, with the resize "
          f"{png_ms['paeth_load_image_ms']:.2f} ms")
    phase_seconds(9, clock)

    # 10. the bench line
    print("[10 bench] ", end="")
    bench_line = bench.main([])
    phase_seconds(10, clock)

    # 11. the gradient family
    gradient_launches = run_gradient_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(11, clock)

    # 12. the input-transformation keys, ANDA and MUMODIG
    input_launches = run_input_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(12, clock)

    # 13. the feature-tap API and the advanced-objective keys
    objective_launches_ = run_objective_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(13, clock)

    # 14. the ResNet gradient surgery and the CNN keys of model_related
    model_related_launches_ = run_model_related_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(14, clock)

    # 15. the ViT surgery and the ViT keys of model_related
    vit_launches_ = run_vit_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(15, clock)

    # 16. IDAA, Everywhere and ODI
    input_launches.update(run_idaa_family(dev, smi))
    torch.cuda.empty_cache()
    phase_seconds(16, clock)

    # 17. the ensemble surrogate, DenseNet and the ensemble keys
    ensemble_launches_ = run_ensemble_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(17, clock)

    # 18. the rest of ensemble/ and the learned transformations
    learned_launches_ = run_learned_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(18, clock)

    # 19. the generators, the TTP family and FAP
    generation_launches_ = run_generation_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(19, clock)

    # 20. AIM, the guided-diffusion UNet, DiffPure and DiffAttack
    diffusion_launches_ = run_diffusion_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(20, clock)

    # 21. the training entry points and DiffAttack's Stable Diffusion backend
    sd_launches_ = run_sd_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(21, clock)

    # 22. the defense suite, its CLI and its bench
    defense_launches_ = run_defense_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(22, clock)

    # 23. the weights converter, the sweep, the family bench, the ViT profile, the gate
    tools_launches_ = run_tools_family(dev, smi)
    torch.cuda.empty_cache()
    phase_seconds(23, clock)

    # 24. resume of the attack state, the runner and the sharded eval
    parallel = run_parallel_family(dev, smi, main_img_s)
    phase_seconds(24, clock)

    # the 1x1 row: the two launches of one chain call together
    in_chain = [c for c in cases_1x1 if c["in_chain"]]
    row_1x1 = {k: sum(c[k] for c in in_chain) for k in ("ms", "plain_ms", "library_ms")}
    row_1x1["bound_ms"], row_1x1["bound_by"] = bound_ms(
        sum(c["bytes"] for c in in_chain), sum(c["flops"] for c in in_chain))
    row_1x1["library"] = "torch.matmul(g, wt): reads neither mask nor skip, not the same function"

    # the headline figures, where the end of the output keeps them
    print(json.dumps({"summary": {
        "main_path_img_s": main_img_s, "bench_img_s": bench_line["value"],
        "bench_spread": bench_line["spread"], "runner_world1_img_s": parallel["runner_img_s"],
        "card": smi, "seconds": clock[-1] - clock[0],
        "phase_seconds": {str(i + 1): round(b - a, 1) for i, (a, b) in
                          enumerate(zip(clock, clock[1:]))}}}))
    print(json.dumps({"kernels": [
        {"name": "fused_sign_update", "route": "cuda",
         "source": "transferattack_torch/ops/csrc/fused_update.cu",
         "replaces": "transferattack_tpu/ops/pallas_update.py:33",
         "launches": launches, "launches_cli": cli_launches,
         "launches_gradient": gradient_launches, "launches_input": input_launches,
         "launches_objective": objective_launches_,
         "launches_model_related": model_related_launches_,
         "launches_vit": vit_launches_,
         "launches_ensemble": ensemble_launches_,
         "launches_learned": learned_launches_,
         "launches_generation": generation_launches_,
         "launches_diffusion": diffusion_launches_,
         "launches_sd": sd_launches_,
         "launches_defense": defense_launches_,
         "launches_tools": tools_launches_,
         "launches_parallel": parallel["launches"],
         "max_abs_err": max_err,
         "ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": update_bound, "bound_by": update_bound_by,
         "library_ms": None},
        {"name": "fused_bwd_1x1", "route": "cuda", "source": FUSED_BWD_CU,
         "replaces": f"{FUSED_BWD}:50", "launches": n_1x1,
         "max_abs_err": max(c["max_abs_err"] for c in cases_1x1), **row_1x1,
         "cases": cases_1x1},
        {"name": "fused_bwd_3x3", "route": "cuda", "source": FUSED_BWD_3X3_CU,
         "replaces": f"{FUSED_BWD}:101", "launches": n_3x3, "max_abs_err": err_3x3,
         **row_3x3, "cases": cases_3x3},
        {"name": "bottleneck_bwd_input", "route": "cuda",
         "source": "transferattack_torch/ops/fused_bwd.py",
         "replaces": f"{FUSED_BWD}:200", "launches": n_1x1 + n_3x3, **chain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
