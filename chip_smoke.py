#!/usr/bin/env python3
"""Drive the PyTorch port's SD1.5 slider serving (at request boundaries
and continuous), slider training (text and image sliders, one at a time and
in fleets, under AdamW and the adaptive optimizers), offline sampling
(`generate_images`), real-image editing and the eval harness (the UCE,
textual-inversion and custom-diffusion generators, the CLIP and LPIPS
scorers), its FLUX-dev
slider serving, slider training and scalar-scale sampling, and its
SDXL-base slider serving (also continuous), slider training (text and
image sliders) and SDXL-Turbo sampling, once on one NVIDIA GPU, under the default conv route and the three
conv-kernel routes of `ops.basic.set_conv_impl`, and with the layout pin
(`ops.basic.set_layout_pin`) off and on.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing one line or a few before the last, and a [time] line
with its seconds and the seconds since the start:
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA/nvcc.
  2. build:  nvcc builds the six kernel libraries (sliders_tpu_torch/csrc:
     attention forward and backward, flash attention, the 3x3 conv kernels,
     GroupNorm, the layout pin) for sm_90a, in parallel; registers, spills
     and shared memory per kernel (the Hopper-mainloop kernels of
     attention_sm90.cuh at d = 40, 64, 80, 128 and #4's at d = 128, #1's
     f32 (3xTF32) forward at every instantiation, the backward mainloop's
     of attention_bwd_sm90.cuh, #2's bf16 dq and dk/dv at d = 40, 64, 80,
     128, #4's at d = 128 and 256, #2's f32 (3xTF32) at every
     instantiation and #4's at d = 128, the split passes, and #4's f32
     d = 512 kernel among them; every f16 instantiation of `precision:
     fp16` too, each held to 0 spill bytes), and the build's seconds.
  3. kernel: the attention forward kernel against its plain PyTorch version
     at the serving shapes (SD1.5's and SDXL's at bucket 8, SDXL training's
     at 512 px) and in f32 (3xTF32) at SD1.5's and SDXL's 512 px denoise
     and FLUX's 1024 px head views (SDPA f32 and both bounds beside), the
     backward kernel at the grad-pass shapes (SD1.5's, and
     SDXL's d = 64 at 512 px, bf16 and f32; error of dq/dk/dv and median
     time of each, f32 beside both bounds); the conv kernels #5-#7
     against their plain versions at every conv shape the SD1.5 UNet routes
     at 512 px (batch 16, the mode the UNet uses there), two at batch 1 and
     one f32 shape each, with cuDNN's conv and one PyTorch expression of each
     kernel's whole function timed beside, and the generic kernel at the
     CONV_GENERIC shapes the plan leaves to it; the GroupNorm kernel #8 at the
     UNet's GN shapes;
     the flash-attention kernel #4 at FLUX's and the VAE's shapes (SDPA
     beside at the VAE's, f32 d = 128 and bf16 d = 256), and #4 and #1
     checked, then timed beside SDPA, at the two FLUX serving shapes on
     head views of (B, L, 3072) buffers; #4's backward (its residual
     forward, dk/dv and dq kernels, each on its plan) at FLUX training's
     2048 px grad pass, the tiny 1280 px f32 run and FLUX's 1536 px in f32
     (the TF32 plan), and d = 256 (two shapes), and #2 at FLUX's 512 px
     grad pass; the layout pin #9 at the SDXL serving boundaries (bf16 and f32;
     contiguous, channel-major and sliced inputs; bit for bit) and its
     identity gradient; #4 at the VAE encoder's mid attention of image-slider
     training ((2, 1, 1024, 512) and (2, 1, 4096, 512) f32) beside SDPA f32
     and the 'xla' route and its two cuBLAS products, and the full-width
     encoder at 256 and 512 px under attention impls 'auto' and 'xla' in
     turns; each kernel's bound and the time of one PyTorch call
     computing the same function; then the tiny slice at 256 px and three tiny
     training steps at 256 px on the GPU (through the kernels) against the
     CPU (plain paths) in f32, under the default route and under conv impl
     'fused', and a tiny FLUX snapshot served at 1280 px through
     `cli/serve.py --flux` and trained at 1280 px through
     `cli/train_flux_slider.py` on both (#4's route, with its backward), and
     TINY_XL at 512 px with the pin on (one forward, three XL train steps
     of a dynamic-crop pair; #1, #2 and #9 with exact launches) on both, and
     tiny image-slider training at 64 px through
     `cli/train_image_slider.py` on PNG folders the script writes (a
     truncated file skipped with its warning) on both, then a two-style
     `--stylecheck` run; then `pipelines/inversion.edit_image` on a tiny
     snapshot at 64 px (the inversion, the null-text optimiser through #1
     and #2, the edit) on both, the GPU's launches exact. The kernel
     phases hold #1 in f32 at the edit's shapes ((1 | 6, 8, 4096, 40),
     (1 | 6, 8, 1024, 80)) and #4 at its encode and decode ((1 | 3, 1,
     4096, 512)), with plain and SDPA times at (5 | 1 | 3, 1, 4096, 512).
     "f16 kernels": #1, #2, #9 and #5-#7 in f16 (`precision: fp16`)
     against their plain versions at SD1.5's and SDXL's shapes, each timed
     beside its bf16 twin, its bound, its plain version and the library
     call; "tiny training fp16": two f16 steps on f32 weights on the card
     against the CPU, then under the three conv impls (the f16 conv
     kernels' launches).
  4. engine: an SD1.5 SliderEngine at full width (UNet SD15, CLIP-L, SD VAE,
     512 px, DDIM STEPS (cut from the CLI's 50), guidance 7.5, start_noise
     750) in bf16 with seeded random weights and two rank-4 noxattn
     sliders, behind the HTTP server;
     one UNet step timed through the kernel and on the plain attention
     path, its device time by kernel class, and the 8-image VAE decode
     under attention impls 'auto' (#4 on the mid attention) and 'xla' in
     turns (and under conv impls, the 'xla' decode once more with cuDNN's
     global TF32 flag flipped: the same bits, as the decode sets its own); the UNet
     step under each conv impl ('xla', 'auto', 'fused_ep', 'fused') in
     alternating rounds, with each conv kernel's launches per forward and
     the noise prediction's distance from the 'xla' route; then the
     training grad pass (batch 1, remat) on the same UNet through both
     attention kernels against the plain attention path, in bf16 and in
     f32 (#1 and #2 on 3xTF32), in turns.
  5. http:   /generate with five scales, two concurrent /generate calls for
     the two sliders (coalesced into one stacked batch), /healthz; then
     five-scale /generate calls under each conv impl ('auto' and 'xla' two
     each, in turns, their latencies printed); every reply is checked, and
     each kernel's launch count must equal its routed calls per UNet forward
     x STEPS steps, plus under 'auto' the VAE decoder's, x the denoise
     batches. Then "continuous": a continuous engine on the same models (8
     rows in flight, chunk 5) behind HTTP, under DDIM and LMS at
     CONT_STEPS: a 5-scale
     request, and a 3-scale one sent after its first chunk that joins its
     live batch; chunk and join ms, both latencies, chunks against two solo
     runs, launches exact (#1 10 x 5 a chunk, #4 one per exit decode), and
     both requests' PNGs against a boundary engine at bucket 8, byte for
     byte.
  6. train:  a full-width SD1.5 snapshot with seeded random weights (UNet +
     CLIP-L + SD VAE + tokenizer) written to a temporary directory, then the
     training CLI in-process with the values of data/config.yaml (bf16,
     remat, rank-4 noxattn, AdamW lr 2e-4, DDIM 50) for a few iterations,
     a resume from its state file, and two iterations under conv impl
     'fused'; then "fp16 sd15": the CLI under `precision: fp16` (f32
     weights, f16 compute) for 3 iterations of the same draws, beside the
     bf16 run, `train_fleet` at K = 2 in fp16, and one image-slider
     iteration in fp16, which runs f32; losses, the moved LoRA, the frozen alphas, the saved files and
     the launch counts of the kernels are checked, and the time per
     iteration is split by phase; then image-slider training through
     `cli/train_image_slider.py` at 256 px for 4 iterations (#1 10, #2 5
     and #4 1 an iteration), its time per iteration (the PNG reader's
     host seconds beside) and device ms of the encode, the grad pass and the
     update, and its peak memory; then offline sampling on the same
     snapshot ("generate sd15"): `cli/generate_images.py` in-process with a
     1-row CSV, --scales=-2,-1,0,1,2, 512 px, bf16, DDIM STEPS and a rank-4
     noxattn slider the phase saves (#1 10 x STEPS launches at (10, 8,
     4096, 40) / (10, 8, 1024, 80), #4 one 5-row decode at (5, 1, 4096,
     512)), then --scheduler lms, euler_a and ddpm at GENERATE_STEPS steps
     and --compose a:1 --compose b:-1 (sweep 0, 1; GENERATE_STEPS steps)
     (#1 10 x GENERATE_STEPS, #4 1 each); folders, files and distinct images checked, each CSV row's wall
     and the peak memory printed; then the SD1 example's scalar merged-delta
     path against the per-row path (LMS GENERATE_STEPS steps, scale 1, the same
     latents): f32 with TF32 off within GENERATE_F32_REL of max|x|, bf16
     printed; then "edit": `edit_image` on the snapshot in f32 (TF32 off)
     on a 512 px PNG the phase writes, scales 0, 2, 4 at start_noise 500,
     DDIM steps cut to 10 and null-text inner steps to 5: the losses per
     step, the scale-0 PSNR, the parts' seconds, the peak memory, an uncut
     50 x 10 time extrapolated, launches exact (#1 f32, #2 f32 in the
     null-text backward, #4 at the encode and the decode); then "maps":
     examples/attention_maps_torch.py's word maps at 512 px in f32 under a
     tap wanting attn2 (#1 10) and an unfiltered one (#1 0), the row sums,
     eps against the untapped forward, the 16 x 16 maps written. Between
     "generate" and "edit", the eval harness on the same snapshot: "uce
     sd15" (`cli/generate_images_uce.py`: an edited UNet .pt of the
     snapshot's weights + seeded noise, scales -1, 0, 1, LMS UCE_STEPS steps, 512
     px; #1 10 x 10 x 3, #4 3; scale 0 byte-equal to the adapter-free
     sampler in-process), "ti sd15" (`cli/generate_images_text_inversion.py`
     with a .pt embedding for a token the CLI adds, DDIM TI_STEPS; #1 10 x TI_STEPS, #4 1;
     the encoder's new row equal to the file's) and "scores"
     (`cli/clip_score.py` and `cli/lpips_score.py` on the UCE run folder
     with ViT-B/32 and AlexNet / LPIPS files on seeded weights, on the card
     and on the CPU: scores within 1e-4 relative, no kernel launch,
     LPIPS(x, x) = 0, ms an image). After "generate sd15", the fleet on the
     same snapshot: "fleet sd15" (`cli/train_fleet.py` with K = 4 prompt
     sets of data/, 512 px, data/config.yaml's values, one iteration under
     each of per_row, shared and stratified on models loaded once: per-row
     t_to, loop length, device ms by phase, peak memory, the four sliders'
     files, #1 10 x (loop + 2 + remat) and #2 10 exact; one more per_row
     iteration with cuDNN's default algorithms, its device spans beside the
     deterministic ones the fleet runs on), "fleet rows" (TINY at 256 px in
     f32: a K = 2 fleet against the solo runs of its row seeds within
     FLEET_ROW_TOL; run twice, and with row 1's pairs changed: both held to
     0, bit for bit), "fleet image
     sd15" (`train_image_slider --stylecheck --fleet`, two styles at 256 px:
     #1 10, #2 5 and #4 1 an iteration, #4 at (4, 1, 1024, 512)),
     "generate fleet sd15" (`generate_images --fleet A --fleet B`, 3
     scales, DDIM FLEET_GENERATE_STEPS: #1 10 x those steps, #4 1; each checkpoint's PNGs against its solo
     run at CONT_JOIN_PSNR or better) and "adaptive optimizers" (prodigy,
     dadaptadam, dadaptadamw, dadaptlion: 5 updates of the full-width
     rank-4 noxattn LoRA on the card against the CPU, ms an update; a
     2-iteration `train_text_slider` run under prodigy).
  7. flux:   FLUX-dev at full width and depth (transformer, T5-XXL encoder,
     CLIP-L, FLUX VAE) in bf16 with seeded random weights and two rank-4
     xattn sliders; one transformer step at bucket 8, 1024 px, timed and
     profiled; behind the HTTP server a 5-scale /generate, two concurrent
     /generate calls for the two sliders (one stacked batch), a skip_till
     past the last step (equal to the scale-0 image) and /healthz at
     1024 px, then a 1-scale and a 5-scale /generate from a 2048 px engine
     on the same models, each with its peak device memory. Launch counts:
     #1 57 x steps x batches at 1024 px, #4 57 x steps at 2048 px, and one
     #4 per VAE decode call (its d = 512 mid attention). Then FLUX-dev
     slider training on the same models through `train_flux_sliders`
     (data/config.yaml's values with the xattn method: bf16, remat, rank-4
     ortho-up LoRA, AdamW lr 2e-4, T5 length 512, max_denoising_steps cut
     to 8): 3 iterations at 512 px (#1 57 x (t_to + 3) and #2 57 per
     iteration; iteration 1 under torch.profiler) and 1 at 2048 px (#4 57 x
     (t_to + 3) and its backward 57), each iteration's host wall and device
     ms by phase, the peak memory, every down moved and every up and alpha
     bit for bit as initialised. Then "flux scalar": the FLUX example's
     scalar-scale call at 1024 px, 2 steps (merged deltas) against the same
     call with the scale as a (1,) vector (the per-row branch) and at scale
     0: #1 57 x 2 x 3 launches, max|err| of the latents beside the slider's
     effect, the peak memory. Then "mesh flux" (the phase's models freed
     first): one torchrun launch of 4 ranks on the card over gloo,
     against this phase's world-1 records: the TINY FLUX step at dp 2 x
     tp 2 in f32 with TF32 off against a world-1 run here; FLUX-dev
     training at tp = 2 (the 512 px config and seed above; 2 ranks, each
     drawing the weights in the world-1 order and keeping its shard: t_to
     equal, loss and grad norm within MESH_REL, #1 and #2 per rank exact at
     12 heads, downs moved, ups and alphas as initialised); and `serve
     --flux --pp 2` at 1024 px (each rank holding one stage's blocks)
     answering the 5-scale sweep and a request with no slider: PSNR
     against the world-1 PNGs, #1 per stage (29 and 28 a forward), each
     rank's peak memory.
  8. sdxl:   SDXL-base at full width (UNet 2,567,463,684 parameters, CLIP-L,
     bigG with its projection, the SDXL VAE) in bf16 with seeded random
     weights and a rank-4 noxattn slider: one denoise step at bucket 8 (16
     CFG rows), 1024 px, guidance rescale 0.7, timed with the pin off and on
     in turn (#1 70 and #9 0 / 22 launches a step), profiled, beside its
     analytic bound, and the 8-image decode at 1024 px under 'auto' and
     'xla' in turns; a 5-scale /generate at 1024 px (DDIM steps cut to 8)
     with the pin off and again on (#9 22 x steps, the same images),
     /healthz is_xl, #4 once per decode; then the training CLI with --xl on
     a snapshot of the same weights, with data/config-xl.yaml's values and
     data/prompts-xl.yaml's age pair at 512 px for 2 iterations, pin on:
     launches exact (#1 10 x (t_to + 3), #2 10, #9 22 x (t_to + 2) + 21 per
     iteration), every down and up moved, host wall and device ms by phase,
     peak memory, then one iteration under `precision: fp16` (f16 #1, #2
     and #9; max_denoising_steps cut to 10); then image-slider training with --xl on the same snapshot
     (its VAE too) at 512 px for 3 iterations, pin off (#1 20, #2 10, #4 1
     an iteration), timed as SD1.5's; then "turbo sdxl" on the same
     snapshot: `generate_images --xl --scheduler euler_a --ddim_steps 3
     --guidance_scale 1 --start_noise 700 --image_size 512`, 5 scales (no
     CFG: #1 10 x 3 at (5, 10, 1024, 64), #4 one 5-row decode at (5, 1,
     4096, 512)); then an SDXL SliderEngine with scheduler 'euler_a' (3
     steps, 512 px) behind HTTP: a 16-scale request and, queued together
     behind it, two with one seed: three batches (no coalescing) and the
     two replies' PNG bytes equal; then "custom diffusion sdxl":
     `cli/generate_images_custom_diffusion.py --compress` on the snapshot
     with a delta checkpoint (every attn2 to_k / to_v as rank-4 {'u','v'}
     factors, a modifier token for both encoders) at 1024 px, DDIM 4
     (#1 70 x 4, #4 1). Before the training, "SDXL continuous":
     the SD1.5 continuous check at 1024 px, 8 steps, chunk 4, one join.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises, exits non-zero and prints
no such line. It needs a CUDA device and the rest of the repository beside
it.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 25  # the SD1.5 engine's DDIM steps, cut from the CLI's 50
ROUTED_PER_FORWARD = 10  # SD1.5 at 512 px: 5 self-attentions at L=4096 + 5 at L=1024
KERNEL_SHAPES = [  # (B, H, L, d), dtype, head views: the 8-row bucket CFG-doubled, and others
    ((16, 8, 4096, 40), "bfloat16", False),
    ((16, 8, 1024, 80), "bfloat16", False),
    ((16, 10, 4096, 64), "bfloat16", False),  # SDXL serving at 1024 px: 10 a forward
    ((16, 20, 1024, 64), "bfloat16", False),  # and 60 a forward
    ((2, 10, 1024, 64), "bfloat16", False),  # SDXL training's CFG-doubled denoise at 512 px
    # (and SDXL image training's grad pass at 512 px, the +-s pair)
    ((2, 8, 1024, 128), "bfloat16", False),
    ((2, 24, 4608, 128), "bfloat16", False),  # FLUX's joint attention at 1024 px, 2 of 8 rows
    ((2, 8, 1024, 40), "bfloat16", False),  # SD1.5 image training's grad pass at 256 px
    ((5, 10, 1024, 64), "bfloat16", False),  # SDXL-Turbo at 512 px: 5 scales, no CFG rows
    # --precision float32 (3xTF32): the CFG-doubled denoise of SD1.5's two
    # levels and SDXL's d = 64 at 512 px, and FLUX's joint attention at
    # 1024 px on head views of (B, L, 3072)
    ((2, 8, 4096, 40), "float32", False),
    ((2, 8, 1024, 80), "float32", False),
    ((2, 10, 1024, 64), "float32", False),
    ((2, 24, 4608, 128), "float32", True),
    # real-image editing in f32 at 512 px: the inversion and the null-text
    # forwards at batch 1, the edit's CFG-doubled sweep of 3 scales
    ((1, 8, 4096, 40), "float32", False),
    ((1, 8, 1024, 80), "float32", False),
    ((6, 8, 4096, 40), "float32", False),
    ((6, 8, 1024, 80), "float32", False),
    # SD1.5 at tp = 2 (phase_mesh): a rank's 4 local heads of a 1-row pass
    ((1, 4, 4096, 40), "bfloat16", False),
    ((1, 4, 1024, 80), "bfloat16", False),
    # FLUX-dev training at tp = 2, 512 px ("mesh flux"): a rank's 12 local
    # heads, the target pass and the frozen batch-3 pass
    ((1, 12, 1536, 128), "bfloat16", False),
    ((3, 12, 1536, 128), "bfloat16", False),
]
BWD_SHAPES = [  # (B, H, L, d), dtype: the grad pass at batch 1 and 2, FLUX's d, and f32
    ((1, 8, 4096, 40), "bfloat16"),
    ((1, 8, 1024, 80), "bfloat16"),
    ((2, 8, 4096, 40), "bfloat16"),
    ((1, 10, 1024, 64), "bfloat16"),  # SDXL training's grad pass at 512 px (10 a pass)
    ((3, 10, 1024, 64), "bfloat16"),  # the same at batch 3
    ((2, 8, 1024, 40), "bfloat16"),  # image training's grad pass (the +-s pair): SD1.5 at 256 px
    ((2, 10, 1024, 64), "bfloat16"),  # and SDXL at 512 px
    ((1, 24, 4096, 128), "bfloat16"),
    ((1, 24, 1536, 128), "bfloat16"),  # FLUX training's grad pass at 512 px
    # --precision float32 (the TF32 plan): SD1.5's two levels, SDXL's d and
    # FLUX's d below 1536 px
    ((1, 8, 4096, 40), "float32"),
    ((1, 8, 1024, 80), "float32"),
    ((1, 10, 1024, 64), "float32"),
    ((1, 24, 1536, 128), "float32"),
    # SD1.5's grad pass at tp = 2 (phase_mesh): 4 local heads, one row a rank
    ((1, 4, 4096, 40), "bfloat16"),
    ((1, 4, 1024, 80), "bfloat16"),
    # FLUX-dev's grad pass at tp = 2, 512 px ("mesh flux"): 12 local heads
    ((1, 12, 1536, 128), "bfloat16"),
]
# #2's shapes timed in interleaved rounds with SDPA's backward (rounds each):
# at (1, 8, 1024, 80) two earlier runs read far apart (ROADMAP queue 2, item 2)
BWD_INTERLEAVED = {(1, 8, 1024, 80): 4}
TRAIN_ITERATIONS = 5  # the full-width run; per_steps and state_checkpoint_every 3
FUSED_ITERATIONS = 2  # the full-width run under conv impl 'fused'
# The 'fused' run's loss against the default ('xla') run's on the same draws,
# relative. Both are bf16; 'fused' rounds silu(x*a + s) once in f32 where
# 'xla' rounds GroupNorm's output and the SiLU apart, so each UNet call's
# noise prediction differs by up to ~2 % of its largest value (phase_conv_step
# holds it to 5 %), and t_to such calls feed the loss: held to the same 5 %.
FUSED_LOSS_RTOL = 0.05
CONV_IMPLS = ("xla", "auto", "fused_ep", "fused")
# SD1.5 at 512 px: routed conv-kernel calls per UNet forward under each impl
# (15 resnets at 64x64, 32x32 and 16x16 pass the gates, 6 down and 9 up;
# 'auto' adds the three upsampler convs)
CONV_PER_FORWARD = {"xla": {}, "auto": {"conv3x3": 33}, "fused_ep": {"epi_conv3x3": 30},
                    "fused": {"fused_conv3x3": 30}}
# routed calls per VAE decode at 512 px: 'auto' routes every conv2d, so the SD
# VAE decoder's 3x3 convs take kernel #5 too (mid block 4, up blocks 24,
# upsamplers 3; conv_in has C = 4 and conv_out N = 3), as in the JAX package;
# its resnets are not UNet resnets, so 'fused' and 'fused_ep' leave it alone
CONV_PER_DECODE = {"auto": {"conv3x3": 31}}
# every (H, C, N, mode) the SD1.5 UNet routes at 512 px: temb for a resnet's
# conv1, residual for its conv2, none for an upsampler
CONV_SHAPES = [
    (64, 320, 320, "temb"), (64, 320, 320, "residual"), (64, 960, 320, "temb"),
    (64, 640, 320, "temb"), (64, 640, 640, "none"),
    (32, 320, 640, "temb"), (32, 640, 640, "residual"), (32, 640, 640, "temb"),
    (32, 1920, 640, "temb"), (32, 1280, 640, "temb"), (32, 960, 640, "temb"),
    (32, 1280, 1280, "none"),
    (16, 640, 1280, "temb"), (16, 1280, 1280, "residual"), (16, 1280, 1280, "temb"),
    (16, 2560, 1280, "temb"), (16, 1920, 1280, "temb"), (16, 1280, 1280, "none"),
]
# every (H, C, N, mode) the SDXL UNet routes at 1024 px (three levels: 15
# resnet shapes at 128x128, 64x64 and 32x32, the two upsamplers), and its
# routed calls per forward under each impl (34 resnet convs, +2 upsamplers
# under 'auto'); tests/test_torch_conv_plan.py holds both lists to the UNets
SDXL_CONV_SHAPES = [
    (128, 320, 320, "temb"), (128, 320, 320, "residual"), (128, 960, 320, "temb"),
    (128, 640, 320, "temb"), (128, 640, 640, "none"),
    (64, 320, 640, "temb"), (64, 640, 640, "residual"), (64, 640, 640, "temb"),
    (64, 1920, 640, "temb"), (64, 1280, 640, "temb"), (64, 960, 640, "temb"),
    (64, 1280, 1280, "none"),
    (32, 640, 1280, "temb"), (32, 1280, 1280, "residual"), (32, 1280, 1280, "temb"),
    (32, 2560, 1280, "temb"), (32, 1920, 1280, "temb"),
]
SDXL_CONV_PER_FORWARD = {"xla": {}, "auto": {"conv3x3": 36}, "fused_ep": {"epi_conv3x3": 34},
                         "fused": {"fused_conv3x3": 34}}
# (B, H, C, N, mode, dtype) beyond the batch-16 serving shapes: the grad
# pass (batch 1) at levels 0 and 1, and one f32 shape
CONV_EXTRA = [
    (1, 64, 320, 320, "temb", "bfloat16"), (1, 32, 640, 640, "residual", "bfloat16"),
    (2, 32, 320, 640, "temb", "float32"),
]
# (B, H, C, N, mode, dtype) that ops/conv3x3.plan leaves to the generic kernel
# (the PR 3 kernel): f32 with C % 4 != 0, f32 with W < 8, bf16 with C % 8 != 0.
# All three kernels at each are held to their plain versions (not timed)
CONV_GENERIC = [
    (2, 32, 102, 128, "temb", "float32"), (8, 6, 64, 96, "residual", "float32"),
    (2, 32, 100, 160, "residual", "bfloat16"),
]
# the training CLI's UNet batches at batch_size 1 (the grad pass 1, the
# CFG-doubled denoise loop 2, the frozen pass 3): every CONV_SHAPES entry at
# each is held against the plain versions too (not timed)
CONV_TRAIN_BATCHES = (1, 2, 3)
# (H, C, N) of kernel #5's f32 calls in the SD VAE decoder at 512 px under
# 'auto' (CONV_PER_DECODE), at the serving decode batch (the bucket, 8)
VAE_CONV_SHAPES = [(64, 512, 512), (128, 512, 512), (256, 512, 512), (256, 512, 256),
                   (256, 256, 256), (512, 256, 256), (512, 256, 128), (512, 128, 128)]
VAE_DECODE_BATCH = 8
# (L, C, silu, eps): the UNet's GroupNorm shapes at 512 px (resnet norms with
# SiLU, transformer norms without, eps 1e-6)
GN_SHAPES = [(hw * hw, c, True, 1e-5) for hw, cs in ((64, (320, 640, 960)),
                                                    (32, (320, 640, 960, 1280, 1920)),
                                                    (16, (640, 1280, 1920, 2560)),
                                                    (8, (1280, 2560))) for c in cs] + [
    (4096, 320, False, 1e-6), (1024, 640, False, 1e-6), (256, 1280, False, 1e-6),
    (64, 1280, False, 1e-6)]
# FLUX-dev serving: 19 double-stream + 38 single-stream blocks, one joint
# attention each; FlowMatch steps per request, cut from the CLI's 30
FLUX_BLOCKS = 57
FLUX_STEPS = {1024: 3, 2048: 1}  # cut from 30
# kernel #4 against its plain version: FLUX's joint attention at 2048 px (two
# of its 24 heads), two rows of the 1024 px bucket, f32 at 1280 px (the tiny
# FLUX run) and at 1536 px (all 24 heads, where f32 first routes to #4), d =
# 256 at a test shape and at one that fills the card in both dtypes, and the
# VAE's single-head mid attention (d = 512, f32) at the decode shapes of
# SD1.5 at 512 px (bucket 8) and FLUX at 1024 px (bucket 8) and 2048 px,
# and a 5-row decode at 512 px (generate_images' and SDXL-Turbo's sweep);
# every call must launch on the plan of its (dtype, d) (`fwd_plan`)
FLASH_SHAPES = [
    ((1, 2, 16896, 128), "bfloat16"), ((2, 24, 4608, 128), "bfloat16"),
    ((1, 2, 6912, 128), "float32"), ((1, 24, 9728, 128), "float32"),
    ((1, 2, 2048, 256), "bfloat16"), ((1, 16, 4096, 256), "bfloat16"),
    ((1, 2, 2048, 256), "float32"), ((1, 16, 4096, 256), "float32"),
    ((8, 1, 4096, 512), "float32"), ((8, 1, 16384, 512), "float32"),
    ((1, 1, 65536, 512), "float32"),
    ((5, 1, 4096, 512), "float32"),  # a 5-row decode at 512 px (generate_images, Turbo)
    ((1, 1, 4096, 512), "float32"),  # the edit's encode at 512 px (batch 1)
    ((3, 1, 4096, 512), "float32"),  # and its 3-row decode
]
# FLUX's and SDXL's VAE decode at 1024 px (bucket 8): #4's plain version and
# SDPA in f32 are timed there, and at SD1.5's decode at 512 px (bucket 8)
VAE_FLASH_SHAPE = (8, 1, 16384, 512)
VAE_DECODE_SHAPES = (VAE_FLASH_SHAPE, (8, 1, 4096, 512))
# and at the shapes of #4's bf16 d = 256 and f32 d = 128 / 256 forwards
FLASH_SDPA_SHAPES = VAE_DECODE_SHAPES + ((1, 2, 6912, 128), (1, 24, 9728, 128),
                                         (1, 2, 2048, 256), (1, 16, 4096, 256),
                                         (5, 1, 4096, 512), (1, 1, 4096, 512),
                                         (3, 1, 4096, 512))
# the two FLUX serving shapes (2048 px bucket 1: #4's route; 1024 px bucket
# 8: #1's) at which #4, #1 and SDPA are timed on the same inputs
FLUX_SERVE_SHAPES = [(1, 24, 16896, 128), (8, 24, 4608, 128)]
# the tiny FLUX snapshot: L = 512 + (1280 / 16)**2 = 6912 at d = 128 in f32,
# which kernel #1's TPU plan refuses, so the joint attention takes #4
TINY_FLUX_PX = 1280  # the least size whose joint attention #4 takes in f32
TINY_FLUX_STEPS = 1  # the CPU side's plain path bounds the phase
# kernel #4's backward against its plain version: FLUX training's grad pass
# at 2048 px (on head views), the tiny FLUX training run at 1280 px (f32, the
# TF32 plan), FLUX's grad pass at 1536 px in f32 (where f32 first routes to
# #4), d = 256 at a test shape and at one that fills the card (bf16 on
# SPLIT, f32 on the cluster plan), and f32 d = 512 at the VAE's single head
FLASH_BWD_SHAPES = [((1, 24, 16896, 128), "bfloat16"), ((1, 2, 6912, 128), "float32"),
                    ((1, 24, 9728, 128), "float32"),
                    ((1, 2, 2048, 256), "bfloat16"), ((1, 16, 4096, 256), "bfloat16"),
                    ((1, 2, 2048, 256), "float32"), ((1, 16, 4096, 256), "float32"),
                    ((1, 1, 4096, 512), "float32")]
# tiny FLUX training GPU vs CPU through the CLI at TINY_FLUX_PX in f32
TINY_FLUX_TRAIN_ITERATIONS = 1  # the CPU side's plain path bounds the phase
TINY_FLUX_TRAIN_STEPS = 3  # max_denoising_steps: t_to in [1, 3)
# Adam moves an element by about lr a step whatever its gradient's size, so
# f32 gradient noise on elements whose gradient nearly cancels between steps
# shows in the LoRA in proportion to lr: at 1e-4 the H100 and CPU runs'
# LoRA differed by 2.2e-6 (loss 4.8e-6 relative). At 1e-5 a gradient of the
# wrong sign still moves an element 10x past the 1e-6 tolerance.
TINY_FLUX_LR = 1e-5
# FLUX-dev training at full width: iterations at each resolution, and
# max_denoising_steps cut from data/config.yaml's 50 (t_to in [1, 8))
FLUX_TRAIN_ITERATIONS = {512: 2, 2048: 1}
FLUX_TRAIN_STEPS = 8
# SDXL-base (the UNet's 2,567,463,684 parameters are diffusers' sdxl-base-1.0,
# as tests/test_unet.py pins them). At 1024 px its 11 Transformer2D blocks
# (5 at 64x64, L = 4096, 2 layers each; 6 at 32x32, L = 1024, 10 layers each)
# are pinned on both sides by #9 when the pin is on, and #1 takes every
# self-attention (10 + 60; the cross-attentions' 77 keys stay plain). At
# 512 px the L = 1024 level is the 640-wide one (10 self-attentions) and the
# 1280-wide level's L = 256 is below #1's gate. In a grad pass 21 of the 22
# pins run their backward: the first boundary's input depends on no LoRA
# factor.
SDXL_UNET_PARAMS = 2_567_463_684
SDXL_SD_SHAPES = [(16, 10, 4096, 64), (16, 20, 1024, 64)]  # #1 at 1024 px, bucket 8
SDXL_BWD_SHAPE = (1, 10, 1024, 64)  # #2 in the 512 px grad pass
SDXL_PINS = 22
SDXL_PIN_BWD = 21
SDXL_SD_1024 = 70
SDXL_SD_512 = 10
SDXL_PX = 1024
SDXL_HTTP_STEPS = 6  # DDIM steps per /generate, cut from the CLI's 50
SDXL_STEP_ROUNDS = 1  # rounds of the step timing, pin off and on in turn
SDXL_TRAIN_ITERATIONS = 2  # cut from data/config-xl.yaml's 1000
SDXL_TRAIN_STEPS = 20  # max_denoising_steps of the bf16 run, cut from 50: t_to in [1, 20)
# kernel #9 at the SDXL serving boundaries (bucket 8, 16 CFG rows, 1024 px)
PIN_SHAPES = [(16, 4096, 640), (16, 1024, 1280)]
# TINY_XL at 512 px: its attention level is 32x32 (L = 1024, #1's route): 8
# self-attentions and 4 transformers (8 pins, 7 with a gradient) a forward
TINY_XL_PX = 512
TINY_XL_SD = 8
TINY_XL_PINS = 8
TINY_XL_LR = 1e-5  # as TINY_FLUX_LR
# image-slider training (`cli/train_image_slider.py`): a pair's two images
# encoded in f32 at 256 px (SD1.5) and 512 px (SDXL), whose mid attention
# (one head, d = 512) is #4's; the UNet's self-attentions at L = 1024 are
# #1's and #2's (SD1.5's level 0 at 256 px: 5; SDXL's 640-wide level at 512
# px: SDXL_SD_512), and #1's again in the backward under remat
IMAGE_PX = {"sd15": 256, "sdxl": 512}
ENCODE_FLASH_SHAPES = [(2, 1, (px // 8) ** 2, 512) for px in IMAGE_PX.values()] + [
    (4, 1, 1024, 512)]  # the last: the image fleet's encode (FLEET_ENCODE_SHAPE)
ENCODE_AB_ROUNDS = 3  # 'auto' / 'xla' turns of the full-width encoder
# cut from the configs' 1000; the last iteration is traced, and saves (per_steps
# 2) fall outside it
IMAGE_TRAIN_ITERATIONS = {"sd15": 4, "sdxl": 3}
READER_PHOTO_PX = 1024  # the reader also timed on one photo-sized PNG
IMAGE_SD_ROUTED = {"sd15": 5, "sdxl": SDXL_SD_512}
# tiny image training GPU vs CPU through the CLI: TINY UNet and TINY VAE (one
# downsample) at 64 px: 32 x 32 latents, 3 self-attentions at L = 1024 (d =
# 16) a UNet call and the encoder's mid attention (d = 32), all #1's
TINY_IMAGE_PX = 64
TINY_IMAGE_ITERATIONS = 3
TINY_IMAGE_ROUTED = 3
TINY_IMAGE_BAD = "b2.png"  # truncated in every folder; the seed-0 draws reach it first
SCALE_FOLDERS = ("verylow", "low", "high", "veryhigh")  # the CLI's default folders

# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, f32 outside
# them (plain FMAs), TF32 tensor cores, device memory
# offline sampling (phase_generate, phase_turbo, phase_flux_scalar): the
# non-DDIM generate_images runs' steps, the f32 merged-against-branch limit
# (of max|x|; the two round W + delta and the branch output apart), SDXL-
# Turbo's steps, the engine's request (a) (the largest bucket, so (b) and (c)
# queue behind it) and the FLUX scalar call's steps
GENERATE_STEPS = 6
GENERATE_F32_REL = 1e-5
TURBO_STEPS = 3
TURBO_A_SCALES = [float(s) for s in range(-8, 8)]
FLUX_SCALAR_STEPS = 2
GENERATE_RUNS = ("ddim", "lms", "euler_a", "ddpm", "compose")
# the eval harness (phase_uce, phase_ti, phase_custom_diffusion,
# phase_scores): UCE's sweep and LMS steps, textual inversion's and custom
# diffusion's DDIM steps (cut from the CLIs' 50; custom diffusion at its
# CLI's default 1024 px), the UCE edit's noise (x each tensor's std), the
# compressed deltas' rank, and the most by which a
# score on the card may depart from the CPU's (relative, TF32 off)
UCE_SCALES = [-1.0, 0.0, 1.0]
UCE_STEPS = 6
TI_STEPS = 6
TI_TOKEN = "<sks-eyes>"
CD_STEPS = 4
CD_PX = 1024
CD_TOKEN = "<sks-eyebrows>"
CD_RANK = 4
UCE_NOISE = 0.01
SCORE_REL = 1e-4
# continuous serving (phase_continuous, phase_sdxl_continuous): the bucket in
# flight, the steps a chunk (SDXL: half its 8 steps), request (b)'s sweep,
# the samplers; the largest (pixel level, share of values) by which a
# joiner's PNGs may depart from the boundary engine's at the same bucket,
# as PSNR. A request that starts a batch holds the slots its boundary run
# holds and must match it byte for byte. A joiner holds other slots: cuDNN's
# bf16 3x3 convs at 32^2, 16^2 and 8^2 round a row by its position in the
# batch (on the H100, whatever cudnn.deterministic or benchmark say), and
# its exit decode runs at its pow2 row count, not the bucket's; 50 bf16
# steps carry that rounding to 44.5-46.8 dB on an H100 (SD1.5 and SDXL)
CONT_ROWS = 8
CONT_CHUNK = 5
SDXL_CONT_CHUNK = 4
CONT_B_SCALES = [-1.5, 0.0, 1.5]
CONT_KINDS = ("ddim", "lms")
CONT_STEPS = 25  # SD1.5's continuous runs, cut from STEPS
CONT_JOIN_PSNR = 40.0
# fleet training (phase_fleet and its neighbours)
FLEET_PROMPTS = ("person_age_slider_GPT", "smile_slider_GPT", "person_surprised_GPT",
                 "animated_eyes_GPT")  # data/prompts-*.yaml: K = 4, 512 px, batch 1
FLEET_MODES = ("per_row", "shared", "stratified")
FLEET_ROW_TOL = 1e-5  # a fleet row's LoRA against its solo run, f32 at lr TINY_LR
# `precision: fp16` (f16 compute): the f16 kernels' shapes (#1 at SD1.5's and
# SDXL's serving shapes, #2 at the grad passes', #9 at SDXL's level-0
# boundary, #5-#7 at one resnet conv of each SD1.5 level and its upsampler
# conv, each in the mode the UNet uses there) and the generic conv's f16 case
F16_SD_SHAPES = [(16, 8, 4096, 40), (16, 8, 1024, 80), (16, 10, 4096, 64), (16, 20, 1024, 64)]
F16_BWD_SHAPES = [(1, 8, 4096, 40), (1, 8, 1024, 80), (1, 10, 1024, 64)]
F16_PIN_SHAPE = (16, 4096, 640)
F16_CONV_SHAPES = [(64, 320, 320, "temb"), (64, 960, 320, "temb"), (32, 1280, 1280, "none"),
                   (16, 1920, 1280, "temb")]
F16_CONV_GENERIC = (2, 32, 100, 160, "residual")
F16_ULPS = 4  # attention: p, ds and the outputs rounded at the plain version's points
F16_CONV_ULPS = 2  # one rounding of f32 sums taken in another order
F16_SLOWER = 1.15  # an f16 kernel past this multiple of its bf16 twin is a finding
F16_TURNS = 4  # rounds of f16 / bf16 timings in turns (the twins of a 0.2 ms kernel
# differed by up to 1.33x in single medians)
FP16_TRAIN_ITERATIONS = 3  # SD1.5 through the CLI: the bf16 run's first three draws
FP16_FLEET_K = 2
FP16_SDXL_STEPS = 10  # max_denoising_steps of the SDXL fp16 run: t_to in [1, 10)
FP16_SDXL_ITERATIONS = 2  # the first pays the run's first f16 calls; the second is warm
FP16_TINY_ITERATIONS = 2
# TINY widened so that #1 and #2 take f16 instantiations (SD1.5's head dim
# 40 at level 0, L = 1024 at 256 px) and the convs at level 1 (160
# channels) pass the conv gates
FP16_TINY = {"block_out_channels": (40, 160), "num_attention_heads": (1, 4)}
FP16_RTOL = 1e-2  # f16 losses, card against CPU (tests/test_torch_fp16.py holds JAX's)
# f16 grad norms, card against CPU, both taking #2's rounding points (the
# CPU through `sd_attention_bwd_ref`, `cpu_attention_bwd_at_kernel_points`):
# with no loss scaling (as in the JAX package) the UNet's output gradient is
# 2 diff / N ~ 1e-5, in f16's subnormal range, where ds is rounded to f16;
# the CPU's default backward (the XLA VJP's points) is 3.5 % away at
# FP16_TINY's second step. tests/test_torch_fp16.py holds the port to JAX
# at the same 1 %
FP16_GRAD_RTOL = 1e-2
# the share of LoRA elements within lr / 10 of the CPU's after the f16
# steps, as tests/test_torch_fp16.py holds the port to JAX on the CPU
FP16_LORA_SHARE = 0.97
# the mesh phase (phase_mesh): SD1.5 at 512 px, 4 ranks on the one card
# over gloo (NCCL refuses two ranks of a communicator on one device, so
# the times say nothing of scaling), t_to in [1, MESH_DENOISE_STEPS)
MESH_DENOISE_STEPS = 4
MESH_ITERATIONS = 2
MESH_REL = 0.01  # loss and grad norm of the 2 x 2 mesh against world 1
MESH_HEADS = 4  # SD1.5's 8 heads over tp = 2
MESH_LAUNCH_TIMEOUT_S = 300
# FLUX over the process mesh (phase "mesh flux"): the 2 x 2 TINY run, f32
# with TF32 off, against world 1 (only the tp all-reduce's sums move: loss
# and grad norm to 1e-5 relative, the LoRA to 1e-6 at lr TINY_FLUX_LR)
MESH_FLUX_TINY_PX = 256
MESH_FLUX_TINY_ITERATIONS = 1
MESH_FLUX_TINY_REL = 1e-5
MESH_FLUX_TINY_ATOL = 1e-6
MESH_FLUX_HEADS = 12  # FLUX-dev's 24 heads over tp = 2
MESH_FLUX_STAGE_BLOCKS = (10 + 19, 9 + 19)  # blocks of stages 0 and 1 at pp = 2
MESH_FLUX_LAUNCH_TIMEOUT_S = 480
FLEET_IMAGE_ITERATIONS = 3
FLEET_ENCODE_SHAPE = (4, 1, 1024, 512)  # the image fleet's encode of 2 x 2 images at 256 px
FLEET_SCALES = [-1.0, 0.0, 1.0]
FLEET_GENERATE_STEPS = 6
ADAPTIVE_UPDATES = 5
# the LoRA after the updates, card against CPU, element by element: ADAPTIVE_ULPS
# ulps of the weight (an update of about 1e-6 rounds into weights of about 0.1)
# plus ADAPTIVE_REL of its leaf's largest move (the up factors start at 0, and an
# element's own move may cancel to near 0)
ADAPTIVE_ULPS = 2
ADAPTIVE_REL = 3e-4
# real-image editing (phase_edit): DDIM steps cut from the notebook's 50,
# null-text inner steps cut from 10, notebook cell 10's sweep and gate; in a
# null-text backward every routed self-attention but the first takes #2 (the
# first one's input does not depend on the uncond embedding)
EDIT_STEPS = 6
EDIT_INNER = 5
EDIT_SCALES = [0.0, 2.0, 4.0]
EDIT_START_NOISE = 500.0
EDIT_ROUTED_BWD = ROUTED_PER_FORWARD - 1
# phase_tiny_edit: TINY at 64 px (3 routed self-attentions a forward, 2 of
# them in a null-text backward), the GPU against the CPU
TINY_EDIT_STEPS = 3
TINY_EDIT_INNER = 2
TINY_EDIT_ROUTED_BWD = 2
TINY_EDIT_REL = 1e-5
# the images: one level on up to 5 % of the values. The null-text Adam
# carries the sums' rounding into the embeddings at about 1e-4 relative
# (tests/test_torch_inversion.py), and the decode truncates to uint8, so a
# value that far from a level boundary flips (3.45-3.47 % on an H100)
TINY_EDIT_PIXELS = (1, 0.05)
# phase_attention_maps: the probabilities' row sums, and eps under a tap
# (plain f32 path) against eps off it (#1's 3xTF32 kernel)
PROB_SUM_TOL = 1e-5
MAPS_EPS_REL = 1e-4
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, dt: str) -> tuple:
    """(ms, 'operations' or 'bytes'): the least time the card could take for
    `flops` operations of type `dt` and `nbytes` moved to or from memory."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def f32_bounds(flops: float, nbytes: float) -> dict:
    """The two bounds of an f32 kernel (a conv, #2's backward): `flops` on
    f32 FMAs (67 TFLOP/s) and 3 x `flops` on TF32 tensor cores (495 TFLOP/s;
    the 3xTF32 mainloops' three products), each beside its bytes; the row's
    bound is the lesser."""
    fma, tf32 = bound(flops, nbytes, "float32"), bound(3 * flops, nbytes, "tf32")
    return {"fma_bound_ms": fma[0], "tf32x3_bound_ms": tf32[0],
            "bound_ms": min(fma, tf32)[0], "bound_by": min(fma, tf32)[1]}


def attention_bounds(shape, dt: str, backward: bool = False) -> dict:
    """attention_bound as bound_ms and bound_by; f32 with both of its
    bounds (f32_bounds), the lesser the row's."""
    B, H, L, d = shape
    if dt == "float32":
        flops = (10 if backward else 4) * B * H * L * L * d
        return f32_bounds(flops, (7 if backward else 4) * B * H * L * d * 4)
    ms, by = attention_bound(shape, dt, backward)
    return {"bound_ms": ms, "bound_by": by}


def attention_bound(shape, dt: str, backward: bool = False) -> tuple:
    """Non-causal attention on (B, H, L, d): forward 4 B H L^2 d operations
    (q k^T, p v) over q, k, v read and o written; backward 10 B H L^2 d (s
    again, dp, dv, dq, dk) over q, k, v, g read and dq, dk, dv written."""
    B, H, L, d = shape
    item = 4 if dt == "float32" else 2
    if backward:
        return bound(10 * B * H * L * L * d, 7 * B * H * L * d * item, dt)
    return bound(4 * B * H * L * L * d, 4 * B * H * L * d * item, dt)


T_START = time.perf_counter()


def timed(name: str, fn, *args):
    """fn(*args), then its elapsed seconds and the time since the start, so
    that a run cut by its time limit shows where it stood."""
    t0 = time.perf_counter()
    out = fn(*args)
    say("time", f"{name}: {time.perf_counter() - t0:.1f} s (at {time.perf_counter() - T_START:.1f} "
        f"s)")
    return out


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, runs: int = 10, reps: int = 1) -> float:
    """Median over `runs` samples, each timed with CUDA events between
    torch.cuda.synchronize() calls, after one warm-up call; a sample is
    `reps` calls back to back, per call (reps > 1: the wrapper's host time
    overlaps the device work of the calls before it, so a short kernel's
    sample reads its device time, not its wrapper's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fns, runs: int = 10) -> float:
    """Device time of one call: the calls `fns` (each on inputs of its own,
    their outputs kept, so that together they outgrow the 50 MB L2 and each
    reads and writes HBM) captured in one CUDA graph, its replay timed by
    median_ms, over len(fns). For kernels shorter than their wrapper's host
    time, which median_ms reads instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in fns]
    ms = median_ms(graph.replay, runs) / len(fns)
    del graph, outs
    return ms


def bf16_tolerance(ref_max: float) -> float:
    """Four bf16 ulps at the output's largest magnitude. The kernel and the
    plain version round p and o to bf16 at the same points but sum in other
    orders (and use the fast exp), so an element may land one or two ulps
    away; four leaves room for a rounding flip of p to carry through P.V."""
    return 4.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-20))) - 7)


F32_TOL = 1e-5  # f32 sums in another order; errors seen are ~2e-7


def phase_device():
    import torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    from sliders_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc}")


# the kernels whose ptxas report `phase_build` prints (the first key an entry
# holds names it): #1's bf16 forward on the Hopper mainloop
# (attention_sm90.cuh, Cfg<DP, BK, TMA, two-pass>) at SD1.5's d = 40 and 80,
# SDXL's d = 64 and FLUX's d = 128, and #4's bf16 forward at d = 128 and 256
# on the same mainloop; the f32 forwards (attention_fwd_tf32.cuh,
# attn_fwd_tf32<FCfg<DPF, BK, TMA, plan>>, 3xTF32): #1's at every
# instantiation, #4's at d = 128 and 256; the backwards on the Hopper
# backward mainloop (attention_bwd_sm90.cuh, BCfg<DP, BN, TMA, dk/dv, #2's
# policy, plan>): #2's bf16 dq and dk/dv kernels at d = 40, 64, 80 and 128
# and #4's at d = 128 (PAIR), #4's at d = 256 (SPLIT), #2's f32 kernels at
# every instantiation and #4's at d = 128 (TF32: DP is twice the padded f32
# head dim); the split passes of those f32 paths; the conv kernels' Hopper
# mainloop (conv3x3_sm90.cuh) in bf16 at each BN, with #6's prologue at BN
# 128 and 160, and in f32 (3xTF32) at BN 128 with and without it, and the
# weights' TF32 split; #4's f32 backward at d = 256 and 512 (TF32 on
# clusters of 2 and 4 blocks, DP a block's share); every generic conv and
# GroupNorm instantiation, #4's f32 d = 512 forward, #9's copy kernels
# #2's f32 (TF32 plan) instantiations, and #1's f32 forward's (FCfg<DPF,
# BK, TMA, FWD_TWO_PASS>, attn_fwd_tf32): (padded head dim, TMA)
TF32_CONFIGS = ((16, 0), (32, 1), (40, 0), (48, 0), (64, 1), (80, 0), (96, 0), (112, 0),
                (128, 0), (128, 1))
FWD_TF32 = tuple((f"FCfgILi{dpf}ELi{64 if dpf <= 64 else 32}ELb{tma}ELi0EE",
                  f"attn_fwd_tf32 #1 f32 d={dpf} ({'TMA' if tma else '16-byte TMA'}, 3xTF32)")
                 for dpf, tma in TF32_CONFIGS)
BWD_SM90 = (("BCfgILi48ELi128ELb0ELb0ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dq d=40 (cp.async)"),
            ("BCfgILi48ELi128ELb0ELb1ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dk/dv d=40 (cp.async)"),
            ("BCfgILi64ELi64ELb1ELb0ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dq d=64 (TMA)"),
            ("BCfgILi64ELi64ELb1ELb1ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dk/dv d=64 (TMA)"),
            ("BCfgILi80ELi64ELb0ELb0ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dq d=80 (cp.async)"),
            ("BCfgILi80ELi64ELb0ELb1ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dk/dv d=80 (cp.async)"),
            ("BCfgILi128ELi64ELb1ELb0ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dq d=128 (TMA)"),
            ("BCfgILi128ELi64ELb1ELb1ELb1ELi0ELi1EE", "attn_bwd_sm90 #2 dk/dv d=128 (TMA)"),
            ("BCfgILi128ELi64ELb1ELb1ELb0ELi0ELi1EE", "attn_bwd_sm90 #4 dk/dv d=128 (TMA)"),
            ("BCfgILi128ELi64ELb1ELb0ELb0ELi0ELi1EE", "attn_bwd_sm90 #4 dq d=128 (TMA)"),
            ("BCfgILi256ELi32ELb1ELb1ELb0ELi1ELi1EE", "attn_bwd_sm90 #4 dk/dv d=256 (TMA, SPLIT)"),
            ("BCfgILi256ELi64ELb1ELb0ELb0ELi1ELi1EE", "attn_bwd_sm90 #4 dq d=256 (TMA, SPLIT)"),
            ("BCfgILi256ELi32ELb1ELb1ELb0ELi2ELi1EE", "attn_bwd_sm90 #4 f32 dk/dv d=128 (TMA, TF32)"),
            ("BCfgILi256ELi32ELb1ELb0ELb0ELi2ELi1EE", "attn_bwd_sm90 #4 f32 dq d=128 (TMA, TF32)"),
            *((f"BCfgILi256ELi{32 if cs == 2 else 16}ELb1ELb{dkv}ELb0ELi2ELi{cs}EE",
               f"attn_bwd_sm90 #4 f32 {'dk/dv' if dkv else 'dq'} d={128 * cs} (TMA, TF32, "
               f"cluster of {cs})") for cs in (2, 4) for dkv in (1, 0)),
            *((f"BCfgILi{2 * dpf}ELi{64 if dpf <= 48 else 32}ELb{tma}ELb{dkv}ELb1ELi2ELi1EE",
               f"attn_bwd_sm90 #2 f32 {'dk/dv' if dkv else 'dq'} d={dpf} "
               f"({'TMA' if tma else 'cp.async'}, TF32)")
              for dpf, tma in TF32_CONFIGS for dkv in (0, 1)))
# the f16 instantiations of `precision: fp16`: #1's forward at every padded
# head dim (CfgF16<DP, BK, TMA, two-pass, blocks an SM>), #2's dq and dk/dv at
# d = 40, 64, 80 and 128 (BCfgF16<DP, BN, TMA, dk/dv>), the conv mainloop at
# each BN with and without #6's prologue, and the generic conv kernel; each
# must build with no spill
F16_SM90 = (*((f"CfgF16ILi{dp}ELi{64 if dp == 64 and tma else 128}ELb{tma}ELb1ELi"
               f"{2 if dp == 64 and tma else 1}E",
               f"attn_sm90 #1 f16 d={dp} ({'TMA' if tma else 'cp.async'})")
              for dp, tma in ((16, 0), (32, 0), (48, 0), (64, 0), (64, 1), (80, 0), (96, 0),
                              (112, 0), (128, 0), (128, 1))),
            *((f"BCfgF16ILi{dp}ELi{128 if dp <= 48 else 64}ELb{tma}ELb{dkv}E",
               f"attn_bwd_sm90 #2 f16 {'dk/dv' if dkv else 'dq'} d={d} "
               f"({'TMA' if tma else 'cp.async'})")
              for d, dp, tma in ((40, 48, 0), (64, 64, 1), (80, 80, 0), (128, 128, 1))
              for dkv in (0, 1)),
            *((f"conv3x3_sm90I6__halfLi{bn}ELb{pro}E",
               f"conv3x3_sm90{'<prologue>' if pro else ''} f16 BN={bn}")
              for bn in (128, 160, 256) for pro in (0, 1) if not (pro and bn == 256)),
            ("conv3x3_2byteI6__halfLb0E", "conv3x3_2byte f16"),
            ("conv3x3_2byteI6__halfLb1E", "conv3x3_2byte<prologue> f16"))
REPORTED = (*F16_SM90,
            ("CfgILi48ELi128ELb0ELb1ELi1E", "attn_sm90 #1 d=40 (cp.async)"),
            ("CfgILi80ELi128ELb0ELb1ELi1E", "attn_sm90 #1 d=80 (cp.async)"),
            ("CfgILi64ELi64ELb1ELb1ELi2E", "attn_sm90 #1 d=64 (TMA, 2 blocks an SM)"),
            ("CfgILi128ELi128ELb1ELb1ELi1E", "attn_sm90 #1 d=128 (TMA)"),
            ("CfgILi128ELi128ELb1ELb0ELi1E", "attn_sm90 #4 d=128 (TMA, one pass)"),
            ("CfgILi256ELi64ELb1ELb0ELi1E", "attn_sm90 #4 d=256 (TMA, one pass)"),
            *FWD_TF32,
            ("FCfgILi128ELi32ELb1ELi1EE", "attn_fwd_tf32 #4 f32 d=128 (TMA, 3xTF32, one pass)"),
            ("FCfgILi256ELi32ELb1ELi2EE", "attn_fwd_tf32 #4 f32 d=256 (TMA, 3xTF32, split d)"),
            *BWD_SM90,
            ("tf32_split_bhld", "tf32_split_bhld"), ("tf32_split_vt", "tf32_split_vt"),
            *((f"conv3x3_sm90I13__nv_bfloat16Li{bn}ELb{pro}E",
               f"conv3x3_sm90{'<prologue>' if pro else ''} bf16 BN={bn}")
              for bn in (128, 160, 256) for pro in (0, 1) if not (pro and bn == 256)),
            *((f"conv3x3_sm90IfLi128ELb{pro}E",
               f"conv3x3_sm90{'<prologue>' if pro else ''} f32 (3xTF32) BN=128") for pro in (0, 1)),
            ("tf32_split", "tf32_split"),
            ("conv3x3_2byteI13__nv_bfloat16Lb0E", "conv3x3_2byte bf16"),
            ("conv3x3_2byteI13__nv_bfloat16Lb1E", "conv3x3_2byte<prologue> bf16"),
            ("conv3x3_f32ILb0E", "conv3x3_f32"), ("conv3x3_f32ILb1E", "conv3x3_f32<prologue>"),
            ("gn_statsI13__nv_bfloat16E", "gn_stats bf16"), ("gn_statsIfE", "gn_stats f32"),
            ("gn_applyI13__nv_bfloat16E", "gn_apply bf16"), ("gn_applyIfE", "gn_apply f32"),
            ("flash_fwd_f32_d512", "flash_fwd_f32_d512"),
            ("layout_pin_rows16", "layout_pin_rows16"),
            ("layout_pin_transposeIt", "layout_pin_transpose_16bit"),
            ("layout_pin_transposeIj", "layout_pin_transpose_32bit"),
            ("layout_pin_gatherIt", "layout_pin_gather_16bit"),
            ("layout_pin_gatherIj", "layout_pin_gather_32bit"))


def ptxas_report(log: str) -> list:
    """'kernel Used N registers, ... (stack frame and spill bytes)' for each
    REPORTED kernel in an nvcc -Xptxas -v log."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry, spill = ln, ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and entry is not None:
            for key, label in REPORTED:
                if key in entry:
                    out.append(f"{label} {ln.split('info    : ')[-1]}" + (f" ({spill})" if spill else ""))
                    break
            entry = None
    return out


def sm90_smem(d: int) -> int:
    """Dynamic shared memory a block of the bf16 Hopper-mainloop kernel takes
    at head dim d (attention_sm90.cuh's Cfg as sd_attention.cu and, at d =
    256, flash_attention.cu pick it: two blocks an SM and 64-key tiles at
    d = 64, one and 64-key tiles at d = 256, else one and 128-key tiles;
    1024 bytes of alignment slack and 1024 of barriers, the 128-row q tile,
    then as many K/V stages as fit 200 KiB split between the SM's blocks, at
    most 4)."""
    dp = -(-d // 16) * 16
    ctas, block_k = (2, 64) if d == 64 else (1, 64) if d == 256 else (1, 128)
    q, stage = 128 * dp * 2, 2 * block_k * dp * 2
    return 2048 + q + min(4, (200 * 1024 // ctas - 2048 - q) // stage) * stage


def bwd_sm90_smem(dp: int, bn: int, dkv: bool, kind: int = 0, cs: int = 1) -> int:
    """Dynamic shared memory a block of the backward mainloop takes
    (attention_bwd_sm90.cuh's BCfg<DP, BN, ..., plan, CS>, plan 0 PAIR, 1
    SPLIT, 2 TF32, CS blocks a cluster): 1024 bytes of alignment slack and
    1024 of barriers, two resident tiles (128 rows; 64 for SPLIT and TF32
    but the f32 dq kernel to d = 64), the consumers' exchange (64-row
    tiles of at least 32 f32 columns), the other blocks' partial tiles (CS
    > 2: two slots of two 64 x BN f32 tiles from each; at CS = 2 they land
    in the exchange), then as many stages
    of two streamed tiles (TF32: a hi and a lo plane each) and, in the dk/dv
    kernel, their rows' three f32 statistics as fit 200 KiB (PAIR) or the
    block's 227 KiB, at most 4."""
    own = kind == 2 and not dkv and dp <= 128  # the f32 dq kernel's own rows (d <= 64)
    res = (128 if kind == 0 or own else 64) * dp * 2
    stage = 2 * (2 if kind == 2 else 1) * bn * dp * 2 + (3 * bn * 4 if dkv else 0)
    xtile = 64 * max(bn, 32) * 4
    if kind == 1:
        x = bn // 2 * 128 * 4 + (0 if dkv else bn // 16 * 4 * 128 * 4)
    elif kind == 2:
        x = 4 * xtile if dkv or own else (2 * xtile
                                         + -(-(bn // 2 + 2) * 128 * 4 // 1024) * 1024)
    else:
        x = 0
    fixed = 2048 + 2 * res + x + (2 * 2 * (cs - 1) * bn // 2 * 128 * 4 if cs > 2 else 0)
    return fixed + min(4, ((200 * 1024 if kind == 0 else 232448) - fixed) // stage) * stage


def fwd_tf32_smem(dpf: int, split_d: bool = False) -> int:
    """Dynamic shared memory a block of the f32 forwards takes
    (attention_fwd_tf32.cuh's FCfg<DPF, BK, TMA, PLAN>: 64 keys a stage
    where DPF <= 64, else 32): 1024 bytes of alignment slack and 1024 of
    barriers, the f32 q tile (128 rows; 64 under FWD_SPLIT_D, #4 at d = 256,
    with 4 partial S tiles of 64 x 32 f32 for the exchange), then as many
    stages of K's and V^T's hi and lo planes (FWD_SPLIT_D: K's two or V^T's
    two) as fit the block's 227 KiB, at most 4."""
    bk = 64 if dpf <= 64 else 32
    rows, planes = (64, 2) if split_d else (128, 4)
    fixed = 2048 + rows * dpf * 4 + (4 * 64 * bk * 4 if split_d else 0)
    stage = planes * bk * dpf * 4
    return fixed + min(4, (232448 - fixed) // stage) * stage


def phase_build():
    from sliders_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_libraries()
    secs = time.perf_counter() - t0
    f16_seen = []
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        regs = ptxas_report(log)
        say("build", f"{lib.name} ({'; '.join(regs) or '?'})")
        f16_seen += [r for r in regs if r.split(" Used ")[0] in {lb for _, lb in F16_SM90}]
        serialized = [ln for ln in log.splitlines() if "wgmma.mma_async instructions are serialized"
                      in ln]
        if serialized:
            # each by its REPORTED label where it has one, else its mangled name
            names = [next((label for key, label in REPORTED if key in ln),
                          ln.split("'")[-2] if ln.count("'") >= 2 else ln[-160:])
                     for ln in serialized]
            say("build", f"{lib.name}: ptxas serialized wgmma in {len(serialized)} kernel(s) "
                f"(C7512 / C7513): " + " | ".join(names))
        _build.library(name)
    say("build", "attn_sm90 dynamic shared memory a block (bytes): " + ", ".join(
        f"d={d} {sm90_smem(d)}" for d in (40, 64, 80, 128))
        + "; with one block an SM its consumers take 224 registers a thread and the producer "
        "56 (setmaxnreg)")
    pair = [(d, -(-d // 16) * 16, 128 if d <= 48 else 64) for d in (40, 64, 80, 128)]
    tf32 = [(d, 2 * d, 64 if d <= 48 else 32) for d in (40, 64, 80, 128)]
    say("build", "attn_bwd_sm90 dynamic shared memory a block (bytes): bf16 PAIR " + ", ".join(
        f"d={d} dq {bwd_sm90_smem(dp, bn, False)} dk/dv {bwd_sm90_smem(dp, bn, True)}"
        for d, dp, bn in pair)
        + f"; bf16 SPLIT d=256 dq {bwd_sm90_smem(256, 64, False, 1)} dk/dv "
        f"{bwd_sm90_smem(256, 32, True, 1)}; f32 TF32 " + ", ".join(
            f"d={d} dq {bwd_sm90_smem(dp, bn, False, 2)} dk/dv {bwd_sm90_smem(dp, bn, True, 2)}"
            for d, dp, bn in tf32)
        + "; f32 on clusters that split d: " + ", ".join(
            f"d={128 * cs} dq {bwd_sm90_smem(256, 32 // (cs // 2), False, 2, cs)} dk/dv "
            f"{bwd_sm90_smem(256, 32 // (cs // 2), True, 2, cs)}" for cs in (2, 4))
        + "; one block an SM, its consumers take 232 registers a thread and the producer 40 "
        "(setmaxnreg)")
    say("build", "attn_fwd_tf32 (#1 f32) dynamic shared memory a block (bytes): " + ", ".join(
        f"d={d} {fwd_tf32_smem(d)}" for d in (40, 64, 80, 128))
        + "; one block an SM, consumers 232 registers a thread, producer 40 (setmaxnreg)")
    say("build", f"#4's forwards, dynamic shared memory a block (bytes): bf16 d=128 "
        f"{sm90_smem(128)} (consumers 224 registers a thread, producer 56), d=256 "
        f"{sm90_smem(256)} (232 / 40); f32 (3xTF32) d=128 {fwd_tf32_smem(128)}, d=256 "
        f"{fwd_tf32_smem(256, split_d=True)} (232 / 40)")
    from sliders_tpu_torch.ops import conv3x3 as tc

    import torch

    plans = {}
    for h, c, n, _ in CONV_SHAPES + SDXL_CONV_SHAPES:
        plan = tc.plan((16, h, h, c), n, torch.bfloat16)
        plans.setdefault((plan.tr, plan.tc, plan.bn), plan)
    f32_plans = {}
    for h, c, n in VAE_CONV_SHAPES:
        plan = tc.plan((VAE_DECODE_BATCH, h, h, c), n, torch.float32)
        f32_plans.setdefault((plan.tr, plan.tc, plan.bn), plan)
    say("build", "conv3x3_sm90 tile plans at the UNets' batch-16 shapes (TR x TC, BN: weight "
        "stages, dynamic shared memory a block): " + ", ".join(
            f"{pl.tr}x{pl.tc}, {pl.bn}: {pl.stages}, {pl.smem}" for pl in plans.values())
        + "; its consumers take 232 registers a thread and the producer 40 (setmaxnreg); #6 "
        "(512 threads, BN <= 160) 184 and 72; f32 (3xTF32) at the VAE decoder's shapes: "
        + ", ".join(f"{pl.tr}x{pl.tc}, {pl.bn}: {pl.stages} stages of hi + lo boxes, {pl.smem}"
                    for pl in f32_plans.values())
        + "; consumers 232 and producer 40, f32 #6 (384 threads, 3 transform warps) 224 and 56")
    spilled = [r for r in f16_seen if "0 bytes spill stores" not in r]
    say("build", f"f16 instantiations: {len(f16_seen)} of {len(F16_SM90)} reported, "
        f"{len(spilled)} with spill stores")
    if len(f16_seen) != len(F16_SM90) or spilled:
        raise AssertionError(f"f16 kernels missing from the build or spilling: {spilled}")
    say("build", f"{len(libs)} libraries built and loaded in {secs:.1f} s")


def phase_kernel():
    """Kernel #1 against its plain version; SDPA on the same inputs is timed
    beside it (a yardstick, never a path of the port)."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import sd_attention as sa

    # the comparison is full f32 on both sides: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for shape, dt, views in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        B, H, L, d = shape
        if views:  # head views of (B, L, H*d) projections, as FLUX passes them
            q, k, v = (torch.randn((B, L, H * d), generator=gen, device="cuda").to(dtype)
                       .view(B, L, H, d).permute(0, 2, 1, 3) for _ in range(3))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
        out = sa.sd_attention(q, k, v)
        ref = sa.sd_attention_ref(q, k, v)
        ref32 = sa.sd_attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err32 = (out.float() - ref32).abs().max().item()
        ref_max = ref.float().abs().max().item()
        del ref32
        tol = bf16_tolerance(ref_max) if dtype == torch.bfloat16 else F32_TOL
        ms = median_ms(lambda: sa.sd_attention(q, k, v))
        plain_ms = median_ms(lambda: sa.sd_attention_ref(q, k, v))
        library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bounds = attention_bounds(shape, dt)
        say("kernel", f"{shape} {dt}{' head views' if views else ''}: max|err| vs plain "
            f"{err:.3g} (tol {tol:.3g}), vs f32 {err32:.3g}, max|ref| {ref_max:.3g}; median "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA ({dt}) {library_ms:.4f} ms; bound "
            f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']})"
            + (f"; bounds 3xTF32 {bounds['tf32x3_bound_ms']:.4f}, FMA "
               f"{bounds['fma_bound_ms']:.4f} ms" if dt == "float32" else ""))
        if not (err <= tol and err32 <= 4 * tol and out.dtype == dtype and out.shape == shape):
            raise AssertionError(f"sd_attention disagrees with its plain version at {shape} {dt}")
        results.append({"shape": shape, "dtype": dt, "err": err, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, **bounds})
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return results


def bf16_ulp(ref_max: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-30))) - 7)


def phase_kernel_bwd():
    """The backward kernel against sd_attention_bwd_ref at the grad-pass
    shapes. bf16: both round p and ds at the same points and differ in
    summation order and the fast exp, held to 4 bf16 ulps at each output's
    largest magnitude; f32 (three TF32 products a step): 1e-5 relative to
    the largest value. SDPA's backward on the same inputs is timed beside
    it, and f32 rows give both bounds (3xTF32 and FMA)."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import sd_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = []
    for shape, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
        out = sa.sd_attention_bwd(q, k, v, g)
        ref = sa.sd_attention_bwd_ref(q, k, v, g)
        torch.cuda.synchronize()
        errs, worst, ok = [], 0.0, True
        for name, o, r in zip(("dq", "dk", "dv"), out, ref):
            ref_max = r.float().abs().max().item()
            err = (o.float() - r.float()).abs().max().item()
            tol = 4 * bf16_ulp(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
            errs.append(f"{name} {err:.3g} (tol {tol:.3g}, max|ref| {ref_max:.3g})")
            ok = ok and err <= tol and o.dtype == dtype and o.shape == r.shape
            worst = max(worst, err)
        del out, ref
        plain_ms = median_ms(lambda: sa.sd_attention_bwd_ref(q, k, v, g), runs=5)
        # SDPA's backward alone: its forward once, then the graph replayed
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves)
        kernel = lambda: sa.sd_attention_bwd(q, k, v, g)  # noqa: E731
        library = lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)  # noqa: E731
        if shape in BWD_INTERLEAVED:
            # kernel, SDPA, SDPA, kernel, ... : each the mean of its medians
            rounds = {"kernel": [], "sdpa": []}
            for r in range(BWD_INTERLEAVED[shape]):
                for side in (("kernel", "sdpa") if r % 2 == 0 else ("sdpa", "kernel")):
                    rounds[side].append(median_ms(kernel if side == "kernel" else library))
            ms, library_ms = statistics.mean(rounds["kernel"]), statistics.mean(rounds["sdpa"])
            say("kernel", f"bwd {shape} {dt} interleaved rounds: kernel "
                f"{[round(t, 4) for t in rounds['kernel']]}, SDPA backward "
                f"{[round(t, 4) for t in rounds['sdpa']]} ms")
        else:
            ms, library_ms = median_ms(kernel), median_ms(library)
        bounds = attention_bounds(shape, dt, backward=True)
        say("kernel", f"bwd {shape} {dt}: max|err| vs plain {', '.join(errs)}; median kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms; bound "
            f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']})"
            + (f"; bounds 3xTF32 {bounds['tf32x3_bound_ms']:.4f}, FMA "
               f"{bounds['fma_bound_ms']:.4f} ms" if dt == "float32" else ""))
        if not ok:
            raise AssertionError(f"sd_attention_bwd disagrees with its plain version at {shape} {dt}")
        results.append({"shape": shape, "dtype": dt, "err": worst, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, **bounds})
        del q, k, v, g, leaves, o
        torch.cuda.empty_cache()
    return results


def bf16_max_ulps(out, ref) -> float:
    """The largest error of `out` against `ref`, each element's in bf16 ulps
    of its own reference value (floored at 2**-6 of the largest, where an
    f32 sum near zero has no meaningful ulp)."""
    import torch

    r = ref.float().abs()
    floor = max(r.max().item(), 2.0**-20) * 2.0**-6
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(r, min=floor))) - 7)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


CONV_ULPS = 2  # both round once from f32 sums taken in other orders: a rounding may flip


def conv_case(B, H, C, N, mode, dtype, gen):
    """Inputs of one routed conv: x (B, H, H, C), the (B, C) GN fold a, s,
    the weight as the models draw it (`ParamFactory.conv`: OIHW laid out
    channels_last, 1/sqrt(fan-in)), bias and the mode's extra, scaled like
    the UNet's (unit activations)."""
    import torch

    from sliders_tpu_torch.models.params import ParamFactory

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(B, H, H, C).to(dtype)
    a, s = 1.0 + randn(B, C, scale=0.1), randn(B, C, scale=0.3)
    w = ParamFactory(gen, dtype, "cuda").conv(C, N)["weight"]
    b = randn(N, scale=0.1).to(dtype)
    extra = {"none": None, "temb": randn(B, N).to(dtype),
             "residual": randn(B, H, H, N).to(dtype)}[mode]
    return x, a, s, w, b, extra


def phase_conv_kernels():
    """Kernels #5, #7 and #6 against their plain versions (f32 accumulation,
    f32 epilogue, one rounding; TF32 off), with the weights laid out as the
    models lay them out: at every conv shape the SD1.5 UNet routes at 512 px
    in the mode the UNet uses there, at batch 16 (timed) and at the training
    batches CONV_TRAIN_BATCHES (not timed); at every shape the SDXL UNet
    routes at 1024 px, at batch 16 (timed); the grad pass's batch 1 at two
    shapes and one f32 shape (timed); #5 at the SD VAE decoder's f32
    shapes at the decode batch (timed); and the CONV_GENERIC shapes (not
    timed). bf16 is held to CONV_ULPS bf16 ulps of each element, f32 to
    1e-5 of the largest value (F32_TOL). Every call must take the variant
    it is planned onto (counted by variant): the CONV_GENERIC ones the
    generic kernel, every other one the Hopper mainloop, f32 on its 3xTF32
    path, each such call after one launch of the `tf32_split` kernel, whose
    output is held to `tf32_split_ref` bit for bit (and timed beside its
    bound at each f32 weight). Each timed line also times cuDNN's conv +
    bias in the case's dtype (the 'xla' route's conv) and one PyTorch
    expression per kernel computing its function, for reference; f32 lines
    give both bounds (FMA and 3xTF32). Returns the rows by kernel, the
    split kernel's under "tf32_split"."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import conv3x3 as tc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(9)
    results = {"conv3x3": [], "epi_conv3x3": [], "fused_conv3x3": []}
    everything = tuple(results)
    results["tf32_split"] = []
    # (B, H, C, N, mode, dtype, kernels, timed)
    cases = ([(16, h, c, n, mode, "bfloat16", everything, True) for h, c, n, mode in CONV_SHAPES]
             + [(16, h, c, n, mode, "bfloat16", everything, True)
                for h, c, n, mode in SDXL_CONV_SHAPES]
             + [(*c, everything, True) for c in CONV_EXTRA]
             + [(B, h, c, n, mode, "bfloat16", everything, False)
                for B in CONV_TRAIN_BATCHES for h, c, n, mode in CONV_SHAPES]
             + [(VAE_DECODE_BATCH, h, c, n, "none", "float32", ("conv3x3",), True)
                for h, c, n in VAE_CONV_SHAPES]
             + [(*c, everything, False) for c in CONV_GENERIC])
    seen = set()
    untimed = {}  # batch -> [cases, calls, worst ulps]
    for B, H, C, N, mode, dt, kernels, timed in cases:
        want = "generic" if (B, H, C, N, mode, dt) in CONV_GENERIC else "hopper"
        dtype = getattr(torch, dt)
        x, a, s, w, b, extra = conv_case(B, H, C, N, mode, dtype, gen)
        calls = [("epi_conv3x3", lambda: tc.epi_conv3x3(x, w, b, extra, mode),
                  lambda: tc.epi_conv3x3_ref(x, w, b, extra, mode)),
                 ("fused_conv3x3", lambda: tc.fused_conv3x3(x, a, s, w, b, extra, mode),
                  lambda: tc.fused_conv3x3_ref(x, a, s, w, b, extra, mode))]
        if (B, H, C, N, dt) not in seen:  # #5 has no mode: once per shape
            seen.add((B, H, C, N, dt))
            calls.insert(0, ("conv3x3", lambda: tc.conv3x3(x, w, b),
                             lambda: tc.conv3x3_ref(x, w, b)))
        calls = [c for c in calls if c[0] in kernels]
        xc = x.permute(0, 3, 1, 2)
        cudnn_ms = median_ms(lambda: F.conv2d(xc, w, b, padding=1)) if timed else None
        # one PyTorch expression per kernel computing its function on the same
        # inputs (channels-last views, as cuDNN takes the port's layout): #7
        # conv + bias + the mode's extra; #6 the GN-affine + SiLU prologue too
        extra_c = (None if extra is None else extra[:, :, None, None] if mode == "temb"
                   else extra.permute(0, 3, 1, 2))
        af, sf = a[:, :, None, None], s[:, :, None, None]  # the fold stays f32, as in #6

        def epi_library(inp=xc):
            y = F.conv2d(inp, w, b, padding=1)
            return y if extra_c is None else y + extra_c

        library = {"conv3x3": cudnn_ms, "epi_conv3x3": None, "fused_conv3x3": None}
        if timed:
            library["epi_conv3x3"] = median_ms(epi_library) if "epi_conv3x3" in kernels else None
            library["fused_conv3x3"] = median_ms(
                lambda: epi_library(F.silu(xc.float() * af + sf).to(dtype))
            ) if "fused_conv3x3" in kernels else None
        parts = []
        # the split kernel against its plain version, bit for bit
        if dtype == torch.float32 and want == "hopper":
            before = tc.tf32_split.launches
            split, split_ref = tc.tf32_split(w), tc.tf32_split_ref(w)
            torch.cuda.synchronize()
            if tc.tf32_split.launches != before + 1 or not torch.equal(split, split_ref):
                raise AssertionError(f"tf32_split at ({N}, {C}, 3, 3) disagrees with "
                                     f"tf32_split_ref or did not launch")
            row = {"shape": (N, C, 3, 3), "err": (split - split_ref).abs().max().item()}
            if timed:
                row["ms"] = median_ms(lambda: tc.tf32_split(w))
                # at least 20 calls and 150 MB of w, hi and lo (3 x 4 x 9 C N bytes a call)
                copies = [w.clone() for _ in range(max(20, -(-150_000_000 // (108 * C * N))))]
                row["graph_ms"] = graph_ms([lambda c=c: tc.tf32_split(c) for c in copies])
                del copies
                row["plain_ms"] = median_ms(lambda: tc.tf32_split_ref(w))
                # w read once, hi and lo written once; a few integer ops a value
                row["bound_ms"], row["bound_by"] = bound(0, 3 * 4 * 9 * C * N, "float32")
                row["library_ms"] = None
            results["tf32_split"].append(row)
            del split, split_ref
        for name, kernel, plain in calls:
            fn = getattr(tc, name)
            took = fn.variants[want]
            splits = tc.tf32_split.launches
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            if fn.variants[want] != took + 1:
                raise AssertionError(f"{name} at {(B, H, H, C)}x{N} {dt} did not take the "
                                     f"{want} kernel: {fn.variants}")
            if tc.tf32_split.launches != splits + (dtype == torch.float32 and want == "hopper"):
                raise AssertionError(f"{name} at {(B, H, H, C)}x{N} {dt} launched "
                                     f"{tc.tf32_split.launches - splits} weight splits")
            err = (out.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            if dtype == torch.bfloat16:
                ulps = bf16_max_ulps(out, ref)
                ok, shown = ulps <= CONV_ULPS, f"{ulps:.2f} ulps (tol {CONV_ULPS})"
            else:
                ulps = 0.0
                tol = F32_TOL * max(1.0, ref_max)
                ok, shown = err <= tol, f"({err / tol:.3f} of tol {tol:.3g})"
            del out, ref
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at "
                                     f"{(B, H, H, C)}x{N} {mode} {dt}")
            entry = {"shape": (B, H, H, C, N), "mode": mode, "dtype": dt, "err": err,
                     "variant": want}
            if timed:
                runs = 10 if dt == "bfloat16" else 5
                entry["ms"], entry["plain_ms"] = median_ms(kernel, runs), median_ms(plain, runs=5)
                # 9 taps x C x N MACs per pixel; x, w, bias, the mode's extra (and
                # #6's f32 a, s) read once, y written once
                item = 2 if dt == "bfloat16" else 4
                extra_n = {"none": 0, "temb": B * N, "residual": B * H * H * N}[mode]
                nbytes = item * (B * H * H * C + 9 * C * N + N + extra_n + B * H * H * N)
                nbytes += 8 * B * C if name == "fused_conv3x3" else 0
                flops = 2 * 9 * B * H * H * C * N
                if dt == "bfloat16":
                    entry["bound_ms"], entry["bound_by"] = bound(flops, nbytes, dt)
                else:  # the lesser of the FMA and the 3xTF32 bound
                    entry.update(f32_bounds(flops, nbytes))
                entry["library_ms"] = library[name]
                entry["cudnn_conv_ms"] = cudnn_ms
                parts.append(f"{name} err {err:.3g} {shown} {entry['ms']:.4f} / "
                             f"{entry['plain_ms']:.4f} ms"
                             + (f" (library {library[name]:.4f})" if library[name] else "")
                             + ("" if dt == "bfloat16" else
                                f" (bounds: FMA {entry['fma_bound_ms']:.4f}, 3xTF32 "
                                f"{entry['tf32x3_bound_ms']:.4f})"))
            elif want == "generic":
                parts.append(f"{name} err {err:.3g} {shown}")
            else:
                tally = untimed.setdefault(B, [0, 0, 0.0])
                tally[1] += 1
                tally[2] = max(tally[2], ulps)
            results[name].append(entry)
        if timed:
            split_part = ""
            if dtype == torch.float32:
                sr = results["tf32_split"][-1]
                split_part = (f"; tf32_split of the weight bit-equal, {sr['ms']:.4f} / "
                              f"{sr['plain_ms']:.4f} ms, {sr['graph_ms']:.4f} ms a call in a "
                              f"CUDA graph (bound {sr['bound_ms']:.4f})")
            say("conv", f"({B}, {H}, {H}, {C})->{N} {mode} {dt} [{want}]: " + "; ".join(parts)
                + f"; cuDNN {dt} conv + bias {cudnn_ms:.4f} ms"
                + (" (TF32 off)" if dt == "float32" else "") + split_part
                + " (kernel / plain, median; library: conv + bias + extra for #7, with "
                "silu(x a + s) before it for #6)")
        elif want == "generic":
            say("conv", f"({B}, {H}, {H}, {C})->{N} {mode} {dt} [{want}]: " + "; ".join(parts))
        else:
            untimed[B][0] += 1
        del x, a, s, w, b, extra, calls
        torch.cuda.empty_cache()
    for B, (n_cases, n_calls, worst) in untimed.items():
        say("conv", f"batch {B} (training): {n_cases} UNet conv shapes, {n_calls} kernel calls "
            f"held to their plain versions, worst {worst:.2f} bf16 ulps (tol {CONV_ULPS})")
    return results


def phase_group_norm_kernel():
    """Kernel #8 against fused_group_norm_ref at the UNet's GroupNorm shapes
    (batch 16, bf16), with and without SiLU, and one f32 shape. Both fold a
    and b from f32 sums taken in other orders, so one of them may round the
    other way: held to 4 bf16 ulps at the largest magnitude (f32: 1e-5).
    Each call must count one launch. F.group_norm (+ F.silu) on the same
    inputs is timed beside it, each time the mean of 20 calls back to back
    (a call's device time is shorter than its wrapper's host time), and the
    kernel's time is printed as a share of its byte bound (x read once, y
    written once)."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import group_norm as tg

    gen = torch.Generator(device="cuda").manual_seed(10)
    results = []
    for (L, C, silu, eps), dt in [(c, "bfloat16") for c in GN_SHAPES] + [
            ((4096, 320, True, 1e-5), "float32")]:
        dtype = getattr(torch, dt)
        x = (torch.randn((16, L, C), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        gamma = 1.0 + 0.2 * torch.randn(C, generator=gen, device="cuda")
        beta = 0.3 * torch.randn(C, generator=gen, device="cuda")
        launches = tg.fused_group_norm.launches
        out = tg.fused_group_norm(x, gamma, beta, 32, eps, silu)
        if tg.fused_group_norm.launches != launches + 1:
            raise AssertionError("fused_group_norm did not count one launch for one call")
        ref = tg.fused_group_norm_ref(x, gamma, beta, 32, eps, silu)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_tolerance(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
        # 20 calls back to back a sample: a call is tens of microseconds of
        # device time, less than the wrapper's host time alone
        ms = median_ms(lambda: tg.fused_group_norm(x, gamma, beta, 32, eps, silu), reps=20)
        plain_ms = median_ms(lambda: tg.fused_group_norm_ref(x, gamma, beta, 32, eps, silu),
                             reps=20)
        # the library's GroupNorm on the channels-first view of x (+ SiLU)
        xc, gc_, bc = x.transpose(1, 2), gamma.to(dtype), beta.to(dtype)

        def library():
            y = F.group_norm(xc, 32, gc_, bc, eps)
            return F.silu(y) if silu else y

        library_ms = median_ms(library, reps=20)
        item = 2 if dt == "bfloat16" else 4
        bound_ms, bound_by = bound(8 * 16 * L * C, 2 * item * 16 * L * C + 8 * C, "float32")
        say("gn", f"(16, {L}, {C}) silu={silu} eps={eps} {dt}: max|err| {err:.3g} (tol {tol:.3g}); "
            f"median kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.group_norm"
            f"{' + SiLU' if silu else ''} {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}; the kernel at {bound_ms / ms:.1%} of it)")
        if not err <= tol:
            raise AssertionError(f"fused_group_norm disagrees with its plain version at {(L, C)}")
        results.append({"shape": (16, L, C), "silu": silu, "dtype": dt, "err": err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
        del x, out, ref
    return results


def phase_flash_kernel():
    """Kernel #4 against flash_attention_ref (the TPU kernel's schedule: 128-key
    blocks, unnormalised p rounded to v's dtype) at FLASH_SHAPES: bf16 held to
    4 bf16 ulps at the output's largest magnitude (both round p and o at the
    same points; sums in other orders and the fast exp may flip a rounding),
    f32 to F32_TOL; every call must launch once, on the plan of its (dtype,
    d) (`fwd_plan`: bf16 "sm90", f32 d = 128 / 256 "tf32", d = 512 "d512");
    each timed (median of 5) beside its bound (f32: 3xTF32 and FMA, the lesser
    the row's), and at FLASH_SDPA_SHAPES beside its plain version and SDPA in
    its dtype too. The plain
    version walks K in blocks, so it holds no L x L logits and runs at every
    head count. Then at FLUX_SERVE_SHAPES, on head
    views of (B, L, H*d) buffers as the FLUX path passes them: #4 and #1
    (which takes these shapes too) held to their plain versions within the
    same 4 ulps, then #4, its plain version, #1 and SDPA timed on the same
    inputs, with the bound. Returns (checks, timings)."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(14)
    checks = []
    for shape, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        plan = fa.fwd_plan(dtype, shape[3])
        plans = dict(fa.flash_attention.launches_by_plan)
        out = fa.flash_attention(q, k, v)
        plans = {p: n - plans[p] for p, n in fa.flash_attention.launches_by_plan.items()}
        ref = fa.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        if dtype == torch.bfloat16:
            tol, shown = bf16_tolerance(ref_max), f"{err / bf16_ulp(ref_max):.2f} bf16 ulps at max"
        else:
            tol, shown = F32_TOL, "f32"
        ms = median_ms(lambda: fa.flash_attention(q, k, v), runs=5)
        row = {"shape": shape, "dtype": dt, "plan": plan, "err": err, "ms": ms,
               **attention_bounds(shape, dt)}
        if shape in FLASH_SDPA_SHAPES:
            row["plain_ms"] = median_ms(lambda: fa.flash_attention_ref(q, k, v), runs=3)
            row["library_ms"] = median_ms(lambda: F.scaled_dot_product_attention(q, k, v), runs=3)
        say("flash", f"{shape} {dt} ({plan} plan, launches {plans}): max|err| vs plain {err:.3g} "
            f"({shown}; tol {tol:.3g}), max|ref| {ref_max:.3g}; median #4 {ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
            + (f" (3xTF32 {row['tf32x3_bound_ms']:.4f}, FMA {row['fma_bound_ms']:.4f})"
               if dt == "float32" else "")
            + (f"; plain {row['plain_ms']:.4f} ms, SDPA ({dt}) {row['library_ms']:.4f} ms"
               if "plain_ms" in row else ""))
        if plans != {p: 1 if p == plan else 0 for p in plans}:
            raise AssertionError(f"flash_attention at {shape} {dt} did not launch once on its "
                                 f"{plan} plan: {plans}")
        if not (err <= tol and out.shape == ref.shape and out.dtype == dtype):
            raise AssertionError(f"flash_attention disagrees with its plain version at {shape} "
                                 f"{dt}")
        checks.append(row)
        del q, k, v, out, ref
        torch.cuda.empty_cache()

    timings = []
    for shape in FLUX_SERVE_SHAPES:
        # head views of (B, L, H*d) projections, as `multihead_attention` passes them
        B, H, L, d = shape
        q, k, v = (torch.randn((B, L, H * d), generator=gen, device="cuda").bfloat16()
                   .view(B, L, H, d).permute(0, 2, 1, 3) for _ in range(3))
        out, ref = fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v)
        ref_max = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        # #1 against sd_attention_ref a row and 4 heads at a time (its f32
        # logits over all heads would be 16 GB at 1024 px, 27 GB a row at 2048)
        sd_out = sa.sd_attention(q, k, v)
        sd_err = sd_max = 0.0
        for b in range(B):
            for h in range(0, H, 4):
                part = (slice(b, b + 1), slice(h, h + 4))
                sd_ref = sa.sd_attention_ref(q[part], k[part], v[part]).float()
                sd_max = max(sd_max, sd_ref.abs().max().item())
                sd_err = max(sd_err, (sd_out[part].float() - sd_ref).abs().max().item())
                del sd_ref
        tol, sd_tol = bf16_tolerance(ref_max), bf16_tolerance(sd_max)
        say("flash", f"{shape} bf16 head views of (B, L, {H * d}) (FLUX serving): #4 max|err| "
            f"vs plain {err:.3g} ({err / bf16_ulp(ref_max):.2f} bf16 ulps at max; tol {tol:.3g}), "
            f"#1 vs its plain version {sd_err:.3g} ({sd_err / bf16_ulp(sd_max):.2f} ulps; tol "
            f"{sd_tol:.3g})")
        if not (err <= tol and out.shape == ref.shape and sd_err <= sd_tol):
            raise AssertionError(f"#4 or #1 disagrees with its plain version at FLUX's {shape}")
        checks.append({"shape": shape, "dtype": "bfloat16", "err": err, "sd_err": sd_err})
        del out, ref, sd_out
        row = {"shape": shape, "dtype": "bfloat16",
               "ms": median_ms(lambda: fa.flash_attention(q, k, v)),
               "sd_ms": median_ms(lambda: sa.sd_attention(q, k, v)),
               "library_ms": median_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               "plain_ms": median_ms(lambda: fa.flash_attention_ref(q, k, v), runs=3)}
        row["bound_ms"], row["bound_by"] = attention_bound(shape, "bfloat16")
        tflops = 4 * math.prod(shape) * shape[2] / row["ms"] / 1e9
        say("flash", f"{shape} bf16 (FLUX serving): median #4 {row['ms']:.4f} ms ({tflops:.1f} "
            f"TFLOP/s), #1 {row['sd_ms']:.4f}, SDPA {row['library_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        timings.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return checks, timings


def phase_flash_bwd_kernel():
    """Kernel #4's backward (the dk/dv kernel, then the dq kernel, from the
    residual forward's o, m, l and di = rowsum(o * do)) against
    flash_attention_bwd_ref at FLASH_BWD_SHAPES, on head views of (B, L,
    H*d) buffers as the FLUX grad pass passes them. Both round p and ds to
    the input dtype at the same points and sum in other orders with another
    exp: bf16 is held to 4 ulps at each output's largest magnitude, f32 to
    1e-5 of it; every error is printed in bf16 ulps at that magnitude. The
    residuals m and l are held to the plain forward's within 1e-5 relative.
    The whole backward is timed (median of 5) beside its plain version, the
    backward of SDPA on the same inputs and the bound (10 B H L^2 d
    operations; this schedule does 14; f32 both bounds, 3xTF32 and FMA).
    Both kernels must launch on the plan of (dtype, d) (`bwd_plan`: f32 at
    d = 128 the TF32 plan)."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(16)
    results = []
    for shape, dt in FLASH_BWD_SHAPES:
        dtype = getattr(torch, dt)
        B, H, L, d = shape
        q, k, v, g = (torch.randn((B, L, H * d), generator=gen, device="cuda").to(dtype)
                      .view(B, L, H, d).permute(0, 2, 1, 3) for _ in range(4))
        o, m, l = fa._forward(q, k, v, residuals=True)
        plans = dict(fa.flash_attention_bwd.launches_by_plan)
        out = fa.flash_attention_bwd(q, k, v, o, g, m, l)
        plan = fa.bwd_plan(dtype, d)
        plans = {p: n - plans[p] for p, n in fa.flash_attention_bwd.launches_by_plan.items()}
        _, rm, rl = fa.flash_attention_fwd_ref(q, k, v)
        ref = fa.flash_attention_bwd_ref(q, k, v, o, g, m, l)
        torch.cuda.synchronize()
        stat_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in ((m, rm), (l, rl)))
        # both kernels on the plan of (dtype, d): f32 at d = 128 the TF32 plan
        errs, ulps, worst = [], [], 0.0
        ok = stat_err <= 1e-5 and plans == {p: 2 if p == plan else 0 for p in plans}
        for name, a, r in zip(("dq", "dk", "dv"), out, ref):
            ref_max = r.float().abs().max().item()
            err = (a.float() - r.float()).abs().max().item()
            tol = 4 * bf16_ulp(ref_max) if dtype == torch.bfloat16 else 1e-5 * max(1.0, ref_max)
            ulps.append(err / bf16_ulp(ref_max))
            errs.append(f"{name} {err:.3g} ({ulps[-1]:.2f} bf16 ulps at max|ref| {ref_max:.3g}; "
                        f"tol {tol:.3g})")
            ok = ok and err <= tol and a.dtype == dtype and a.shape == r.shape
            worst = max(worst, err)
        del out, ref, rm, rl
        ms = median_ms(lambda: fa.flash_attention_bwd(q, k, v, o, g, m, l), runs=5)
        plain_ms = median_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, g, m, l), runs=3)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*leaves)
        library_ms = median_ms(lambda: torch.autograd.grad(so, leaves, g, retain_graph=True),
                               runs=5)
        bounds = attention_bounds(shape, dt, backward=True)
        say("flash", f"bwd {shape} {dt} head views ({plan} plan, launches {plans}): m, l max rel "
            f"err {stat_err:.3g} (tol 1e-5); max|err| vs plain {', '.join(errs)}; median #4 "
            f"backward {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward ({dt}) "
            f"{library_ms:.4f} ms; bound {bounds['bound_ms']:.4f} ms ({bounds['bound_by']})"
            + (f"; bounds 3xTF32 {bounds['tf32x3_bound_ms']:.4f}, FMA "
               f"{bounds['fma_bound_ms']:.4f} ms" if dt == "float32" else ""))
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version (or left "
                                 f"its plan) at {shape} {dt}")
        results.append({"shape": shape, "dtype": dt, "plan": plan, "err": worst,
                        "err_ulps": max(ulps), "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, **bounds})
        del q, k, v, g, o, m, l, leaves, so
        torch.cuda.empty_cache()
    return results


def tiny_slice(device: str, trees: dict, clip_cfg, latents, tok):
    """Tiny SD at 256 px (L=1024 at level 0, so the routed path) in f32,
    3 DDIM steps with a slider at scales [-1, 0, 1]; returns the latents."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    m = {k: tree_to(v, device) for k, v in trees.items()}
    cond = encode_prompts(tok, m["clip"], clip_cfg, ["a photo of a person"])
    uncond = encode_prompts(tok, m["clip"], clip_cfg, [""])
    fn = t2i.make_sampling_fn(unet2d.TINY, make_sampler(make_schedule(), "ddim", 3),
                              compute_dtype=torch.float32)
    n = latents.shape[0]
    return fn(m["unet"], latents.to(device), cond.expand(n, -1, -1), uncond.expand(n, -1, -1),
              m["slider"], torch.tensor([-1.0, 0.0, 1.0]), torch.full((n,), 750.0),
              torch.full((n,), 7.5)).cpu()


def phase_tiny_slice(tok_dir: str):
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    gen = torch.Generator().manual_seed(1)
    tok = ClipTokenizer.from_pretrained(tok_dir)
    clip_cfg = clip_text.ClipTextConfig(
        vocab_size=len(tok.vocab), hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_positions=16, eos_token_id=tok.eos_token_id,
    )
    tok.model_max_length = clip_cfg.max_positions
    unet = unet2d.init_params(gen, unet2d.TINY)
    slider = create_slider_network(gen, unet, rank=4, train_method="noxattn")
    for e in slider.values():
        e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.1
    trees = {"unet": unet, "clip": clip_text.init_params(gen, clip_cfg), "slider": slider}
    latents = torch.randn((3, 32, 32, 4), generator=gen)
    before = sa.sd_attention.launches
    gpu = tiny_slice("cuda", trees, clip_cfg, latents, tok)
    launched = sa.sd_attention.launches - before
    cpu = tiny_slice("cpu", trees, clip_cfg, latents, tok)
    err = (gpu - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    say("kernel", f"tiny slice 256 px f32, GPU (kernel, {launched} launches) vs CPU (plain): "
        f"max|err| {err:.3g}, max|latent| {scale:.3g}")
    if launched == 0 or not torch.isfinite(gpu).all() or err > 1e-3 * max(1.0, scale):
        raise AssertionError("the tiny slice on the GPU disagrees with the CPU")


TINY_LR = 1e-4


def tiny_train(device: str, unet: dict, lora: dict, pairs: dict, draws: list, cfg=None,
               px: int = 256, lr: float = TINY_LR, dtype=None):
    """A tiny UNet (TINY unless `cfg`) at `px` (256: L=1024 at level 0, so
    the routed attention path) in f32 (or the compute `dtype`, on the f32
    weights) with remat: len(draws) train steps with the given draws (an
    SDXL step for a text_time `cfg`); returns the losses, the grad norms and
    the final LoRA on the CPU."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.lora.network import trainable_mask
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.training import optimizers, text_slider

    sched = make_schedule()
    cfg = cfg or unet2d.TINY
    tx = optimizers.make_optimizer("adamw", optimizers.make_lr_schedule("constant", lr, 100),
                                   trainable_mask=trainable_mask(lora))
    step = text_slider.make_text_slider_step(
        cfg, sched, make_sampler(sched, "ddim", 5), tx, max_denoising_steps=5,
        resolution=px, compute_dtype=dtype or torch.float32, remat=True,
        is_xl=cfg.addition_embed_type is not None)
    # a copy: the update is in place, and tree_to keeps a CPU tensor as it is
    lora = {m: {k: t.to(device, copy=True) for k, t in e.items()} for m, e in lora.items()}
    state = text_slider.SliderTrainState.create(0, lora, tx)
    params = tree_to(unet, device)
    on_device = {k: v.to(device) for k, v in pairs.items()}
    losses, norms = [], []
    for d in draws:
        state, m = step(state, params, on_device, draws=d)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    return losses, norms, {m: {k: t.cpu() for k, t in e.items()} for m, e in state.lora.items()}


def phase_tiny_train(conv_impl: str = "xla"):
    """Three tiny train steps on the GPU (the kernels, remat) against the
    CPU (plain paths) with the same draws, in f32 with TF32 off. The two
    differ only by f32 sums in other orders, so each step's loss is held to
    1e-5 relative, its grad norm to 1e-4 relative (a wrong gradient path, say
    swapped dk/dv or a LoRA factor with no gradient, moves it far more), and
    the LoRA after the last update to 1e-6 absolute (Adam moves an element
    about lr = 1e-4 a step, so a sign flip of a gradient shows).

    Under conv impl 'fused' the UNet is TINY with 128 channels, so that its
    resnets pass the conv gates at 32x32 and 16x16 (8 blocks, 16 kernel #6
    calls a forward); the GPU run's launches must be that per forward times
    sum(t_to + 2), every one on the Hopper mainloop's f32 (3xTF32) path after
    its weight's split."""
    import dataclasses

    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import conv3x3 as tc
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.training.text_slider import step_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused = conv_impl == "fused"
    cfg = dataclasses.replace(unet2d.TINY, block_out_channels=(128, 128)) if fused else unet2d.TINY
    gen = torch.Generator().manual_seed(6)
    unet = unet2d.init_params(gen, cfg)
    lora = create_slider_network(gen, unet, rank=4, train_method="noxattn")
    pairs = {k: torch.randn((1, 8, 32), generator=gen)
             for k in ("target", "positive", "neutral", "unconditional")}
    pairs["guidance_signed"] = torch.tensor([2.0])
    draws = [step_draws(6, i, 1, 5, (1, 32, 32, 4), 1.0) for i in range(3)]
    basic.set_conv_impl(conv_impl)
    try:
        sa.sd_attention.launches = sa.sd_attention_bwd.launches = 0
        reset_conv_launches()
        gpu_losses, gpu_norms, gpu_lora = tiny_train("cuda", unet, lora, pairs, draws, cfg)
        fwd, bwd, conv = (sa.sd_attention.launches, sa.sd_attention_bwd.launches,
                          tc.fused_conv3x3.launches)
        variants, splits = conv_variants(), tc.tf32_split.launches
        cpu_losses, cpu_norms, cpu_lora = tiny_train("cpu", unet, lora, pairs, draws, cfg)
    finally:
        basic.set_conv_impl("xla")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_norms, cpu_norms))
    lora_err = max((gpu_lora[m][k] - cpu_lora[m][k]).abs().max().item()
                   for m in cpu_lora for k in ("down", "up"))
    conv_expected = 16 * sum(d[1] + 2 for d in draws) if fused else 0
    say("kernel", f"tiny training 256 px f32, conv impl {conv_impl!r}, 3 steps (t_to "
        f"{[d[1] for d in draws]}), GPU (kernels: {fwd} forward, {bwd} backward attention, "
        f"{conv} fused conv launches, expected {conv_expected}, by variant {variants}, "
        f"{splits} weight splits) vs CPU (plain): losses "
        f"{[f'{x:.6g}' for x in gpu_losses]} vs {[f'{x:.6g}' for x in cpu_losses]}, max rel err "
        f"{loss_err:.3g} (tol 1e-5); grad norms {[f'{x:.6g}' for x in gpu_norms]} vs "
        f"{[f'{x:.6g}' for x in cpu_norms]}, max rel err {norm_err:.3g} (tol 1e-4); LoRA "
        f"max|err| {lora_err:.3g} (tol 1e-6)")
    if fwd == 0 or bwd == 0 or conv != conv_expected or splits != conv_expected or (
            variants != ({"hopper": conv} if conv else {})):
        raise AssertionError("tiny training on the GPU did not go through the kernels")
    if not (loss_err <= 1e-5 and norm_err <= 1e-4 and lora_err <= 1e-6):
        raise AssertionError("tiny training on the GPU disagrees with the CPU")
    return conv


@contextlib.contextmanager
def unet_input_dtypes():
    """The dtype of x at every `models.unet2d.apply` call inside the block
    (the training steps call it through the module)."""
    from sliders_tpu_torch.models import unet2d

    seen, apply = [], unet2d.apply

    def spy(params, cfg, x, *args, **kwargs):
        seen.append(x.dtype)
        return apply(params, cfg, x, *args, **kwargs)

    unet2d.apply = spy
    try:
        yield seen
    finally:
        unet2d.apply = apply


@contextlib.contextmanager
def f16_sum_flags():
    """cuBLAS's `allow_fp16_reduced_precision_reduction` at every
    `models.unet2d.apply` call inside the block (the fp16 text and fleet
    steps turn it off: f16 GEMMs sum in f32, as the JAX package's do)."""
    import torch

    from sliders_tpu_torch.models import unet2d

    seen, apply = [], unet2d.apply

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)
        return apply(*args, **kwargs)

    unet2d.apply = spy
    try:
        yield seen
    finally:
        unet2d.apply = apply


@contextlib.contextmanager
def cpu_attention_bwd_at_kernel_points():
    """Inside the block, `SdAttention`'s backward on CPU tensors is
    `sd_attention_bwd_ref` (#2's plain version: its rounding points) in place
    of autograd through the plain forward (the XLA VJP's points, as the JAX
    package differentiates off the TPU), so that a CPU run holds #2 to its
    own plain version."""
    from sliders_tpu_torch.ops import sd_attention as sa

    backward = sa.SdAttention.__dict__["backward"]

    def at_kernel_points(ctx, g):
        q, k, v = ctx.saved_tensors
        if q.device.type != "cpu":
            raise AssertionError("cpu_attention_bwd_at_kernel_points is for CPU runs")
        return sa.sd_attention_bwd_ref(q, k, v, g)

    sa.SdAttention.backward = staticmethod(at_kernel_points)
    try:
        yield
    finally:
        sa.SdAttention.backward = backward


def lora_within_adamw(a: dict, b: dict, steps: int, lr: float) -> tuple:
    """(largest |a - b| over the LoRA factors, share within lr / 10) and
    whether each element is within 2 lr a step (AdamW's first steps move an
    element about lr whatever its gradient's size, so an f16 gradient within
    its rounding of zero may step the other way) and FP16_LORA_SHARE of
    them within lr / 10."""
    import torch

    d = torch.cat([(a[m][k] - b[m][k]).abs().flatten() for m in b for k in ("down", "up")])
    worst, share = d.max().item(), (d <= lr / 10).float().mean().item()
    return worst, share, worst <= 2 * lr * steps * 1.01 and share >= FP16_LORA_SHARE


def phase_tiny_train_fp16() -> dict:
    """`precision: fp16` on a tiny UNet (TINY widened to FP16_TINY: head dim
    40, so #1 and #2 take f16 instantiations at level 0's L = 1024 at 256
    px, and level 1's convs pass the conv gates): FP16_TINY_ITERATIONS
    text steps in f16 on f32 weights on the GPU (the kernels) against the
    CPU (plain paths, the attention backward at #2's rounding points:
    `cpu_attention_bwd_at_kernel_points`) on the same draws. Both run the
    text step as the loop runs it (f16 GEMMs summing in f32); each sums in
    its own order, so losses are held to FP16_RTOL relative, grad norms to
    FP16_GRAD_RTOL and the LoRA by `lora_within_adamw`; every UNet call of
    both runs takes f16 input. Then the same steps on the GPU under conv
    impls 'auto', 'fused_ep' and 'fused': the f16 conv kernels #5, #7 and
    #6 on the Hopper mainloop, each run's launches the per-forward count of
    a probe forward (no grad) times sum(t_to + 2), its losses within
    FUSED_LOSS_RTOL of the default run's. Returns the launches by kernel and run."""
    import dataclasses

    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import conv3x3 as tc
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.training.text_slider import step_draws

    cfg = dataclasses.replace(unet2d.TINY, **FP16_TINY)
    gen = torch.Generator().manual_seed(7)
    unet = unet2d.init_params(gen, cfg)
    lora = create_slider_network(gen, unet, rank=4, train_method="noxattn")
    pairs = {k: torch.randn((1, 8, 32), generator=gen)
             for k in ("target", "positive", "neutral", "unconditional")}
    pairs["guidance_signed"] = torch.tensor([2.0])
    draws = [step_draws(7, i, 1, 5, (1, 32, 32, 4), 1.0) for i in range(FP16_TINY_ITERATIONS)]
    calls = sum(d[1] + 2 for d in draws)  # UNet forwards of the run
    half = torch.float16
    sa.sd_attention.launches = sa.sd_attention_bwd.launches = 0
    t0 = time.perf_counter()
    with unet_input_dtypes() as gpu_in, f16_sum_flags() as sums:
        gpu = tiny_train("cuda", unet, lora, pairs, draws, cfg, dtype=half)
    gpu_s = time.perf_counter() - t0
    fwd, bwd = sa.sd_attention.launches, sa.sd_attention_bwd.launches
    t0 = time.perf_counter()
    with unet_input_dtypes() as cpu_in, cpu_attention_bwd_at_kernel_points():
        cpu = tiny_train("cpu", unet, lora, pairs, draws, cfg, dtype=half)
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu[0], cpu[0]))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(gpu[1], cpu[1]))
    worst, share, lora_ok = lora_within_adamw(gpu[2], cpu[2], len(draws), TINY_LR)
    # #1's routed calls per forward, from one probe forward on the card
    params = tree_to(unet, "cuda")
    x = torch.randn((1, 32, 32, 4), device="cuda").half()
    ehs = pairs["target"].to("cuda", half)
    t = torch.tensor(500.0, device="cuda")

    def probe():
        with torch.no_grad():
            return unet2d.apply(params, cfg, x, t, ehs)

    sa.sd_attention.launches = 0
    probe()
    routed = sa.sd_attention.launches
    say("fp16", f"tiny fp16 256 px (TINY at {FP16_TINY}, head dim 40), {len(draws)} steps (t_to "
        f"{[d[1] for d in draws]}) in f16 on f32 weights, GPU (#1 {fwd}, #2 {bwd} f16 launches; "
        f"{routed} a forward) vs CPU (plain): losses {[f'{v:.6g}' for v in gpu[0]]} vs "
        f"{[f'{v:.6g}' for v in cpu[0]]} (max rel {loss_err:.3g}, tol {FP16_RTOL}); grad norms "
        f"max rel {norm_err:.3g} (tol {FP16_GRAD_RTOL}); LoRA max|diff| {worst:.3g} (tol "
        f"{2 * TINY_LR * len(draws):.3g}), {share:.4f} of it within lr / 10 (tol "
        f"{FP16_LORA_SHARE}); UNet inputs {sorted({str(d) for d in gpu_in + cpu_in})}; "
        f"{gpu_s:.1f} s on the card, {cpu_s:.1f} s on the CPU")
    if not (fwd == routed * (calls + len(draws)) and bwd == routed * len(draws) and routed > 0):
        raise AssertionError("tiny fp16 training did not take #1 and #2 on every routed call")
    if set(gpu_in) != {half} or set(cpu_in) != {half} or len(gpu_in) != calls:
        raise AssertionError("a tiny fp16 UNet call did not compute in f16")
    if set(sums) != {False}:
        raise AssertionError("a tiny fp16 UNet call let cuBLAS sum f16 GEMMs in f16")
    if not (loss_err <= FP16_RTOL and norm_err <= FP16_GRAD_RTOL and lora_ok):
        raise AssertionError("tiny fp16 training on the GPU disagrees with the CPU")
    out = {"sd": fwd, "sd_bwd": bwd}
    for impl, name in (("auto", "conv3x3"), ("fused_ep", "epi_conv3x3"),
                       ("fused", "fused_conv3x3")):
        basic.set_conv_impl(impl)
        try:
            reset_conv_launches()
            probe()
            per_forward = getattr(tc, name).launches
            reset_conv_launches()
            t0 = time.perf_counter()
            losses = tiny_train("cuda", unet, lora, pairs, draws, cfg, dtype=half)[0]
            run_s = time.perf_counter() - t0
            got = dict(conv_launches())
            variants = conv_variants()
        finally:
            basic.set_conv_impl("xla")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, gpu[0]))
        say("fp16", f"tiny fp16 under conv impl {impl!r}: {name} f16 launches {got} ({per_forward} "
            f"a forward x {calls} forwards), by variant {variants}; losses "
            f"{[f'{v:.6g}' for v in losses]} (max rel {rel:.3g} from 'xla', tol "
            f"{FUSED_LOSS_RTOL}); {run_s:.1f} s")
        if per_forward == 0 or got != {name: per_forward * calls} or (
                variants != {"hopper": per_forward * calls}) or rel > FUSED_LOSS_RTOL:
            raise AssertionError(f"tiny fp16 under {impl!r} did not take the f16 {name} kernel "
                                 "on every routed conv, or its losses moved")
        out[name] = got[name]
    return out


def write_tokenizer(d: str, size: int = 0) -> None:
    """A small synthetic CLIP BPE vocabulary (no tokenizer files ship with
    random weights); any token id it yields is valid for CLIP-L. With
    `size`, padded with unused entries to `size` ids, as a real vocabulary
    fills its encoder's embedding matrix (a token added to it then grows
    the matrix)."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789!,.")
    vocab = {}
    for c in chars:
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    merges = [("o", "l"), ("ol", "d</w>"), ("p", "e"), ("pe", "r"), ("s", "o")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    for i in range(size - len(vocab)):
        vocab[f"<|unused{i}|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))


def write_t5_tokenizer(d: str) -> None:
    """A WordLevel + Whitespace T5 tokenizer.json (the layout the `tokenizers`
    library saves) with <pad> 0 and </s> 1; any id it yields is valid for
    T5-XXL."""
    words = ["<pad>", "</s>", "<unk>", "a", "photo", "of", "person", "very", "old", "young",
             "smiling"]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": {w: i for i, w in enumerate(words)},
                      "unk_token": "<unk>"}}
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"pad_token": "<pad>", "eos_token": "</s>", "model_max_length": 512}, f)


def clip_hf_config(cfg, eos: int) -> dict:
    """The transformers text_encoder/config.json of a ClipTextConfig."""
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_positions, "hidden_act": cfg.hidden_act,
            "eos_token_id": eos,
            **({"projection_dim": cfg.projection_dim} if cfg.projection_dim else {})}


def write_tiny_flux_snapshot(root: str) -> None:
    """A diffusers-layout FLUX snapshot with seeded random f32 weights: the
    TINY transformer (2 heads, 2 + 2 blocks) at FLUX's head dim 128, a tiny
    CLIP (the synthetic BPE tokenizer) and T5 (a WordLevel tokenizer_2), and
    TINY_FLUX's VAE with 128 mid-block channels, so that its single-head mid
    attention (d = 128, L = 160**2 at 1280 px) takes kernel #4 as well and no
    plain L x L score matrix is formed (TINY_FLUX's d = 32 would make it 5.4
    GB a row)."""
    import dataclasses

    import torch

    from sliders_tpu_torch.models import clip_text, flux, t5, vae
    from sliders_tpu_torch.models.convert import write_safetensors
    from sliders_tpu_torch.utils.pytree import flatten

    gen = torch.Generator().manual_seed(12)
    fcfg = dataclasses.replace(flux.TINY, attention_head_dim=128, axes_dims_rope=(16, 56, 56))
    os.makedirs(os.path.join(root, "tokenizer"))
    write_tokenizer(os.path.join(root, "tokenizer"))
    write_t5_tokenizer(os.path.join(root, "tokenizer_2"))
    with open(os.path.join(root, "tokenizer", "vocab.json")) as f:
        vocab = json.load(f)
    ccfg = clip_text.ClipTextConfig(
        vocab_size=len(vocab), hidden_size=fcfg.pooled_projection_dim, num_layers=2, num_heads=2,
        intermediate_size=2 * fcfg.pooled_projection_dim, max_positions=16,
        eos_token_id=vocab["<|endoftext|>"])
    tcfg = t5.T5Config(vocab_size=32, d_model=fcfg.joint_attention_dim, d_kv=8, d_ff=64,
                       num_layers=2, num_heads=2)
    vcfg = dataclasses.replace(vae.TINY_FLUX, block_out_channels=(32, 128))
    components = {
        "transformer": (flux.init_params(gen, fcfg), {
            "in_channels": fcfg.in_channels, "num_layers": fcfg.num_layers,
            "num_single_layers": fcfg.num_single_layers,
            "attention_head_dim": fcfg.attention_head_dim,
            "num_attention_heads": fcfg.num_attention_heads,
            "joint_attention_dim": fcfg.joint_attention_dim,
            "pooled_projection_dim": fcfg.pooled_projection_dim,
            "guidance_embeds": fcfg.guidance_embeds, "axes_dims_rope": list(fcfg.axes_dims_rope)}),
        "text_encoder": (clip_text.init_params(gen, ccfg), clip_hf_config(ccfg, ccfg.eos_token_id)),
        "text_encoder_2": (t5.init_params(gen, tcfg), {
            "vocab_size": tcfg.vocab_size, "d_model": tcfg.d_model, "d_kv": tcfg.d_kv,
            "d_ff": tcfg.d_ff, "num_layers": tcfg.num_layers, "num_heads": tcfg.num_heads}),
        "vae": (vae.init_params(gen, vcfg), vae_hf_config(vcfg)),
    }
    for sub, (params, config) in components.items():
        os.makedirs(os.path.join(root, sub))
        write_safetensors(os.path.join(root, sub, "model.safetensors"), flatten(params))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(config, f)


def tiny_flux_serve(snap: str, device: str, slider: dict) -> tuple:
    """The engine `cli/serve.py --flux` builds for the tiny snapshot at
    TINY_FLUX_PX in f32 on `device`, one request with the slider at scales
    [-1, 2]; returns (denoised packed latents on the CPU, PNG pixel bytes)."""
    from sliders_tpu_torch.cli import serve

    engine = serve.make_engine(serve.build_parser().parse_args([
        "--flux", "--base", snap, "--device", device, "--precision", "float32",
        "--ddim_steps", str(TINY_FLUX_STEPS), "--image_size", str(TINY_FLUX_PX),
        "--buckets", "1,2", "--no_warmup"]))
    denoised = []
    fn = engine.fn
    engine.fn = lambda *a: denoised.append(fn(*a)) or denoised[-1]
    try:
        engine.register_slider("s", slider)
        reply = engine.generate("a photo of a very old person", seed=3, slider="s",
                                scales=[-1.0, 2.0])
    finally:
        engine.close(timeout=60)
    return denoised[0].cpu(), [png_pixels(png)[2] for _, png in reply]


def phase_tiny_flux():
    """The tiny FLUX snapshot through load_flux -> FluxSliderEngine (built by
    `cli/serve.py --flux`) at TINY_FLUX_PX, f32, TF32 off, on the GPU (the
    kernels) and on the CPU (plain paths). The denoised latents are held to
    1e-3 of their largest magnitude (f32 sums in other orders through 4
    blocks and 2 steps; a wrong block moves them by O(1)), the images to one
    level of 255. #4 must launch 4 joint attentions x steps + 1 VAE mid
    attention times, all f32 at d = 128 on its "tf32" plan (the one-pass
    3xTF32 kernel); #1 never (T5 and CLIP are masked: plain path)."""
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models.loader import load_flux
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as snap:
        write_tiny_flux_snapshot(snap)
        gen = torch.Generator().manual_seed(15)
        slider = create_slider_network(gen, load_flux(snap, dtype=torch.float32).transformer_params,
                                       rank=4, train_method="xattn")
        for e in slider.values():
            e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.1
        fa.flash_attention.launches = sa.sd_attention.launches = 0
        fa.flash_attention.launches_by_plan = dict.fromkeys(fa.FWD_PLANS, 0)
        gpu, gpu_px = tiny_flux_serve(snap, "cuda", slider)
        flash, sd = fa.flash_attention.launches, sa.sd_attention.launches
        plans = dict(fa.flash_attention.launches_by_plan)
        t0 = time.perf_counter()
        cpu, cpu_px = tiny_flux_serve(snap, "cpu", slider)
        cpu_s = time.perf_counter() - t0
    err = (gpu - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    px_err = max(max(abs(a - b) for a, b in zip(g, c)) for g, c in zip(gpu_px, cpu_px))
    expected = 4 * TINY_FLUX_STEPS + 1
    say("kernel", f"tiny FLUX {TINY_FLUX_PX} px f32 via cli/serve.py --flux, {TINY_FLUX_STEPS} "
        f"steps, scales [-1, 2]: GPU (#4 {flash} launches, expected {expected}, by plan {plans}; "
        f"#1 {sd}) vs CPU "
        f"(plain, {cpu_s:.1f} s): latents max|err| {err:.3g} (tol {1e-3 * max(1.0, scale):.3g}, "
        f"max|latent| {scale:.3g}); images max level diff {px_err} (tol 1)")
    if flash != expected or sd != 0 or plans != {p: flash if p == "tf32" else 0 for p in plans}:
        raise AssertionError("the tiny FLUX slice did not take kernel #4's tf32 plan where the "
                             "gate routes it")
    if not torch.isfinite(gpu).all() or err > 1e-3 * max(1.0, scale) or px_err > 1:
        raise AssertionError("the tiny FLUX slice on the GPU disagrees with the CPU")
    if gpu_px[0] == gpu_px[1]:
        raise AssertionError("the tiny FLUX slider did nothing")
    return {"flash": flash, "fwd_plans": plans}


def tiny_flux_train(snap: str, device: str, lora: dict, tmp: str) -> tuple:
    """`cli/train_flux_slider.py` on the tiny snapshot at TINY_FLUX_PX in f32
    with remat on `device` (a CUDA ordinal or cpu), TINY_FLUX_TRAIN_ITERATIONS
    iterations from `lora`; returns the per-iteration metrics and the final
    LoRA on the CPU."""
    from sliders_tpu_torch.cli import train_flux_slider as cli

    prompts = os.path.join(tmp, "tiny_flux_prompts.yaml")
    with open(prompts, "w") as f:
        f.write(f"- target: person\n  positive: very old person\n  unconditional: young person\n"
                f"  neutral: person\n  action: enhance\n  guidance_scale: 2\n"
                f"  resolution: {TINY_FLUX_PX}\n  batch_size: 1\n")
    config = os.path.join(tmp, f"tiny_flux_train_{device}.yaml")
    with open(config, "w") as f:
        f.write(dump_yaml({
            "prompts_file": prompts, "pretrained_model": {"name_or_path": snap},
            "network": {"rank": 4, "alpha": 1.0, "training_method": "xattn"},
            "train": {"precision": "float32", "iterations": TINY_FLUX_TRAIN_ITERATIONS,
                      "lr": TINY_FLUX_LR, "max_denoising_steps": TINY_FLUX_TRAIN_STEPS},
            "save": {"name": "tiny", "path": os.path.join(tmp, f"out_{device}")},
            "logging": {"log_every": 1}, "tpu": {"remat": True}}) + "\n")
    records = []
    final = cli.main(cli.build_parser().parse_args(["--config_file", config, "--device", device]),
                     on_step=lambda i, state, m: records.append(m), lora=lora)
    return records, final


def flux_counts() -> dict:
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    return {"sd": sa.sd_attention.launches, "sd_bwd": sa.sd_attention_bwd.launches,
            "flash": fa.flash_attention.launches, "dkv": fa.flash_attention_bwd.dkv_launches,
            "dq": fa.flash_attention_bwd.dq_launches,
            "fwd_plans": dict(fa.flash_attention.launches_by_plan),
            "bwd_plans": dict(fa.flash_attention_bwd.launches_by_plan)}


def reset_flux_counts() -> None:
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    sa.sd_attention.launches = sa.sd_attention_bwd.launches = fa.flash_attention.launches = 0
    fa.flash_attention_bwd.dkv_launches = fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention.launches_by_plan = dict.fromkeys(fa.FWD_PLANS, 0)
    fa.flash_attention_bwd.launches_by_plan = dict.fromkeys(fa.BWD_PLANS, 0)


def phase_tiny_flux_train():
    """The tiny FLUX snapshot through the training CLI at TINY_FLUX_PX in f32
    (L = 512 + 80**2 = 6912: #4's route, forward and backward), TF32 off, on
    the GPU (the kernels) and on the CPU (plain versions), from one ortho-up
    xattn LoRA. f32 sums in other orders only: each iteration's loss is held
    to 1e-5 relative, its grad norm to 1e-4, the LoRA after the last update
    to 1e-6. Launches are exact: #4's forward 4 joint attentions x (t_to + 1
    frozen + 2 grad with remat) per iteration, every one on its "tf32" plan
    (the one-pass 3xTF32 kernel, whose residuals the backward reads), its
    dk/dv and dq kernels 4 each per iteration, every one on the backward's
    TF32 plan (3xTF32 `wgmma`), #1 and #2 never. The lr is TINY_FLUX_LR (see
    there)."""
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models.loader import load_flux

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "flux_tiny")
        write_tiny_flux_snapshot(snap)
        lora = create_slider_network(
            torch.Generator().manual_seed(17), load_flux(snap, dtype=torch.float32)
            .transformer_params, rank=4, alpha=1.0, train_method="xattn", ortho_up=True)
        reset_flux_counts()
        gpu, gpu_lora = tiny_flux_train(snap, "0", lora, tmp)
        counts = flux_counts()
        t0 = time.perf_counter()
        cpu, cpu_lora = tiny_flux_train(snap, "cpu", lora, tmp)
        cpu_s = time.perf_counter() - t0
    t_tos = [m["t_to"] for m in gpu]
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(gpu, cpu))
    norm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                   for a, b in zip(gpu, cpu))
    lora_err = max((gpu_lora[m][k] - cpu_lora[m][k]).abs().max().item()
                   for m in cpu_lora for k in ("down", "up"))
    fwd_expected = 4 * sum(t + 3 for t in t_tos)
    bwd_expected = 4 * TINY_FLUX_TRAIN_ITERATIONS
    say("kernel", f"tiny FLUX training {TINY_FLUX_PX} px f32 via cli/train_flux_slider.py, "
        f"{len(gpu)} iterations (t_to {t_tos}), GPU (#4 forward {counts['flash']} launches, "
        f"expected {fwd_expected}, by plan {counts['fwd_plans']}; dk/dv {counts['dkv']}, dq "
        f"{counts['dq']}, expected "
        f"{bwd_expected}, by plan {counts['bwd_plans']}; #1 {counts['sd']}, #2 "
        f"{counts['sd_bwd']}) vs CPU (plain, {cpu_s:.1f} s): "
        f"losses {[round(m['loss'], 9) for m in gpu]} vs {[round(m['loss'], 9) for m in cpu]}, max "
        f"rel err {loss_err:.3g} (tol 1e-5); grad norms max rel err {norm_err:.3g} (tol 1e-4); "
        f"LoRA max|err| {lora_err:.3g} (tol 1e-6)")
    if (counts["flash"] != fwd_expected or counts["dkv"] != bwd_expected
            or counts["dq"] != bwd_expected or counts["sd"] or counts["sd_bwd"]
            or counts["fwd_plans"] != {p: fwd_expected if p == "tf32" else 0
                                       for p in counts["fwd_plans"]}
            or counts["bwd_plans"] != {p: 2 * bwd_expected if p == "tf32" else 0
                                       for p in counts["bwd_plans"]}):
        raise AssertionError("tiny FLUX training on the GPU did not take #4's route exactly")
    if t_tos != [m["t_to"] for m in cpu] or not (
            loss_err <= 1e-5 and norm_err <= 1e-4 and lora_err <= 1e-6):
        raise AssertionError("tiny FLUX training on the GPU disagrees with the CPU")
    return {"flash": counts["flash"], "dkv": counts["dkv"], "dq": counts["dq"],
            "fwd_plans": counts["fwd_plans"], "bwd_plans": counts["bwd_plans"]}


def build_engine(tok_dir: str):
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d, vae
    from sliders_tpu_torch.models.loader import SDModels, TextEncoderBundle
    from sliders_tpu_torch.serving.server import SliderEngine
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    # the engine as served: cuDNN convs may use TF32, matmuls stay full f32;
    # both set explicitly (the f32 VAE decode sets its own,
    # text2image.decode_precision)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tok = ClipTokenizer.from_pretrained(tok_dir)
    tok.model_max_length = clip_text.CLIP_L.max_positions
    unet = unet2d.init_params(gen, unet2d.SD15, dtype=torch.bfloat16, device="cuda")
    models = SDModels(
        unet, unet2d.SD15,
        [TextEncoderBundle(tok, clip_text.init_params(gen, clip_text.CLIP_L, device="cuda"),
                           clip_text.CLIP_L)],
        vae_params=vae.init_params(gen, vae.SD_VAE, dtype=torch.bfloat16, device="cuda"),
        vae_config=vae.SD_VAE,
    )
    n_params = sum(t.numel() for t in _leaves(unet))
    engine = SliderEngine(models, device="cuda", steps=STEPS, image_size=512,
                          guidance_scale=7.5, start_noise=750.0, compute_dtype=torch.bfloat16)
    for name in ("s1", "s2"):
        w = create_slider_network(gen, unet, rank=4, alpha=1.0, train_method="noxattn",
                                  device="cuda")
        for e in w.values():  # nonzero up, so the scale changes the image
            e["up"] = torch.randn(e["up"].shape, generator=gen, device="cuda") * 0.05
        engine.register_slider(name, w)
    torch.cuda.synchronize()
    say("engine", f"SD1.5 UNet {n_params / 1e6:.1f} M params + CLIP-L + SD VAE on "
        f"{engine.device}, bf16, 512 px, DDIM {STEPS}, 2 rank-4 noxattn sliders "
        f"({len(w)} modules each): built in {time.perf_counter() - t0:.1f} s")
    return engine


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _kernel_class(name: str) -> str:
    n = name.lower()
    for key, cls in (("layout_pin", "layout pin kernel"),
                     ("attn_fwd", "attention kernel"), ("flash_fwd", "flash attention kernel"),
                     ("attn_bwd", "attention backward kernel"),
                     ("flash_bwd", "flash attention backward kernel"),
                     ("conv3x3_", "conv kernel"),
                     ("conv", "conv"), ("fprop", "conv"),
                     ("gemm", "gemm"), ("xmma", "gemm"), ("cutlass", "gemm"), ("nvjet", "gemm"),
                     ("reduce", "reduction"), ("elementwise", "elementwise")):
        if key in n:
            return cls
    return "other"


def top_kernels(prof, n: int = 5) -> str:
    """The n kernels with the most device time over a torch.profiler run."""
    rows = sorted((e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                  key=lambda e: -e.device_time_total)[:n]
    return "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3:.1f} ms" for e in rows)


def by_kernel_class(prof) -> dict:
    """Device ms by `_kernel_class` over a torch.profiler run."""
    out: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            cls = _kernel_class(e.key)
            out[cls] = out.get(cls, 0.0) + e.device_time_total / 1e3
    return out


def phase_step(engine):
    """Where a denoise step goes: one UNet forward of the 8-row bucket
    (16 rows CFG-doubled) with a slider, timed through the kernel and on the
    plain attention path, then profiled by kernel class; and the VAE decode
    of 8 rows under attention impls 'auto' and 'xla' in turns, then under
    conv impls 'auto' (#5 in f32) and 'xla' (`decode_ab`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops.basic import SliderLora

    m = engine.models
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((16, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    ctx = torch.randn((16, 77, 768), generator=gen, device="cuda").bfloat16()
    lora = SliderLora(engine.sliders["s1"], torch.linspace(-2, 2, 16, device="cuda"))
    t = torch.tensor(501.0, device="cuda")

    def step():
        with torch.inference_mode():
            unet2d.apply(m.unet_params, m.unet_config, x, t, ctx, lora=lora)

    kernel_ms = median_ms(step)
    ta.set_attention_impl("xla")  # every attention on the plain path
    try:
        plain_ms = median_ms(step)
    finally:
        ta.set_attention_impl("auto")
    say("step", f"UNet forward, 16 rows (bucket 8 CFG-doubled), 512 px, bf16, slider on: "
        f"median {kernel_ms:.2f} ms through the kernel, {plain_ms:.2f} ms on the plain "
        f"attention path")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_class = by_kernel_class(prof)
    busy = sum(by_class.values())
    say("step", "device ms per step by kernel class: " + ", ".join(
        f"{cls} {ms / 3:.2f} ({ms / busy * 100:.1f}%)"
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]))
        + f"; idle share {(1 - busy / wall) * 100:.1f}% (profiler on, 3 steps)")

    lat = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    what = "SD1.5 VAE decode of 8 images at 512 px"
    dec = decode_ab(m.vae_params, m.vae_config, lat, what)
    dec_conv = decode_ab(m.vae_params, m.vae_config, lat, what, route="conv")
    say("step", f"peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return dec, dec_conv


def decode_ab(vae_params, vae_config, lat, what: str, rounds: int = 2, runs: int = 3,
              route: str = "attention") -> dict:
    """One VAE decode (f32, as served: under the decode's own TF32 flags,
    `text2image.decode_precision`) timed under impls
    'auto' and 'xla' in alternating rounds (auto, xla, xla, auto, ...;
    median of `runs` synced decodes each); each impl's time is the median of
    its rounds. route 'attention': the attention impl, 'auto' putting the
    mid attention (the VAE's only routed attention) on #4, which it must
    launch once; 'xla' the plain path. route 'conv': the conv impl, 'auto'
    putting the decoder's CONV_PER_DECODE f32 convs on #5's 3xTF32 Hopper
    mainloop (f32-accurate; each after one weight split), 'xla' on cuDNN in
    TF32, one TF32 pass: the two are not the same arithmetic. The two images
    may differ by roundings only. Under route 'conv' the 'xla' decode runs
    once more with cuDNN's global TF32 flag flipped, and must give the same
    bits: the decode sets its own."""
    import torch

    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import conv3x3 as tc
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.pipelines.text2image import DECODE_CONV_TF32, decode_images

    set_impl, rest = ((ta.set_attention_impl, "auto") if route == "attention"
                      else (basic.set_conv_impl, "xla"))

    def decode():
        return decode_images(vae_params, vae_config, lat)

    imgs, times = {}, {"auto": [], "xla": []}
    try:
        for impl in ("auto", "xla"):
            set_impl(impl)
            before = fa.flash_attention.launches
            reset_conv_launches()
            imgs[impl] = decode()
            torch.cuda.synchronize()
            if route == "attention" and impl == "auto" and fa.flash_attention.launches != before + 1:
                raise AssertionError(f"{what}: {fa.flash_attention.launches - before} #4 launches "
                                     f"under 'auto', not 1")
            convs = CONV_PER_DECODE["auto"]["conv3x3"] if route == "conv" and impl == "auto" else 0
            if (conv_launches(), conv_variants(), tc.tf32_split.launches) != (
                    {"conv3x3": convs} if convs else {}, {"hopper": convs} if convs else {}, convs):
                raise AssertionError(f"{what} under {route} impl {impl!r}: conv launches "
                                     f"{conv_launches()} by variant {conv_variants()}, "
                                     f"{tc.tf32_split.launches} splits; expected {convs} on the "
                                     f"Hopper mainloop")
        if route == "conv":
            flag = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = not flag
            try:
                flipped = decode()
            finally:
                torch.backends.cudnn.allow_tf32 = flag
            if not torch.equal(flipped, imgs["xla"]):
                raise AssertionError(f"{what}: the 'xla' decode moved with cuDNN's global TF32 "
                                     f"flag")
        for r in range(rounds):
            for impl in (("auto", "xla") if r % 2 == 0 else ("xla", "auto")):
                set_impl(impl)
                times[impl].append(median_ms(decode, runs=runs))
    finally:
        set_impl(rest)
    diff = (imgs["auto"].int() - imgs["xla"].int()).abs().max().item()
    auto_ms, xla_ms = statistics.median(times["auto"]), statistics.median(times["xla"])
    tf32 = ("cuDNN TF32 allowed" if DECODE_CONV_TF32 else "cuDNN TF32 off") + " by the decode"
    how = ({"auto": "#4 on the mid attention", "xla": "the plain attention path"}
           if route == "attention" else
           {"auto": f"{CONV_PER_DECODE['auto']['conv3x3']} convs on #5's 3xTF32 mainloop, "
                    f"f32-accurate", "xla": f"cuDNN convs, {tf32}: one TF32 pass"})
    say("decode", f"{what} (f32, {tf32}), {route} impls: median {auto_ms:.2f} ms under 'auto' "
        f"({how['auto']}), {xla_ms:.2f} ms under 'xla' ({how['xla']}) (rounds "
        f"{[round(t, 2) for t in times['auto']]} / {[round(t, 2) for t in times['xla']]}); "
        f"'auto' / 'xla' {auto_ms / xla_ms:.3f}; images' max|diff| {diff} of 255")
    # the f32 roundings of the mid attention, or TF32's of cuDNN's convs, move
    # a pixel by a level or two; a wrong kernel moves many by tens
    if diff > 8:
        raise AssertionError(f"{what}: the images under 'auto' and 'xla' differ by {diff} levels")
    return {"auto_ms": auto_ms, "xla_ms": xla_ms, "auto_rounds": times["auto"],
            "xla_rounds": times["xla"], "max_diff_levels": diff, "cudnn_tf32": tf32}


def conv_launches() -> dict:
    from sliders_tpu_torch.ops import conv3x3 as tc

    return {fn.__name__: fn.launches for fn in (tc.conv3x3, tc.epi_conv3x3, tc.fused_conv3x3)
            if fn.launches}


def conv_variants() -> dict:
    """{variant: launches} summed over the three conv kernels since the last
    reset, variants that launched only."""
    from sliders_tpu_torch.ops import conv3x3 as tc

    out = {}
    for fn in (tc.conv3x3, tc.epi_conv3x3, tc.fused_conv3x3):
        for v, n in fn.variants.items():
            out[v] = out.get(v, 0) + n
    return {v: n for v, n in out.items() if n}


def reset_conv_launches() -> None:
    from sliders_tpu_torch.ops import conv3x3 as tc

    for fn in (tc.conv3x3, tc.epi_conv3x3, tc.fused_conv3x3):
        fn.launches = 0
        fn.variants = dict.fromkeys(tc.VARIANTS, 0)
    tc.tf32_split.launches = 0


def expect_hopper(per_forward: dict, variants: dict, what: str) -> None:
    """Every routed bf16 UNet conv of a forward took the Hopper mainloop."""
    total = sum(per_forward.values())
    if variants != ({"hopper": total} if total else {}):
        raise AssertionError(f"{what}: conv launches by variant {variants}, expected all "
                             f"{total} on the Hopper mainloop")


def phase_conv_step(engine, rounds: int = 1):
    """The UNet step of `phase_step` (bucket 8, 16 rows, bf16, slider on)
    under each conv impl, in alternating rounds of 5 synced steps: ms per
    step, each conv kernel's launches per forward (CONV_PER_FORWARD), and the
    largest distance of the noise prediction from the 'xla' route's, held to
    5e-2 of its largest magnitude (bf16 through 16 resnets and 16
    transformers: the kernels round once where cuDNN + the adds round two or
    three times, and 'fused' takes GroupNorm through the f32 fold and SiLU
    in f32; a lost tap, bias, temb or residual moves it by O(1)). Then one
    profile per impl: device time by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops.basic import SliderLora

    m = engine.models
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((16, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    ctx = torch.randn((16, 77, 768), generator=gen, device="cuda").bfloat16()
    lora = SliderLora(engine.sliders["s1"], torch.linspace(-2, 2, 16, device="cuda"))
    t = torch.tensor(501.0, device="cuda")

    def step():
        with torch.inference_mode():
            return unet2d.apply(m.unet_params, m.unet_config, x, t, ctx, lora=lora)

    eps, per_forward, times = {}, {}, {impl: [] for impl in CONV_IMPLS}
    try:
        for impl in CONV_IMPLS:
            basic.set_conv_impl(impl)
            reset_conv_launches()
            eps[impl] = step().float()
            torch.cuda.synchronize()
            per_forward[impl] = conv_launches()
            expect_hopper(per_forward[impl], conv_variants(), f"SD1.5 step under {impl!r}")
        for r in range(rounds):
            for impl in (CONV_IMPLS if r % 2 == 0 else CONV_IMPLS[::-1]):
                basic.set_conv_impl(impl)
                times[impl].append(median_ms(step, runs=5))
        classes = {}
        for impl in CONV_IMPLS:
            basic.set_conv_impl(impl)
            step()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
            classes[impl] = by_kernel_class(prof)
    finally:
        basic.set_conv_impl("xla")
    ref_max = eps["xla"].abs().max().item()
    out = {}
    for impl in CONV_IMPLS:
        diff = (eps[impl] - eps["xla"]).abs().max().item()
        cls = classes[impl]
        busy = sum(cls.values())
        say("step", f"conv impl {impl!r}: ms per step by round {[round(v, 2) for v in times[impl]]}; "
            f"conv-kernel launches per forward {per_forward[impl] or 0}, all on the Hopper "
            f"mainloop (expected "
            f"{CONV_PER_FORWARD[impl] or 0}); max|eps - eps_xla| {diff:.3g} (tol "
            f"{5e-2 * ref_max:.3g}, max|eps_xla| {ref_max:.3g}); device ms per step: " + ", ".join(
                f"{c} {v / 3:.2f}" for c, v in sorted(cls.items(), key=lambda kv: -kv[1]))
            + f" (busy {busy / 3:.2f})")
        if per_forward[impl] != CONV_PER_FORWARD[impl]:
            raise AssertionError(f"conv impl {impl!r} launched {per_forward[impl]} per forward")
        if not (torch.isfinite(eps[impl]).all() and diff <= 5e-2 * ref_max):
            raise AssertionError(f"conv impl {impl!r} moved the noise prediction by {diff}")
        out[impl] = {"ms": statistics.median(times[impl]), "per_forward": per_forward[impl]}
    return out


def phase_grad_ab(engine, dtype: str = "bfloat16", rounds: int = 1, passes: int = 5):
    """The training grad pass at full width (SD1.5 UNet, batch 1, 512 px,
    remat, the rank-4 slider's factors as the leaves) through the kernel
    route (#1 and #2) against the plain attention route ('xla'), in
    alternating order; per round the median of `passes` synced passes, the
    host's enqueue time, the working memory above what was allocated
    before, and the grad norm. Each pass must launch #2 once a routed
    self-attention (10) and #1 twice (the forward and remat's recompute: 20)
    on the kernel route and neither on the plain one.

    bf16 (the engine's weights): the grad norms agree within 1e-2 relative
    (bf16 through the whole UNet, and the plain route's autograd rounds dp
    where the kernel rounds ds). f32 (`precision: float32`; the engine's
    weights cast to f32, TF32 off in matmuls and convs): #1 and #2 run on
    3xTF32 `wgmma`, the plain route's attention on f32 cuBLAS; each
    attention output and gradient agrees with the plain route's within
    1e-5 of its largest magnitude (the kernel phases), and such differences
    carried through 16 attention layers and the UNet's backward stay far
    below 1e-4 relative in the norm, which a gradient path gone wrong
    (swapped dk and dv, a factor with no gradient) misses by orders of
    magnitude: held to 1e-4. The kernels' correctness is held tightly
    elsewhere; this phase measures the routes. Returns the per-route
    medians."""
    import torch

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import attention as ta
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.ops.basic import SliderLora

    f32 = dtype == "float32"
    m = engine.models
    params = tree_to(m.unet_params, dtype=torch.float32) if f32 else m.unet_params
    cast = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 64, 64, 4), generator=gen, device="cuda").to(cast)
    ctx = torch.randn((1, 77, 768), generator=gen, device="cuda").to(cast)
    t = torch.tensor(501.0, device="cuda")
    slider = engine.sliders["s1"]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def grad_pass():
        leaves = {n: {k: (v.detach().float().requires_grad_() if k != "alpha" else v)
                      for k, v in e.items()} for n, e in slider.items()}
        eps = unet2d.apply(params, m.unet_config, x, t, ctx,
                           lora=SliderLora(leaves, 1.0), remat=True)
        grads = [e[k] for e in leaves.values() for k in ("down", "up")]
        return torch.autograd.grad((eps.float() ** 2).mean(), grads)

    def run(impl):
        ta.set_attention_impl(impl)
        try:
            grad_pass()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            f0, b0 = sa.sd_attention.launches, sa.sd_attention_bwd.launches
            dev, host = [], []
            for _ in range(passes):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                s.record()
                grads = grad_pass()
                h1 = time.perf_counter()
                e.record()
                torch.cuda.synchronize()
                dev.append(s.elapsed_time(e))
                host.append((h1 - h0) * 1e3)
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads)).item()
            return {"ms": statistics.median(dev), "host_ms": statistics.median(host),
                    "work_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                    "fwd_per_pass": (sa.sd_attention.launches - f0) / passes,
                    "bwd_per_pass": (sa.sd_attention_bwd.launches - b0) / passes, "norm": norm}
        finally:
            ta.set_attention_impl("auto")

    out = {"auto": [], "xla": []}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not f32 and flags[1]
    try:
        for r in range(rounds):
            for impl in (("auto", "xla") if r % 2 == 0 else ("xla", "auto")):
                out[impl].append(run(impl))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for impl, name in (("auto", "kernel route"), ("xla", "plain route")):
        rs = out[impl]
        say("grad", f"{dtype} {name}: ms per pass by round {[round(r['ms'], 2) for r in rs]} "
            f"(median {statistics.median(r['ms'] for r in rs):.2f}); host enqueue "
            f"{[round(r['host_ms'], 2) for r in rs]}; working memory "
            f"{max(r['work_gb'] for r in rs):.2f} GB; kernel launches per pass: #1 "
            f"{rs[0]['fwd_per_pass']:g}, #2 {rs[0]['bwd_per_pass']:g}; grad norm "
            f"{rs[0]['norm']:.8g}")
    k_norm, p_norm = out["auto"][0]["norm"], out["xla"][0]["norm"]
    rel = abs(k_norm - p_norm) / abs(p_norm)
    tol = 1e-4 if f32 else 1e-2
    say("grad", f"{dtype} grad norms: kernel route {k_norm:.8g}, plain route {p_norm:.8g}, "
        f"relative difference {rel:.3g} (tol {tol:g})")
    if (out["auto"][0]["bwd_per_pass"], out["auto"][0]["fwd_per_pass"]) != (
            ROUTED_PER_FORWARD, 2 * ROUTED_PER_FORWARD) or (
            out["xla"][0]["bwd_per_pass"], out["xla"][0]["fwd_per_pass"]) != (0, 0):
        raise AssertionError("the grad pass did not take the route it was given")
    if not (math.isfinite(k_norm) and rel <= tol):
        raise AssertionError(f"grad norms disagree between the routes: {k_norm} vs {p_norm}")
    del params
    return {impl: {"ms": statistics.median(r["ms"] for r in rs),
                   "host_ms": statistics.median(r["host_ms"] for r in rs),
                   "work_gb": max(r["work_gb"] for r in rs)} for impl, rs in out.items()}


def png_pixels(png: bytes):
    """Decode one of the engine's PNGs (8-bit RGB, filter 0): returns
    (width, height, pixel bytes) after checking the signature and CRCs."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + data) & 0xFFFFFFFF:
            raise AssertionError(f"bad CRC in PNG chunk {tag!r}")
        chunks.setdefault(tag, b"")
        chunks[tag] += data
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2):
        raise AssertionError(f"PNG is not 8-bit RGB: depth {depth} color {color}")
    raw = zlib.decompress(chunks[b"IDAT"])
    stride = 1 + 3 * w
    if len(raw) != h * stride or any(raw[r * stride] for r in range(h)):
        raise AssertionError("unexpected PNG scanline layout")
    return w, h, b"".join(raw[r * stride + 1:(r + 1) * stride] for r in range(h))


def post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:  # the engine's error, e.g. out of memory
        raise AssertionError(f"{path} answered {e.code}: {e.read()[:2000]!r}") from None


def check_images(reply: dict, scales: list, tag: str, size: int = 512) -> list:
    imgs = reply["images"]
    if [im["scale"] for im in imgs] != [float(s) for s in scales]:
        raise AssertionError(f"{tag}: scales {[im['scale'] for im in imgs]} != {scales}")
    pixels = []
    for im in imgs:
        w, h, px = png_pixels(base64.b64decode(im["png"]))
        if (w, h) != (size, size):
            raise AssertionError(f"{tag}: image is {w}x{h}, not {size}x{size}")
        if px.count(px[:1]) == len(px):
            raise AssertionError(f"{tag}: image at scale {im['scale']} is one flat value")
        pixels.append(px)
    return pixels


def serve_http(engine, fn):
    """Run fn(port) with `engine` behind the HTTP server; close both after."""
    from sliders_tpu_torch.serving.server import make_http_server

    server = make_http_server(engine, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        return fn(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=60)


SWEEP = [-2, -1, 0, 1, 2]
NO_SLIDER_REQUEST = {"prompt": "a photo of a dog", "seed": 6}


def sweep_and_pair(engine, port: int, size: int, tag: str) -> dict:
    """(a) a 5-scale /generate for slider s1; (b) one 2-scale /generate each
    for s1 and s2, sent once (a) has started denoising (its first launch of
    kernel #1), so both wait in the queue together and the worker serves them
    as one stacked batch of 4. Every image is checked (size x size, not
    flat; -2 and +2 differ). Returns {key: (reply, client seconds)}."""
    from sliders_tpu_torch.ops import sd_attention as sa

    stats0 = dict(engine.stats)
    replies = {}

    def call(key, payload):
        t = time.perf_counter()
        replies[key] = (post(port, "/generate", payload), time.perf_counter() - t)

    ta = threading.Thread(target=call, args=("a", {
        "prompt": "a photo of a person", "seed": 1, "slider": "s1", "scales": SWEEP}))
    ta.start()
    deadline = time.monotonic() + 600
    while sa.sd_attention.launches == 0:
        if time.monotonic() > deadline or not ta.is_alive():
            raise AssertionError(f"{tag}: request (a) never started denoising")
        time.sleep(0.005)
    tb = [threading.Thread(target=call, args=(f"b{i}", {
        "prompt": "a photo of a person", "seed": 2 + i, "slider": f"s{i + 1}",
        "scales": [-1.5, 1.5]})) for i in range(2)]
    t_b = time.perf_counter()
    for t in tb:
        t.start()
    while len(engine._queue) < 2:
        if engine.stats["batches"] != stats0["batches"]:
            raise AssertionError(f"{tag}: request (a) finished before both (b) were queued")
        time.sleep(0.005)
    say(tag, f"both (b) requests queued behind (a) after "
        f"{(time.perf_counter() - t_b) * 1e3:.1f} ms")
    for t in [ta, *tb]:
        t.join(timeout=900)
        if t.is_alive():
            raise AssertionError(f"{tag}: a /generate call did not return")
    for key in ("a", "b0", "b1"):
        if key not in replies:
            raise AssertionError(f"{tag}: request {key} failed")
    px_a = check_images(replies["a"][0], SWEEP, f"{tag} a", size)
    if px_a[0] == px_a[-1]:
        raise AssertionError(f"{tag}: the -2 and +2 images are identical: the slider did nothing")
    check_images(replies["b0"][0], [-1.5, 1.5], f"{tag} b0", size)
    check_images(replies["b1"][0], [-1.5, 1.5], f"{tag} b1", size)
    for key, (reply, wall) in replies.items():
        say(tag, f"/generate {key}: {len(reply['images'])} images {size}x{size}, server latency "
            f"{reply['latency_ms']} ms, client {wall * 1e3:.1f} ms")
    replies["px_a"] = px_a
    return replies


def healthz(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    if r.status != 200 or not health["ok"] or health["sliders"] != ["s1", "s2"]:
        raise AssertionError(f"/healthz answered {r.status}: {health}")
    return health


def phase_http(engine):
    """SD1.5 behind the HTTP server: warmup, `sweep_and_pair`, /healthz, then
    /generate under each conv impl (`serve_conv_impls`). #1 must launch 10 x
    50 x batches, #4 once per batch (the VAE's mid attention)."""
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    def run(port):
        t0 = time.perf_counter()
        engine.warmup(with_slider="s1")
        say("http", f"warmup (5 scales -> bucket 8, one denoise) {time.perf_counter() - t0:.2f} s")
        stats0 = dict(engine.stats)
        # count only the served requests from here
        sa.sd_attention.launches = fa.flash_attention.launches = 0
        sweep_and_pair(engine, port, 512, "http")
        health = healthz(port)
        batches = engine.stats["batches"] - stats0["batches"]
        rows = engine.stats["rows"] - stats0["rows"]
        launches, flash = sa.sd_attention.launches, fa.flash_attention.launches
        expected = ROUTED_PER_FORWARD * STEPS * batches
        say("http", "every image 512x512 and not flat; -2 and +2 differ; latents finite "
            "(the engine refuses non-finite latents before decoding)")
        say("http", f"/healthz ok; engine stats {health['stats']}; denoise batches for the "
            f"3 requests: {batches} ({rows} rows); kernel launches {launches}, expected "
            f"{ROUTED_PER_FORWARD} x {STEPS} x {batches} = {expected}; flash-attention kernel "
            f"launches {flash} (the VAE's mid attention, d = 512 f32, one per decode), expected "
            f"{batches}")
        if batches != 2 or rows != 9:
            raise AssertionError("the two (b) requests were not coalesced into one batch")
        if launches != expected or flash != batches:
            raise AssertionError("not every routed self-attention went through its kernel")
        return launches, flash, serve_conv_impls(engine, port)

    return serve_http(engine, run)


GENERATE_TURNS = ("auto", "xla", "fused_ep", "fused")


def serve_conv_impls(engine, port: int) -> dict:
    """Five-scale /generate calls under the conv-kernel impls in
    GENERATE_TURNS ('auto', 'xla', 'fused_ep', 'fused'); each reply is
    checked as phase 5 checks it,
    and the impl's kernel must have launched (its calls per UNet forward x
    STEPS steps + its calls per VAE decode) x the denoise batches, the others
    never, all on the Hopper mainloop (the decoder's f32 convs under 'auto'
    on its 3xTF32 path, each after one weight split). Prints the server
    latencies of 'auto' and 'xla' with their medians. Returns {kernel:
    launches} of one request an impl, with the split kernel's launches
    under 'auto' as "tf32_split" and the latencies (ms) under
    "generate_ms"."""
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import conv3x3 as tc

    scales = [-2, -1, 0, 1, 2]
    latency = {"auto": [], "xla": []}
    out = {"generate_ms": latency}
    for impl in GENERATE_TURNS:
        basic.set_conv_impl(impl)
        try:
            stats0 = dict(engine.stats)
            reset_conv_launches()
            t0 = time.perf_counter()
            reply = post(port, "/generate", {"prompt": "a photo of a person", "seed": 1,
                                             "slider": "s1", "scales": scales})
            wall = time.perf_counter() - t0
            launched, variants = conv_launches(), conv_variants()
            splits = tc.tf32_split.launches
        finally:
            basic.set_conv_impl("xla")
        px = check_images(reply, scales, impl)
        if px[0] == px[-1]:
            raise AssertionError(f"{impl}: the -2 and +2 images are identical")
        batches = engine.stats["batches"] - stats0["batches"]
        per_decode = CONV_PER_DECODE.get(impl, {})
        expected = {k: (v * STEPS + per_decode.get(k, 0)) * batches
                    for k, v in CONV_PER_FORWARD[impl].items()}
        # the UNet's bf16 convs and the VAE decoder's f32 convs ('auto', each
        # after one weight split) on the Hopper mainloop
        by_variant = {"hopper": sum(expected.values())} if expected else {}
        splits_expected = sum(per_decode.values()) * batches
        say("http", f"/generate under conv impl {impl!r}: {len(reply['images'])} images, server "
            f"latency {reply['latency_ms']} ms, client {wall * 1e3:.1f} ms; {batches} denoise "
            f"batch(es); conv-kernel launches {launched}, expected {expected}; by variant "
            f"{variants}, expected {by_variant}; weight splits {splits}, expected "
            f"{splits_expected}")
        if launched != expected or variants != by_variant or splits != splits_expected:
            raise AssertionError(f"not every routed conv under {impl!r} went through its kernel")
        out.update(launched)
        if impl == "auto":
            out["tf32_split"] = splits
        if impl in latency:
            latency[impl].append(reply["latency_ms"])
    auto_ms, xla_ms = statistics.median(latency["auto"]), statistics.median(latency["xla"])
    say("http", f"/generate server latency under {GENERATE_TURNS[:2]}: 'auto' "
        f"{latency['auto']} ms (median {auto_ms:.1f}; the decoder's f32 convs on #5's 3xTF32 "
        f"mainloop, f32-accurate), 'xla' {latency['xla']} ms (median {xla_ms:.1f}; cuDNN "
        f"convs with TF32 on, as served: one TF32 pass); 'auto' / 'xla' {auto_ms / xla_ms:.3f}")
    return out


def unet_hf_config(cfg) -> dict:
    """The diffusers unet/config.json of a UNetConfig (SD1 keys, and SDXL's
    added-conditioning keys for a text_time config)."""
    xl = {} if cfg.addition_embed_type is None else {
        "addition_embed_type": cfg.addition_embed_type,
        "addition_time_embed_dim": cfg.addition_time_embed_dim,
        "projection_class_embeddings_input_dim": cfg.projection_class_embeddings_input_dim}
    return {**xl,
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": list(cfg.down_block_types),
        "up_block_types": list(cfg.up_block_types), "layers_per_block": cfg.layers_per_block,
        "cross_attention_dim": cfg.cross_attention_dim,
        "attention_head_dim": list(cfg.num_attention_heads),
        "transformer_layers_per_block": list(cfg.transformer_layers_per_block),
        "use_linear_projection": cfg.use_linear_projection,
        "norm_num_groups": cfg.norm_num_groups,
    }


def write_sd15_snapshot(root: str) -> int:
    """A diffusers-layout SD1.5 snapshot with seeded random weights: the UNet
    in bf16, CLIP-L and the SD VAE in f32 (image-slider training encodes
    with it; text-slider training loads none), the synthetic tokenizer.
    Returns the UNet's parameter count."""
    import torch

    from sliders_tpu_torch.models import clip_text, unet2d, vae
    from sliders_tpu_torch.models.convert import write_safetensors
    from sliders_tpu_torch.utils.pytree import flatten

    for sub in ("unet", "text_encoder", "tokenizer", "vae"):
        os.makedirs(os.path.join(root, sub))
    write_tokenizer(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json")) as f:
        eos = json.load(f)["<|endoftext|>"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    unet = flatten(unet2d.init_params(gen, unet2d.SD15, dtype=torch.bfloat16, device="cuda"))
    n_params = sum(t.numel() for t in unet.values())
    write_safetensors(os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"), unet)
    with open(os.path.join(root, "unet", "config.json"), "w") as f:
        json.dump(unet_hf_config(unet2d.SD15), f)
    del unet
    cfg = clip_text.CLIP_L
    clip = flatten(clip_text.init_params(gen, cfg, device="cuda"))
    write_safetensors(os.path.join(root, "text_encoder", "model.safetensors"), clip)
    with open(os.path.join(root, "text_encoder", "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_positions, "hidden_act": cfg.hidden_act,
                   "eos_token_id": eos}, f)
    del clip
    write_safetensors(os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
                      flatten(vae.init_params(gen, vae.SD_VAE, device="cuda")))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump(vae_hf_config(vae.SD_VAE), f)
    return n_params


def dump_yaml(tree: dict, indent: int = 0) -> str:
    """Nested mappings of scalars as YAML (strings double-quoted)."""
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines.append(" " * indent + f"{k}:")
            lines.append(dump_yaml(v, indent + 2))
        elif isinstance(v, bool) or v is None:
            lines.append(" " * indent + f"{k}: {json.dumps(v)}")  # true / false / null
        else:
            text = json.dumps(v) if isinstance(v, str) else repr(v)
            lines.append(" " * indent + f"{k}: {text}")
    return "\n".join(lines)


def run_training(cfg: dict, path: str, extra: list, probe=None) -> dict:
    """The training CLI in-process on cuda:0 with the config `cfg` (written
    to `path`); the kernels' counts are set to 0 just before and read just
    after. Returns the per-iteration records, the counts and the LoRA.
    `probe(state)`, if given, adds its dict to each iteration's metrics."""
    import torch

    from sliders_tpu_torch.cli import train_text_slider as cli
    from sliders_tpu_torch.ops import layout_pin as lp
    from sliders_tpu_torch.ops import sd_attention as sa

    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    records = []
    torch.cuda.reset_peak_memory_stats()
    sa.sd_attention.launches = sa.sd_attention_bwd.launches = lp.layout_pin_copy.launches = 0
    reset_conv_launches()
    t0 = time.perf_counter()
    final = cli.main(cli.build_parser().parse_args(["--config_file", path, "--device", "0",
                                                    *extra]),
                     on_step=lambda i, state, m: records.append(
                         (i, time.perf_counter(), {**m, **(probe(state) if probe else {})})))
    torch.cuda.synchronize()
    return {"records": records, "fwd": sa.sd_attention.launches, "bwd": sa.sd_attention_bwd.launches,
            "pin": lp.layout_pin_copy.launches, "conv": conv_launches(), "lora": final,
            "seconds": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def expected_fwd(records, remat: bool) -> int:
    """Forward-kernel launches of the iterations: 10 routed self-attentions
    per UNet call, t_to calls in the partial denoise, one frozen pass, the
    grad pass, and with remat the grad pass's forward again in the backward."""
    return sum(ROUTED_PER_FORWARD * (m["t_to"] + 2 + int(remat)) for _, _, m in records)


def run_fused_training(cfg: dict, tmp: str, xla_recs: list) -> dict:
    """The training CLI for FUSED_ITERATIONS iterations from step 0 under
    conv impl 'fused', on the same snapshot and config with a fresh output
    directory: kernel #6 launches 30 x sum(t_to + 2) (each UNet forward
    routes 15 resnets; remat recomputes transformer blocks, not resnets),
    the attention kernels as in the default run, every LoRA up factor
    moves, and each iteration repeats the default run's draws (t_to, pair)
    with a loss within FUSED_LOSS_RTOL of its loss there (`xla_recs`)."""
    from sliders_tpu_torch.ops import basic

    cfg = {**cfg, "train": {**cfg["train"], "iterations": FUSED_ITERATIONS},
           "save": {**cfg["save"], "path": os.path.join(tmp, "out_fused")}}
    basic.set_conv_impl("fused")
    try:
        run = run_training(cfg, os.path.join(tmp, "config_fused.yaml"), [])
    finally:
        basic.set_conv_impl("xla")
    recs = run["records"]
    t_tos = [m["t_to"] for _, _, m in recs]
    conv_expected = CONV_PER_FORWARD["fused"]["fused_conv3x3"] * sum(t + 2 for t in t_tos)
    fwd_expected = expected_fwd(recs, bool(cfg["tpu"]["remat"]))
    frozen_up = [m for m, e in run["lora"].items() if not bool(e["up"].abs().max() > 0)]
    losses = [f"{m['loss']:.6g}" for _, _, m in recs]
    xla = [m for _, _, m in xla_recs[:len(recs)]]
    xla_losses = [f"{x['loss']:.6g}" for x in xla]
    rels = [abs(m["loss"] - x["loss"]) / abs(x["loss"]) for (_, _, m), x in zip(recs, xla)]
    say("train", f"conv impl 'fused', {len(recs)} iterations: t_to {t_tos}, losses "
        f"{losses} vs 'xla' {xla_losses} on the same draws, max rel diff {max(rels):.3g} "
        f"(tol {FUSED_LOSS_RTOL}); launches: fused conv {run['conv']} (expected "
        f"fused_conv3x3 {conv_expected} = 30 x sum(t_to + 2)), attention forward {run['fwd']} "
        f"(expected {fwd_expected}), backward {run['bwd']}; LoRA up factors that never moved: "
        f"{len(frozen_up)}; peak device memory {run['peak_gb']:.2f} GB")
    if [i for i, _, _ in recs] != list(range(FUSED_ITERATIONS)):
        raise AssertionError("the 'fused' run did not take every iteration")
    if not all(math.isfinite(m["loss"]) for _, _, m in recs) or frozen_up:
        raise AssertionError("the 'fused' run's losses or LoRA are wrong")
    if [(m["t_to"], m["pair"]) for _, _, m in recs] != [(x["t_to"], x["pair"]) for x in xla] or (
            max(rels) > FUSED_LOSS_RTOL):
        raise AssertionError("the 'fused' run's losses disagree with the 'xla' run's on the "
                             "same draws")
    if run["conv"] != {"fused_conv3x3": conv_expected} or run["fwd"] != fwd_expected or (
            run["bwd"] != ROUTED_PER_FORWARD * FUSED_ITERATIONS):
        raise AssertionError("not every routed conv of the 'fused' run went through kernel #6")
    return run


VALIDATE_STEPS = 3  # DDIM steps of the runbook's sweep, cut from its 50
SINGLE_FILE_ATOL = 1e-4  # the runbook's single-file check, f32 UNet on the golden probe


def write_ldm_single_file(snap: str, path: str) -> int:
    """The snapshot's UNet, VAE and CLIP-L as one LDM-layout .safetensors
    (keys by `ldm_checkpoint.diffusers_to_ldm_keys`, the VAE's attention
    linears as 1x1 convs, CLIP's position_ids beside, as real files hold
    them); returns the file's bytes."""
    import torch

    from sliders_tpu_torch.models import convert, ldm_checkpoint, unet2d, vae
    from sliders_tpu_torch.models.convert import write_safetensors

    state = ldm_checkpoint.to_ldm_state(
        convert.load_component(snap, "unet"), unet2d.SD15, convert.load_component(snap, "vae"),
        vae.SD_VAE, convert.load_component(snap, "text_encoder"))
    state[ldm_checkpoint.TEXT_PREFIX + "text_model.embeddings.position_ids"] = torch.arange(77)[None]
    write_safetensors(path, state)
    return os.path.getsize(path)


def phase_single_file(snap: str, tmp: str) -> dict:
    """SD1.5 at full width from one LDM single file: every tensor bit-equal
    to the snapshot's load, then one UNet forward on the golden probe (512
    px, #1 10 times) and one 512 px VAE decode (#4 at d = 512, once),
    counted, and held against the snapshot model's forward."""
    import torch

    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.utils.goldens import fixed_unet_probe, unet_on_probe
    from sliders_tpu_torch.utils.pytree import flatten

    path = os.path.join(tmp, "sd15.safetensors")
    t0 = time.perf_counter()
    size = write_ldm_single_file(snap, path)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = loader.load_sd(path, tokenizer_dir=os.path.join(snap, "tokenizer"), load_vae=True,
                       device="cuda")
    t_load = time.perf_counter() - t0
    ref = loader.load_sd(snap, load_vae=True, device="cuda")
    pairs = [(m.unet_params, ref.unet_params), (m.vae_params, ref.vae_params),
             (m.text_encoders[0].params, ref.text_encoders[0].params)]
    n_tensors, unequal = 0, []
    for a, b in pairs:
        got, want = flatten(a), flatten(b)
        if set(got) != set(want):
            raise AssertionError(f"the single file's tree has other paths: "
                                 f"{sorted(set(got) ^ set(want))[:5]}")
        n_tensors += len(got)
        unequal += [k for k in got if got[k].dtype != want[k].dtype
                    or got[k].stride() != want[k].stride() or not torch.equal(got[k], want[k])]
    if unequal:
        raise AssertionError(f"{len(unequal)} tensors differ from the snapshot's, e.g. "
                             f"{unequal[:3]}")
    probe = fixed_unet_probe(m.unet_config)
    lat = torch.from_numpy(probe["x"]).cuda() * 0.5
    sa.sd_attention.launches = fa.flash_attention.launches = 0
    eps = unet_on_probe(m.unet_params, m.unet_config, probe)
    img = t2i.decode_images(m.vae_params, m.vae_config, lat)
    torch.cuda.synchronize()
    counts = {"sd": sa.sd_attention.launches, "flash": fa.flash_attention.launches}
    eps_ref = unet_on_probe(ref.unet_params, ref.unet_config, probe)
    diff = (eps - eps_ref).abs().max().item()
    scale = max(1.0, eps_ref.abs().max().item())
    say("single file", f"{size / 1e9:.3f} GB LDM .safetensors written in {t_write:.1f} s, "
        f"loaded in {t_load:.1f} s: {n_tensors} tensors (UNet, VAE, CLIP-L) bit-equal to the "
        f"snapshot's in dtype, layout and value; UNet f32 forward on the 512 px probe: "
        f"max|diff| {diff:.3g} against the snapshot model's (limit {SINGLE_FILE_ATOL} x "
        f"{scale:.3g}); decode {tuple(img.shape)}; launches #1 {counts['sd']} (expected "
        f"{ROUTED_PER_FORWARD}), #4 {counts['flash']} (expected 1)")
    if not torch.isfinite(eps).all() or diff > SINGLE_FILE_ATOL * scale:
        raise AssertionError("the single file's UNet disagrees with the snapshot's")
    if tuple(img.shape) != (1, 512, 512, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"the decode gave {tuple(img.shape)} {img.dtype}")
    if counts != {"sd": ROUTED_PER_FORWARD, "flash": 1}:
        raise AssertionError("the single file's forward or decode did not go through #1 / #4")
    del m, ref
    return {"path": path, "bytes": size, **counts}


def phase_validate(snap: str, ckpt: str, tmp: str) -> dict:
    """The real-weight runbook `cli.validate_real_weights` in-process on the
    card, --sd15 the snapshot --ckpt its single file, 512 px, VALIDATE_STEPS
    DDIM steps, f32, twice with one golden: load, single_file and sweep PASS
    and eps_golden RECORDED, then MATCHED; CLIP and LPIPS SKIP (no weights
    passed). #1 launches 10 per UNet forward (the golden's, the two
    single-file forwards and the sweep's CFG-doubled steps), #4 once (the
    sweep's decode)."""
    import torch

    from sliders_tpu_torch.cli import validate_real_weights as rb
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    out, golden = os.path.join(tmp, "validate"), os.path.join(tmp, "torch_sd15_eps_golden.npz")
    argv = ["--sd15", snap, "--ckpt", ckpt, "--golden", golden, "--out", out, "--steps",
            str(VALIDATE_STEPS), "--image_size", "512", "--device", "0"]
    want_sd = ROUTED_PER_FORWARD * (3 + VALIDATE_STEPS)
    runs = []
    for golden_status in ("RECORDED", "MATCHED"):
        sa.sd_attention.launches = fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        rc = rb.main(rb.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, "validation.json")) as f:
            status = {k: v["status"] for k, v in json.load(f).items()}
        counts = {"sd": sa.sd_attention.launches, "flash": fa.flash_attention.launches}
        with open(os.path.join(out, "sweep_+0.0.png"), "rb") as f:
            w, h, pixels = png_pixels(f.read())
        say("validate", f"run {len(runs) + 1}: rc {rc} in {seconds:.1f} s, statuses {status}; "
            f"sweep PNG {w}x{h} (pixel mean {sum(pixels) / len(pixels):.1f}); launches #1 "
            f"{counts['sd']} (expected {want_sd} = 10 x (1 golden + 2 single-file + "
            f"{VALIDATE_STEPS} sweep steps), of which the sweep's {counts['sd'] - 30}), #4 "
            f"{counts['flash']} (expected 1: the sweep's decode)")
        expected = {"load": "PASS", "eps_golden": golden_status, "single_file": "PASS",
                    "clip": "SKIP", "lpips": "SKIP", "sweep": "PASS"}
        if rc != 0 or status != expected or (w, h) != (512, 512):
            raise AssertionError(f"the runbook gave {status} (rc {rc}), expected {expected}")
        if counts != {"sd": want_sd, "flash": 1}:
            raise AssertionError("the runbook's forwards or decode did not go through #1 / #4")
        runs.append({"seconds": seconds, **counts})
        gc.collect()
        torch.cuda.empty_cache()
    return {"runs": runs, "sd": runs[0]["sd"], "flash": runs[0]["flash"],
            "sweep_sd": runs[0]["sd"] - 3 * ROUTED_PER_FORWARD}


class WandbStub:
    """A stand-in `wandb` module (the card's machine has none): records each
    init and log call with its host time."""

    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", time.perf_counter(), kw))

    def log(self, row):
        self.calls.append(("log", time.perf_counter(), row))


def check_loop_trace(path: str, fwd: int, bwd: int) -> dict:
    """The text loop's Chrome trace: parses as JSON, and its device kernels
    name #1's bf16 forward (`attn_sm90`) and #2's (`attn_bwd_sm90`, two
    kernels a backward)."""
    with open(path) as f:
        trace = json.load(f)
    kernels = [e.get("name", "") for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    found = {"attn_sm90": sum("attn_sm90" in k for k in kernels),
             "attn_bwd_sm90": sum("attn_bwd_sm90" in k for k in kernels)}
    if not found["attn_sm90"] or not found["attn_bwd_sm90"]:
        raise AssertionError(f"the loop's trace names neither #1 nor #2: {found}, "
                             f"{len(kernels)} kernel events")
    return {"bytes": os.path.getsize(path), "events": len(trace["traceEvents"]),
            "kernels": len(kernels), "found": found, "fwd_launches": fwd, "bwd_launches": bwd}


def spans_line(recs: list) -> str:
    """Each iteration's t_to, host wall (from the one before) and device
    spans of a training run's records."""
    parts, prev = [], None
    for i, t_end, m in recs:
        ph = m["phase_ms"]
        wall = "" if prev is None else f"{t_end - prev:.3f} s, "
        parts.append(f"{i} (t_to {m['t_to']}): {wall}denoise {ph['denoise']:.1f}, frozen "
                     f"{ph['frozen']:.1f}, grad {ph['grad']:.1f}, update {ph['update']:.1f} ms")
        prev = t_end
    return "; ".join(parts)


def phase_fp16_sd15(snap: str, tmp: str, cfg: dict, bf16_recs: list) -> dict:
    """`precision: fp16` at SD1.5's full width on phase_train's snapshot:
      - the text-slider CLI with data/config.yaml's values but fp16, for
        FP16_TRAIN_ITERATIONS iterations (seed 0: the draws of the bf16
        run's first iterations): the weights load in f32, every UNet call
        computes in f16, so every #1 and #2 launch of the run is an f16 one;
        launches exact, losses finite; per-iteration host wall and device
        spans beside the bf16 run's same iterations; peak memory;
      - train_fleet at K = FP16_FLEET_K (FLEET_PROMPTS's first), one
        iteration, f16 on f32-loaded weights, under conv impl 'auto': the
        f16 #5 at full width, launches of #1, #2 and #5 exact;
      - the image-slider CLI, one iteration at 256 px: it computes in f32,
        as the JAX CLI does under fp16 (every UNet input f32), and says so.
    Returns the launches and times of each."""
    import io

    import torch

    from sliders_tpu_torch.cli import train_fleet as fcli
    from sliders_tpu_torch.ops import basic

    remat = bool(cfg["tpu"]["remat"])
    run_cfg = json.loads(json.dumps(cfg))
    run_cfg["train"].update(precision="fp16", iterations=FP16_TRAIN_ITERATIONS)
    run_cfg["save"].update(path=os.path.join(tmp, "fp16_out"), per_steps=0)
    run_cfg["tpu"].update(state_checkpoint_every=0, profile_dir="")
    run_cfg["logging"]["use_wandb"] = False
    with unet_input_dtypes() as dtypes, f16_sum_flags() as sums:
        run = run_training(run_cfg, os.path.join(tmp, "config_fp16.yaml"), [])
    recs = run["records"]
    losses = [m["loss"] for _, _, m in recs]
    expected = {"fwd": expected_fwd(recs, remat), "bwd": ROUTED_PER_FORWARD * len(recs)}
    got = {"fwd": run["fwd"], "bwd": run["bwd"]}
    wall = [b[1] - a[1] for a, b in zip(recs, recs[1:])]
    bf16 = bf16_recs[:len(recs)]
    say("fp16", f"SD1.5 text slider, precision fp16 (f32-loaded weights, f16 compute): "
        f"{len(recs)} iterations, t_to {[m['t_to'] for _, _, m in recs]}, losses "
        f"{[f'{v:.6g}' for v in losses]}; f16 launches #1 {got['fwd']}, #2 {got['bwd']} "
        f"(expected {expected}); UNet inputs {sorted({str(d) for d in dtypes})} over "
        f"{len(dtypes)} calls, f16 GEMMs summing in f32 at {sums.count(False)} of them; peak "
        f"device memory {run['peak_gb']:.2f} GB; whole run {run['seconds']:.1f} s including "
        f"the f32 load")
    say("fp16", f"fp16 iterations: {spans_line(recs)}")
    say("fp16", f"bf16 iterations of the same draws (this call's SD1.5 run): {spans_line(bf16)}")
    if [m["t_to"] for _, _, m in recs] != [m["t_to"] for _, _, m in bf16]:
        raise AssertionError("the fp16 run did not draw the bf16 run's t_to")
    if got != expected or set(dtypes) != {torch.float16} or set(sums) != {False} or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"the SD1.5 fp16 run: launches {got} (expected {expected}), UNet "
                             f"inputs {set(dtypes)}, f16 sums in f32 {set(sums)}, losses {losses}")
    out = {**got, "t_to": [m["t_to"] for _, _, m in recs], "iteration_s": wall,
           "phase_ms": [m["phase_ms"] for _, _, m in recs], "peak_gb": run["peak_gb"],
           "bf16_iteration_s": [b[1] - a[1] for a, b in zip(bf16, bf16[1:])],
           "bf16_phase_ms": [m["phase_ms"] for _, _, m in bf16]}

    from sliders_tpu_torch.ops import sd_attention as sa

    prompts, _ = fleet_prompt_files(tmp)
    fleet_cfg = {**run_cfg, "train": {**run_cfg["train"], "iterations": 1},
                 "save": {**run_cfg["save"], "path": os.path.join(tmp, "fp16_fleet")}}
    path = os.path.join(tmp, "fleet_fp16.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(fleet_cfg) + "\n")
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.sd_attention.launches = sa.sd_attention_bwd.launches = 0
    reset_conv_launches()
    basic.set_conv_impl("auto")
    t0 = time.perf_counter()
    try:
        with unet_input_dtypes() as fleet_dtypes, f16_sum_flags() as fleet_sums:
            fcli.main(fcli.build_parser().parse_args(
                ["--config_file", path, "--device", "0", "--prompts_file",
                 *prompts[:FP16_FLEET_K]]), on_step=lambda i, state, m: records.append(m))
        torch.cuda.synchronize()
    finally:
        basic.set_conv_impl("xla")
    seconds = time.perf_counter() - t0
    (m,) = records
    # UNet forwards: the loop, the frozen pass, the grad pass; remat
    # recomputes the transformer blocks (#1), not the resnets (#5)
    calls = m["loop"] + 2
    fgot = {"fwd": sa.sd_attention.launches, "bwd": sa.sd_attention_bwd.launches,
            "conv": conv_launches(), "conv_variants": conv_variants()}
    fexp = {"fwd": ROUTED_PER_FORWARD * (calls + remat), "bwd": ROUTED_PER_FORWARD,
            "conv": {k: v * calls for k, v in CONV_PER_FORWARD["auto"].items()}}
    ph = m["phase_ms"]
    say("fp16", f"train_fleet fp16 under conv impl 'auto', K = {FP16_FLEET_K}, one iteration: "
        f"per-row t_to {m['t_to']}, loop {m['loop']}, losses "
        f"{[f'{v:.6g}' for v in m['loss']]}; f16 launches #1 {fgot['fwd']}, #2 {fgot['bwd']}, "
        f"#5 {fgot['conv']} by variant {fgot['conv_variants']} (expected {fexp}); device ms "
        f"denoise {ph['denoise']:.1f}, frozen {ph['frozen']:.1f}, grad {ph['grad']:.1f}, update "
        f"{ph['update']:.1f}; {seconds:.2f} s the CLI call with the f32 load; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if ({k: fgot[k] for k in fexp} != fexp or set(fleet_dtypes) != {torch.float16}
            or set(fleet_sums) != {False} or not all(map(math.isfinite, m["loss"]))):
        raise AssertionError(f"the fp16 fleet: launches {fgot} (expected {fexp}), UNet inputs "
                             f"{set(fleet_dtypes)}, losses {m['loss']}")
    out["fleet"] = {**fgot, "loop": m["loop"], "seconds": seconds, "phase_ms": ph}

    from sliders_tpu_torch.core import yaml_subset

    image_cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
    image_cfg["prompts_file"] = os.path.join(REPO, "data", "prompts.yaml")
    image_cfg["pretrained_model"]["name_or_path"] = snap
    image_cfg["train"].update(precision="fp16", iterations=1)
    image_cfg["save"].update(path=os.path.join(tmp, "fp16_image_out"), per_steps=0)
    image_cfg["logging"] = {"log_every": 1}
    px = IMAGE_PX["sd15"]
    pairs = os.path.join(tmp, "fp16_pairs")
    folders, scales = write_pair_folders(pairs, (px * 5 // 4, px * 9 // 8), 2, seed=22)
    text = io.StringIO()
    with unet_input_dtypes() as image_dtypes, contextlib.redirect_stdout(text):
        image = run_image_training(image_cfg, os.path.join(tmp, "fp16_image.yaml"),
                                   ["--folder_main", pairs, "--folders", folders, "--scales",
                                    scales, "--device", "0"])
    note = next((ln for ln in text.getvalue().splitlines() if ln.startswith("precision fp16")),
                None)
    (_, _, im), = image["records"]
    say("fp16", f"image slider, precision fp16, one iteration at {px} px: UNet inputs "
        f"{sorted({str(d) for d in image_dtypes})}, loss {im['loss']:.6g}; launches #1 "
        f"{image['sd']}, #2 {image['sd_bwd']}, #4 {image['flash']} (the f32 plans); the CLI "
        f"said: {note!r}")
    if set(image_dtypes) != {torch.float32} or note is None or not math.isfinite(im["loss"]):
        raise AssertionError("the image slider under fp16 did not run, and say it runs, in f32")
    out["image"] = {k: image[k] for k in ("sd", "sd_bwd", "flash")}
    return out


def phase_train():
    """SD1.5 at full width through the training CLI, then a resume."""
    import torch

    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import unet2d

    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "sd15")
        t0 = time.perf_counter()
        n_params = write_sd15_snapshot(snap)
        say("train", f"SD1.5 snapshot with random weights (UNet {n_params / 1e6:.1f} M params "
            f"bf16, CLIP-L and the SD VAE f32) written in {time.perf_counter() - t0:.1f} s")

        cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
        overrides = {
            ("prompts_file",): os.path.join(REPO, "data", "prompts.yaml"),
            ("pretrained_model", "name_or_path"): snap,
            ("train", "iterations"): TRAIN_ITERATIONS,
            ("save", "path"): os.path.join(tmp, "out"),
            ("save", "per_steps"): 3,
            ("logging", "log_every"): 1,
            ("tpu", "state_checkpoint_every"): 3,
        }
        for keys, value in overrides.items():
            node = cfg
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
        say("train", f"config data/config.yaml: train {cfg['train']}; network {cfg['network']}; "
            f"tpu {cfg['tpu']}; overridden: iterations, save.per_steps, logging.log_every, "
            f"tpu.state_checkpoint_every and the paths (prompts: data/prompts.yaml)")
        remat = bool(cfg["tpu"]["remat"])

        run = run_training(cfg, os.path.join(tmp, "config.yaml"), [])
        recs = run["records"]
        losses = [m["loss"] for _, _, m in recs]
        t_tos = [m["t_to"] for _, _, m in recs]
        fwd_expected = expected_fwd(recs, remat)
        bwd_expected = ROUTED_PER_FORWARD * TRAIN_ITERATIONS
        say("train", f"{len(recs)} iterations: t_to {t_tos}, losses "
            f"{[f'{x:.6g}' for x in losses]}; kernel launches: forward {run['fwd']} (expected "
            f"{fwd_expected} = 10 x sum(t_to + 2 + remat)), backward {run['bwd']} (expected "
            f"{bwd_expected} = 10 x {TRAIN_ITERATIONS})")
        if [i for i, _, _ in recs] != list(range(TRAIN_ITERATIONS)):
            raise AssertionError("the run did not take every iteration")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("a training loss is not finite")
        if run["fwd"] != fwd_expected or run["bwd"] != bwd_expected:
            raise AssertionError("not every routed self-attention of the training run went "
                                 "through the kernels")

        final = run["lora"]
        frozen_up = [m for m, e in final.items() if not bool(e["up"].abs().max() > 0)]
        if frozen_up:
            raise AssertionError(f"{len(frozen_up)} LoRA up factors never moved from zero, e.g. "
                                 f"{frozen_up[:3]}")
        if any(e["alpha"].item() != cfg["network"]["alpha"] for e in final.values()):
            raise AssertionError("a LoRA alpha changed")
        name = (f"{cfg['save']['name']}_alpha{float(cfg['network']['alpha'])}"
                f"_rank{cfg['network']['rank']}_{cfg['network']['training_method']}")
        out_dir = os.path.join(tmp, "out", name)
        files = sorted(os.listdir(out_dir))
        expected_files = sorted(f"{name}{s}" for s in ("_3steps.safetensors", "_last.safetensors",
                                                       "_metadata.json", "_trainstate.pt"))
        if files != expected_files:
            raise AssertionError(f"saved files {files}, expected {expected_files}")
        meta_unet = unet2d.init_params(None, unet2d.SD15, device="meta")
        last = lora_io.load_slider(os.path.join(out_dir, f"{name}_last.safetensors"), meta_unet)
        if set(last) != set(final) or any(not torch.equal(last[m][k], final[m][k])
                                          for m in final for k in ("down", "up", "alpha")):
            raise AssertionError("the _last slider does not reload equal to the trained LoRA")
        say("train", f"{len(final)} LoRA modules: every up factor moved from zero, every alpha "
            f"still {cfg['network']['alpha']}; files {files}; _last reloads equal")

        # resume from the state saved after step 3 for one more iteration,
        # traced (tpu.profile_dir) and logged to a stub wandb
        cfg["train"]["iterations"] = 5
        trace_dir = os.path.join(tmp, "trace")
        cfg["tpu"]["profile_dir"], cfg["logging"]["use_wandb"] = trace_dir, True
        stub, saved_wandb = WandbStub(), sys.modules.get("wandb")
        sys.modules["wandb"] = stub
        try:
            resumed = run_training(cfg, os.path.join(tmp, "config_resume.yaml"),
                                   ["--resume", os.path.join(out_dir, f"{name}_trainstate.pt")])
        finally:
            if saved_wandb is None:
                del sys.modules["wandb"]
            else:
                sys.modules["wandb"] = saved_wandb
        cfg["tpu"]["profile_dir"], cfg["logging"]["use_wandb"] = "", False
        rrecs = resumed["records"]
        trace = check_loop_trace(os.path.join(trace_dir, f"{name}_loop.pt.trace.json"),
                                 resumed["fwd"], resumed["bwd"])
        kinds = [c[0] for c in stub.calls]
        init_kw = stub.calls[0][2] if kinds and kinds[0] == "init" else {}
        with open(os.path.join(out_dir, f"{name}_metadata.json")) as f:
            meta = json.load(f)
        logged = [c[2] for c in stub.calls[1:]]
        want_log = [{"loss": rrecs[0][2]["loss"], "iteration": 4,
                     "lr": float(cfg["train"]["lr"])}] if rrecs else []
        traced_s = rrecs[0][1] - stub.calls[0][1] if rrecs and stub.calls else float("nan")
        plain_s = recs[4][1] - recs[3][1]
        r_ms, m_ms = rrecs[0][2]["phase_ms"], recs[4][2]["phase_ms"]
        say("train", f"resumed run traced: {trace['bytes'] / 1e6:.1f} MB Chrome trace, "
            f"{trace['events']} events, {trace['kernels']} device kernels, of which #1's "
            f"attn_sm90 {trace['found']['attn_sm90']} (forward launches {resumed['fwd']}) and "
            f"#2's attn_bwd_sm90 {trace['found']['attn_bwd_sm90']} (backward launches "
            f"{resumed['bwd']}); step 4 host wall {traced_s:.3f} s with the profiler (from "
            f"wandb.init to the step's end) against {plain_s:.3f} s without (the first run's "
            f"step 4, from step 3's end, which includes step 3's saves); device ms "
            f"{sum(r_ms.values()):.1f} / {sum(m_ms.values()):.1f}; whole resumed run "
            f"{resumed['seconds']:.1f} s with the load and the trace's export; wandb stub: "
            f"{kinds}, init project {init_kw.get('project')!r}")
        if kinds != ["init", "log"] or init_kw != {"project": f"LECO_{name}", "config": meta}:
            raise AssertionError(f"the stub wandb saw {kinds} with {init_kw.get('project')!r}")
        if logged != want_log:
            raise AssertionError(f"wandb.log got {logged}, expected {want_log}")
        if [i for i, _, _ in rrecs] != [4]:
            raise AssertionError(f"the resumed run took steps {[i for i, _, _ in rrecs]}, not [4]")
        m4, r4 = recs[4][2], rrecs[0][2]
        rel = abs(r4["loss"] - m4["loss"]) / abs(m4["loss"])
        r_fwd = expected_fwd(rrecs, remat)
        say("train", f"resume at step 4: t_to {r4['t_to']} pair {r4['pair']} (first run "
            f"{m4['t_to']}, {m4['pair']}), loss {r4['loss']:.6g} vs {m4['loss']:.6g} (rel "
            f"{rel:.3g}); launches forward {resumed['fwd']} (expected {r_fwd}), backward "
            f"{resumed['bwd']} (expected {ROUTED_PER_FORWARD})")
        if (r4["t_to"], r4["pair"]) != (m4["t_to"], m4["pair"]) or rel > 1e-3:
            raise AssertionError("the resumed step does not repeat the first run's step 4")
        if resumed["fwd"] != r_fwd or resumed["bwd"] != ROUTED_PER_FORWARD:
            raise AssertionError("the resumed run did not go through the kernels")
        if run["conv"] or resumed["conv"]:
            raise AssertionError("a conv kernel launched under the default conv impl 'xla'")

        fused = run_fused_training(cfg, tmp, recs)
        gc.collect()
        torch.cuda.empty_cache()
        fp16 = timed("fp16 sd15", phase_fp16_sd15, snap, tmp, cfg, recs)
        gc.collect()
        torch.cuda.empty_cache()
        single_file = timed("single file", phase_single_file, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        validate = timed("validate_real_weights", phase_validate, snap, single_file["path"], tmp)
        os.remove(single_file["path"])
        image = timed("SD1.5 image training", phase_image_train, snap, tmp, "sd15")
        gc.collect()
        torch.cuda.empty_cache()
        generate = timed("generate sd15", phase_generate, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        fleet = timed("fleet sd15", phase_fleet, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        fleet_rows = timed("fleet rows", phase_fleet_rows)
        fleet_image = timed("fleet image sd15", phase_fleet_image, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        generate_fleet = timed("generate fleet sd15", phase_generate_fleet, snap, tmp)
        adaptive = timed("adaptive optimizers", phase_adaptive, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        uce = timed("uce sd15", phase_uce, snap, tmp)
        ti = timed("ti sd15", phase_ti, snap, tmp)
        scores = timed("scores", phase_scores, uce["folder"], uce["csv"], tmp)
        gc.collect()
        torch.cuda.empty_cache()
        edit = timed("edit sd15", phase_edit, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        maps = timed("attention maps sd15", phase_attention_maps, snap, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        mesh = timed("mesh sd15", phase_mesh, snap, tmp, cfg)

    # time per iteration, past the first (which includes cuBLAS/cuDNN set-up)
    steady = recs[1:]
    host_s = [b[1] - a[1] for a, b in zip(recs, recs[1:])]
    phases = {k: statistics.median(m["phase_ms"][k] for _, _, m in steady)
              for k in ("denoise", "frozen", "grad", "update")}
    per_call = statistics.median(m["phase_ms"]["denoise"] / m["t_to"] for _, _, m in steady)
    say("train", f"median per iteration (iterations 1-{len(recs) - 1}): "
        f"{statistics.median(host_s):.3f} s host wall; device ms: denoise loop "
        f"{phases['denoise']:.1f} ({per_call:.2f} per CFG-doubled UNet call), frozen pass "
        f"{phases['frozen']:.2f}, grad pass forward + backward {phases['grad']:.2f}, update "
        f"{phases['update']:.2f}; peak device memory {run['peak_gb']:.2f} GB; whole run "
        f"{run['seconds']:.1f} s including the load")
    # the same iteration (same draws) under 'xla' and under 'fused'
    ph, fph = recs[1][2]["phase_ms"], fused["records"][1][2]["phase_ms"]
    say("train", f"iteration 1 (t_to {recs[1][2]['t_to']}), 'xla' / 'fused': device ms denoise "
        f"{ph['denoise']:.1f} / {fph['denoise']:.1f}, frozen {ph['frozen']:.2f} / "
        f"{fph['frozen']:.2f}, grad {ph['grad']:.2f} / {fph['grad']:.2f}, update "
        f"{ph['update']:.2f} / {fph['update']:.2f}; peak device memory {run['peak_gb']:.2f} / "
        f"{fused['peak_gb']:.2f} GB")
    return {"fwd": run["fwd"], "bwd": run["bwd"], "resume_fwd": resumed["fwd"],
            "resume_bwd": resumed["bwd"], "fused_fwd": fused["fwd"], "fused_bwd": fused["bwd"],
            "fused_conv": fused["conv"].get("fused_conv3x3", 0), "image": image,
            "generate": generate, "edit": edit, "maps": maps, "uce": uce, "ti": ti,
            "scores": scores, "fleet": fleet, "fleet_rows": fleet_rows,
            "fleet_image": fleet_image, "generate_fleet": generate_fleet, "adaptive": adaptive,
            "single_file": single_file, "validate": validate, "trace": trace, "fp16": fp16,
            "mesh": mesh}


def build_flux_engine(tok_dir: str, t5_tok_dir: str):
    """FLUX-dev at full width and depth in bf16 with seeded random weights
    drawn on the card (transformer, T5-XXL encoder, CLIP-L, FLUX VAE), a
    FluxSliderEngine at 1024 px and two rank-4 xattn sliders with nonzero up."""
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, flux, t5, vae
    from sliders_tpu_torch.models.loader import FluxModels, TextEncoderBundle
    from sliders_tpu_torch.serving.server import FluxSliderEngine
    from sliders_tpu_torch.text.t5_tokenizer import T5Tokenizer
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    # as served: cuDNN convs may use TF32 (the VAE decodes in f32), matmuls not
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    tok = ClipTokenizer.from_pretrained(tok_dir)
    tok.model_max_length = clip_text.CLIP_L.max_positions
    transformer = flux.init_params(gen, flux.FLUX_DEV, dtype=bf16, device="cuda")
    t5_params = t5.init_params(gen, t5.T5_XXL, dtype=bf16, device="cuda")
    models = FluxModels(
        transformer, flux.FLUX_DEV,
        TextEncoderBundle(tok, clip_text.init_params(gen, clip_text.CLIP_L, dtype=bf16,
                                                     device="cuda"), clip_text.CLIP_L),
        t5_params, t5.T5_XXL, T5Tokenizer.from_pretrained(t5_tok_dir),
        vae_params=vae.init_params(gen, vae.FLUX_VAE, dtype=bf16, device="cuda"),
        vae_config=vae.FLUX_VAE,
    )
    engine = FluxSliderEngine(models, device="cuda", steps=FLUX_STEPS[1024], image_size=1024,
                              guidance_scale=3.5, compute_dtype=bf16)
    for name in ("s1", "s2"):
        w = create_slider_network(gen, transformer, rank=4, alpha=1.0, train_method="xattn",
                                  device="cuda")
        for e in w.values():  # nonzero up, so the scale changes the image
            e["up"] = torch.randn(e["up"].shape, generator=gen, device="cuda") * 0.05
        engine.register_slider(name, w)
    torch.cuda.synchronize()
    n_flux = sum(t.numel() for t in _leaves(transformer))
    n_t5 = sum(t.numel() for t in _leaves(t5_params))
    say("flux", f"FLUX-dev transformer {n_flux / 1e9:.3f} B params (19 + 38 blocks, D 3072, 24 "
        f"heads, d 128) + T5-XXL encoder {n_t5 / 1e9:.3f} B + CLIP-L + FLUX VAE on "
        f"{engine.device}, bf16, 1024 px, FlowMatch {FLUX_STEPS[1024]} steps (cut from 30), "
        f"guidance 3.5, 2 rank-4 xattn sliders ({len(w)} modules each): built in "
        f"{time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return engine


def phase_flux_step(engine) -> dict:
    """One FLUX-dev transformer forward at bucket 8, 1024 px (4096 image + 512
    text tokens), bf16, slider on at per-row scales: its launches (57 of #1,
    none of #4), the median of 3 synced steps, then torch.profiler over one
    step by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.ops.basic import SliderLora

    m = engine.models
    cfg = m.transformer_config
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, hw = 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    x, pooled, t5e = randn(B, (hw // 2) ** 2, 64), randn(B, 768), randn(B, 512, 4096)
    t = torch.full((B,), 0.5, device="cuda")
    g = torch.full((B,), 3.5, device="cuda")
    lora = SliderLora(engine.sliders["s1"], torch.linspace(-2, 2, B, device="cuda"))
    img_ids, txt_ids = flux.image_ids(hw, hw), flux.text_ids(512)

    def step():
        with torch.inference_mode():
            return flux.apply(m.transformer_params, cfg, x, t, pooled, t5e, txt_ids, img_ids,
                              guidance=g, lora=lora)

    sa.sd_attention.launches = fa.flash_attention.launches = 0
    v = step()
    torch.cuda.synchronize()
    per_step = (sa.sd_attention.launches, fa.flash_attention.launches)
    if v.shape != (B, (hw // 2) ** 2, 64) or not torch.isfinite(v).all():
        raise AssertionError(f"the FLUX step gave {tuple(v.shape)} or non-finite values")
    if per_step != (FLUX_BLOCKS, 0):
        raise AssertionError(f"the FLUX step launched (#1, #4) {per_step}, not ({FLUX_BLOCKS}, 0)")
    ms = median_ms(step, runs=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_class = by_kernel_class(prof)
    busy = sum(by_class.values())
    say("flux", f"transformer step, bucket 8, 1024 px, bf16, slider on: median {ms:.1f} ms "
        f"(launches per step: #1 {per_step[0]}, #4 {per_step[1]}); device ms per step by kernel "
        f"class: " + ", ".join(f"{c} {v:.1f} ({v / busy * 100:.1f}%)"
                               for c, v in sorted(by_class.items(), key=lambda kv: -kv[1]))
        + f"; idle share {(1 - busy / wall) * 100:.1f}% (profiler on, 1 step); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say("flux", f"top kernels over the profiled step: {top_kernels(prof)}")
    return {"ms": ms, "sd_per_step": per_step[0]}


def flux_image_px(engine) -> int:
    """The engine's image side: its latents (image_size / 8) upsampled by
    the VAE's decoder blocks."""
    return engine.image_size // 8 * 2 ** (len(engine.models.vae_config.block_out_channels) - 1)


def phase_flux_http(engine) -> dict:
    """FLUX-dev at 1024 px behind the HTTP server: `sweep_and_pair`, then (c)
    (a) again with skip_till past the last step: every image must equal
    (a)'s scale-0 image (the same batch shape and rows, so no summation
    order changes); /healthz. #1 must launch 57 x steps x batches, #4 once
    per batch (the VAE's mid attention). Then NO_SLIDER_REQUEST; returns
    (a)'s and its PNGs beside the counts."""
    import torch

    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    steps, size = engine.steps, flux_image_px(engine)

    def run(port):
        stats0 = dict(engine.stats)
        torch.cuda.reset_peak_memory_stats()
        sa.sd_attention.launches = fa.flash_attention.launches = 0
        replies = sweep_and_pair(engine, port, size, "flux")
        t0 = time.perf_counter()
        gated = post(port, "/generate", {"prompt": "a photo of a person", "seed": 1,
                                         "slider": "s1", "scales": SWEEP, "skip_till": steps})
        say("flux", f"/generate c (skip_till {steps}): {len(gated['images'])} images, server "
            f"latency {gated['latency_ms']} ms, client {(time.perf_counter() - t0) * 1e3:.1f} ms")
        px_a = replies["px_a"]
        gate_diff = [0 if pc == px_a[2] else sum(a != b for a, b in zip(pc, px_a[2]))
                     for pc in check_images(gated, SWEEP, "flux c", size)]
        health = healthz(port)
        batches = engine.stats["batches"] - stats0["batches"]
        rows = engine.stats["rows"] - stats0["rows"]
        sd, flash = sa.sd_attention.launches, fa.flash_attention.launches
        expected = FLUX_BLOCKS * steps * batches
        say("flux", f"skip_till {steps} (past the last step): pixels differing from (a)'s "
            f"scale-0 image per scale {gate_diff} (must be 0); /healthz {health['family']}, "
            f"stats {health['stats']}; {batches} batches ({rows} rows); launches #1 {sd} "
            f"(expected {FLUX_BLOCKS} x {steps} x {batches} = {expected}), #4 {flash} (expected "
            f"{batches}, the VAE's mid attention); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if health["family"] != "flux":
            raise AssertionError(f"FLUX /healthz answered {health}")
        if any(gate_diff):
            raise AssertionError("skip_till past the last step did not give the scale-0 image")
        if batches != 3 or rows != 14:
            raise AssertionError("the two FLUX (b) requests were not coalesced into one batch")
        if sd != expected or flash != batches:
            raise AssertionError("not every FLUX joint attention went through kernel #1")
        # the world-1 images of phase_mesh_flux's pp = 2 engine: (a) and a
        # request with no slider
        none = post(port, "/generate", NO_SLIDER_REQUEST)
        check_images(none, [0.0], "flux no slider", size)
        return {"sd": sd, "flash": flash,
                "pngs": {"a": [base64.b64decode(im["png"]) for im in replies["a"][0]["images"]],
                         "none": [base64.b64decode(im["png"]) for im in none["images"]]}}

    return serve_http(engine, run)


def phase_flux_2048(models, sliders: dict) -> dict:
    """A second FluxSliderEngine at 2048 px on the same models (L = 512 +
    128**2 = 16896: kernel #1's TPU plan refuses it, so #4): one /generate of
    one scale, then the 5-scale sweep (bucket 8), each with its peak device
    memory. #4 must launch 57 x steps times plus once per VAE decode call
    (the engine decodes `decode_rows` rows at a time), #1 never."""
    import torch

    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.serving.server import FluxSliderEngine

    engine = FluxSliderEngine(models, device="cuda", steps=FLUX_STEPS[2048], image_size=2048,
                              guidance_scale=3.5, compute_dtype=torch.bfloat16)
    engine.register_slider("s1", sliders["s1"])

    def request(port, scales, bucket):
        # return the cached blocks of the previous request first: the sweep
        # peaks at about 68 GB of the card's 80
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sa.sd_attention.launches = fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        reply = post(port, "/generate", {"prompt": "a photo of a very old person", "seed": 4,
                                         "slider": "s1", "scales": scales})
        wall = time.perf_counter() - t0
        check_images(reply, scales, "flux 2048", flux_image_px(engine))
        sd, flash = sa.sd_attention.launches, fa.flash_attention.launches
        decodes = -(-bucket // engine.decode_rows)
        expected = FLUX_BLOCKS * FLUX_STEPS[2048] + decodes
        say("flux", f"2048 px engine, {FLUX_STEPS[2048]} steps (cut from 30): /generate "
            f"{len(scales)} images 2048x2048 (bucket {bucket}), server latency "
            f"{reply['latency_ms']} ms, client {wall * 1e3:.1f} ms; launches #4 {flash} (expected "
            f"{FLUX_BLOCKS} x {FLUX_STEPS[2048]} + {decodes} VAE decode calls of "
            f"{engine.decode_rows} rows = {expected}), #1 {sd} (expected 0); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if flash != expected or sd != 0:
            raise AssertionError("not every FLUX joint attention at 2048 px went through #4")
        return flash

    def run(port):
        return {"flash": request(port, [1.0], 1), "flash_sweep": request(port, SWEEP, 8)}

    return serve_http(engine, run)


def flux_train_config(tmp: str, px: int, tp: int = 1) -> tuple:
    """The FLUX training run's config (data/config.yaml's values with the
    xattn method, FLUX_TRAIN_ITERATIONS[px] iterations, max_denoising_steps
    FLUX_TRAIN_STEPS, `tpu.tp` = tp) and prompts (data/prompts.yaml's pairs
    at `px`), written under `tmp`: (RootConfig, prompts, the config dict)."""
    from sliders_tpu_torch.core import config as config_util
    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.prompts import load_prompts_from_yaml

    cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
    pairs = yaml_subset.load(os.path.join(REPO, "data", "prompts.yaml"))
    prompts_path = os.path.join(tmp, f"flux_prompts_{px}.yaml")
    with open(prompts_path, "w") as f:
        for pair in pairs:
            f.write("\n".join(f"{'- ' if i == 0 else '  '}{k}: {json.dumps(v)}"
                              for i, (k, v) in enumerate({**pair, "resolution": px}.items())) + "\n")
    cfg["prompts_file"] = prompts_path
    cfg["pretrained_model"]["name_or_path"] = "flux-dev (random weights, in memory)"
    cfg["network"]["training_method"] = "xattn"
    cfg["train"].update(iterations=FLUX_TRAIN_ITERATIONS[px], max_denoising_steps=FLUX_TRAIN_STEPS)
    cfg["save"]["path"] = os.path.join(tmp, f"flux_train_{px}_tp{tp}")
    cfg["logging"] = {**cfg.get("logging", {}), "log_every": 1}
    cfg["tpu"] = {**cfg.get("tpu", {}), "dp": 1, "tp": tp}
    path = os.path.join(tmp, f"flux_train_{px}_tp{tp}.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    return config_util.load_config_from_yaml(path), load_prompts_from_yaml(prompts_path, []), cfg


def flux_train_run(models, tmp: str, px: int, lora: dict, profile: bool = False) -> dict:
    """`train_flux_sliders` on the in-memory FLUX-dev at `px` with the values
    of data/config.yaml (bf16, remat, rank 4, alpha 1, AdamW lr 2e-4) but the
    FLUX slider method xattn (266 modules, ortho-up), data/prompts.yaml's
    pairs at `px`, T5 length 512, FLUX_TRAIN_ITERATIONS[px] iterations and
    max_denoising_steps FLUX_TRAIN_STEPS (`flux_train_config`), from `lora`
    (the driver's ortho-up draw, made once by phase_flux_train). The
    kernels' counts are set to 0 just before and read just after. With `profile`,
    torch.profiler records iteration 1 alone (started and stopped at the
    iteration boundaries, where the step has synced on its loss)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from sliders_tpu_torch.training.driver import train_flux_sliders

    config, prompts, cfg = flux_train_config(tmp, px)
    records = []  # (iteration, host start, host end, metrics)
    prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile else None

    def on_step(i, state, m):
        records.append((i, start[0], time.perf_counter(), m))
        if prof is not None and i in (0, 1):
            prof.start() if i == 0 else prof.stop()
        start[0] = time.perf_counter()  # the profiler's start and stop belong to no iteration

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flux_counts()
    t0 = time.perf_counter()
    start = [t0]
    final = train_flux_sliders(config, prompts, models, seed=0, t5_len=512, on_step=on_step,
                               lora=lora)
    torch.cuda.synchronize()
    return {"records": records, "seconds": time.perf_counter() - t0,
            "counts": flux_counts(), "lora": final, "prof": prof,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "cfg": cfg}


def phase_flux_train(models, tmp: str) -> dict:
    """FLUX-dev slider training at full width on the serving phases' models:
    FLUX_TRAIN_ITERATIONS at 512 px (L = 1024 + 512: #1 forward, #2 backward)
    and at 2048 px (L = 16896: #4 forward and backward). Launches are exact:
    57 blocks x (t_to denoise + 1 frozen + 2 grad with remat) forward and 57
    backward per iteration. Both runs start from one ortho-up draw of the
    driver's (seed + 1 on the card), made here once. Every down must move,
    every up and alpha must equal the init bit for bit (the ortho-up mask
    freezes them), every loss be finite; per iteration the host wall time and the device ms by
    phase, and the peak device memory, are printed."""
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    init = create_slider_network(torch.Generator(device="cuda").manual_seed(1),
                                 models.transformer_params, rank=4, alpha=1.0,
                                 train_method="xattn", ortho_up=True, device="cuda")
    init = {m: {k: t.cpu() for k, t in e.items()} for m, e in init.items()}
    say("flux", f"ortho-up init of {len(init)} xattn modules on the card (the driver's draw, "
        f"the runs' start): {time.perf_counter() - t0:.1f} s")
    out = {}
    for px in FLUX_TRAIN_ITERATIONS:
        run = flux_train_run(models, tmp, px, init, profile=px == 512)
        recs, c = run["records"], run["counts"]
        t_tos = [m["t_to"] for *_, m in recs]
        fwd_expected = FLUX_BLOCKS * sum(t + 3 for t in t_tos)
        bwd_expected = FLUX_BLOCKS * len(recs)
        fwd_plans, plans = dict.fromkeys(c["fwd_plans"], 0), dict.fromkeys(c["bwd_plans"], 0)
        if px == 2048:  # bf16 d = 128: #4's forward on "sm90", its backward on PAIR
            expected = {"sd": 0, "sd_bwd": 0, "flash": fwd_expected, "dkv": bwd_expected,
                        "dq": bwd_expected, "fwd_plans": {**fwd_plans, "sm90": fwd_expected},
                        "bwd_plans": {**plans, "pair": 2 * bwd_expected}}
        else:
            expected = {"sd": fwd_expected, "sd_bwd": bwd_expected, "flash": 0, "dkv": 0, "dq": 0,
                        "fwd_plans": fwd_plans, "bwd_plans": plans}
        final = run["lora"]
        moved = sum(not torch.equal(final[m]["down"], init[m]["down"]) for m in init)
        frozen = sum(torch.equal(final[m]["up"], init[m]["up"])
                     and torch.equal(final[m]["alpha"], init[m]["alpha"]) for m in init)
        losses = [m["loss"] for *_, m in recs]
        times = [te - ts for _, ts, te, _ in recs]
        for (i, *_, m), wall in zip(recs, times):
            ph = m["phase_ms"]
            say("flux", f"train {px} px iteration {i}: pair {m['pair']}, t_to {m['t_to']}, loss "
                f"{m['loss']:.6g}, grad norm {m['grad_norm']:.4g}; host wall {wall:.3f} s"
                f"{' (with the prompt encodes)' if i == 0 else ''}"
                f"{' (profiler on)' if run['prof'] is not None and i == 1 else ''}; device ms: denoise "
                f"{ph['denoise']:.1f} ({ph['denoise'] / m['t_to']:.1f} per forward), frozen "
                f"{ph['frozen']:.1f}, grad {ph['grad']:.1f}, update {ph['update']:.2f}")
        if run["prof"] is not None:
            by_class = by_kernel_class(run["prof"])
            busy, wall = sum(by_class.values()), times[1] * 1e3
            say("flux", f"train {px} px iteration 1 under torch.profiler: host wall {wall:.1f} ms, "
                f"device busy {busy:.1f} ms, idle share {(1 - busy / wall) * 100:.1f}% (profiler "
                "on); device ms by kernel class: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))
        say("flux", f"train {px} px (bf16, remat, rank 4 xattn ortho-up, AdamW lr "
            f"{run['cfg']['train']['lr']}, T5 512, max_denoising_steps {FLUX_TRAIN_STEPS} cut from "
            f"50): {len(recs)} iterations in {run['seconds']:.1f} s; launches {c} (expected "
            f"{expected}); {moved} of {len(init)} down factors moved, {frozen} up/alpha pairs bit "
            f"for bit unchanged; peak device memory {run['peak_gb']:.2f} GB")
        if [r[0] for r in recs] != list(range(FLUX_TRAIN_ITERATIONS[px])):
            raise AssertionError(f"the {px} px run did not take every iteration")
        if c != expected:
            raise AssertionError(f"the {px} px FLUX training run's launches {c} are not {expected}")
        if moved != len(init) or frozen != len(init) or not all(map(math.isfinite, losses)):
            raise AssertionError(f"the {px} px FLUX training run's LoRA or losses are wrong")
        out[px] = {"counts": c, "peak_gb": run["peak_gb"],
                   "metrics": [{k: m[k] for k in ("t_to", "pair", "loss", "grad_norm")}
                               for *_, m in recs]}
    out["init"] = init
    return out


def phase_flux(tmp: str) -> dict:
    """Phase 7: FLUX-dev serving at 1024 and 2048 px, then training at 512 and
    2048 px on the same models."""
    import torch

    tok_dir, t5_dir = os.path.join(tmp, "tokenizer"), os.path.join(tmp, "tokenizer_2")
    os.makedirs(tok_dir)
    write_tokenizer(tok_dir)
    write_t5_tokenizer(t5_dir)
    engine = timed("flux build", build_flux_engine, tok_dir, t5_dir)
    step = timed("flux step", phase_flux_step, engine)
    served = timed("flux serving 1024 px", phase_flux_http, engine)
    torch.cuda.empty_cache()
    big = timed("flux serving 2048 px", phase_flux_2048, engine.models, engine.sliders)
    models, slider = engine.models, engine.sliders["s1"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    train = timed("flux training", phase_flux_train, models, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    scalar = timed("flux scalar", phase_flux_scalar, models, slider)
    return {"step": step, "serve_1024": served, "serve_2048": big, "train": train,
            "scalar": scalar}


# ---------------------------------------------------------------------------
# kernel #9 and SDXL-base
# ---------------------------------------------------------------------------


def per_call_ms(fn, calls: int = 20) -> float:
    """Median ms of one call, from CUDA-event timings of `calls` calls in a
    row (a single call of a fast kernel is mostly launch overhead)."""
    return median_ms(lambda: [fn() for _ in range(calls)]) / calls


def phase_layout_pin_kernel():
    """Kernel #9 against its plain version at the SDXL serving boundary
    shapes, in bf16 and f32, on a contiguous tensor, the channel-major view
    of an NCHW buffer and a slice of wider rows: max abs error 0 (the bits
    are copied) and a contiguous output. Its gradient through `LayoutPin` is
    the identity. Median ms beside its bound (2 x bytes / 3.35 TB/s), its
    plain version and `.contiguous()` (`torch.clone` of a contiguous input)."""
    import torch

    from sliders_tpu_torch.ops import layout_pin as lp

    gen = torch.Generator(device="cuda").manual_seed(21)
    out = []
    for B, L, C in PIN_SHAPES:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            views = {
                "contiguous": torch.randn((B, L, C), generator=gen, device="cuda").to(dtype),
                "channel_major": torch.randn((B, C, L), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2),
                "sliced": torch.randn((B, L, C + 64), generator=gen, device="cuda")
                .to(dtype)[..., 32:C + 32],
            }
            for kind, x in views.items():
                y = lp.layout_pin_copy(x)
                ref = lp.layout_pin_ref(x)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                as_int = torch.int16 if dt == "bfloat16" else torch.int32
                if err != 0 or not torch.equal(y.view(as_int), ref.view(as_int)) or (
                        not y.is_contiguous()):
                    raise AssertionError(f"kernel #9 at {(B, L, C)} {dt} {kind}: max|err| {err}")
                b_ms, b_by = bound(0, 2 * x.numel() * x.element_size(), dt)
                library = (lambda x=x: torch.clone(x)) if x.is_contiguous() else x.contiguous
                r = {"shape": (B, L, C), "dtype": dt, "view": kind, "err": err,
                     "ms": per_call_ms(lambda: lp.layout_pin_copy(x)),
                     "plain_ms": per_call_ms(lambda: lp.layout_pin_ref(x)),
                     "library_ms": per_call_ms(library), "bound_ms": b_ms, "bound_by": b_by}
                say("kernel", f"#9 layout pin {(B, L, C)} {dt} {kind}: max|err| 0, contiguous; "
                    f"{r['ms']:.4f} ms (bound {b_ms:.4f}, {b_ms / r['ms'] * 100:.0f}% of it; "
                    f"plain {r['plain_ms']:.4f}, .contiguous()/clone {r['library_ms']:.4f})")
                out.append(r)
            del views, x, y, ref
    x = torch.randn((2, 1024, 1280), generator=gen, device="cuda").bfloat16().requires_grad_()
    g = torch.randn((2, 1024, 1280), generator=gen, device="cuda").bfloat16().transpose(0, 1)
    g = g.contiguous().transpose(0, 1)  # a strided cotangent
    y = lp.LayoutPin.apply(x)
    (gx,) = torch.autograd.grad(y, x, g)
    if not (torch.equal(y, x.detach()) and torch.equal(gx, g) and gx.is_contiguous()):
        raise AssertionError("LayoutPin's forward or gradient is not the identity")
    say("kernel", "#9 through LayoutPin: output and gradient (of a strided cotangent) equal "
        "their inputs bit for bit, both contiguous")
    return out


def f16_tolerance(ref_max: float, ulps: int = F16_ULPS) -> float:
    """`ulps` f16 ulps (11 significant bits) at the output's largest magnitude."""
    return ulps * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-14))) - 10)


def f16_max_ulps(out, ref) -> float:
    """bf16_max_ulps in f16 ulps: each element's error in ulps of its own
    reference value (floored at 2**-6 of the largest)."""
    import torch

    r = ref.float().abs()
    floor = max(r.max().item(), 2.0**-14) * 2.0**-6
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(r, min=floor))) - 10)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


def phase_f16_kernels() -> dict:
    """The f16 kernels of `precision: fp16` against their plain versions on
    the same inputs, each timed beside its bf16 twin on the same values
    rounded to bf16, in turns (F16_TURNS rounds): #1 at F16_SD_SHAPES and #2 at F16_BWD_SHAPES (F16_ULPS
    f16 ulps at each output's largest magnitude; SDPA in f16, and its
    backward, timed beside), #9 at F16_PIN_SHAPE contiguous and channel-major
    (bit for bit; `torch.clone` / `.contiguous()` beside), #5-#7 at
    F16_CONV_SHAPES on the Hopper mainloop (F16_CONV_ULPS f16 ulps of each
    element; cuDNN's f16 conv + bias and phase_conv_kernels' library
    expressions beside) and all three on the generic kernel at
    F16_CONV_GENERIC (not timed). Bounds at 989 TFLOP/s f16 and 3.35 TB/s.
    An f16 kernel past F16_SLOWER x its bf16 twin is printed as a finding.
    Returns the rows by kernel."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import conv3x3 as tc
    from sliders_tpu_torch.ops import layout_pin as lp
    from sliders_tpu_torch.ops import sd_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = {k: [] for k in ("sd_attention_fwd", "sd_attention_bwd", "layout_pin", "conv3x3",
                            "epi_conv3x3", "fused_conv3x3")}
    findings = []

    def turns(f16_fn, bf16_fn, timer=median_ms, rounds=F16_TURNS):
        """f16 and its bf16 twin timed in turns (f16, bf16, bf16, f16, ...):
        the mean of each side's medians."""
        ms = {"f16": [], "bf16": []}
        for r in range(rounds):
            for side in (("f16", "bf16") if r % 2 == 0 else ("bf16", "f16")):
                ms[side].append(timer(f16_fn if side == "f16" else bf16_fn))
        return statistics.mean(ms["f16"]), statistics.mean(ms["bf16"])

    def row(kernel, what, **r):
        r["bf16_ratio"] = r["ms"] / r["bf16_ms"]
        if r["bf16_ratio"] > F16_SLOWER:
            findings.append(f"{kernel} {what} {r['bf16_ratio']:.3f}x its bf16 twin")
        rows[kernel].append(r)
        return r

    for shape in F16_SD_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").half() for _ in range(3))
        out, ref = sa.sd_attention(q, k, v), sa.sd_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = f16_tolerance(ref.float().abs().max().item())
        if not (err <= tol and out.dtype == torch.float16 and out.shape == shape):
            raise AssertionError(f"#1 f16 disagrees with its plain version at {shape}")
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        b_ms, b_by = attention_bound(shape, "float16")
        ms, bf16_ms = turns(lambda: sa.sd_attention(q, k, v), lambda: sa.sd_attention(qb, kb, vb))
        r = row("sd_attention_fwd", str(shape), shape=shape, err=err, ms=ms, bf16_ms=bf16_ms,
                plain_ms=median_ms(lambda: sa.sd_attention_ref(q, k, v)),
                library_ms=median_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                bound_ms=b_ms, bound_by=b_by)
        say("f16", f"#1 {shape} f16: max|err| {err:.3g} (tol {tol:.3g}); kernel {r['ms']:.4f} ms "
            f"(bf16 twin {r['bf16_ms']:.4f}, {r['bf16_ratio']:.3f}x), plain {r['plain_ms']:.4f}, "
            f"SDPA f16 {r['library_ms']:.4f}; bound {b_ms:.4f} ms ({b_by})")
        del q, k, v, qb, kb, vb, out, ref
    for shape in F16_BWD_SHAPES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").half() for _ in range(4))
        out, ref = sa.sd_attention_bwd(q, k, v, g), sa.sd_attention_bwd_ref(q, k, v, g)
        torch.cuda.synchronize()
        errs, worst = [], 0.0
        for name, o, r_ in zip(("dq", "dk", "dv"), out, ref):
            err = (o.float() - r_.float()).abs().max().item()
            tol = f16_tolerance(r_.float().abs().max().item())
            errs.append(f"{name} {err:.3g} (tol {tol:.3g})")
            if not (err <= tol and o.dtype == torch.float16 and o.shape == shape):
                raise AssertionError(f"#2 f16 disagrees with its plain version at {shape}")
            worst = max(worst, err)
        qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, g))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves)
        b_ms, b_by = attention_bound(shape, "float16", backward=True)
        ms, bf16_ms = turns(lambda: sa.sd_attention_bwd(q, k, v, g),
                            lambda: sa.sd_attention_bwd(qb, kb, vb, gb))
        r = row("sd_attention_bwd", str(shape), shape=shape, err=worst, ms=ms, bf16_ms=bf16_ms,
                plain_ms=median_ms(lambda: sa.sd_attention_bwd_ref(q, k, v, g), runs=5),
                library_ms=median_ms(lambda: torch.autograd.grad(o, leaves, g,
                                                                 retain_graph=True)),
                bound_ms=b_ms, bound_by=b_by)
        # the grad pass's g, 2 diff / N with no loss scaling, lies in f16's
        # subnormal range: there too both round ds and the outputs alike
        gs = (g.float() * 2.0**-16).half()
        small = [(o.float() - r_.float()).abs().max().item() / f16_tolerance(
            r_.float().abs().max().item()) for o, r_ in zip(
                sa.sd_attention_bwd(q, k, v, gs), sa.sd_attention_bwd_ref(q, k, v, gs))]
        if max(small) > 1:
            raise AssertionError(f"#2 f16 disagrees with its plain version at {shape} with g in "
                                 f"the subnormal range: {small} of the tolerance")
        say("f16", f"#2 {shape} f16: max|err| {', '.join(errs)}; with g x 2^-16 (subnormal) "
            f"{max(small):.3f} of the tolerance; kernel {r['ms']:.4f} ms (bf16 "
            f"twin {r['bf16_ms']:.4f}, {r['bf16_ratio']:.3f}x), plain {r['plain_ms']:.4f}, SDPA "
            f"f16 backward {r['library_ms']:.4f}; bound {b_ms:.4f} ms ({b_by})")
        del q, k, v, g, gs, qb, kb, vb, gb, leaves, o, out, ref
    B, L, C = F16_PIN_SHAPE
    for kind in ("contiguous", "channel_major"):
        x = torch.randn((B, L, C) if kind == "contiguous" else (B, C, L), generator=gen,
                        device="cuda").half()
        x = x if kind == "contiguous" else x.transpose(1, 2)
        y = lp.layout_pin_copy(x)
        torch.cuda.synchronize()
        if not (y.is_contiguous() and torch.equal(y.view(torch.int16),
                                                  lp.layout_pin_ref(x).view(torch.int16))):
            raise AssertionError(f"#9 f16 at {F16_PIN_SHAPE} {kind} is not a bit-exact copy")
        xb = x.bfloat16()
        b_ms, b_by = bound(0, 2 * x.numel() * 2, "float16")
        ms, bf16_ms = turns(lambda: lp.layout_pin_copy(x), lambda: lp.layout_pin_copy(xb),
                            timer=per_call_ms)
        r = row("layout_pin", kind, shape=F16_PIN_SHAPE, view=kind, err=0.0, ms=ms,
                bf16_ms=bf16_ms,
                plain_ms=per_call_ms(lambda: lp.layout_pin_ref(x)),
                library_ms=per_call_ms((lambda: torch.clone(x)) if kind == "contiguous"
                                       else x.contiguous),
                bound_ms=b_ms, bound_by=b_by)
        say("f16", f"#9 {F16_PIN_SHAPE} f16 {kind}: bit for bit; {r['ms']:.4f} ms (bf16 twin "
            f"{r['bf16_ms']:.4f}, {r['bf16_ratio']:.3f}x; bound {b_ms:.4f}, plain "
            f"{r['plain_ms']:.4f}, clone / .contiguous() {r['library_ms']:.4f})")
        del x, xb, y
    cases = [(16, h, c, n, mode, True) for h, c, n, mode in F16_CONV_SHAPES]
    cases.append((*F16_CONV_GENERIC, False))
    for Bc, H, Cc, N, mode, timed_case in cases:
        want = "hopper" if timed_case else "generic"
        x, a, s_, w, b, extra = conv_case(Bc, H, Cc, N, mode, torch.float16, gen)
        xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        eb = None if extra is None else extra.bfloat16()
        xc, extra_c = x.permute(0, 3, 1, 2), (
            None if extra is None else extra[:, :, None, None] if mode == "temb"
            else extra.permute(0, 3, 1, 2))

        def epi_library(inp=xc):
            y_ = F.conv2d(inp, w, b, padding=1)
            return y_ if extra_c is None else y_ + extra_c

        calls = {  # kernel, its plain version, its bf16 twin, one PyTorch expression
            "conv3x3": (lambda: tc.conv3x3(x, w, b), lambda: tc.conv3x3_ref(x, w, b),
                        lambda: tc.conv3x3(xb, wb, bb), lambda: F.conv2d(xc, w, b, padding=1)),
            "epi_conv3x3": (lambda: tc.epi_conv3x3(x, w, b, extra, mode),
                            lambda: tc.epi_conv3x3_ref(x, w, b, extra, mode),
                            lambda: tc.epi_conv3x3(xb, wb, bb, eb, mode), epi_library),
            "fused_conv3x3": (lambda: tc.fused_conv3x3(x, a, s_, w, b, extra, mode),
                              lambda: tc.fused_conv3x3_ref(x, a, s_, w, b, extra, mode),
                              lambda: tc.fused_conv3x3(xb, a, s_, wb, bb, eb, mode),
                              lambda: epi_library(F.silu(xc.float() * a[:, :, None, None]
                                                         + s_[:, :, None, None]).half())),
        }
        parts = []
        for name, (kernel, plain, twin, library) in calls.items():
            fn = getattr(tc, name)
            took = fn.variants[want]
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            ulps = f16_max_ulps(out, ref)
            if fn.variants[want] != took + 1 or ulps > F16_CONV_ULPS or out.dtype != torch.float16:
                raise AssertionError(f"{name} f16 at {(Bc, H, H, Cc)}x{N} {mode}: {ulps:.2f} "
                                     f"ulps on {fn.variants}")
            err = (out.float() - ref.float()).abs().max().item()
            del out, ref
            if not timed_case:
                parts.append(f"{name} {ulps:.2f} ulps")
                continue
            extra_n = {"none": 0, "temb": Bc * N, "residual": Bc * H * H * N}[mode]
            nbytes = 2 * (Bc * H * H * Cc + 9 * Cc * N + N + extra_n + Bc * H * H * N)
            nbytes += 8 * Bc * Cc if name == "fused_conv3x3" else 0
            b_ms, b_by = bound(2 * 9 * Bc * H * H * Cc * N, nbytes, "float16")
            ms, bf16_ms = turns(kernel, twin)
            r = row(name, f"{(Bc, H, H, Cc)}->{N} {mode}", shape=(Bc, H, H, Cc, N), mode=mode,
                    err=err, ms=ms, bf16_ms=bf16_ms,
                    plain_ms=median_ms(plain, runs=5), library_ms=median_ms(library),
                    bound_ms=b_ms, bound_by=b_by)
            parts.append(f"{name} {ulps:.2f} ulps (tol {F16_CONV_ULPS}), {r['ms']:.4f} ms (bf16 "
                         f"twin {r['bf16_ms']:.4f}, {r['bf16_ratio']:.3f}x), plain "
                         f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
                         f"{b_ms:.4f} ({b_by})")
        say("f16", f"conv ({Bc}, {H}, {H}, {Cc})->{N} {mode} f16 [{want}]: " + "; ".join(parts)
            + ("" if timed_case else " (not timed)")
            + (" (library: cuDNN f16 conv + bias, + extra for #7, silu(x a + s) before it "
               "for #6)" if timed_case else ""))
        del x, a, s_, w, b, extra, xb, wb, bb, eb, calls
        torch.cuda.empty_cache()
    say("f16", "findings (an f16 kernel past " + f"{F16_SLOWER}x its bf16 twin): "
        + ("; ".join(findings) if findings else "none"))
    return rows


def phase_tiny_sdxl():
    """TINY_XL (text_time conditioning, linear projections) at TINY_XL_PX in
    f32, TF32 off, with the layout pin on, on the GPU (the kernels: #1 at
    the L = 1024 level, #2 in the grad pass, #9 at the transformer
    boundaries) against the CPU (plain paths; there the pin is the
    identity). One forward with a slider at per-row scales, held to 1e-5 of
    its largest value; then three XL train steps of a dynamic-crop pair, held
    as the tiny FLUX training is: losses 1e-5 relative, grad norms 1e-4,
    the LoRA after the last update 1e-6 at lr TINY_XL_LR. Launches are
    exact."""
    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import layout_pin as lp
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.ops.basic import SliderLora
    from sliders_tpu_torch.training.text_slider import step_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, hw = unet2d.TINY_XL, TINY_XL_PX // 8
    gen = torch.Generator().manual_seed(31)
    unet = unet2d.init_params(gen, cfg)
    lora = create_slider_network(gen, unet, rank=4, train_method="noxattn")
    slider = {m: {**e, "up": torch.randn(e["up"].shape, generator=gen) * 0.1}
              for m, e in lora.items()}
    x = torch.randn((3, hw, hw, 4), generator=gen)
    ctx = torch.randn((3, 7, 32), generator=gen)
    added = {"text_embeds": torch.randn((3, 16), generator=gen),
             "time_ids": torch.tensor([[512.0, 512, 0, 0, 512, 512], [1024, 768, 40, 8, 512, 512],
                                       [600, 700, 3, 90, 512, 512]])}
    t = torch.tensor([999.0, 500.0, 1.0])
    mult = torch.tensor([-1.0, 0.0, 2.0])

    def forward(device):
        with torch.inference_mode():
            return unet2d.apply(tree_to(unet, device), cfg, x.to(device), t.to(device),
                                ctx.to(device), added_cond={k: v.to(device) for k, v in added.items()},
                                lora=SliderLora(tree_to(slider, device), mult.to(device))).cpu()

    def counts():
        return (sa.sd_attention.launches, sa.sd_attention_bwd.launches, lp.layout_pin_copy.launches)

    pairs = {k: torch.randn((1, 8, 32), generator=gen)
             for k in ("target", "positive", "neutral", "unconditional")}
    pairs.update({f"pooled_{k}": torch.randn((1, 16), generator=gen) for k in list(pairs)})
    pairs["time_ids"] = torch.tensor([[512.0, 512, 0, 0, 512, 512]])
    pairs["dynamic_crops"] = torch.tensor([1.0])
    pairs["guidance_signed"] = torch.tensor([2.0])
    draws = [step_draws(31, i, 1, 5, (1, hw, hw, 4), 1.0, crop=True) for i in range(3)]
    basic.set_layout_pin(True)
    try:
        sa.sd_attention.launches = sa.sd_attention_bwd.launches = lp.layout_pin_copy.launches = 0
        gpu = forward("cuda")
        fwd_counts = counts()
        cpu = forward("cpu")
        sa.sd_attention.launches = sa.sd_attention_bwd.launches = lp.layout_pin_copy.launches = 0
        gpu_losses, gpu_norms, gpu_lora = tiny_train("cuda", unet, lora, pairs, draws, cfg,
                                                     TINY_XL_PX, TINY_XL_LR)
        train_counts = counts()
        cpu_losses, cpu_norms, cpu_lora = tiny_train("cpu", unet, lora, pairs, draws, cfg,
                                                     TINY_XL_PX, TINY_XL_LR)
    finally:
        basic.set_layout_pin(False)
    err, scale = (gpu - cpu).abs().max().item(), cpu.abs().max().item()
    t_tos = [d[1] for d in draws]
    train_expected = (TINY_XL_SD * sum(t + 3 for t in t_tos), TINY_XL_SD * len(draws),
                      sum(TINY_XL_PINS * (t + 2) + TINY_XL_PINS - 1 for t in t_tos))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_norms, cpu_norms))
    lora_err = max((gpu_lora[m][k] - cpu_lora[m][k]).abs().max().item()
                   for m in cpu_lora for k in ("down", "up"))
    say("kernel", f"tiny SDXL {TINY_XL_PX} px f32, pin on: forward GPU (#1, #2, #9 launches "
        f"{fwd_counts}, expected ({TINY_XL_SD}, 0, {TINY_XL_PINS})) vs CPU: max|err| {err:.3g} "
        f"(tol {1e-5 * scale:.3g}, max|eps| {scale:.3g}); 3 XL train steps of a dynamic-crop pair "
        f"(t_to {t_tos}): launches {train_counts} (expected {train_expected} = 8 x sum(t_to + 3), "
        f"8 x 3, sum(8 x (t_to + 2) + 7)), losses {[f'{v:.6g}' for v in gpu_losses]} vs "
        f"{[f'{v:.6g}' for v in cpu_losses]}, max rel err {loss_err:.3g} (tol 1e-5); grad norms "
        f"max rel err {norm_err:.3g} (tol 1e-4); LoRA max|err| {lora_err:.3g} (tol 1e-6)")
    if fwd_counts != (TINY_XL_SD, 0, TINY_XL_PINS) or train_counts != train_expected:
        raise AssertionError("tiny SDXL on the GPU did not go through the kernels exactly")
    if not torch.isfinite(gpu).all() or err > 1e-5 * scale:
        raise AssertionError("the tiny SDXL forward on the GPU disagrees with the CPU")
    if not (loss_err <= 1e-5 and norm_err <= 1e-4 and lora_err <= 1e-6):
        raise AssertionError("tiny SDXL training on the GPU disagrees with the CPU")
    return {"sd": fwd_counts[0] + train_counts[0], "sd_bwd": train_counts[1],
            "pin": fwd_counts[2] + train_counts[2]}


def build_sdxl_engine(tok_dir: str):
    """An SDXL SliderEngine at SDXL-base's full widths (UNet, CLIP-L, bigG
    with its projection, the SDXL VAE) in bf16 with seeded random weights
    drawn on the card, 1024 px, DDIM SDXL_HTTP_STEPS, guidance 7.5 with
    rescale 0.7, start_noise 750, and one rank-4 noxattn slider. Both
    tokenizers are the synthetic BPE one (tokenizer_2 pads with 0); the
    encoders' EOS id is its EOS, so the pooled output is read there."""
    import dataclasses

    import torch

    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import clip_text, unet2d, vae
    from sliders_tpu_torch.models.loader import SDModels, TextEncoderBundle
    from sliders_tpu_torch.serving.server import SliderEngine
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(40)
    tes = []
    for cfg, pad in ((clip_text.CLIP_L, None), (clip_text.CLIP_BIG_G, 0)):
        tok = ClipTokenizer.from_pretrained(tok_dir, pad_token_id=pad)
        tok.model_max_length = cfg.max_positions
        cfg = dataclasses.replace(cfg, eos_token_id=tok.eos_token_id)
        tes.append(TextEncoderBundle(tok, clip_text.init_params(gen, cfg, dtype=torch.bfloat16,
                                                                device="cuda"), cfg))
    unet = unet2d.init_params(gen, unet2d.SDXL, dtype=torch.bfloat16, device="cuda")
    models = SDModels(unet, unet2d.SDXL, tes,
                      vae_params=vae.init_params(gen, vae.SDXL_VAE, dtype=torch.bfloat16,
                                                 device="cuda"),
                      vae_config=vae.SDXL_VAE, is_xl=True)
    n_unet = sum(t.numel() for t in _leaves(unet))
    n_te = [sum(t.numel() for t in _leaves(te.params)) for te in tes]
    n_vae = sum(t.numel() for t in _leaves(models.vae_params))
    if n_unet != SDXL_UNET_PARAMS:
        raise AssertionError(f"the SDXL UNet has {n_unet:,} parameters, not {SDXL_UNET_PARAMS:,}")
    engine = SliderEngine(models, device="cuda", steps=SDXL_HTTP_STEPS, image_size=SDXL_PX,
                          guidance_scale=7.5, start_noise=750.0, compute_dtype=torch.bfloat16)
    w = create_slider_network(gen, unet, rank=4, alpha=1.0, train_method="noxattn",
                              device="cuda")
    for e in w.values():  # nonzero up, so the scale changes the image
        e["up"] = torch.randn(e["up"].shape, generator=gen, device="cuda") * 0.05
    engine.register_slider("s1", w)
    torch.cuda.synchronize()
    say("sdxl", f"SDXL-base at full width, bf16, random weights: UNet {n_unet:,} parameters "
        f"(diffusers' sdxl-base-1.0: {SDXL_UNET_PARAMS:,}), CLIP-L {n_te[0]:,}, bigG {n_te[1]:,}, "
        f"VAE {n_vae:,}; engine family {engine.family!r}, {SDXL_PX} px, DDIM {engine.steps}, "
        f"guidance 7.5 with rescale 0.7, 1 rank-4 noxattn slider ({len(w)} modules), decode "
        f"{engine.decode_rows} rows per VAE call: built in {time.perf_counter() - t0:.1f} s")
    return engine


def sdxl_step_bound(batch: int) -> tuple:
    """(ms, operations) of the least time of one CFG-doubled SDXL UNet
    forward of `batch` rows at SDXL_PX: the operations its convs, linears
    and attention products do, counted by torch's FLOP counter on the meta
    device from the config (no weights, no card), at the bf16 peak; the
    weights' bytes give a bound below it."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import attention as ta

    cfg, hw, dt = unet2d.SDXL, SDXL_PX // 8, torch.bfloat16
    params = unet2d.init_params(None, cfg, dtype=dt, device="meta")
    x = torch.empty((batch, hw, hw, 4), dtype=dt, device="meta")
    ctx = torch.empty((batch, 77, cfg.cross_attention_dim), dtype=dt, device="meta")
    added = {"text_embeds": torch.empty((batch, 1280), dtype=dt, device="meta"),
             "time_ids": torch.empty((batch, 6), device="meta")}
    ta.set_attention_impl("xla")  # attention as two counted batched products
    try:
        with FlopCounterMode(display=False) as counter, torch.inference_mode():
            unet2d.apply(params, cfg, x, torch.tensor(1.0, device="meta"), ctx, added_cond=added)
    finally:
        ta.set_attention_impl("auto")
    flops = counter.get_total_flops()
    nbytes = 2 * sum(t.numel() for t in _leaves(params))
    return bound(flops, nbytes, "bfloat16")[0], flops


def sdxl_step_fn(engine):
    """(step, latents): one SDXL denoise step at bucket 8 (16 CFG rows),
    SDXL_PX, bf16, through the engine's sampling function with one DDIM
    step, a rank-4 slider at per-row scales, added conditioning and
    guidance rescale 0.7."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.pipelines import text2image as t2i

    m = engine.models
    gen = torch.Generator(device="cuda").manual_seed(41)
    B, hw = 8, SDXL_PX // 8
    lat = torch.randn((B, hw, hw, 4), generator=gen, device="cuda")
    cond, uncond, added = t2i.tile_conditioning(
        *t2i.encode_conditioning(m, "a photo of a person", "", SDXL_PX), B)
    fn = t2i.make_sampling_fn(m.unet_config, make_sampler(make_schedule(), "ddim", 1),
                              guidance_rescale=0.7, compute_dtype=torch.bfloat16)
    scales = torch.linspace(-2, 2, B, device="cuda")
    sn, g = torch.full((B,), 1000.0, device="cuda"), torch.full((B,), 7.5, device="cuda")

    def step():
        return fn(m.unet_params, lat, cond, uncond, engine.sliders["s1"], scales, sn, g, added)

    return step, lat


def phase_sdxl_conv_step(engine, rounds: int = 1) -> dict:
    """The SDXL step of `phase_sdxl_step` (pin off) under each conv impl, in
    alternating rounds of 3 synced steps: ms per step, each conv kernel's
    launches per step (one UNet forward of 16 rows; SDXL_CONV_PER_FORWARD),
    all on the Hopper mainloop; the noise prediction of one UNet forward on
    random inputs (16 rows, slider on, t = 501) held to the 'xla' route's
    within 5e-2 of its largest magnitude, as `phase_conv_step` holds
    SD1.5's (the step's own output carries guidance 7.5, which scales the
    routes' rounding differences up with it); then one profiled step per
    impl: device time by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops.basic import SliderLora

    m = engine.models
    step, _ = sdxl_step_fn(engine)
    gen = torch.Generator(device="cuda").manual_seed(43)
    hw, rows = SDXL_PX // 8, 16
    x = torch.randn((rows, hw, hw, 4), generator=gen, device="cuda").bfloat16()
    ctx = torch.randn((rows, 77, m.unet_config.cross_attention_dim), generator=gen,
                      device="cuda").bfloat16()
    added = {"text_embeds": torch.randn((rows, 1280), generator=gen, device="cuda").bfloat16(),
             "time_ids": torch.tensor([[SDXL_PX, SDXL_PX, 0, 0, SDXL_PX, SDXL_PX]] * rows,
                                      dtype=torch.float32, device="cuda")}
    lora = SliderLora(engine.sliders["s1"], torch.linspace(-2, 2, rows, device="cuda"))
    t = torch.tensor(501.0, device="cuda")

    def unet():
        with torch.inference_mode():
            return unet2d.apply(m.unet_params, m.unet_config, x, t, ctx, lora=lora,
                                added_cond=added)

    outs, per_forward, times, classes = {}, {}, {impl: [] for impl in CONV_IMPLS}, {}
    try:
        for impl in CONV_IMPLS:
            basic.set_conv_impl(impl)
            reset_conv_launches()
            step()
            torch.cuda.synchronize()
            per_forward[impl] = conv_launches()
            expect_hopper(per_forward[impl], conv_variants(), f"SDXL step under {impl!r}")
            outs[impl] = unet().float()
        for r in range(rounds):
            for impl in (CONV_IMPLS if r % 2 == 0 else CONV_IMPLS[::-1]):
                basic.set_conv_impl(impl)
                times[impl].append(median_ms(step, runs=3))
        for impl in CONV_IMPLS:
            basic.set_conv_impl(impl)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            classes[impl] = by_kernel_class(prof)
    finally:
        basic.set_conv_impl("xla")
    ref_max = outs["xla"].abs().max().item()
    out = {}
    for impl in CONV_IMPLS:
        diff = (outs[impl] - outs["xla"]).abs().max().item()
        cls = classes[impl]
        say("sdxl", f"conv impl {impl!r}: ms per step by round {[round(v, 2) for v in times[impl]]}"
            f"; conv-kernel launches per forward {per_forward[impl] or 0}, all on the Hopper "
            f"mainloop (expected {SDXL_CONV_PER_FORWARD[impl] or 0}); max|eps - eps_xla| "
            f"{diff:.3g} (tol {5e-2 * ref_max:.3g}, max|eps_xla| {ref_max:.3g}); device ms per "
            f"step: " + ", ".join(
                f"{c} {v:.2f}" for c, v in sorted(cls.items(), key=lambda kv: -kv[1]))
            + f" (busy {sum(cls.values()):.2f})")
        if per_forward[impl] != SDXL_CONV_PER_FORWARD[impl]:
            raise AssertionError(f"SDXL conv impl {impl!r} launched {per_forward[impl]} a forward")
        if not (torch.isfinite(outs[impl]).all() and diff <= 5e-2 * ref_max):
            raise AssertionError(f"SDXL conv impl {impl!r} moved the noise prediction by {diff}")
        out[impl] = {"ms": statistics.median(times[impl]), "per_forward": per_forward[impl],
                     "device_ms": cls}
    return out


def phase_sdxl_step(engine) -> dict:
    """One SDXL denoise step at bucket 8 (16 CFG rows), 1024 px, bf16: the
    engine's sampling function with one DDIM step, a rank-4 slider at
    per-row scales, added conditioning and guidance rescale 0.7. Launches
    per step with the pin off and on (#1 70; #9 0 and 22), the median of
    synced steps with the pin off and on in turn, the two outputs' distance,
    torch.profiler over one step (pin off) by kernel class, and the step's
    analytic bound; then the VAE decode of 8 images at 1024 px (#4 at
    (8, 1, 16384, 512) in f32) under attention impls 'auto' and 'xla' in
    turns, then under conv impls 'auto' (#5 in f32) and 'xla' (`decode_ab`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import layout_pin as lp
    from sliders_tpu_torch.ops import sd_attention as sa

    m = engine.models
    B = 8
    step, lat = sdxl_step_fn(engine)
    outs, per_step = {}, {}
    torch.cuda.reset_peak_memory_stats()  # the step's own peak, not an earlier phase's
    try:
        for pin in (False, True):
            basic.set_layout_pin(pin)
            sa.sd_attention.launches = lp.layout_pin_copy.launches = 0
            outs[pin] = step()
            torch.cuda.synchronize()
            per_step[pin] = (sa.sd_attention.launches, lp.layout_pin_copy.launches)
        times = {False: [], True: []}
        for r in range(SDXL_STEP_ROUNDS):
            for pin in ((False, True) if r % 2 == 0 else (True, False)):
                basic.set_layout_pin(pin)
                times[pin].append(median_ms(step, runs=3))
    finally:
        basic.set_layout_pin(False)
    diff = (outs[True].float() - outs[False].float()).abs().max().item()
    tol = bf16_ulp(outs[False].float().abs().max().item())
    if per_step != {False: (SDXL_SD_1024, 0), True: (SDXL_SD_1024, SDXL_PINS)}:
        raise AssertionError(f"the SDXL step launched (#1, #9) {per_step}, not "
                             f"({SDXL_SD_1024}, 0) with the pin off and ({SDXL_SD_1024}, "
                             f"{SDXL_PINS}) with it on")
    if not torch.isfinite(outs[False]).all() or diff > tol:
        raise AssertionError(f"the SDXL step is not finite, or the pin changed it by {diff}")
    off, on = statistics.median(times[False]), statistics.median(times[True])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_class = by_kernel_class(prof)
    busy = sum(by_class.values())
    bound_ms, flops = sdxl_step_bound(2 * B)
    say("sdxl", f"denoise step, bucket 8 (16 CFG rows), {SDXL_PX} px, bf16, slider on, rescale "
        f"0.7: median {off:.2f} ms with the pin off, {on:.2f} ms on (rounds {times[False]} / "
        f"{times[True]}; +{on - off:.2f} ms, {(on / off - 1) * 100:.1f}%); launches per step "
        f"(#1, #9): off {per_step[False]}, on {per_step[True]}; outputs' max|diff| {diff:.3g} "
        f"(tol one bf16 ulp, {tol:.3g}); "
        f"bound {bound_ms:.1f} ms ({flops / 1e12:.2f} TFLOP at the bf16 peak; the step takes "
        f"{bound_ms / off * 100:.1f}% of it)")
    say("sdxl", "device ms per step by kernel class: " + ", ".join(
        f"{c} {v:.1f} ({v / busy * 100:.1f}%)"
        for c, v in sorted(by_class.items(), key=lambda kv: -kv[1]))
        + f"; idle share {(1 - busy / wall) * 100:.1f}% (profiler on, 1 step, pin off); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say("sdxl", f"top kernels of the profiled step: {top_kernels(prof)}")
    del outs, prof
    torch.cuda.empty_cache()
    what = f"SDXL VAE decode of 8 images at {SDXL_PX} px"
    dec = decode_ab(m.vae_params, m.vae_config, lat, what, rounds=2, runs=2)
    dec_conv = decode_ab(m.vae_params, m.vae_config, lat, what, rounds=2, runs=2, route="conv")
    return {"ms_off": off, "ms_on": on, "sd_per_step": per_step[False][0],
            "pin_per_step": per_step[True][1], "bound_ms": bound_ms, "decode": dec,
            "decode_conv": dec_conv}


def phase_sdxl_http(engine) -> dict:
    """SDXL behind the HTTP server: /healthz (is_xl), a warmup, then a 5-scale
    /generate at 1024 px (SDXL_HTTP_STEPS DDIM steps): five distinct
    1024x1024 images; #1 launches 70 x steps, #4 once (one f32 decode of the
    8-row bucket: its d = 512 mid attention), #9 none (pin off); the
    request's peak device memory. Then the same request with the layout pin
    on: #9 22 x steps and the same images."""
    import torch

    from sliders_tpu_torch.ops import basic
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import layout_pin as lp
    from sliders_tpu_torch.ops import sd_attention as sa

    def run(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not (health["ok"] and health["is_xl"] and health["family"] == "xl"
                and health["image_size"] == SDXL_PX):
            raise AssertionError(f"/healthz of the SDXL engine: {health}")
        t0 = time.perf_counter()
        engine.warmup(with_slider="s1")
        say("sdxl", f"/healthz {health}; warmup (5 scales -> bucket 8) "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sa.sd_attention.launches = fa.flash_attention.launches = lp.layout_pin_copy.launches = 0
        t0 = time.perf_counter()
        reply = post(port, "/generate", {"prompt": "a photo of a person", "seed": 1,
                                         "slider": "s1", "scales": SWEEP})
        wall = time.perf_counter() - t0
        counts = (sa.sd_attention.launches, fa.flash_attention.launches,
                  lp.layout_pin_copy.launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        px = check_images(reply, SWEEP, "sdxl http", SDXL_PX)
        expected = (SDXL_SD_1024 * SDXL_HTTP_STEPS, 1, 0)
        say("sdxl", f"/generate 5 scales at {SDXL_PX} px ({SDXL_HTTP_STEPS} steps, cut from 50), "
            f"pin off: server latency {reply['latency_ms']} ms, client {wall * 1e3:.1f} ms; "
            f"{len(set(px))} distinct {SDXL_PX}x{SDXL_PX} images; launches (#1, #4, #9) {counts} "
            f"(expected {expected}); peak device memory {peak:.2f} GB")
        if len(set(px)) != len(SWEEP):
            raise AssertionError("the SDXL sweep's images are not all distinct")
        if counts != expected:
            raise AssertionError(f"the SDXL request launched {counts}, not {expected}")
        # the same request with the layout pin on: #9 at every boundary of
        # every step, and the same images (the pin is the identity)
        basic.set_layout_pin(True)
        try:
            sa.sd_attention.launches = fa.flash_attention.launches = 0
            lp.layout_pin_copy.launches = 0
            pinned = post(port, "/generate", {"prompt": "a photo of a person", "seed": 1,
                                              "slider": "s1", "scales": SWEEP})
            pin_counts = (sa.sd_attention.launches, fa.flash_attention.launches,
                          lp.layout_pin_copy.launches)
        finally:
            basic.set_layout_pin(False)
        pin_expected = (SDXL_SD_1024 * SDXL_HTTP_STEPS, 1, SDXL_PINS * SDXL_HTTP_STEPS)
        same = check_images(pinned, SWEEP, "sdxl http pinned", SDXL_PX) == px
        say("sdxl", f"the same /generate with the pin on: server latency {pinned['latency_ms']} "
            f"ms; launches (#1, #4, #9) {pin_counts} (expected {pin_expected}); images "
            f"{'equal' if same else 'DIFFERENT'} to the unpinned request's")
        if pin_counts != pin_expected or not same:
            raise AssertionError("the pinned SDXL request did not pin every boundary, or its "
                                 "images differ")
        return {"sd": counts[0], "flash": counts[1], "pin": pin_counts[2],
                "latency_ms": reply["latency_ms"], "pinned_latency_ms": pinned["latency_ms"],
                "peak_gb": peak}

    return serve_http(engine, run)


def write_sdxl_snapshot(root: str, models) -> None:
    """A diffusers-layout SDXL snapshot of the engine's weights (bf16): the
    UNet, CLIP-L, bigG with its projection, both tokenizers, and the SDXL
    VAE (image-slider training encodes with it)."""
    from sliders_tpu_torch.models.convert import write_safetensors
    from sliders_tpu_torch.utils.pytree import flatten

    for sub in ("tokenizer", "tokenizer_2"):
        os.makedirs(os.path.join(root, sub))
        write_tokenizer(os.path.join(root, sub))
    os.makedirs(os.path.join(root, "unet"))
    write_safetensors(os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"),
                      flatten(models.unet_params))
    with open(os.path.join(root, "unet", "config.json"), "w") as f:
        json.dump(unet_hf_config(models.unet_config), f)
    for sub, te in zip(("text_encoder", "text_encoder_2"), models.text_encoders):
        os.makedirs(os.path.join(root, sub))
        write_safetensors(os.path.join(root, sub, "model.safetensors"), flatten(te.params))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(clip_hf_config(te.config, te.config.eos_token_id), f)
    os.makedirs(os.path.join(root, "vae"))
    write_safetensors(os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
                      flatten(models.vae_params))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump(vae_hf_config(models.vae_config), f)


def phase_sdxl_train(snap: str, tmp: str) -> dict:
    """SDXL slider training at full width through the training CLI in
    process (`--xl`, on `snap`, a snapshot of the serving phases' weights), with the
    values of data/config-xl.yaml (bf16, remat, rank-4 noxattn lierla, AdamW
    lr 2e-4, DDIM; max_denoising_steps cut to SDXL_TRAIN_STEPS) and
    data/prompts-xl.yaml's age pair at 512 px, for SDXL_TRAIN_ITERATIONS
    iterations, with the layout pin on. Launches are
    exact: #1 10 x (t_to + 3) (t_to denoise calls, the frozen pass, the grad
    pass and its remat recompute), #2 10, #9 22 x (t_to + 2) forward (the
    pins sit outside the remat checkpoints) + 21 backward per iteration.
    Every down and every up moves from its init; alphas stay."""
    import torch

    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.ops import basic

    cfg = yaml_subset.load(os.path.join(REPO, "data", "config-xl.yaml"))
    cfg["prompts_file"] = os.path.join(REPO, "data", "prompts-xl.yaml")
    cfg["pretrained_model"]["name_or_path"] = snap
    cfg["train"].update(iterations=SDXL_TRAIN_ITERATIONS, max_denoising_steps=SDXL_TRAIN_STEPS)
    cfg["save"]["path"] = os.path.join(tmp, "sdxl_out")
    cfg["logging"] = {"log_every": 1}
    say("sdxl", f"config data/config-xl.yaml: train {cfg['train']}; network {cfg['network']}; "
        f"tpu {cfg['tpu']}; overridden: iterations, max_denoising_steps, logging.log_every and "
        f"the paths (prompts: "
        f"data/prompts-xl.yaml)")
    basic.set_layout_pin(True)
    try:
        run = run_training(cfg, os.path.join(tmp, "config_xl.yaml"), ["--xl"])
    finally:
        basic.set_layout_pin(False)
    recs = run["records"]
    t_tos = [m["t_to"] for _, _, m in recs]
    expected = {"sd": SDXL_SD_512 * sum(t + 3 for t in t_tos), "sd_bwd": SDXL_SD_512 * len(recs),
                "pin": sum(SDXL_PINS * (t + 2) + SDXL_PIN_BWD for t in t_tos)}
    got = {"sd": run["fwd"], "sd_bwd": run["bwd"], "pin": run["pin"]}
    init = create_slider_network(torch.Generator().manual_seed(1),
                                 unet2d.init_params(None, unet2d.SDXL, device="meta"), rank=4,
                                 alpha=1.0, train_method="noxattn")
    final = run["lora"]
    moved = sum(not torch.equal(final[m]["down"], init[m]["down"])
                and bool(final[m]["up"].abs().max() > 0) for m in init)
    alphas = all(final[m]["alpha"].item() == 1.0 for m in init)
    losses = [m["loss"] for _, _, m in recs]
    say("sdxl", f"train 512 px (bf16, remat, rank 4 noxattn, AdamW lr {cfg['train']['lr']}, "
        f"DDIM, max_denoising_steps {SDXL_TRAIN_STEPS}, pin on): {len(recs)} iterations, t_to "
        f"{t_tos}, losses "
        f"{[f'{v:.6g}' for v in losses]}; launches {got} (expected {expected}: 10 x sum(t_to + "
        f"3), 10 x {len(recs)}, sum(22 x (t_to + 2) + 21)); {moved} of {len(init)} modules moved "
        f"both down and up, alphas {'unchanged' if alphas else 'CHANGED'}; peak device memory "
        f"{run['peak_gb']:.2f} GB; whole run {run['seconds']:.1f} s including the load")
    prev = None
    for i, t_end, m in recs:
        ph = m["phase_ms"]
        wall = "" if prev is None else f"host wall {t_end - prev:.3f} s; "
        say("sdxl", f"train iteration {i}: t_to {m['t_to']}, loss {m['loss']:.6g}; {wall}device "
            f"ms: denoise {ph['denoise']:.1f} ({ph['denoise'] / m['t_to']:.1f} per CFG-doubled "
            f"UNet call), frozen {ph['frozen']:.1f}, grad {ph['grad']:.1f}, update "
            f"{ph['update']:.2f}")
        prev = t_end
    if [i for i, _, _ in recs] != list(range(SDXL_TRAIN_ITERATIONS)):
        raise AssertionError("the SDXL run did not take every iteration")
    if got != expected:
        raise AssertionError(f"the SDXL training launches {got} are not {expected}")
    if moved != len(init) or not alphas or not all(map(math.isfinite, losses)):
        raise AssertionError("the SDXL run's LoRA or losses are wrong")

    # precision fp16: f32-loaded weights, f16 compute, pin on;
    # FP16_SDXL_ITERATIONS iterations with the denoise cut to max_denoising_steps
    # FP16_SDXL_STEPS
    cfg["train"].update(precision="fp16", iterations=FP16_SDXL_ITERATIONS,
                        max_denoising_steps=FP16_SDXL_STEPS)
    cfg["save"]["path"] = os.path.join(tmp, "sdxl_fp16_out")
    basic.set_layout_pin(True)
    try:
        with unet_input_dtypes() as dtypes, f16_sum_flags() as sums:
            fp16 = run_training(cfg, os.path.join(tmp, "config_xl_fp16.yaml"), ["--xl"])
    finally:
        basic.set_layout_pin(False)
    recs16 = fp16["records"]
    t16 = [m["t_to"] for _, _, m in recs16]
    losses16 = [m["loss"] for _, _, m in recs16]
    exp16 = {"sd": SDXL_SD_512 * sum(t + 3 for t in t16), "sd_bwd": SDXL_SD_512 * len(recs16),
             "pin": sum(SDXL_PINS * (t + 2) + SDXL_PIN_BWD for t in t16)}
    got16 = {"sd": fp16["fwd"], "sd_bwd": fp16["bwd"], "pin": fp16["pin"]}
    say("sdxl", f"train 512 px, precision fp16 (f32-loaded weights, f16 compute, pin on, "
        f"max_denoising_steps {FP16_SDXL_STEPS}): {len(recs16)} iterations, t_to {t16}, losses "
        f"{[f'{v:.6g}' for v in losses16]}; f16 launches {got16} (expected {exp16}); UNet inputs "
        f"{sorted({str(d) for d in dtypes})}; peak device memory {fp16['peak_gb']:.2f} GB; "
        f"whole run {fp16['seconds']:.1f} s including the f32 load")
    for i, _, m in recs16:
        ph = m["phase_ms"]
        say("sdxl", f"train fp16 iteration {i}{' (the first f16 calls)' if i == 0 else ''}: "
            f"t_to {m['t_to']}; device ms: denoise {ph['denoise']:.1f} "
            f"({ph['denoise'] / m['t_to']:.1f} per CFG-doubled UNet call), frozen "
            f"{ph['frozen']:.1f}, grad {ph['grad']:.1f}, update {ph['update']:.2f}")
    if [i for i, _, _ in recs16] != list(range(FP16_SDXL_ITERATIONS)) or got16 != exp16 or (
            set(dtypes) != {torch.float16}) or set(sums) != {False} or not all(
            map(math.isfinite, losses16)):
        raise AssertionError(f"the SDXL fp16 run: launches {got16} (expected {exp16}), UNet "
                             f"inputs {set(dtypes)}, losses {losses16}")
    return {**got, "peak_gb": run["peak_gb"],
            "fp16": {**got16, "t_to": t16, "phase_ms": [m["phase_ms"] for _, _, m in recs16],
                     "peak_gb": fp16["peak_gb"], "seconds": fp16["seconds"]}}


def phase_sdxl(tmp: str) -> dict:
    """SDXL-base at full width: the step and the HTTP request on the engine,
    then training on a snapshot of the same weights."""
    import torch

    tok_dir = os.path.join(tmp, "sdxl_tokenizer")
    os.makedirs(tok_dir)
    write_tokenizer(tok_dir)
    engine = timed("sdxl build", build_sdxl_engine, tok_dir)
    step = timed("SDXL step", phase_sdxl_step, engine)
    conv = timed("SDXL conv impls", phase_sdxl_conv_step, engine)
    http = timed("SDXL http", phase_sdxl_http, engine)
    cont = timed("SDXL continuous", phase_sdxl_continuous, engine)
    snap = os.path.join(tmp, "sdxl")
    timed("SDXL snapshot", write_sdxl_snapshot, snap, engine.models)
    del engine  # the training run loads its own copy from the snapshot
    gc.collect()
    torch.cuda.empty_cache()
    train = timed("SDXL training", phase_sdxl_train, snap, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    image = timed("SDXL image training", phase_image_train, snap, tmp, "sdxl")
    gc.collect()
    torch.cuda.empty_cache()
    turbo = timed("turbo sdxl", phase_turbo, snap, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    custom = timed("custom diffusion sdxl", phase_custom_diffusion, snap, tmp)
    return {"step": step, "conv": conv, "http": http, "train": train, "image": image,
            "turbo": turbo, "continuous": cont, "custom_diffusion": custom}


@contextlib.contextmanager
def tf32_flags(cudnn: bool, matmul: bool):
    """cuDNN's and cuBLAS's TF32 flags as given inside the block, restored
    after (later phases rely on the flags the earlier ones left)."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_encode_kernel():
    """Kernel #4 against flash_attention_ref at the encoder's mid attention
    of image-slider training (ENCODE_FLASH_SHAPES: a pair's two images at
    256 and 512 px, f32, d = 512) within F32_TOL, one launch each on its
    "d512" plan; each timed (median of 5) beside its bound (3xTF32 and
    FMA, the lesser the row's), its plain version, SDPA f32, the 'xla'
    route (`xla_attention`: f32 logits, softmax, P.V) and that route's two
    cuBLAS products alone, with cuBLAS's TF32 off as the training CLI runs.
    Returns the rows."""
    import torch
    import torch.nn.functional as F

    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops.attention import xla_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for shape in ENCODE_FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        plan = fa.fwd_plan(torch.float32, shape[3])
        plans = dict(fa.flash_attention.launches_by_plan)
        out = fa.flash_attention(q, k, v)
        plans = {p: n - plans[p] for p, n in fa.flash_attention.launches_by_plan.items()}
        ref = fa.flash_attention_ref(q, k, v)
        err = (out - ref).abs().max().item()
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * shape[3] ** -0.5, dim=-1)
        row = {"shape": shape, "dtype": "float32", "plan": plan, "err": err,
               "ms": median_ms(lambda: fa.flash_attention(q, k, v), runs=5),
               "plain_ms": median_ms(lambda: fa.flash_attention_ref(q, k, v), runs=3),
               "library_ms": median_ms(lambda: F.scaled_dot_product_attention(q, k, v), runs=5),
               "xla_ms": median_ms(lambda: xla_attention(q, k, v), runs=5),
               "xla_products_ms": median_ms(
                   lambda: (torch.matmul(q, k.transpose(-1, -2)), torch.matmul(p, v)), runs=5),
               **attention_bounds(shape, "float32")}
        say("encode", f"#4 at the encoder's {shape} f32 ({plan} plan, launches {plans}): max|err| "
            f"vs plain {err:.3g} (tol {F32_TOL}); median #4 {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; 3xTF32 {row['tf32x3_bound_ms']:.4f}, "
            f"FMA {row['fma_bound_ms']:.4f}); plain {row['plain_ms']:.4f}, SDPA f32 "
            f"{row['library_ms']:.4f}, the 'xla' route {row['xla_ms']:.4f} (its two cuBLAS "
            f"products {row['xla_products_ms']:.4f})")
        if plans != {p: 1 if p == plan else 0 for p in plans}:
            raise AssertionError(f"flash_attention at {shape} did not launch once on its {plan} "
                                 f"plan: {plans}")
        if not (err <= F32_TOL and out.shape == ref.shape and out.dtype == torch.float32):
            raise AssertionError(f"flash_attention disagrees with its plain version at {shape}")
        rows.append(row)
        del q, k, v, p, out, ref
        torch.cuda.empty_cache()
    return rows


def phase_encode_ab(rounds: int = ENCODE_AB_ROUNDS, runs: int = 3) -> dict:
    """The SD VAE's encoder at full width (random f32 weights) on a pair's
    two images at IMAGE_PX (256 px: SD1.5's image training; 512 px: SDXL's,
    whose VAE differs only in its scaling factor), under attention impls
    'auto' (#4 on the mid attention) and 'xla' in turns, `rounds` rounds of
    a median of `runs` calls each, with PyTorch's default TF32 flags (cuDNN
    on, cuBLAS off) as the training CLI runs. #4 launches once per 'auto'
    encode and never under 'xla'; the two routes' means agree within 1e-3
    of their scale. Returns {model: {"auto": ms, "xla": ms, ...}}."""
    import torch

    from sliders_tpu_torch.models import vae
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops.attention import set_attention_impl

    gen = torch.Generator(device="cuda").manual_seed(16)
    params = vae.init_params(gen, vae.SD_VAE, device="cuda")

    def encode(impl: str, imgs):
        """The means of one encode under `impl`, and the median ms."""
        set_attention_impl(impl)
        with torch.no_grad():
            before = fa.flash_attention.launches
            mean = vae.encode(params, vae.SD_VAE, imgs)[0]
            launched = fa.flash_attention.launches - before
            ms = median_ms(lambda: vae.encode(params, vae.SD_VAE, imgs), runs=runs)
        if launched != (impl == "auto"):
            raise AssertionError(f"the {impl!r} encode launched #4 {launched} times")
        return mean, ms

    out = {}
    with tf32_flags(True, False):
        try:
            for model, px in IMAGE_PX.items():
                imgs = torch.rand((2, px, px, 3), generator=gen, device="cuda") * 2 - 1
                samples, means = {"auto": [], "xla": []}, {}
                for r in range(rounds):
                    for impl in ("auto", "xla") if r % 2 == 0 else ("xla", "auto"):
                        means[impl], ms = encode(impl, imgs)
                        samples[impl].append(ms)
                diff = (means["auto"] - means["xla"]).abs().max()
                rel = (diff / means["xla"].abs().max()).item()
                med = {impl: statistics.median(v) for impl, v in samples.items()}
                say("encode", f"{model}'s VAE encoder, 2 images at {px} px, f32 (cuDNN TF32 "
                    f"on): median 'auto' (#4) {med['auto']:.3f} ms, 'xla' {med['xla']:.3f} ms "
                    f"({med['auto'] / med['xla']:.3f}x; {rounds} rounds in turns: 'auto' "
                    f"{[f'{x:.3f}' for x in samples['auto']]}, 'xla' "
                    f"{[f'{x:.3f}' for x in samples['xla']]}); mean max|diff| / max|mean| "
                    f"{rel:.3g}")
                if not (rel <= 1e-3 and all(torch.isfinite(m).all() for m in means.values())):
                    raise AssertionError(f"{model}'s encode differs between the attention impls")
                out[model] = {**med, "samples": samples, "rel_diff": rel}
                del imgs, means
        finally:
            set_attention_impl("auto")
    del params
    torch.cuda.empty_cache()
    return out


def vae_hf_config(cfg) -> dict:
    """The diffusers vae/config.json of a VaeConfig."""
    return {"latent_channels": cfg.latent_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block, "norm_num_groups": cfg.norm_num_groups,
            "scaling_factor": cfg.scaling_factor, "shift_factor": cfg.shift_factor}


def write_tiny_sd_snapshot(root: str) -> None:
    """A diffusers-layout SD snapshot with seeded random f32 weights: the
    TINY UNet, a tiny CLIP (the synthetic BPE tokenizer) and the TINY VAE."""
    import torch

    from sliders_tpu_torch.models import clip_text, unet2d, vae
    from sliders_tpu_torch.models.convert import write_safetensors
    from sliders_tpu_torch.utils.pytree import flatten

    gen = torch.Generator().manual_seed(17)
    os.makedirs(os.path.join(root, "tokenizer"))
    write_tokenizer(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json")) as f:
        vocab = json.load(f)
    width = unet2d.TINY.cross_attention_dim
    ccfg = clip_text.ClipTextConfig(
        vocab_size=len(vocab), hidden_size=width, num_layers=2, num_heads=2,
        intermediate_size=2 * width, max_positions=16, eos_token_id=vocab["<|endoftext|>"])
    components = {
        "unet": (unet2d.init_params(gen, unet2d.TINY), unet_hf_config(unet2d.TINY)),
        "text_encoder": (clip_text.init_params(gen, ccfg), clip_hf_config(ccfg, ccfg.eos_token_id)),
        "vae": (vae.init_params(gen, vae.TINY), vae_hf_config(vae.TINY)),
    }
    for sub, (params, config) in components.items():
        os.makedirs(os.path.join(root, sub))
        write_safetensors(os.path.join(root, sub, "model.safetensors"), flatten(params))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(config, f)


def write_pair_folders(root: str, hw: tuple, files: int, seed: int, bad: str = "") -> tuple:
    """SCALE_FOLDERS under `root` (scales -2, -1, 1, 2), each holding the
    same `files` names: (h, w) PNGs written by `serving/server.encode_png`,
    a wave pattern that brightens with the scale, plus noise; `bad`, if
    given, a truncated PNG of that name in every folder. Returns the CLI's
    --folders and --scales."""
    import numpy as np

    from sliders_tpu_torch.serving.server import encode_png

    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    for i, folder in enumerate(SCALE_FOLDERS):
        os.makedirs(os.path.join(root, folder))
        for j in range(files):
            wave = 40 * np.sin(xx / (5 + j) + yy / (9 + i))[..., None]
            img = (45 + 50 * i + wave + rng.integers(0, 24, (h, w, 3))).clip(0, 255)
            with open(os.path.join(root, folder, f"{chr(97 + j)}.png"), "wb") as f:
                f.write(encode_png(img.astype(np.uint8)))
        if bad:
            with open(os.path.join(root, folder, bad), "wb") as f:
                f.write(encode_png(np.zeros((8, 8, 3), np.uint8))[:40])
    return ", ".join(SCALE_FOLDERS), "-2, -1, 1, 2"


def run_image_training(cfg: dict, path: str, extra: list, trace_last: bool = False) -> dict:
    """The image-slider CLI in-process with the config `cfg` (written to
    `path`) and the arguments `extra`; the kernels' counts are set to 0 just
    before and read just after, and the reader's skip warnings are kept.
    Returns the per-iteration records, the counts, the LoRAs by save name,
    the warnings, the seconds and the peak device memory. With
    `trace_last`, torch.profiler traces the last iteration, from the end of
    the one before to its own end: "trace" holds its host wall and device
    ms by kernel class."""
    import logging

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sliders_tpu_torch.cli import train_image_slider as icli
    from sliders_tpu_torch.ops import flash_attention as fa
    from sliders_tpu_torch.ops import sd_attention as sa

    class Keep(logging.Handler):
        def emit(self, record):
            skipped.append(record.getMessage())

    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    records, skipped, handler = [], [], Keep(logging.WARNING)
    last, trace = cfg["train"]["iterations"] - 1, {}

    def on_step(i, state, m):
        records.append((i, time.perf_counter(), m))
        if trace_last and i == last - 1:
            trace["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            trace["prof"].start()
            trace["t0"] = time.perf_counter()
        elif trace_last and i == last:
            torch.cuda.synchronize()
            trace["wall_ms"] = (time.perf_counter() - trace["t0"]) * 1e3
            trace["prof"].stop()

    reader_log = logging.getLogger("sliders_tpu_torch.data.paired_images")
    reader_log.addHandler(handler)
    torch.cuda.reset_peak_memory_stats()
    sa.sd_attention.launches = sa.sd_attention_bwd.launches = fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    try:
        loras = icli.main(icli.build_parser().parse_args(["--config_file", path, *extra]),
                          on_step=on_step)
        torch.cuda.synchronize()
    finally:
        reader_log.removeHandler(handler)
    return {"records": records, "sd": sa.sd_attention.launches,
            "sd_bwd": sa.sd_attention_bwd.launches, "flash": fa.flash_attention.launches,
            "loras": loras, "warnings": skipped, "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "trace": trace and {"wall_ms": trace["wall_ms"],
                                "by_class": by_kernel_class(trace["prof"])}}


def encode_png_paeth(img) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG with every row Paeth-filtered,
    the filter libpng's adaptive choice mostly takes for photographs, and
    the one the reader undoes by its slowest route (a wavefront)."""
    import numpy as np

    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) % 256).astype(np.uint8).reshape(x.shape[0], -1)
    raw = np.concatenate([np.full((x.shape[0], 1), 4, np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", x.shape[1], x.shape[0], 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def time_reader_at_photo_size(tmp: str, px: int) -> dict:
    """The port's reader on one READER_PHOTO_PX-square PNG, Paeth-filtered
    (`encode_png_paeth`; a wave pattern plus noise, as the training folders
    hold): host seconds, median of 3, of the decode alone and of the decode
    with the resize to `px` (`load_batch`), and the file's size."""
    import numpy as np

    from sliders_tpu_torch.data import native_loader as nl

    n = READER_PHOTO_PX
    yy, xx = np.mgrid[0:n, 0:n]
    img = 90 + 40 * np.sin(xx / 37 + yy / 53)[..., None]
    img = img + np.random.default_rng(21).integers(0, 24, (n, n, 3))
    img = img.clip(0, 255).astype(np.uint8)
    path = os.path.join(tmp, f"photo_{n}.png")
    with open(path, "wb") as f:
        f.write(encode_png_paeth(img))
    if not np.array_equal(nl.decode_file(path), img):
        raise AssertionError("the reader does not give back the Paeth-filtered PNG's pixels")

    def median_s(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    return {"decode_s": median_s(lambda: nl.decode_file(path)),
            "load_s": median_s(lambda: nl.load_batch([path], px)),
            "mb": os.path.getsize(path) / 1e6}


def phase_tiny_image() -> dict:
    """Tiny image-slider training through the CLI on the GPU (the kernels)
    against the CPU (plain paths), f32 with TF32 off, on a tiny snapshot and
    paired folders this phase writes: scales -+1 and -+2, three files each
    and a truncated one, which both runs skip with the reader's warning at
    the same draw. Every loss within 1e-5 relative and the LoRA within 1e-6
    absolute (lr 1e-4), as phase_tiny_train holds them; the GPU run's
    launches exact (#1 TINY_IMAGE_ROUTED x (1 + remat) + 1 for the encoder
    per iteration, #2 TINY_IMAGE_ROUTED). Then a two-style --stylecheck run
    on the GPU: one slider per style folder, saved under its name."""
    import torch

    with tf32_flags(False, False), tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "sd_tiny")
        write_tiny_sd_snapshot(snap)
        pairs, styles = os.path.join(tmp, "pairs"), os.path.join(tmp, "styles")
        folders, scales = write_pair_folders(pairs, (72, 80), 3, seed=18, bad=TINY_IMAGE_BAD)
        for i, style in enumerate(("0", "1")):
            write_pair_folders(os.path.join(styles, style), (72, 80), 2, seed=19 + i)
        with open(os.path.join(tmp, "prompts.yaml"), "w") as f:
            f.write("- target: eyes\n  positive: big eyes\n  neutral: eyes\n"
                    "  unconditional: small eyes\n  resolution: 64\n")
        cfg = {"prompts_file": os.path.join(tmp, "prompts.yaml"),
               "pretrained_model": {"name_or_path": snap},
               "network": {"rank": 2, "alpha": 1.0, "training_method": "noxattn"},
               "train": {"precision": "float32", "iterations": TINY_IMAGE_ITERATIONS,
                         "lr": TINY_LR, "max_denoising_steps": 5},
               "save": {"name": "tiny", "per_steps": 2},
               "logging": {"log_every": 1}, "tpu": {"remat": True}}
        args = ["--folders", folders, "--scales", scales, "--resolution", str(TINY_IMAGE_PX)]
        runs = {}
        for device in ("0", "cpu"):
            run_cfg = {**cfg, "save": {**cfg["save"], "path": os.path.join(tmp, f"out_{device}")}}
            runs[device] = run_image_training(run_cfg, os.path.join(tmp, f"{device}.yaml"),
                                              [*args, "--folder_main", pairs, "--device", device])
        gpu, cpu = runs["0"], runs["cpu"]
        style_cfg = {**cfg, "train": {**cfg["train"], "iterations": 2},
                     "save": {**cfg["save"], "name": "style", "path": os.path.join(tmp, "st")}}
        style = run_image_training(style_cfg, os.path.join(tmp, "style.yaml"),
                                   [*args, "--folder_main", styles, "--stylecheck", "1",
                                    "--device", "0"])
        style_dir = os.path.join(tmp, "st", "style_alpha1.0_rank2_noxattn")
        style_files = sorted(os.listdir(style_dir))

    (name,) = gpu["loras"]
    g_lora, c_lora = gpu["loras"][name], cpu["loras"][name]
    g_loss = [m["loss"] for _, _, m in gpu["records"]]
    c_loss = [m["loss"] for _, _, m in cpu["records"]]
    draws = [(m["t_to"], m["scale"]) for _, _, m in gpu["records"]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    lora_err = max((g_lora[m][k] - c_lora[m][k]).abs().max().item()
                   for m in c_lora for k in ("down", "up"))
    n = len(gpu["records"])
    expected = {"sd": n * (TINY_IMAGE_ROUTED * 2 + 1), "sd_bwd": n * TINY_IMAGE_ROUTED,
                "flash": 0}
    got = {k: gpu[k] for k in expected}
    say("kernel", f"tiny image training {TINY_IMAGE_PX} px f32 through the CLI, {n} "
        f"iterations ((t_to, scale) {draws}), GPU (launches {got}, expected {expected}) vs CPU "
        f"(plain): losses {[f'{x:.6g}' for x in g_loss]} vs {[f'{x:.6g}' for x in c_loss]}, max "
        f"rel err {loss_err:.3g} (tol 1e-5); LoRA max|err| {lora_err:.3g} (tol 1e-6); the "
        f"reader skipped {len(gpu['warnings'])} / {len(cpu['warnings'])} files with the warning "
        f"{gpu['warnings'][:1]}")
    style_names = [f"{s}_style_alpha1.0_rank2_noxattn" for s in ("0", "1")]
    style_expected = {"sd": 2 * 2 * (TINY_IMAGE_ROUTED * 2 + 1),
                      "sd_bwd": 2 * 2 * TINY_IMAGE_ROUTED}
    style_got = {k: style[k] for k in style_expected}
    say("kernel", f"tiny --stylecheck on 2 style folders (GPU, 2 iterations each): sliders "
        f"{list(style['loras'])}, files {style_files}, launches {style_got} (expected "
        f"{style_expected})")
    if got != expected or style_got != style_expected:
        raise AssertionError("tiny image training on the GPU did not go through the kernels")
    if draws != [(m["t_to"], m["scale"]) for _, _, m in cpu["records"]] or n != (
            TINY_IMAGE_ITERATIONS):
        raise AssertionError("the GPU and CPU runs did not take the same draws")
    if not (loss_err <= 1e-5 and lora_err <= 1e-6):
        raise AssertionError("tiny image training on the GPU disagrees with the CPU")
    if not (gpu["warnings"] and len(gpu["warnings"]) == len(cpu["warnings"])
            and all(TINY_IMAGE_BAD in w for w in gpu["warnings"])):
        raise AssertionError("the truncated file was not skipped with its warning")
    if list(style["loras"]) != style_names or style_files != sorted(
            f"{s}_last.safetensors" for s in style_names):
        raise AssertionError("--stylecheck did not train one slider per style folder")
    a, b = (style["loras"][s] for s in style_names)
    if all(torch.equal(a[m]["down"], b[m]["down"]) for m in a):
        raise AssertionError("the two style folders trained the same slider")
    return {**got, "style": style_got}


def phase_image_train(snap: str, tmp: str, model: str) -> dict:
    """Image-slider training at full width through the CLI in-process on
    `snap` (a snapshot with random weights and a VAE): SD1.5 with
    data/config.yaml's values, or SDXL (`--xl`) with data/config-xl.yaml's
    (bf16, remat, rank-4 noxattn, AdamW lr 2e-4, DDIM 50), the first prompt
    set of data/prompts(-xl).yaml, at IMAGE_PX (the CLI's default),
    IMAGE_TRAIN_ITERATIONS iterations with per_steps 2, on paired folders
    this phase writes (scales -+1 and -+2, two files each, 5/4 x 9/8 the
    train size, so the reader resizes), with PyTorch's default TF32 flags.
    Launches exact per iteration: #1 IMAGE_SD_ROUTED x (1 + remat), #2
    IMAGE_SD_ROUTED, #4 one (the encode). Every up factor moves from zero,
    the alphas stay, the saves are the JAX CLI's, `_last` reloads equal.
    Prints each iteration's host wall, the reader's host seconds and the
    device ms (CUDA-event spans, idle gaps included) of the encode, the grad
    pass and the update, and the peak device memory; then the last
    iteration, traced: its device busy ms by kernel class against its host
    wall and its spans, and so its idle share; and the reader on one
    photo-sized PNG (`time_reader_at_photo_size`)."""
    import torch

    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import unet2d

    xl = model == "sdxl"
    px = IMAGE_PX[model]
    cfg = yaml_subset.load(os.path.join(REPO, "data", "config-xl.yaml" if xl else "config.yaml"))
    cfg["prompts_file"] = os.path.join(REPO, "data", "prompts-xl.yaml" if xl else "prompts.yaml")
    cfg["pretrained_model"]["name_or_path"] = snap
    cfg["train"]["iterations"] = IMAGE_TRAIN_ITERATIONS[model]
    cfg["save"].update(path=os.path.join(tmp, f"{model}_image_out"), per_steps=2)
    cfg["logging"] = {"log_every": 1}
    pairs = os.path.join(tmp, f"{model}_pairs")
    folders, scales = write_pair_folders(pairs, (px * 5 // 4, px * 9 // 8), 2, seed=20)
    say(model, f"image training: config data/{'config-xl' if xl else 'config'}.yaml: train "
        f"{cfg['train']}; network {cfg['network']}; tpu {cfg['tpu']}; overridden: iterations, "
        f"save.per_steps, logging.log_every and the paths; {px} px")
    with tf32_flags(True, False):
        run = run_image_training(cfg, os.path.join(tmp, f"{model}_image.yaml"),
                                 ["--folder_main", pairs, "--folders", folders, "--scales", scales,
                                  "--device", "0", *(["--xl"] if xl else [])], trace_last=True)
    recs = run["records"]
    n, routed, remat = len(recs), IMAGE_SD_ROUTED[model], bool(cfg["tpu"]["remat"])
    expected = {"sd": n * routed * (1 + remat), "sd_bwd": n * routed, "flash": n}
    got = {k: run[k] for k in expected}
    ((name, lora),) = run["loras"].items()
    moved = sum(bool(e["up"].abs().max() > 0) for e in lora.values())
    alphas = all(e["alpha"].item() == cfg["network"]["alpha"] for e in lora.values())
    out_dir = os.path.join(cfg["save"]["path"], name)
    files = sorted(os.listdir(out_dir))
    expected_files = sorted([f"{name}_last.safetensors"]
                            + ([f"{name}_2steps.safetensors"] if n - 1 > 2 else []))
    meta = unet2d.init_params(None, unet2d.SDXL if xl else unet2d.SD15, device="meta")
    last = lora_io.load_slider(os.path.join(out_dir, f"{name}_last.safetensors"), meta)
    reloads = set(last) == set(lora) and all(torch.equal(last[m][k], lora[m][k])
                                             for m in lora for k in ("down", "up", "alpha"))
    losses = [m["loss"] for _, _, m in recs]
    say(model, f"image training {px} px: {n} iterations, (t_to, scale) "
        f"{[(m['t_to'], m['scale']) for _, _, m in recs]}, losses "
        f"{[f'{x:.6g}' for x in losses]}; launches {got} (expected {expected}: #1 {routed} x (1 + "
        f"remat), #2 {routed}, #4 1 an iteration); {moved} of {len(lora)} up factors moved, "
        f"alphas {'unchanged' if alphas else 'CHANGED'}; files {files}, _last reloads "
        f"{'equal' if reloads else 'DIFFERENT'}; peak device memory {run['peak_gb']:.2f} GB; "
        f"whole run {run['seconds']:.1f} s including the load")
    prev = None
    for i, t_end, m in recs:
        ph = m["phase_ms"]
        wall = "" if prev is None else f"host wall {t_end - prev:.3f} s; "
        say(model, f"image iteration {i}{' (traced)' if i == n - 1 else ''}: {wall}reader "
            f"{m['read_s']:.3f} s; device ms (event spans): encode {ph['encode']:.2f}, grad "
            f"{ph['grad']:.2f}, update {ph['update']:.2f}")
        prev = t_end
    steady = recs[1:-1]  # the first warms up; the last is traced
    per_iter = statistics.median(b[1] - a[1] for a, b in zip(recs[:-2], steady))
    phases = {k: statistics.median(m["phase_ms"][k] for _, _, m in steady)
              for k in ("encode", "grad", "update")}
    read_s = statistics.median(m["read_s"] for _, _, m in steady)
    say(model, f"image training median over iterations 1-{n - 2}: {per_iter:.3f} s an iteration "
        f"host wall (the reader {read_s:.3f} s of it); device ms (event spans): encode "
        f"{phases['encode']:.2f}, grad pass {phases['grad']:.2f}, update {phases['update']:.2f}")
    tr, last_m = run["trace"], recs[-1][2]
    busy = sum(tr["by_class"].values())
    spans = sum(last_m["phase_ms"].values())
    seen = busy > 0  # else the profiler saw no device time: no idle share
    trace = {"wall_ms": tr["wall_ms"], "busy_ms": busy, "spans_ms": spans,
             "read_ms": last_m["read_s"] * 1e3,
             "idle_share": 1 - busy / tr["wall_ms"] if seen else None,
             "span_idle_share": 1 - busy / spans if seen else None}
    say(model, f"image iteration {n - 1} traced (profiler on): host wall {tr['wall_ms']:.2f} ms, "
        f"the reader {trace['read_ms']:.2f} ms of it; event spans {spans:.2f} ms; device busy "
        f"{busy:.2f} ms: " + ", ".join(f"{c} {ms:.2f}" for c, ms in sorted(
            tr["by_class"].items(), key=lambda kv: -kv[1]))
        + (f"; idle share {trace['idle_share'] * 100:.1f}% of the wall, "
           f"{trace['span_idle_share'] * 100:.1f}% of the spans" if seen else
           "; the profiler saw no device time: idle share not measured"))
    photo = time_reader_at_photo_size(tmp, px)
    say(model, f"reader on one {READER_PHOTO_PX}x{READER_PHOTO_PX} PNG ({photo['mb']:.2f} MB): "
        f"decode {photo['decode_s']:.3f} s, decode and resize to {px} px {photo['load_s']:.3f} s "
        f"(host, median of 3; a pair reads two)")
    if [i for i, _, _ in recs] != list(range(IMAGE_TRAIN_ITERATIONS[model])):
        raise AssertionError(f"the {model} image run did not take every iteration")
    if got != expected:
        raise AssertionError(f"the {model} image training launches {got} are not {expected}")
    if moved != len(lora) or not alphas or not all(map(math.isfinite, losses)):
        raise AssertionError(f"the {model} image run's LoRA or losses are wrong")
    if files != expected_files or not reloads:
        raise AssertionError(f"the {model} image run saved {files}, expected {expected_files}, "
                             f"or its _last does not reload equal")
    return {**got, "peak_gb": run["peak_gb"], "iteration_s": per_iter, "read_s": read_s,
            "phase_ms": phases, "trace": trace, "reader_photo": photo}


# ---------------------------------------------------------------------------
# fleet training, the adaptive optimizers and the fleet sweep
# ---------------------------------------------------------------------------


def fleet_counts() -> dict:
    """#1, #2 and #4 launches since the last `reset_flux_counts`."""
    counts = flux_counts()
    return {"sd": counts["sd"], "sd_bwd": counts["sd_bwd"], "flash": counts["flash"]}


def fleet_prompt_files(tmp: str) -> tuple:
    """FLEET_PROMPTS's prompt sets of data/ written under `tmp`, their text
    cut to the letters and spaces the synthetic tokenizer holds: (paths,
    pairs in the last set)."""
    from sliders_tpu_torch.core import yaml_subset

    paths = []
    for p in FLEET_PROMPTS:
        sets = yaml_subset.load(os.path.join(REPO, "data", f"prompts-{p}.yaml"))
        for s in sets:
            for role in ("target", "positive", "unconditional", "neutral"):
                s[role] = re.sub(r"[^a-z ]", " ", str(s.get(role, "")).lower())
        paths.append(os.path.join(tmp, f"prompts-{p}.yaml"))
        if not os.path.exists(paths[-1]):
            with open(paths[-1], "w") as f:
                f.write("".join("- " + dump_yaml(s).replace("\n", "\n  ") + "\n" for s in sets))
    return paths, len(sets)


def phase_fleet(snap: str, tmp: str) -> dict:
    """`cli/train_fleet.py` in-process on the full-width SD1.5 snapshot of
    `phase_train`: FLEET_PROMPTS (K = 4 prompt YAMLs of data/, batch 1, 512
    px) with data/config.yaml's values (bf16, remat, rank-4 noxattn, AdamW
    lr 2e-4, DDIM, max_denoising_steps 50), one iteration under each t_to
    mode on the same models (loaded once by `loader.load_sd`, as the CLI
    loads them). Each iteration's per-row t_to, loop length, host seconds
    and peak device memory are printed. Checks: four `_last.safetensors`
    with the reference key set that `lora/io` reloads equal, finite per-row
    losses, and exact launches: #1 10 x (loop + 2 + remat) (a CFG-doubled
    K-row call per loop step, the 3K-row frozen pass, the K-row grad pass
    and its recomputation), #2 10 (the grad pass's backward). The steps run
    under cuDNN's deterministic algorithms (`fleet.deterministic_cudnn`);
    one more shared iteration with that context replaced by a no-op
    (cuDNN's defaults) prints both shared iterations' device spans side by
    side (the same draws; both after the per_row iteration's warm-up): what
    the rows' bit isolation costs."""
    import torch

    from sliders_tpu_torch.cli import train_fleet as fcli
    from sliders_tpu_torch.training import fleet as tfleet
    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import loader, unet2d
    from sliders_tpu_torch.models.convert import read_safetensors

    cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
    cfg["pretrained_model"]["name_or_path"] = snap
    cfg["train"]["iterations"] = 1
    cfg["logging"] = {"log_every": 1}
    remat = bool(cfg["tpu"]["remat"])
    prompts, n_pairs = fleet_prompt_files(tmp)
    t0 = time.perf_counter()
    models = loader.load_sd(snap, device="cuda", dtype=torch.bfloat16)
    load_s = time.perf_counter() - t0
    say("fleet", f"K = {len(prompts)} sliders (data/prompts-*.yaml of {', '.join(FLEET_PROMPTS)}, "
        f"{n_pairs} pairs each, text cut to letters), data/config.yaml: "
        f"train {cfg['train']}; network {cfg['network']}; tpu {cfg['tpu']}; overridden: "
        f"iterations, logging.log_every and the paths; models loaded once in {load_s:.1f} s")
    meta_unet = unet2d.init_params(None, unet2d.SD15, device="meta")
    out = {}
    for mode in (*FLEET_MODES, "shared_cudnn_default"):
        deterministic = mode != "shared_cudnn_default"
        run_cfg = {**cfg, "save": {**cfg["save"], "path": os.path.join(tmp, f"fleet_{mode}")}}
        path = os.path.join(tmp, f"fleet_{mode}.yaml")
        with open(path, "w") as f:
            f.write(dump_yaml(run_cfg) + "\n")
        records = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flux_counts()
        t0 = time.perf_counter()
        saved = tfleet.deterministic_cudnn
        if not deterministic:
            tfleet.deterministic_cudnn = contextlib.nullcontext
        try:
            loras = fcli.main(fcli.build_parser().parse_args(
                ["--config_file", path, "--device", "0", "--t_to_mode",
                 mode if deterministic else "shared", "--prompts_file", *prompts]),
                on_step=lambda i, state, m: records.append(m), models=models)
        finally:
            tfleet.deterministic_cudnn = saved
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = fleet_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        (m,) = records
        expected = {"sd": ROUTED_PER_FORWARD * (m["loop"] + 2 + remat),
                    "sd_bwd": ROUTED_PER_FORWARD, "flash": 0}
        name = (f"{cfg['save']['name']}_alpha{float(cfg['network']['alpha'])}"
                f"_rank{cfg['network']['rank']}_{cfg['network']['training_method']}")
        out_dir = os.path.join(run_cfg["save"]["path"], f"{name}_fleet")
        files = sorted(os.listdir(out_dir))
        # the CLI names each slider by its prompts file's stem and the run suffix
        sliders = [f"prompts-{p}{name[len(cfg['save']['name']):]}" for p in FLEET_PROMPTS]
        expected_files = sorted([f"{s}_last.safetensors" for s in sliders]
                                + [f"{name}_fleet_metadata.json"])
        reloads = keys = True
        for s, lora in zip(sliders, loras):
            file = os.path.join(out_dir, f"{s}_last.safetensors")
            keys &= set(read_safetensors(file)) == set(lora_io.to_reference_state_dict(lora))
            last = lora_io.load_slider(file, meta_unet)
            reloads &= set(last) == set(lora) and all(
                torch.equal(last[k][n], lora[k][n]) for k in lora for n in ("down", "up", "alpha"))
        ph = m["phase_ms"]
        say("fleet", f"{mode}: per-row t_to {m['t_to']} (pairs {m['pair']}), loop {m['loop']}; "
            f"losses {[f'{x:.6g}' for x in m['loss']]}, grad norms "
            f"{[f'{x:.4g}' for x in m['grad_norm']]}; {seconds:.2f} s the CLI call (one "
            f"iteration, prompt encodes and saves included); device ms denoise "
            f"{ph['denoise']:.1f} ({ph['denoise'] / m['loop']:.2f} per {2 * len(prompts)}-row "
            f"call), frozen {ph['frozen']:.2f}, grad {ph['grad']:.2f}, update {ph['update']:.2f}; "
            f"peak device memory {peak:.2f} GB; launches {counts} (expected {expected}); files "
            f"{files}; reference keys {'equal' if keys else 'DIFFERENT'}, _last reloads "
            f"{'equal' if reloads else 'DIFFERENT'}")
        if counts != expected:
            raise AssertionError(f"fleet {mode}: launches {counts}, not {expected}")
        if not all(map(math.isfinite, m["loss"])) or len(m["loss"]) != len(prompts):
            raise AssertionError(f"fleet {mode}: per-row losses {m['loss']}")
        if files != expected_files or not keys or not reloads:
            raise AssertionError(f"fleet {mode}: files {files} (expected {expected_files}), "
                                 f"keys or reloads wrong")
        if mode == "shared" and len(set(m["t_to"])) != 1:
            raise AssertionError(f"fleet shared: rows took t_to {m['t_to']}")
        out[mode] = {**counts, "t_to": m["t_to"], "loop": m["loop"], "seconds": seconds,
                     "peak_gb": peak, "phase_ms": ph}
    det, dflt = out["shared"], out.pop("shared_cudnn_default")
    say("fleet", f"shared under cuDNN's deterministic algorithms (the fleet's default) / its "
        f"default ones, same draws (loop {det['loop']} / {dflt['loop']}): device ms " + ", ".join(
            f"{k} {det['phase_ms'][k]:.1f} / {dflt['phase_ms'][k]:.1f} "
            f"({det['phase_ms'][k] / dflt['phase_ms'][k]:.3f}x)"
            for k in ("denoise", "frozen", "grad", "update"))
        + f"; CLI call {det['seconds']:.2f} / {dflt['seconds']:.2f} s")
    if dflt["t_to"] != det["t_to"]:
        raise AssertionError("the two shared iterations drew different t_to")
    out["cudnn_default"] = {"shared": dflt["phase_ms"], "seconds": dflt["seconds"]}
    del models
    return out


def phase_fleet_rows() -> dict:
    """The fleet's row contract on the card, TINY at 256 px in f32 with TF32
    off: a K = 2 fleet of `make_fleet_text_step` against the two solo port
    runs (`make_text_slider_step`) of seeds `fleet_row_seed(seed, r)`, two
    iterations at lr 1e-4, each row's LoRA within FLEET_ROW_TOL of its solo
    run's (the fleet's rows sit at other batch positions than a solo run's,
    which on the card may change bits: ROADMAP queue 3). The fleet's steps
    run under cuDNN's deterministic algorithms (`fleet.deterministic_cudnn`),
    so the default fleet run twice is bit-equal and, with row 1's prompt
    pairs changed, row 0 moves by 0, bit for bit: both held to 0."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_sampler, make_schedule
    from sliders_tpu_torch.lora.network import create_slider_network, trainable_mask
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.training import fleet, optimizers, text_slider

    seed, px, steps = 12, 256, 5
    sched = make_schedule()
    sampler = make_sampler(sched, "ddim", steps)
    gen = torch.Generator().manual_seed(13)
    unet = tree_to(unet2d.init_params(gen, unet2d.TINY), "cuda")

    def pairs(s, n):
        g = torch.Generator().manual_seed(s)
        p = {k: torch.randn((n, 8, 32), generator=g)
             for k in ("target", "positive", "neutral", "unconditional")}
        p["guidance_signed"] = torch.tensor([2.0, -1.0][:n])
        return {k: v.to("cuda") for k, v in p.items()}

    def opt(lora):
        return optimizers.make_optimizer("adamw", optimizers.make_lr_schedule("constant", TINY_LR, 100),
                                         trainable_mask=trainable_mask(lora))

    def lora_of(s):
        return tree_to(create_slider_network(torch.Generator().manual_seed(s + 1), unet2d.init_params(
            None, unet2d.TINY, device="meta"), rank=4, train_method="noxattn"), "cuda")

    def run_fleet(sets):
        lora = fleet.stack_fleet([lora_of(fleet.fleet_row_seed(seed, r)) for r in range(2)])
        tx = opt(lora)
        step = fleet.make_fleet_text_step(unet2d.TINY, sched, sampler, tx, n_sliders=2,
                                          max_denoising_steps=steps, resolution=px,
                                          compute_dtype=torch.float32, remat=True)
        state = text_slider.SliderTrainState.create(seed, lora, tx)
        stacked = fleet.stack_fleet_pairs(sets)
        ms = [step(state, unet, stacked)[1] for _ in range(2)]
        return [tree_to(r, "cpu") for r in fleet.unstack_fleet(state.lora)], ms

    def max_diff(a, b, keys=("down", "up")) -> float:
        return max((a[m][k] - b[m][k]).abs().max().item() for m in a for k in keys)

    with tf32_flags(False, False):
        sets = [pairs(30, 2), pairs(31, 2)]
        rows, ms = run_fleet(sets)
        again, _ = run_fleet(sets)
        rerun = max(max_diff(rows[r], again[r]) for r in range(2))
        errs, solo_t = [], []
        for r in range(2):
            s = fleet.fleet_row_seed(seed, r)
            lora = lora_of(s)
            tx = opt(lora)
            step = text_slider.make_text_slider_step(unet2d.TINY, sched, sampler, tx,
                                                     max_denoising_steps=steps, resolution=px,
                                                     compute_dtype=torch.float32, remat=True)
            state = text_slider.SliderTrainState.create(s, lora, tx)
            sm = [step(state, unet, sets[r])[1] for _ in range(2)]
            solo_t.append([x["t_to"] for x in sm])
            if [x["t_to"] for x in sm] != [x["t_to"][r] for x in ms]:
                raise AssertionError(f"fleet row {r} did not draw its solo run's t_to")
            errs.append(max((rows[r][m][k] - state.lora[m][k].cpu()).abs().max().item()
                            for m in state.lora for k in ("down", "up")))
        other, _ = run_fleet([sets[0], pairs(32, 2)])
        iso = max_diff(rows[0], other[0])
        moved = max((rows[1][m]["up"] - other[1][m]["up"]).abs().max().item() for m in rows[1])
    say("fleet", f"rows: TINY {px} px f32, K = 2, 2 iterations (t_to by row {solo_t}), lr "
        f"{TINY_LR}: the default fleet run twice: max|diff| {rerun:.3g} (limit 0); row 1's "
        f"pairs changed: row 0 moved {iso:.3g} (limit 0), row 1 {moved:.3g}; each row's LoRA "
        f"against its solo run of seed fleet_row_seed(seed, r): max|err| "
        f"{[f'{e:.3g}' for e in errs]} (limit {FLEET_ROW_TOL})")
    if rerun or iso:
        raise AssertionError("the fleet's rows are not repeatable or not isolated bit for bit")
    if max(errs) > FLEET_ROW_TOL or moved == 0:
        raise AssertionError("the fleet's rows are not their solo runs, or row 1 did not move")
    return {"row_err": max(errs), "isolation": iso, "rerun": rerun}


def phase_fleet_image(snap: str, tmp: str) -> dict:
    """`train_image_slider --stylecheck 1 --fleet` at full width on the
    SD1.5 snapshot (its VAE too) with data/config.yaml's values at 256 px:
    two style folders of `write_pair_folders`, FLEET_IMAGE_ITERATIONS
    iterations with per_steps 2, one step for both sliders (an f32 VAE
    encode of 2 x 2 images: #4 at (4, 1, 1024, 512)). Checks the per-style
    files, finite per-row losses and exact launches per iteration: #1
    IMAGE_SD_ROUTED x (1 + remat), #2 IMAGE_SD_ROUTED, #4 1."""
    import torch

    from sliders_tpu_torch.core import yaml_subset

    cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
    cfg["prompts_file"] = os.path.join(REPO, "data", "prompts.yaml")
    cfg["pretrained_model"]["name_or_path"] = snap
    cfg["train"]["iterations"] = FLEET_IMAGE_ITERATIONS
    cfg["save"].update(path=os.path.join(tmp, "fleet_image_out"), per_steps=2, name="style")
    cfg["logging"] = {"log_every": 1}
    styles = os.path.join(tmp, "fleet_styles")
    for i, style in enumerate(("0", "1")):
        folders, scales = write_pair_folders(os.path.join(styles, style), (320, 288), 2,
                                             seed=40 + i)
    with tf32_flags(True, False):
        run = run_image_training(cfg, os.path.join(tmp, "fleet_image.yaml"),
                                 ["--folder_main", styles, "--folders", folders, "--scales",
                                  scales, "--device", "0", "--stylecheck", "1", "--fleet"])
    recs = run["records"]
    n, routed, remat = len(recs), IMAGE_SD_ROUTED["sd15"], bool(cfg["tpu"]["remat"])
    expected = {"sd": n * routed * (1 + remat), "sd_bwd": n * routed, "flash": n}
    got = {k: run[k] for k in expected}
    base = f"style_alpha{float(cfg['network']['alpha'])}_rank{cfg['network']['rank']}_noxattn"
    names = [f"{s}_{base}" for s in ("0", "1")]
    files = sorted(os.listdir(os.path.join(cfg["save"]["path"], base)))
    saves = ("2steps", "last") if n - 1 > 2 else ("last",)  # the solo CLI's cadence
    expected_files = sorted(f"{s}_{t}.safetensors" for s in names for t in saves)
    losses = [m["loss"] for _, _, m in recs]
    steady = [b[1] - a[1] for a, b in zip(recs, recs[1:])]
    say("fleet", f"image --stylecheck --fleet 256 px, 2 styles, {n} iterations: (t_to, scale) by "
        f"row {[(m['t_to'], m['scale']) for _, _, m in recs]}, losses "
        f"{[[f'{x:.6g}' for x in l] for l in losses]}; launches {got} (expected {expected}); "
        f"host wall per iteration after the first {[f'{s:.3f}' for s in steady]} s; peak device "
        f"memory {run['peak_gb']:.2f} GB; sliders {list(run['loras'])}; files {files}")
    if got != expected:
        raise AssertionError(f"fleet image launches {got}, not {expected}")
    if list(run["loras"]) != names or files != expected_files:
        raise AssertionError(f"fleet image saved {files}, expected {expected_files}")
    if not all(math.isfinite(x) for l in losses for x in l) or any(len(l) != 2 for l in losses):
        raise AssertionError(f"fleet image losses {losses}")
    return {**got, "peak_gb": run["peak_gb"], "iteration_s": steady}


def phase_generate_fleet(snap: str, tmp: str) -> dict:
    """`generate_images --fleet A --fleet B` on the SD1.5 snapshot: one CSV
    row, one sample, FLEET_SCALES, DDIM FLEET_GENERATE_STEPS at 512 px: six
    rows in one denoise (#1 10 x steps, #4 one decode); each checkpoint's
    PNGs against its solo `--model_name` run at CONT_JOIN_PSNR or better
    (its rows sit at other batch positions: queue 3), the PSNR printed."""
    import torch

    from sliders_tpu_torch.cli import generate_images as gcli
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.serving.server import decode_rows_for

    root = os.path.join(tmp, "generate_fleet")
    os.makedirs(root)
    csv_path = os.path.join(root, "prompts.csv")
    with open(csv_path, "w") as f:
        f.write('case_number,prompt,evaluation_seed\n0,"a photo of a person, smiling",2\n')
    ckpts = [os.path.join(root, f"{n}_alpha1.0_rank4_noxattn_last.safetensors")
             for n in ("age", "smile")]
    for i, path in enumerate(ckpts):
        save_random_slider(path, unet2d.SD15, 60 + i)
    argv = ["--base", snap, "--prompts_path", csv_path,
            f"--scales={','.join(str(s) for s in FLEET_SCALES)}", "--image_size", "512",
            "--ddim_steps", str(FLEET_GENERATE_STEPS), "--device", "0"]

    def run(out, *extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flux_counts()
        t0 = time.perf_counter()
        res = gcli.main(gcli.build_parser().parse_args(argv + ["--save_path", out, *extra]))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, sampling_counts(), (
            torch.cuda.max_memory_allocated() / 1e9)

    res, wall, counts, peak = run(os.path.join(root, "fleet"), "--fleet", ckpts[0],
                                  "--fleet", ckpts[1])
    rows = len(ckpts) * len(FLEET_SCALES)
    expected = (ROUTED_PER_FORWARD * FLEET_GENERATE_STEPS, -(-rows // decode_rows_for(512)))
    (case, row_s), = res["cases"]
    names = [gcli.scale_folder_name(float(s)) for s in FLEET_SCALES]
    psnr = []
    for path, folder in zip(ckpts, res["folders"]):
        solo, _, _, _ = run(os.path.join(root, "solo"), "--model_name", path)
        (solo_folder,) = solo["folders"]
        if sorted(os.listdir(folder)) != sorted(names + ["all"]):
            raise AssertionError(f"generate --fleet: {folder} holds {os.listdir(folder)}")
        for sub in names:
            with open(os.path.join(folder, sub, f"{case}_0.png"), "rb") as f:
                a = f.read()
            with open(os.path.join(solo_folder, sub, f"{case}_0.png"), "rb") as f:
                b = f.read()
            psnr.append(png_diff(a, b)[2])
    say("generate", f"--fleet of 2 checkpoints x {len(FLEET_SCALES)} scales at 512 px, DDIM "
        f"{FLEET_GENERATE_STEPS}: {rows} rows in one denoise, {row_s:.3f} s the CSV row, {wall:.2f} "
        f"s the call with the load; launches (#1, #4) {counts} (expected {expected}); peak device "
        f"memory {peak:.2f} GB; PSNR against each checkpoint's solo run "
        f"{[f'{p:.2f}' for p in psnr]} dB (limit {CONT_JOIN_PSNR})")
    if counts != expected:
        raise AssertionError(f"generate --fleet: launches {counts}, not {expected}")
    if min(psnr) < CONT_JOIN_PSNR:
        raise AssertionError("generate --fleet departs from the checkpoints' solo runs")
    return {"sd": counts[0], "flash": counts[1], "row_s": row_s, "psnr": min(psnr),
            "peak_gb": peak}


def phase_adaptive(snap: str, tmp: str) -> dict:
    """The adaptive optimizers: ADAPTIVE_UPDATES updates of SD1.5's
    full-width rank-4 noxattn LoRA tree on CUDA against the CPU from the same
    seeded gradients (a common direction plus noise, so the step-size
    estimates grow), for prodigy, dadaptadam, dadaptadamw and dadaptlion
    (lr 1.0, weight decay 1e-2): each weight's difference held to
    ADAPTIVE_ULPS ulps of it plus ADAPTIVE_REL of its leaf's largest move, the
    estimates' relative difference printed, ms per update on the card
    (synced, median). Then a 2-iteration full-width
    `train_text_slider` run under `optimizer: prodigy` (lr 1.0): finite
    losses, every up factor moved, `estim_lr` after each iteration, launches
    as the AdamW run's."""
    import warnings

    import torch

    from sliders_tpu_torch.core import yaml_subset
    from sliders_tpu_torch.lora.network import create_slider_network, trainable_mask
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.training import optimizers

    gen = torch.Generator().manual_seed(70)
    lora = create_slider_network(gen, unet2d.init_params(None, unet2d.SD15, device="meta"),
                                 rank=4, train_method="noxattn")
    n_params = sum(t.numel() for e in lora.values() for k, t in e.items() if k != "alpha")
    base = {m: {k: torch.randn(t.shape, generator=gen) for k, t in e.items()}
            for m, e in lora.items()}
    grads = [{m: {k: base[m][k] + 0.1 * torch.randn(t.shape, generator=gen)
                  for k, t in e.items()} for m, e in lora.items()}
             for _ in range(ADAPTIVE_UPDATES)]
    gpu_grads = [tree_to(g, "cuda") for g in grads]
    rows = {}
    for name in ("prodigy", "dadaptadam", "dadaptadamw", "dadaptlion"):
        results = {}
        for device, gs in (("cpu", grads), ("cuda", gpu_grads)):
            w = tree_to({m: {k: t.clone() for k, t in e.items()} for m, e in lora.items()},
                        device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                tx = optimizers.make_optimizer(name, optimizers.make_lr_schedule(
                    "constant", 1.0, 100), {"weight_decay": 1e-2},
                    trainable_mask=trainable_mask(w))
            state = tx.init(w)
            ms = []
            for g in gs:
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                tx.update(w, g, state)
                if device == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            results[device] = (tree_to(w, "cpu"), float(state["estim_lr"]), ms)
        (cw, c_lr, _), (gw, g_lr, g_ms) = results["cpu"], results["cuda"]
        leaves = [(cw[m][k], gw[m][k], lora[m][k]) for m in cw for k in ("down", "up")]
        err = max((a - b).abs().max().item() for a, b, _ in leaves)
        move = max((a - w).abs().max().item() for a, _, w in leaves)
        # each element's difference over its limit
        worst = max(((a - b).abs() / (ADAPTIVE_ULPS * (torch.nextafter(
            a.abs(), torch.tensor(math.inf)) - a.abs()) + ADAPTIVE_REL * (a - w).abs().max())
                     ).max().item() for a, b, w in leaves)
        rows[name] = {"err": err, "of_limit": worst, "move": move, "estim_lr": g_lr,
                      "estim_lr_rel": abs(g_lr - c_lr) / c_lr, "ms": statistics.median(g_ms[1:])}
        say("adaptive", f"{name}: {ADAPTIVE_UPDATES} updates of the SD1.5 rank-4 noxattn LoRA "
            f"({len(lora)} modules, {n_params} trainable values) on the card against the CPU: "
            f"max|diff| {err:.3g} (the largest move {move:.3g}), at most {worst:.3g} of its limit "
            f"({ADAPTIVE_ULPS} ulps of the weight + {ADAPTIVE_REL} of its leaf's largest move); "
            f"estim_lr "
            f"{g_lr:.6g} vs {c_lr:.6g} (rel {rows[name]['estim_lr_rel']:.3g}); "
            f"{rows[name]['ms']:.2f} ms an update on the card (median of updates "
            f"2-{ADAPTIVE_UPDATES}, synced)")
        if worst > 1 or not math.isfinite(g_lr) or g_lr <= 1e-6:
            raise AssertionError(f"{name} on the card disagrees with the CPU or did not adapt")

    cfg = yaml_subset.load(os.path.join(REPO, "data", "config.yaml"))
    cfg["prompts_file"] = os.path.join(REPO, "data", "prompts.yaml")
    cfg["pretrained_model"]["name_or_path"] = snap
    cfg["train"].update(iterations=2, optimizer="prodigy", lr=1.0)
    cfg["save"].update(path=os.path.join(tmp, "prodigy_out"))
    cfg["logging"] = {"log_every": 1}
    run = run_training(cfg, os.path.join(tmp, "prodigy.yaml"), [],
                       probe=lambda state: {"estim_lr": float(state.opt_state["estim_lr"])})
    recs = run["records"]
    fwd_expected = expected_fwd(recs, bool(cfg["tpu"]["remat"]))
    moved = sum(bool(e["up"].abs().max() > 0) for e in run["lora"].values())
    losses = [f"{m['loss']:.6g}" for _, _, m in recs]
    estims = [f"{m['estim_lr']:.6g}" for _, _, m in recs]
    say("adaptive", f"train_text_slider under prodigy (lr 1.0), 2 iterations at full width: "
        f"t_to {[m['t_to'] for _, _, m in recs]}, losses {losses}, estim_lr {estims}; {moved} of "
        f"{len(run['lora'])} up factors moved; launches forward {run['fwd']} (expected "
        f"{fwd_expected}), backward {run['bwd']} (expected {2 * ROUTED_PER_FORWARD}); "
        f"{run['seconds']:.1f} s with the load")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["estim_lr"]) for _, _, m in recs):
        raise AssertionError("the prodigy run's losses or estimates are not finite")
    if moved != len(run["lora"]) or run["fwd"] != fwd_expected or (
            run["bwd"] != 2 * ROUTED_PER_FORWARD):
        raise AssertionError("the prodigy run did not train through the kernels")
    return {"optimizers": rows, "fwd": run["fwd"], "bwd": run["bwd"],
            "estim_lr": [m["estim_lr"] for _, _, m in recs]}


# ---------------------------------------------------------------------------
# offline slider sampling: generate_images, SDXL-Turbo, the scalar path
# ---------------------------------------------------------------------------


def sampling_counts() -> tuple:
    """(#1, #4) launches since the last `reset_flux_counts`."""
    counts = flux_counts()
    return counts["sd"], counts["flash"]


def load_example(name: str):
    """An example script of examples/ as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples",
                                                                     name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def save_random_slider(path: str, unet_cfg, seed: int, rank: int = 4) -> dict:
    """A rank-`rank` noxattn slider with nonzero up (0.05 x normal) for the
    module paths of `unet_cfg`, saved to `path` (CPU, f32)."""
    import torch

    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import unet2d

    gen = torch.Generator().manual_seed(seed)
    w = create_slider_network(gen, unet2d.init_params(None, unet_cfg, device="meta"), rank=rank,
                              alpha=1.0, train_method="noxattn")
    for e in w.values():
        e["up"] = torch.randn(e["up"].shape, generator=gen) * 0.05
    lora_io.save_slider(path, w)
    return w


def run_generate(tag: str, snap: str, out: str, csv_path: str, slider_args: list, scales: list,
                 extra: list, routed: int, steps: int, px: int) -> dict:
    """`cli/generate_images.py` in-process at `px` for one CSV row: the
    folders and files of the scorers' layout, PNGs that decode to distinct
    images across the scales and an all/ grid of their width; launches
    exact: #1 `routed` x `steps` (one denoise), #4 one per decode call."""
    import torch

    from sliders_tpu_torch.cli import generate_images as gcli
    from sliders_tpu_torch.serving.server import decode_rows_for

    argv = ["--base", snap, "--prompts_path", csv_path, "--save_path", out,
            f"--scales={','.join(str(s) for s in scales)}", "--image_size", str(px),
            "--ddim_steps", str(steps), "--device", "0", *slider_args, *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flux_counts()
    t0 = time.perf_counter()
    res = gcli.main(gcli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sampling_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    expected = (routed * steps, -(-len(scales) // decode_rows_for(px)))
    (folder,) = res["folders"]
    (case, row_s), = res["cases"]
    names = [gcli.scale_folder_name(float(s)) for s in scales]
    if sorted(os.listdir(folder)) != sorted(names + ["all"]):
        raise AssertionError(f"{tag}: folders {sorted(os.listdir(folder))}")
    pixels = []
    for sub in names + ["all"]:
        if os.listdir(os.path.join(folder, sub)) != [f"{case}_0.png"]:
            raise AssertionError(f"{tag}: {sub}/ holds {os.listdir(os.path.join(folder, sub))}")
        with open(os.path.join(folder, sub, f"{case}_0.png"), "rb") as f:
            w, h, px_bytes = png_pixels(f.read())
        if (w, h) != ((len(scales) if sub == "all" else 1) * px, px):
            raise AssertionError(f"{tag}: {sub}/{case}_0.png is {w}x{h}")
        if sub != "all":
            pixels.append(px_bytes)
    say("generate", f"{tag}: {len(scales)} scales at {px} px, {steps} steps, "
        f"{' '.join(extra) or 'ddim, guidance 7.5'}: {wall:.2f} s the call with the model "
        f"load, {row_s:.3f} s the CSV row (encode, denoise, decode, PNGs); launches (#1, #4) "
        f"{counts} (expected {expected}); {len(set(pixels))} distinct images; peak device "
        f"memory {peak:.2f} GB; folders {sorted(os.listdir(folder))}")
    if counts != expected:
        raise AssertionError(f"{tag}: launches {counts}, not {expected}")
    if len(set(pixels)) != len(scales):
        raise AssertionError(f"{tag}: the images are not distinct across the scales")
    return {"sd": counts[0], "flash": counts[1], "row_s": row_s, "wall_s": wall,
            "peak_gb": peak}


def merged_vs_branch(models, weights, prompt: str, steps: int, dtype) -> dict:
    """The SD1 example's scalar merged-delta path (`sweep_latents`, scale 1,
    LMS `steps`) against the per-row branch (a (1,) scale vector) on the
    same latents: max|err| of the final latents and their max|x|."""
    import torch

    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    example = load_example("sd1_slider_inference_torch")
    (merged,) = example.sweep_latents(models, weights, prompt, [1.0], scheduler="lms",
                                      steps=steps, start_noise=750.0, guidance=7.5, size=512,
                                      seed=0, dtype=dtype)
    sampler = make_sampler(make_schedule(), "lms", steps)
    fn = t2i.make_sampling_fn(models.unet_config, sampler, compute_dtype=dtype)
    te = models.text_encoders[0]
    cond = encode_prompts(te.tokenizer, te.params, te.config, [prompt])
    uncond = encode_prompts(te.tokenizer, te.params, te.config, [""])
    lats = t2i.initial_latents(torch.Generator().manual_seed(0), 1, 512, 512,
                               sampler.init_noise_sigma)
    branch = fn(models.unet_params, lats.to(cond.device), cond, uncond, weights,
                torch.ones(1), 750.0, 7.5)
    merged, branch = merged.float(), branch.float()
    if not (torch.isfinite(merged).all() and torch.isfinite(branch).all()):
        raise AssertionError("the merged or the per-row latents are not finite")
    return {"err": float((merged - branch).abs().max()), "max": float(branch.abs().max())}


def phase_generate(snap: str, tmp: str) -> dict:
    """`generate_images` on the full-width SD1.5 snapshot of `phase_train`
    with a rank-4 noxattn slider it saves: 1 CSV row, --scales=-2,-1,0,1,2,
    512 px, bf16, DDIM STEPS (#1 10 x STEPS, #4 1); then --scheduler lms,
    euler_a and ddpm at GENERATE_STEPS steps (#1 10 x GENERATE_STEPS each)
    and --compose a:1 --compose b:-1 (sweep 0, 1; GENERATE_STEPS steps).
    Then the scalar merged path (the SD1 example's) against the per-row
    path, LMS GENERATE_STEPS steps at scale 1 on the same latents,
    in f32 with TF32 off (held to GENERATE_F32_REL of max|x|) and in bf16
    (printed)."""
    import torch

    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import loader, unet2d
    from sliders_tpu_torch.models.params import tree_to

    gen_dir = os.path.join(tmp, "generate")
    os.makedirs(gen_dir)
    csv_path = os.path.join(gen_dir, "prompts.csv")
    with open(csv_path, "w") as f:
        f.write('case_number,prompt,evaluation_seed\n0,"a photo of a person, smiling",1\n')
    a = os.path.join(gen_dir, "age_alpha1.0_rank4_noxattn_last.safetensors")
    b = os.path.join(gen_dir, "eyes_alpha1.0_rank4_noxattn_last.safetensors")
    save_random_slider(a, unet2d.SD15, 50)
    save_random_slider(b, unet2d.SD15, 51)
    out = os.path.join(gen_dir, "out")
    # one CFG-doubled UNet forward a step: ROUTED_PER_FORWARD launches of #1
    runs = {"ddim": run_generate("sd15 ddim", snap, out, csv_path, ["--model_name", a], SWEEP,
                                 [], ROUTED_PER_FORWARD, STEPS, 512)}
    for kind in ("lms", "euler_a", "ddpm"):
        runs[kind] = run_generate(f"sd15 {kind}", snap, out, csv_path, ["--model_name", a], SWEEP,
                                  ["--scheduler", kind], ROUTED_PER_FORWARD, GENERATE_STEPS, 512)
    runs["compose"] = run_generate("sd15 compose", snap, out, csv_path,
                                   ["--compose", f"{a}:1", "--compose", f"{b}:-1"], [0, 1], [],
                                   ROUTED_PER_FORWARD, GENERATE_STEPS, 512)
    with tf32_flags(False, False):
        f32 = loader.load_sd(snap, device="cuda", dtype=torch.float32, load_vae=False)
        w = tree_to(lora_io.load_slider(a, f32.unet_params), "cuda")
        e32 = merged_vs_branch(f32, w, "a photo of a person, smiling", GENERATE_STEPS,
                               torch.float32)
        del f32
        gc.collect()
        torch.cuda.empty_cache()
    bf = loader.load_sd(snap, device="cuda", dtype=torch.bfloat16, load_vae=False)
    e16 = merged_vs_branch(bf, w, "a photo of a person, smiling", GENERATE_STEPS, torch.bfloat16)
    del bf
    say("generate", f"scalar merged path (examples/sd1_slider_inference_torch.py) against the "
        f"per-row path, LMS {GENERATE_STEPS} steps, scale 1, start_noise 750, same latents: f32 "
        f"(TF32 off) max|err| {e32['err']:.3e} of max|x| {e32['max']:.4g} (limit "
        f"{GENERATE_F32_REL:g} x max|x|); bf16 max|err| {e16['err']:.4g} of max|x| "
        f"{e16['max']:.4g}")
    if e32["err"] > GENERATE_F32_REL * e32["max"]:
        raise AssertionError("the f32 merged path departs from the per-row path")
    return {**runs, "merged_f32": e32, "merged_bf16": e16}


def phase_turbo(snap: str, tmp: str) -> dict:
    """SDXL-Turbo's path on the SDXL snapshot of `phase_sdxl`:
    `generate_images --xl --scheduler euler_a --ddim_steps 3 --guidance_scale 1
    --start_noise 700 --image_size 512`, 5 scales (no CFG: #1 10 x 3, the
    (5, 10, 1024, 64) shape; #4 1, the (5, 1, 4096, 512) decode). Then an
    SDXL SliderEngine with scheduler='euler_a' (3 steps, 512 px) on the same
    weights: a request (a) and, queued together behind it, two with the
    same seed (b, c); stats.batches grows by 3 (no coalescing), and (b)
    and (c) have the same PNG bytes."""
    import torch

    from sliders_tpu_torch.models import loader, unet2d
    from sliders_tpu_torch.serving.server import SliderEngine

    gen_dir = os.path.join(tmp, "turbo")
    os.makedirs(gen_dir)
    csv_path = os.path.join(gen_dir, "prompts.csv")
    with open(csv_path, "w") as f:
        f.write("case_number,prompt,evaluation_seed\n0,a photo of a person,2\n")
    slider = os.path.join(gen_dir, "muscular_alpha1.0_rank4_noxattn_last.safetensors")
    w = save_random_slider(slider, unet2d.SDXL, 52)
    run = run_generate("sdxl turbo", snap, os.path.join(gen_dir, "out"), csv_path,
                       ["--model_name", slider], SWEEP,
                       ["--xl", "--scheduler", "euler_a", "--guidance_scale", "1",
                        "--start_noise", "700"], SDXL_SD_512, TURBO_STEPS, 512)

    models = loader.load_sdxl(snap, device="cuda", dtype=torch.bfloat16, load_vae=True)
    engine = SliderEngine(models, device="cuda", scheduler="euler_a", steps=TURBO_STEPS,
                          image_size=512, guidance_scale=7.5, start_noise=700.0,
                          compute_dtype=torch.bfloat16)
    engine.register_slider("s1", w)

    def serve(port):
        stats0 = dict(engine.stats)
        replies = {}

        def call(key, seed, scales):
            replies[key] = post(port, "/generate", {"prompt": "a photo of a person",
                                                    "seed": seed, "slider": "s1",
                                                    "scales": scales})

        reset_flux_counts()
        # (a) fills the largest bucket, so (b) and (c) queue behind it
        ta = threading.Thread(target=call, args=("a", 1, TURBO_A_SCALES))
        ta.start()
        deadline = time.monotonic() + 600
        while sampling_counts()[0] == 0:
            if time.monotonic() > deadline or not ta.is_alive():
                raise AssertionError("turbo engine: request (a) never started denoising")
            time.sleep(0.002)
        tb = [threading.Thread(target=call, args=(k, 3, [-2, 2])) for k in ("b", "c")]
        for t in tb:
            t.start()
        queued = 0
        while engine.stats["batches"] == stats0["batches"] and ta.is_alive():
            queued = max(queued, len(engine._queue))
            time.sleep(0.002)
        for t in [ta, *tb]:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("turbo engine: a /generate call did not return")
        batches = engine.stats["batches"] - stats0["batches"]
        pngs = {k: [im["png"] for im in r["images"]] for k, r in replies.items()}
        for k, r in replies.items():
            check_images(r, TURBO_A_SCALES if k == "a" else [-2, 2], f"turbo engine {k}", 512)
        say("sdxl", f"euler_a engine (3 steps, 512 px): requests a (seed 1) and, queued together "
            f"behind it ({queued} in the queue at once), b and c (seed 3): {batches} batches "
            f"(expected 3: no coalescing); b and c PNG bytes "
            f"{'equal' if pngs['b'] == pngs['c'] else 'DIFFERENT'}; server latency "
            f"{[replies[k]['latency_ms'] for k in 'abc']} ms")
        if queued < 2 or batches != 3:
            raise AssertionError("the euler_a engine coalesced requests, or (b) and (c) were "
                                 "never queued together")
        if pngs["b"] != pngs["c"]:
            raise AssertionError("the euler_a engine does not repeat a seed bit for bit")
        return {"batches": batches, "queued": queued}

    served = serve_http(engine, serve)
    del engine, models
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "engine": served}


def phase_flux_scalar(models, weights) -> dict:
    """FLUX-dev at 1024 px, FlowMatch FLUX_SCALAR_STEPS steps, bf16: the
    FLUX example's scalar merged-delta call (scale 1.5, skip_till 0) against
    the same call with the scale as a (1,) vector (the per-row branch) and
    against scale 0; launches #1 57 x steps x 3 calls; max|err| of the
    packed latents beside the slider's own effect, and the peak memory
    (the merged weights add about the size of the targeted weights)."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_flowmatch_sampler
    from sliders_tpu_torch.pipelines.flux_t2i import (encode_prompts_flux,
                                                      initial_packed_latents,
                                                      make_flux_sampling_fn)

    example = load_example("flux_slider_inference_torch")
    prompt, n = "a portrait photo", FLUX_SCALAR_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    reset_flux_counts()
    t0 = time.perf_counter()
    (merged,) = example.sweep_latents(models, weights, prompt, [1.5], steps=n, skip_till=0,
                                      size=1024, seed=0)
    torch.cuda.synchronize()
    merged_s = time.perf_counter() - t0
    merged_peak = torch.cuda.max_memory_allocated() / 1e9
    sampler = make_flowmatch_sampler(num_steps=n, image_seq_len=(1024 // 16) ** 2)
    fn = make_flux_sampling_fn(models.transformer_config, sampler, latent_hw=128)
    pooled, t5e = encode_prompts_flux(models, [prompt])
    lats = initial_packed_latents(torch.Generator().manual_seed(0), 1, 1024, 1024,
                                  models.vae_config.latent_channels).to("cuda")
    t0 = time.perf_counter()
    branch = fn(models.transformer_params, lats, pooled, t5e, weights, torch.full((1,), 1.5),
                torch.zeros(1), 3.5)
    torch.cuda.synchronize()
    branch_s = time.perf_counter() - t0
    base = fn(models.transformer_params, lats, pooled, t5e, None, 0.0, 0.0, 3.5)
    counts = sampling_counts()
    expected = (FLUX_BLOCKS * n * 3, 0)
    merged, branch, base = merged.float(), branch.float(), base.float()
    err = float((merged - branch).abs().max())
    effect = float((branch - base).abs().max())
    say("flux", f"scalar merged path (examples/flux_slider_inference_torch.py) at 1024 px, {n} "
        f"steps, scale 1.5, skip_till 0, bf16: max|err| against the per-row branch {err:.4g} "
        f"(the slider's own effect, branch against scale 0: {effect:.4g}; max|x| "
        f"{float(branch.abs().max()):.4g}); {merged_s:.2f} s merged (the merge included) / "
        f"{branch_s:.2f} s branch; launches (#1, #4) {counts} (expected {expected}); peak device "
        f"memory {merged_peak:.2f} GB in the merged call, {base_gb:.2f} GB held before it")
    if counts != expected:
        raise AssertionError(f"flux scalar: launches {counts}, not {expected}")
    if not (math.isfinite(err) and err < 0.5 * effect):
        raise AssertionError("the FLUX merged path departs from the per-row branch by as much "
                             "as the slider moves the latents")
    return {"sd": counts[0], "err": err, "effect": effect, "peak_gb": merged_peak,
            "merged_s": merged_s, "branch_s": branch_s}


def png_diff(a: bytes, b: bytes) -> tuple:
    """(max |pixel difference|, share of differing values, PSNR in dB) of
    two of the engine's PNGs of one size."""
    import numpy as np

    pa, pb = (np.frombuffer(png_pixels(p)[2], np.uint8).astype(np.int64) for p in (a, b))
    d = np.abs(pa - pb)
    mse = float(np.mean(d * d))
    return int(d.max()), float(np.mean(d > 0)), (10 * math.log10(255.0 ** 2 / mse)
                                                 if mse else float("inf"))


def continuous_run(models, sliders: dict, tag: str, kind: str, px: int, steps: int, chunk: int,
                   routed: int, b_slider: str) -> dict:
    """One continuous engine (CONT_ROWS rows in flight, `chunk` steps a call)
    behind the HTTP server: request (a), 5 scales of slider s1, and request
    (b), CONT_B_SCALES of `b_slider`, sent once (a)'s first chunk has
    started, so (b) joins (a)'s live batch after that chunk. Each chunk and the join are timed with a
    device sync around the call. Launches exact: #1 `routed` x `chunk` x
    chunks (every chunk runs `chunk` CFG-doubled forwards of the whole
    bucket), #4 one per exit decode (2); chunks = the chunk (b) joined
    after + ceil(steps / chunk). Then both requests through a boundary
    engine at bucket CONT_ROWS: (a), whose rows hold the slots of its run
    there, byte for byte; (b), which joins at other slots, to CONT_JOIN_PSNR
    (see it)."""
    import torch

    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.serving.server import SliderEngine

    kw = dict(device="cuda", scheduler=kind, steps=steps, image_size=px, guidance_scale=7.5,
              start_noise=750.0, compute_dtype=torch.bfloat16)
    cont = SliderEngine(models, continuous=True, continuous_rows=CONT_ROWS, chunk_steps=chunk,
                        **kw)
    for name in {"s1", b_slider}:
        cont.register_slider(name, sliders[name])
    chunk_ms, join_ms, joined_after = [], [], []
    step_fn, join_fn = cont._cont_fn, cont._cont_join_state

    def timed_chunk(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_join(*args):
        joined_after.append(cont.stats["chunks"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = join_fn(*args)
        torch.cuda.synchronize()
        join_ms.append((time.perf_counter() - t) * 1e3)
        return out

    cont._cont_fn, cont._cont_join_state = timed_chunk, timed_join
    req = {"a": {"prompt": "a photo of a person", "seed": 1, "slider": "s1", "scales": SWEEP},
           "b": {"prompt": "a photo of a person, smiling", "seed": 2, "slider": b_slider,
                 "scales": CONT_B_SCALES}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flux_counts()

    def run(port):
        replies = {}

        def call(key):
            t = time.perf_counter()
            replies[key] = (post(port, "/generate", req[key]), time.perf_counter() - t)

        ta = threading.Thread(target=call, args=("a",))
        ta.start()
        deadline = time.monotonic() + 600
        while sa.sd_attention.launches == 0:  # (a)'s first chunk has started
            if time.monotonic() > deadline or not ta.is_alive():
                raise AssertionError(f"{tag}: request (a) never started its first chunk")
            time.sleep(0.002)
        tb = threading.Thread(target=call, args=("b",))
        tb.start()
        for t in (ta, tb):
            t.join(timeout=900)
            if t.is_alive():
                raise AssertionError(f"{tag}: a /generate call did not return")
        return replies

    replies = serve_http(cont, run)
    counts, peak = sampling_counts(), torch.cuda.max_memory_allocated() / 1e9
    n_chunks = -(-steps // chunk)
    if sorted(replies) != ["a", "b"] or len(joined_after) != 1:
        raise AssertionError(f"{tag}: replies {sorted(replies)}, joins {joined_after}: (b) did "
                             f"not join (a)'s live batch")
    chunks = cont.stats["chunks"]
    expected = (routed * chunk * chunks, 2)
    px_a = check_images(replies["a"][0], SWEEP, f"{tag} a", px)
    check_images(replies["b"][0], CONT_B_SCALES, f"{tag} b", px)
    if px_a[0] == px_a[-1]:
        raise AssertionError(f"{tag}: the -2 and +2 images are identical: the slider did nothing")

    boundary = SliderEngine(models, buckets=(CONT_ROWS,), **kw)
    for name in {"s1", b_slider}:
        boundary.register_slider(name, sliders[name])
    solo, solo_s = {}, {}
    try:
        for key, r in req.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            solo[key] = boundary.generate(r["prompt"], seed=r["seed"], slider=r["slider"],
                                          scales=r["scales"])
            solo_s[key] = time.perf_counter() - t
    finally:
        boundary.close(timeout=60)
    diffs = {}
    for key in req:
        served = [base64.b64decode(im["png"]) for im in replies[key][0]["images"]]
        ref = [png for _, png in solo[key]]
        diffs[key] = [png_diff(a, b) for a, b in zip(served, ref)]
    equal = {key: all(d[0] == 0 for d in ds) for key, ds in diffs.items()}
    shown = {key: "byte-equal" if equal[key] else
             [f"max {m} levels on {share:.4f} of values, PSNR {psnr:.2f} dB"
              for m, share, psnr in ds] for key, ds in diffs.items()}
    say("continuous", f"{tag} {kind}, {px} px, {steps} steps, {CONT_ROWS} rows, chunk {chunk}: "
        f"(a) 5 scales server latency {replies['a'][0]['latency_ms']} ms (client "
        f"{replies['a'][1] * 1e3:.1f}); (b) {len(CONT_B_SCALES)} scales joined after chunk "
        f"{joined_after[0]}: server latency {replies['b'][0]['latency_ms']} ms (client "
        f"{replies['b'][1] * 1e3:.1f}); chunks {chunks} (expected {joined_after[0]} + "
        f"{n_chunks}; two solo runs {2 * n_chunks}); chunk ms median "
        f"{statistics.median(chunk_ms):.2f} (min {min(chunk_ms):.2f}, max {max(chunk_ms):.2f}, "
        f"{len(chunk_ms)} chunks, synced), join {join_ms[0]:.2f} ms; launches (#1, #4) {counts} "
        f"(expected {expected}); peak device memory {peak:.2f} GB")
    say("continuous", f"{tag} {kind}: boundary engine at bucket {CONT_ROWS}: (a) "
        f"{solo_s['a']:.3f} s, (b) {solo_s['b']:.3f} s; (b) queued behind (a) there would wait "
        f"out (a): {(solo_s['a'] + solo_s['b']) * 1e3:.1f} ms against "
        f"{replies['b'][0]['latency_ms']} ms joined; PNGs against the continuous engine's: "
        f"{shown}")
    if chunks != joined_after[0] + n_chunks:
        raise AssertionError(f"{tag}: {chunks} chunks, not {joined_after[0]} + {n_chunks}")
    if counts != expected:
        raise AssertionError(f"{tag}: launches {counts}, not {expected}")
    join_psnr = min(d[2] for d in diffs["b"])
    if not equal["a"] or join_psnr < CONT_JOIN_PSNR:
        raise AssertionError(f"{tag} {kind}: against the boundary engine (a) is "
                             f"{shown['a']}, (b) {shown['b']} (limit {CONT_JOIN_PSNR} dB)")
    return {"sd": counts[0], "flash": counts[1], "chunks": chunks, "joined_after": joined_after[0],
            "chunk_ms": statistics.median(chunk_ms), "join_ms": join_ms[0],
            "latency_ms": {k: replies[k][0]["latency_ms"] for k in req},
            "boundary_s": solo_s, "equal": equal, "join_psnr": join_psnr, "peak_gb": peak}


def phase_continuous(models, sliders: dict) -> dict:
    """SD1.5 at full width, 512 px, bf16, DDIM and LMS at CONT_STEPS:
    `continuous_run` on the HTTP phase's models and sliders ((b) on slider
    s2: a stacked batch of two adapters)."""
    return {kind: continuous_run(models, sliders, "SD1.5", kind, 512, CONT_STEPS, CONT_CHUNK,
                                 ROUTED_PER_FORWARD, "s2") for kind in CONT_KINDS}


def phase_sdxl_continuous(engine) -> dict:
    """SDXL-base at full width, 1024 px, bf16, DDIM SDXL_HTTP_STEPS (cut as
    the SDXL http phase cuts them), chunk SDXL_CONT_CHUNK: `continuous_run`
    with one join, both requests on slider s1."""
    return continuous_run(engine.models, engine.sliders, "SDXL", "ddim", SDXL_PX,
                          SDXL_HTTP_STEPS, SDXL_CONT_CHUNK, SDXL_SD_1024, "s1")


def edit_test_image(px: int):
    """A (px, px, 3) uint8 test picture: smooth colour ramps, a bright disc
    and a dark bar."""
    import numpy as np

    yy, xx = np.mgrid[0:px, 0:px] / px
    img = np.stack([0.2 + 0.6 * xx, 0.3 + 0.5 * yy, 0.5 + 0.3 * np.sin(6 * xx * yy)], -1)
    img[(xx - 0.55) ** 2 + (yy - 0.45) ** 2 < 0.05] = (0.95, 0.85, 0.7)
    img[(yy > 0.75) & (yy < 0.82) & (xx > 0.2) & (xx < 0.8)] = 0.1
    return (img * 255).round().astype(np.uint8)


def edit_launches(losses: dict, steps: int, routed: int, routed_bwd: int) -> tuple:
    """(#1, #2) of `edit_image` at `steps` steps: `routed` forward launches
    per UNet forward (the inversion's, each null-text step's conditional
    forward, its inner steps' and its advance, the CFG-doubled edit's) and
    `routed_bwd` backward launches per inner step."""
    inner = sum(len(v) for v in losses.values())
    return routed * (2 * steps + 2 * steps + inner), routed_bwd * inner


def phase_edit(snap: str, tmp: str) -> dict:
    """Real-image editing on the full-width SD1.5 snapshot of `phase_train`,
    f32 (its bf16 UNet weights cast up), TF32 off: `edit_image` on a 512 px
    PNG the phase writes (read back by examples/edit_real_image_torch.py's
    `load_image`), a rank-4 noxattn slider, scales EDIT_SCALES, start_noise
    500, DDIM steps cut from 50 to EDIT_STEPS and null-text inner steps cut
    from 10 to EDIT_INNER. Prints each step's null-text losses, the scale-0
    reconstruction's PSNR against the input, the seconds of each part, the
    peak memory and an uncut (50 x 10) time extrapolated per forward and per
    inner step. Launches exact: #1 and #2 (`edit_launches`), #4 two (the
    encoder's mid attention (1, 1, 4096, 512), the 3-row decode's)."""
    import numpy as np
    import torch

    from sliders_tpu_torch.models import loader, unet2d
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.pipelines.inversion import edit_image
    from sliders_tpu_torch.serving.server import encode_png

    path = os.path.join(tmp, "edit_input.png")
    with open(path, "wb") as f:
        f.write(encode_png(edit_test_image(512)))
    image = load_example("edit_real_image_torch").load_image(path, 512)
    with tf32_flags(False, False):
        models = loader.load_sd(snap, device="cuda", dtype=torch.float32, load_vae=True)
        w = tree_to(save_random_slider(os.path.join(tmp, "edit.safetensors"), unet2d.SD15, 60),
                    "cuda")
        losses, timings = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flux_counts()
        t0 = time.perf_counter()
        out = edit_image(models, image, "a photo of a person", w, EDIT_SCALES,
                         num_steps=EDIT_STEPS, start_noise=EDIT_START_NOISE, guidance_scale=7.5,
                         num_inner_steps=EDIT_INNER,
                         on_step=lambda i, ls: losses.setdefault(i, ls), timings=timings)
        wall = time.perf_counter() - t0
        counts = (sa.sd_attention.launches, sa.sd_attention_bwd.launches,
                  flux_counts()["flash"])
        peak = torch.cuda.max_memory_allocated() / 1e9
    del models
    inner = sum(len(v) for v in losses.values())
    expected = edit_launches(losses, EDIT_STEPS, ROUTED_PER_FORWARD, EDIT_ROUTED_BWD) + (2,)
    ref = (image + 1.0) * 127.5
    mse = float(np.mean((out[0.0].astype(np.float64) - ref) ** 2))
    psnr = 10 * math.log10(255.0 ** 2 / mse) if mse else float("inf")
    for i in sorted(losses):
        say("edit", f"null-text step {i}: {len(losses[i])} updates, losses "
            f"{' '.join(f'{x:.4e}' for x in losses[i])}")
    per_fwd = timings["inversion"] / EDIT_STEPS
    per_inner = (timings["null_text"] - 2 * EDIT_STEPS * per_fwd) / inner
    uncut = (timings["encode"] + 50 * per_fwd + 50 * (2 * per_fwd + 10 * per_inner)
             + timings["edit"] * 50 / EDIT_STEPS + timings["decode"])
    say("edit", f"SD1.5 f32 (TF32 off), 512 px, scales {EDIT_SCALES}, start_noise "
        f"{EDIT_START_NOISE:g}; cut: DDIM steps 50 -> {EDIT_STEPS}, null-text inner steps 10 -> "
        f"{EDIT_INNER}: {wall:.2f} s (encode {timings['encode']:.3f}, inversion "
        f"{timings['inversion']:.3f}, null-text {timings['null_text']:.3f} for {inner} inner "
        f"steps, edit {timings['edit']:.3f} ({len(EDIT_SCALES)} rows, CFG-doubled), decode "
        f"{timings['decode']:.3f}); {per_fwd * 1e3:.1f} ms a batch-1 forward, "
        f"{per_inner * 1e3:.1f} ms an inner step (forward + backward + Adam); uncut 50 x 10 "
        f"extrapolated {uncut:.1f} s; scale-0 reconstruction PSNR {psnr:.2f} dB against the "
        f"input (random weights); launches (#1, #2, #4) {counts} (expected {expected}); peak "
        f"device memory {peak:.2f} GB")
    if counts != expected:
        raise AssertionError(f"edit: launches {counts}, not {expected}")
    for s, img in out.items():
        if img.shape != (512, 512, 3) or img.dtype != np.uint8:
            raise AssertionError(f"edit: the scale-{s} image is {img.shape} {img.dtype}")
    if np.array_equal(out[EDIT_SCALES[0]], out[EDIT_SCALES[-1]]):
        raise AssertionError("edit: the slider did nothing")
    return {"sd": counts[0], "sd_bwd": counts[1], "flash": counts[2], "seconds": timings,
            "per_inner_ms": per_inner * 1e3, "uncut_s": uncut, "psnr": psnr, "peak_gb": peak,
            "inner": inner}


def phase_attention_maps(snap: str, tmp: str) -> dict:
    """examples/attention_maps_torch.py's `word_maps` on the full-width SD1.5
    snapshot in f32 (TF32 off) at 512 px, t 501: one forward under a tap
    that wants only attn2 (#1 takes the 10 self-attentions: 10 launches)
    and one under an unfiltered tap (every call on the plain path: 0).
    Every probability row sums to 1 within PROB_SUM_TOL; eps under each tap
    is held to eps of the untapped forward within MAPS_EPS_REL of its
    largest value (the tapped calls run the plain f32 path, the routed ones
    #1's 3xTF32 kernel); the 16 x 16 word maps are written as PNGs."""
    import torch

    from sliders_tpu_torch.models import loader, unet2d
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    example = load_example("attention_maps_torch")
    prompt = "a photo of an old person"
    with tf32_flags(False, False):
        models = loader.load_sd(snap, device="cuda", dtype=torch.float32)
        te = models.text_encoders[0]
        ehs = encode_prompts(te.tokenizer, te.params, te.config, [prompt])
        lat = t2i.initial_latents(torch.Generator().manual_seed(0), 1, 512, 512, 1.0)
        with torch.inference_mode():
            eps_ref = unet2d.apply(models.unet_params, models.unet_config, lat.cuda(),
                                   torch.tensor([501.0]), ehs)
        runs = {}
        for name, flt in (("attn2", lambda n: n.endswith("attn2")), ("all", None)):
            torch.cuda.synchronize()
            reset_flux_counts()
            t0 = time.perf_counter()
            eps, raw, maps = example.word_maps(models, prompt, t=501.0, size=512, res=16,
                                               attn_filter=flt)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = sa.sd_attention.launches
            err = float((eps - eps_ref).abs().max())
            sum_err = max(float((p.sum(-1) - 1).abs().max()) for p in raw.values())
            files = example.save_maps(maps, os.path.join(tmp, f"maps_{name}"))
            runs[name] = {"sd": launches, "taps": len(raw), "err": err, "sum_err": sum_err,
                          "ms": ms, "maps": len(files)}
            del raw
        ref_max = float(eps_ref.abs().max())
    del models
    expected = {"attn2": (ROUTED_PER_FORWARD, 16), "all": (0, 32)}
    for name, r in runs.items():
        say("maps", f"tap wanting {name}: {r['taps']} call sites stored, #1 launches {r['sd']} "
            f"(expected {expected[name][0]}); max |row sum - 1| {r['sum_err']:.3g} (limit "
            f"{PROB_SUM_TOL:g}); eps max|err| against the untapped forward {r['err']:.3g} of "
            f"max|eps| {ref_max:.4g} (limit {MAPS_EPS_REL:g} x); {r['maps']} 16 x 16 word maps "
            f"written; {r['ms']:.1f} ms the forward with its maps")
        if (r["sd"], r["taps"]) != expected[name] or r["maps"] < 3:
            raise AssertionError(f"maps {name}: launches {r['sd']}, taps {r['taps']}, maps "
                                 f"{r['maps']}")
        if r["sum_err"] > PROB_SUM_TOL or r["err"] > MAPS_EPS_REL * ref_max:
            raise AssertionError(f"maps {name}: the probabilities or eps are off")
    return runs


# ---------------------------------------------------------------------------
# the eval harness: UCE, textual inversion, custom diffusion, CLIP / LPIPS
# ---------------------------------------------------------------------------


def eval_csv(path: str, seed: int) -> str:
    with open(path, "w") as f:
        f.write(f'case_number,prompt,evaluation_seed\n0,"a photo of a person, smiling",{seed}\n')
    return path


def run_eval_cli(tag: str, module, argv: list, expected: tuple) -> tuple:
    """`module.main` in-process on CUDA device 0: (its result, its wall
    seconds); launches (#1, #4) exact, the peak memory printed."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flux_counts()
    t0 = time.perf_counter()
    res = module.main(module.build_parser().parse_args(argv + ["--device", "0"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sampling_counts()
    say("eval", f"{tag}: {wall:.2f} s the call with the model load, "
        f"{[round(s, 3) for _, s in res['cases']]} s the CSV row; launches (#1, #4) {counts} "
        f"(expected {expected}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if counts != expected:
        raise AssertionError(f"{tag}: launches {counts}, not {expected}")
    return res, wall


def full_vocab_snapshot(snap: str, root: str) -> str:
    """`snap` under `root` with its weights linked and its tokenizers
    rewritten at CLIP's full vocabulary (49408 ids, the embedding matrices'
    rows), so that a token the CLIs add gets id 49408 and grows the matrix,
    as with the real tokenizer files."""
    from sliders_tpu_torch.models import clip_text

    os.makedirs(root)
    for sub in os.listdir(snap):
        if sub.startswith("tokenizer"):
            os.makedirs(os.path.join(root, sub))
            write_tokenizer(os.path.join(root, sub), clip_text.CLIP_L.vocab_size)
        else:
            os.symlink(os.path.join(snap, sub), os.path.join(root, sub))
    return root


def png_files(folder: str) -> dict:
    """{name: pixel bytes} of the 512 px PNGs of `folder`."""
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = png_pixels(f.read())
    return out


def phase_uce(snap: str, tmp: str) -> dict:
    """UCE on the full-width SD1.5 snapshot of `phase_train`: an edited UNet
    state dict (.pt) = the snapshot's UNet + UCE_NOISE x normal (seeded),
    then `generate_images_uce --scales=-1,0,1 --ddim_steps 10 --image_size
    512 --num_samples 1` (LMS): #1 10 x 10 x 3, #4 3 (one decode a scale);
    three distinct PNGs and an all/ strip. Then in-process: at scale 0
    `make_uce_sampling_fn` gives the latents of `make_sampling_fn` with no
    adapter, byte for byte (the interpolation at 0 is the base tree)."""
    import torch

    from sliders_tpu_torch.cli import generate_images_uce
    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.evals.baselines import make_uce_sampling_fn
    from sliders_tpu_torch.models.convert import read_safetensors
    from sliders_tpu_torch.pipelines import text2image as t2i
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    d = os.path.join(tmp, "uce")
    os.makedirs(d)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(70)
    state = read_safetensors(os.path.join(snap, "unet", "diffusion_pytorch_model.safetensors"))
    edited = {}
    for k, v in state.items():
        v = v.to("cuda")
        noise = torch.randn(v.shape, generator=gen, device="cuda") * UCE_NOISE
        scale = max(float(v.float().abs().mean()), 1e-3)
        edited[k] = (v.float() + noise * scale).to(v.dtype).cpu()
    ckpt = os.path.join(d, "uce_age.pt")
    torch.save(edited, ckpt)
    del state, edited
    say("eval", f"uce sd15: edited UNet state dict written in {time.perf_counter() - t0:.1f} s")
    csv_path = eval_csv(os.path.join(d, "prompts.csv"), 3)
    argv = ["--model_name", ckpt, "--prompts_path", csv_path, "--base", snap, "--save_path",
            os.path.join(d, "out"), f"--scales={','.join(str(s) for s in UCE_SCALES)}",
            "--ddim_steps", str(UCE_STEPS), "--image_size", "512", "--num_samples", "1"]
    res, wall = run_eval_cli("uce sd15", generate_images_uce, argv,
                             (ROUTED_PER_FORWARD * UCE_STEPS * len(UCE_SCALES), len(UCE_SCALES)))
    folder = res["folder"]
    names = ["-1", "0", "1"]
    if sorted(os.listdir(folder)) != sorted(names + ["all"]):
        raise AssertionError(f"uce sd15: folders {sorted(os.listdir(folder))}")
    pixels = {n: png_files(os.path.join(folder, n))["0_0.png"] for n in names}
    strip = png_files(os.path.join(folder, "all"))["0_0.png"]
    if {px[:2] for px in pixels.values()} != {(512, 512)} or strip[:2] != (1536, 512):
        raise AssertionError("uce sd15: image sizes")
    if len({px[2] for px in pixels.values()}) != len(names):
        raise AssertionError("uce sd15: the three scales' PNGs are not distinct")

    models, edited = res.pop("models"), res.pop("edited_params")  # the CLI's, loaded once
    sampler = make_sampler(make_schedule(), "lms", UCE_STEPS)
    te = models.text_encoders[0]
    cond = encode_prompts(te.tokenizer, te.params, te.config, ["a photo of a person, smiling"])
    uncond = encode_prompts(te.tokenizer, te.params, te.config, [""])
    lats = t2i.initial_latents(torch.Generator().manual_seed(3), 1, 512, 512,
                               sampler.init_noise_sigma).cuda()
    uce0 = make_uce_sampling_fn(models.unet_config, sampler)(
        models.unet_params, edited, lats, cond, uncond, 0.0, 800.0, 7.5)
    uce1 = make_uce_sampling_fn(models.unet_config, sampler)(
        models.unet_params, edited, lats, cond, uncond, 1.0, 800.0, 7.5)
    base = t2i.make_sampling_fn(models.unet_config, sampler)(
        models.unet_params, lats, cond, uncond, None, 0.0, 800.0, 7.5)
    same = torch.equal(uce0, base)
    moved = float((uce1.float() - base.float()).abs().max())
    say("eval", f"uce sd15: at scale 0 the UCE sampler's latents are the adapter-free "
        f"sampler's {'byte for byte' if same else 'NOT byte for byte'}; at scale 1 they move "
        f"by max|dx| {moved:.4g} (max|x| {float(base.float().abs().max()):.4g})")
    if not same or moved == 0.0:
        raise AssertionError("uce sd15: scale 0 is not the base sampler, or scale 1 is")
    row_s = res["cases"][0][1]
    del models, edited, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"sd": ROUTED_PER_FORWARD * UCE_STEPS * len(UCE_SCALES), "flash": len(UCE_SCALES),
            "row_s": row_s, "wall_s": wall, "folder": folder, "csv": csv_path}


def phase_ti(snap: str, tmp: str) -> dict:
    """Textual inversion on the same snapshot (`full_vocab_snapshot`): a .pt
    embedding for TI_TOKEN, which the vocabulary cannot spell (the CLI adds
    it as id 49408 and grows the matrix), DDIM TI_STEPS steps at 512 px: #1
    10 x TI_STEPS, #4 1; the encoder's new row equals the file's vector (drawn
    bf16-exact)."""
    import torch

    from sliders_tpu_torch.cli import generate_images_text_inversion

    d = os.path.join(tmp, "ti")
    os.makedirs(d)
    vec = torch.randn(768, generator=torch.Generator().manual_seed(71)).bfloat16().float()
    emb = os.path.join(d, "eyes_embeds.pt")
    torch.save({TI_TOKEN: vec}, emb)
    argv = ["--model_name", full_vocab_snapshot(snap, os.path.join(d, "sd15")),
            "--prompts_path", eval_csv(os.path.join(d, "p.csv"), 4),
            "--token", TI_TOKEN, "--embedding_file", emb, "--save_path", os.path.join(d, "out"),
            "--ddim_steps", str(TI_STEPS), "--image_size", "512", "--num_samples", "1"]
    expected = (ROUTED_PER_FORWARD * TI_STEPS, 1)
    res, wall = run_eval_cli("ti sd15", generate_images_text_inversion, argv, expected)
    (te,) = res["text_encoders"]
    tid = te.tokenizer.convert_tokens_to_ids(TI_TOKEN)
    emb_w = te.params["text_model"]["embeddings"]["token_embedding"]["weight"]
    row_ok = tid == emb_w.shape[0] - 1 and torch.equal(emb_w[tid].float().cpu(), vec)
    files, res_row = png_files(res["folder"]), res["cases"][0][1]
    say("eval", f"ti sd15: token {TI_TOKEN!r} added as id {tid} of {emb_w.shape[0]}; the "
        f"encoder's row {'equals' if row_ok else 'DIFFERS FROM'} the file's vector; files "
        f"{sorted(files)}")
    if not row_ok or sorted(files) != ["0_0.png"] or files["0_0.png"][:2] != (512, 512):
        raise AssertionError("ti sd15: the learned row or the output")
    del res, te, emb_w
    gc.collect()
    torch.cuda.empty_cache()
    return {"sd": expected[0], "flash": expected[1], "row_s": res_row, "wall_s": wall}


def phase_custom_diffusion(snap: str, tmp: str) -> dict:
    """Custom diffusion on the SDXL snapshot of `phase_sdxl`
    (`full_vocab_snapshot`): a delta
    checkpoint (attn2 to_k / to_v of every transformer block as rank-CD_RANK
    {'u','v'} factors, a modifier token with a 768- and a 1280-wide
    embedding) run with --compress at the CLI's default 1024 px, DDIM 4
    steps: #1 70 x 4, #4 1; the run named after the checkpoint's folder."""
    import torch

    from sliders_tpu_torch.cli import generate_images_custom_diffusion
    from sliders_tpu_torch.models import unet2d
    from sliders_tpu_torch.utils.pytree import flatten

    d = os.path.join(tmp, "custom_diffusion", "eyebrows_run")
    os.makedirs(d)
    gen = torch.Generator().manual_seed(72)
    meta = flatten(unet2d.init_params(None, unet2d.SDXL, device="meta"))
    deltas = {k: {"u": torch.randn(w.shape[0], CD_RANK, generator=gen) * 0.02,
                  "v": torch.randn(CD_RANK, w.shape[1], generator=gen) * 0.02}
              for k, w in meta.items() if k.endswith(("attn2.to_k.weight", "attn2.to_v.weight"))}
    ckpt = os.path.join(d, "delta.pt")
    torch.save({"unet": deltas, "modifier_token": {CD_TOKEN: [
        torch.randn(768, generator=gen) * 0.02, torch.randn(1280, generator=gen) * 0.02]}}, ckpt)
    argv = ["--model_name", ckpt, "--prompts_path",
            eval_csv(os.path.join(tmp, "custom_diffusion", "p.csv"), 5), "--token", CD_TOKEN,
            "--base", full_vocab_snapshot(snap, os.path.join(tmp, "custom_diffusion", "sdxl")),
            "--compress", "--save_path",
            os.path.join(tmp, "custom_diffusion", "out"), "--ddim_steps", str(CD_STEPS),
            "--num_samples", "1"]
    expected = (SDXL_SD_1024 * CD_STEPS, 1)
    res, wall = run_eval_cli(f"custom diffusion sdxl ({len(deltas)} compressed deltas)",
                             generate_images_custom_diffusion, argv, expected)
    files = png_files(res["folder"])
    tes = res["text_encoders"]
    rows = [te.params["text_model"]["embeddings"]["token_embedding"]["weight"].shape[0]
            for te in tes]
    if os.path.basename(res["folder"]) != "eyebrows_run" or sorted(files) != ["0_0.png"] \
            or files["0_0.png"][:2] != (CD_PX, CD_PX) or rows != [49409, 49409]:
        raise AssertionError(f"custom diffusion sdxl: output {res['folder']} {sorted(files)}, "
                             f"embedding rows {rows}")
    row_s = res["cases"][0][1]
    del res, tes
    gc.collect()
    torch.cuda.empty_cache()
    return {"sd": expected[0], "flash": expected[1], "row_s": row_s, "wall_s": wall}


def write_score_models(d: str) -> tuple:
    """A ViT-B/32 CLIP snapshot on seeded weights (config.json,
    model.safetensors, the synthetic tokenizer; the text tower at
    openai/clip-vit-base-patch32's widths, its vocabulary and 77
    positions) and AlexNet / LPIPS .pth files in the torchvision and lpips
    layouts. Returns (clip dir, alexnet path, lpips path)."""
    import dataclasses

    import torch

    from sliders_tpu_torch.evals import lpips
    from sliders_tpu_torch.models import clip_vision

    clip_dir = os.path.join(d, "clip-vit-base-patch32")
    os.makedirs(clip_dir)
    write_tokenizer(clip_dir)
    with open(os.path.join(clip_dir, "vocab.json")) as f:
        eos = json.load(f)["<|endoftext|>"]
    tcfg = dataclasses.replace(clip_vision.VIT_B32_TEXT, eos_token_id=eos)
    gen = torch.Generator().manual_seed(73)
    clip_vision.save_clip_model(clip_dir, clip_vision.init_params(
        gen, clip_vision.VIT_B32, tcfg, projection_dim=tcfg.projection_dim),
        clip_vision.VIT_B32, tcfg)
    alex, lins = lpips.torchvision_state(lpips.init_params(gen))
    paths = os.path.join(d, "alexnet.pth"), os.path.join(d, "alex.pth")
    torch.save(alex, paths[0])
    torch.save(lins, paths[1])
    return (clip_dir, *paths)


def phase_scores(run_folder: str, csv_path: str, tmp: str) -> dict:
    """`clip_score` and `lpips_score` (--true 0) on the UCE run folder with
    ViT-B/32 and AlexNet on seeded weights, on the card and on the CPU (the
    scorers turn TF32 off): every score within SCORE_REL relative, the
    columns the scale folders', no launch of #1 or #4 (ViT-B/32's 50 tokens
    and AlexNet take the plain paths), LPIPS(x, x) = 0 on the card; then
    the per-image time of each scorer on the card, the models loaded."""
    import torch

    from sliders_tpu_torch.cli import clip_score, lpips_score
    from sliders_tpu_torch.evals import lpips, scoring
    from sliders_tpu_torch.models import clip_vision

    d = os.path.join(tmp, "scores")
    os.makedirs(d)
    clip_dir, alex, lins = write_score_models(d)
    clip_argv = ["--im_path", run_folder, "--prompt", "a photo of an old person",
                 "--prompts_path", csv_path, "--clip_model", clip_dir]
    lpips_argv = ["--im_path", run_folder, "--prompts_path", csv_path, "--true", "0",
                  "--alexnet_weights", alex, "--lpips_weights", lins]
    tables = {}
    for device in ("0", "cpu"):
        reset_flux_counts()
        t0 = time.perf_counter()
        tables[device] = {
            "clip": clip_score.main(clip_score.build_parser().parse_args(
                clip_argv + ["--device", device])),
            "lpips": lpips_score.main(lpips_score.build_parser().parse_args(
                lpips_argv + ["--device", device]))}
        say("eval", f"scores on {'the card' if device == '0' else 'the CPU'}: "
            f"{time.perf_counter() - t0:.2f} s both CLIs with the model loads; launches "
            f"(#1, #4) {sampling_counts()}")
        if sampling_counts() != (0, 0):
            raise AssertionError("scores: a scorer launched an attention kernel")
    errs = {}
    for kind, want_cols in (("clip", ["clip_-1", "clip_0", "clip_1"]),
                            ("lpips", ["lpips_-1", "lpips_1"])):
        gpu, cpu = tables["0"][kind], tables["cpu"][kind]
        if list(gpu) != ["case_number", "prompt", "evaluation_seed", *want_cols] \
                or list(cpu) != list(gpu):
            raise AssertionError(f"scores: {kind} columns {list(gpu)}")
        for col in want_cols:
            (g,), (c,) = gpu[col], cpu[col]
            if not (math.isfinite(g) and math.isfinite(c)):
                raise AssertionError(f"scores: {col} is not finite: {g} / {c}")
            errs[col] = abs(g - c) / max(abs(c), 1e-30)
        say("eval", f"{kind} scores card / CPU: "
            f"{[(col, gpu[col][0], cpu[col][0]) for col in want_cols]}")
    worst = max(errs.values())

    params, vcfg, tcfg, tok = clip_vision.load_clip_model(clip_dir, "cuda")
    lp = lpips.load_torch_weights(alex, lins, "cuda")
    x = lpips.load_image_64(os.path.join(run_folder, "0", "0_0.png")).cuda()
    with tf32_flags(False, False):
        self_dist = float(lpips.lpips_distance(lp, x, x)[0])
    per_folder = {f: len(os.listdir(os.path.join(run_folder, f))) for f in ("-1", "0", "1")}
    n_images, n_pairs = sum(per_folder.values()), per_folder["-1"] + per_folder["1"]
    times = {}
    for kind, fn in (("clip", lambda: scoring.clip_scores(
            run_folder, "a photo of an old person", csv_path, params, vcfg, tcfg, tok)),
                     ("lpips", lambda: scoring.lpips_scores(run_folder, "0", csv_path, lp))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[kind] = (time.perf_counter() - t0) * 1e3
    say("eval", f"scores: max relative error card vs CPU {worst:.3g} (limit {SCORE_REL:g}; "
        f"{errs}); LPIPS(x, x) on the card {self_dist}; a second call on loaded models: CLIP "
        f"{times['clip']:.1f} ms for {n_images} images ({times['clip'] / n_images:.1f} ms an "
        f"image, decode and CSV included), LPIPS {times['lpips']:.1f} ms for "
        f"{n_pairs} pairs ({times['lpips'] / n_pairs:.1f} ms a pair)")
    if worst > SCORE_REL or self_dist != 0.0:
        raise AssertionError("scores: the card's scores depart from the CPU's, or LPIPS(x, x) "
                             "is not 0")
    return {"sd": 0, "flash": 0, "max_rel_err": worst, "clip_ms_per_image":
            times["clip"] / n_images, "lpips_ms_per_pair": times["lpips"] / n_pairs}


def phase_tiny_edit() -> dict:
    """`edit_image` on a tiny snapshot (TINY UNet and VAE) at 64 px on the
    GPU (the kernels: #1 at the level-0 self-attentions, L = 1024, and the
    VAE's mid attentions, #2 in the null-text backward) against the CPU
    (plain paths), f32 with TF32 off: the DDIM inversion within
    TINY_EDIT_REL of the largest value, then the whole edit (3 steps, 2
    inner steps, scales 0 and 2): the uint8 images within TINY_EDIT_PIXELS
    (max level, share of values). The GPU run's launches exact."""
    import numpy as np
    import torch

    from sliders_tpu_torch.diffusion import make_sampler, make_schedule
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.pipelines import inversion
    from sliders_tpu_torch.pipelines.encoding import encode_prompts

    rng = np.random.default_rng(21)
    image = (edit_test_image(64) / 127.5 - 1.0).astype(np.float32)
    clean = rng.standard_normal((1, 32, 32, 4)).astype(np.float32) * 0.5
    with tf32_flags(False, False), tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "sd_tiny")
        write_tiny_sd_snapshot(snap)
        res = {}
        for dev in ("cuda", "cpu"):
            m = loader.load_sd(snap, device=dev, dtype=torch.float32, load_vae=True)
            w = create_slider_network(torch.Generator().manual_seed(4), m.unet_params, rank=2,
                                      alpha=1.0, train_method="noxattn")
            for e in w.values():
                e["up"] = e["up"] + 0.2
            te = m.text_encoders[0]
            cond = encode_prompts(te.tokenizer, te.params, te.config, ["a person"])
            sampler = make_sampler(make_schedule(), "ddim", TINY_EDIT_STEPS)
            traj = inversion.make_ddim_inversion_fn(m.unet_config, sampler)(
                m.unet_params, torch.tensor(clean, device=dev), cond)
            reset_flux_counts()
            losses = {}
            out = inversion.edit_image(m, image, "a person", tree_to(w, dev), [0.0, 2.0],
                                       num_steps=TINY_EDIT_STEPS, num_inner_steps=TINY_EDIT_INNER,
                                       on_step=lambda i, ls: losses.setdefault(i, ls))
            res[dev] = {"traj": traj.cpu(), "out": out, "losses": losses,
                        "counts": (sa.sd_attention.launches, sa.sd_attention_bwd.launches)}
    g, c = res["cuda"], res["cpu"]
    terr = float((g["traj"] - c["traj"]).abs().max())
    tmax = float(c["traj"].abs().max())
    worst = max((int(np.abs(g["out"][s].astype(int) - c["out"][s].astype(int)).max()),
                 float((g["out"][s] != c["out"][s]).mean())) for s in c["out"])
    expected = edit_launches(g["losses"], TINY_EDIT_STEPS, TINY_IMAGE_ROUTED,
                             TINY_EDIT_ROUTED_BWD)
    expected = (expected[0] + 2, expected[1])  # the VAE's encode and decode mid attentions
    say("tiny edit", f"GPU vs CPU, f32: inversion max|err| {terr:.3g} of max {tmax:.4g} (limit "
        f"{TINY_EDIT_REL:g} x); edit images (0, 2) at 64 px: worst (max level, share) {worst} "
        f"(limit {TINY_EDIT_PIXELS}); null-text updates GPU {sum(map(len, g['losses'].values()))}"
        f" CPU {sum(map(len, c['losses'].values()))}; GPU launches (#1, #2) {g['counts']} "
        f"(expected {expected})")
    if terr > TINY_EDIT_REL * tmax:
        raise AssertionError("tiny edit: the GPU inversion departs from the CPU's")
    if worst[0] > TINY_EDIT_PIXELS[0] or worst[1] > TINY_EDIT_PIXELS[1]:
        raise AssertionError("tiny edit: the GPU images depart from the CPU's")
    if g["counts"] != expected:
        raise AssertionError(f"tiny edit: launches {g['counts']}, not {expected}")
    return {"sd": g["counts"][0], "sd_bwd": g["counts"][1], "traj_err": terr, "worst": worst}


def f16_entries(f16: dict, train: dict, sdxl: dict, tiny_fp16: dict) -> list:
    """The kernels line's f16 variants (`precision: fp16`): #1 and #2 with
    their launches in the SD1.5 fp16 training run (beside the fleet's, the
    SDXL run's and the tiny run's), #9 in the SDXL fp16 run with the pin on,
    #5 in the fp16 fleet run under 'auto' (beside the tiny run's), #6 and #7
    in the tiny fp16 runs under their conv impls; times, bounds and
    errors at the first shape phase_f16_kernels lists, every shape's under
    "shapes", each beside its bf16 twin's time."""
    fp16, xl16 = train["fp16"], sdxl["train"]["fp16"]
    where = {
        "sd_attention_fwd": ("sliders_tpu_torch/csrc/sd_attention.cu",
                             "sliders_tpu/ops/pallas_attention.py:43", fp16["fwd"],
                             {"train_fp16": fp16["fwd"], "fleet_fp16": fp16["fleet"]["fwd"],
                              "sdxl_train_512_fp16": xl16["sd"], "tiny_fp16": tiny_fp16["sd"]}),
        "sd_attention_bwd": ("sliders_tpu_torch/csrc/sd_attention_bwd.cu",
                             "sliders_tpu/ops/pallas_attention.py:156", fp16["bwd"],
                             {"train_fp16": fp16["bwd"], "fleet_fp16": fp16["fleet"]["bwd"],
                              "sdxl_train_512_fp16": xl16["sd_bwd"],
                              "tiny_fp16": tiny_fp16["sd_bwd"]}),
        "layout_pin": ("sliders_tpu_torch/csrc/layout_pin.cu", "sliders_tpu/ops/basic.py:339",
                       xl16["pin"], {"sdxl_train_512_fp16_pin_on": xl16["pin"]}),
        "conv3x3": ("sliders_tpu_torch/csrc/conv3x3.cu", "sliders_tpu/ops/pallas_conv.py:44",
                    fp16["fleet"]["conv"]["conv3x3"],
                    {"fleet_fp16_auto": fp16["fleet"]["conv"]["conv3x3"],
                     "tiny_fp16_auto": tiny_fp16["conv3x3"]}),
        "epi_conv3x3": ("sliders_tpu_torch/csrc/conv3x3.cu", "sliders_tpu/ops/pallas_conv.py:409",
                        tiny_fp16["epi_conv3x3"], {"tiny_fp16_fused_ep": tiny_fp16["epi_conv3x3"]}),
        "fused_conv3x3": ("sliders_tpu_torch/csrc/conv3x3.cu",
                          "sliders_tpu/ops/pallas_conv.py:208", tiny_fp16["fused_conv3x3"],
                          {"tiny_fp16_fused": tiny_fp16["fused_conv3x3"]}),
    }
    out = []
    for name, (source, replaces, launches, by_path) in where.items():
        rows = f16[name]
        out.append({"name": f"{name}_f16", "route": "cuda", "source": source,
                    "replaces": replaces, "dtype": "float16", "launches": launches,
                    "launches_by_path": by_path, "max_abs_err": max(r["err"] for r in rows),
                    **{k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "bf16_ms")},
                    "shapes": [{k: r[k] for k in ("shape", "ms", "bf16_ms", "plain_ms",
                                                  "library_ms", "bound_ms", "bound_by")}
                               for r in rows]})
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_rank(argv: list) -> int:
    """One rank of the mesh launch (`chip_smoke.py --mesh-rank OUT
    TEXT-ARGS... --fleet FLEET-ARGS...` under torch.distributed.run): the
    rank joins the process group (`maybe_initialize_distributed`), runs the
    text CLI, then `train_fleet` (f32, TF32 off), each in-process on that
    group, with #1 and #2's counts set to 0 just before each run and read
    just after and #1's calls counted by head count; writes OUT.{rank}.json,
    and rank 0 the text run's last train state (OUT.state.pt) and the
    fleet's rows (OUT.rows.pt)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from sliders_tpu_torch.cli import train_fleet as fleet_cli
    from sliders_tpu_torch.cli import train_text_slider as text_cli
    from sliders_tpu_torch.ops import sd_attention as sa
    from sliders_tpu_torch.parallel.mesh import maybe_initialize_distributed

    out, rest = argv[0], argv[1:]
    cut = rest.index("--fleet")
    text_args, fleet_args = rest[:cut], rest[cut + 1:]
    maybe_initialize_distributed(torch.device("cuda"))
    rank = dist.get_rank()
    heads = count_heads()

    def run(main) -> dict:
        records = []
        heads.clear()
        sa.sd_attention.launches = sa.sd_attention_bwd.launches = 0
        t0 = time.perf_counter()
        main(records)
        torch.cuda.synchronize()
        return {"records": records, "fwd": sa.sd_attention.launches,
                "bwd": sa.sd_attention_bwd.launches, "heads": dict(heads),
                "seconds": time.perf_counter() - t0}

    def text(records):
        def on_step(i, state, m):
            records.append({k: m[k] for k in ("loss", "grad_norm", "t_to", "pair")}
                           | {"i": i, "host_s": time.perf_counter()})
            if rank == 0:
                torch.save(state.state_dict(), f"{out}.state.pt")

        text_cli.main(text_cli.build_parser().parse_args(text_args), on_step=on_step)

    def fleet(records):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        rows = fleet_cli.main(fleet_cli.build_parser().parse_args(fleet_args), on_step=lambda
                              i, s, m: records.append({"i": i, "loss": m["loss"],
                                                       "t_to": m["t_to"], "loop": m["loop"]}))
        if rank == 0:
            torch.save(rows, f"{out}.rows.pt")

    result = {"rank": rank, "text": run(text), "fleet": run(fleet),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def launch_ranks(tag: str, n: int, out: str, args: list, entry: str = "--mesh-rank",
                 timeout: float = MESH_LAUNCH_TIMEOUT_S) -> list:
    """`n` ranks of `mesh_rank` (or the rank function of `entry`) under
    torch.distributed.run on this card (a process group of their own,
    killed whole past `timeout` seconds); prints the launch's mesh lines,
    rank 0's step lines and its [time] line; returns the ranks' records."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "localhost", "--master_port", str(free_port()),
           os.path.join(REPO, "chip_smoke.py"), entry, out, *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{tag}: the ranks ran past {timeout} s:\n{log[-3000:]}")
    secs = time.perf_counter() - t0
    for line in log.splitlines():
        if line.startswith(("mesh ", "tp=", "fleet of", "step ", "fleet step ", "resumed",
                            "serving ", "create LoRA")):
            say("mesh", f"{tag}: {line}")
    say("time", f"mesh launch {tag} ({n} ranks): {secs:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: torch.distributed.run exited {proc.returncode}:\n"
                             f"{log[-4000:]}")
    ranks = []
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


def count_heads() -> dict:
    """{head count: calls} of kernel #1's forward from here on (the
    attention router's entry wrapped)."""
    from sliders_tpu_torch.ops import attention as att

    heads: dict = {}
    kernel = att.sd_attention

    def by_heads(q, k, v, *a, **kw):
        heads[q.shape[1]] = heads.get(q.shape[1], 0) + 1
        return kernel(q, k, v, *a, **kw)

    att.sd_attention = by_heads
    return heads


def tiny_flux_mesh_steps(mesh=None) -> list:
    """(c) of "mesh flux": MESH_FLUX_TINY_ITERATIONS FLUX slider steps of
    TINY at MESH_FLUX_TINY_PX, batch 2, f32 with TF32 off, remat, an
    ortho-up rank-4 xattn LoRA at lr TINY_FLUX_LR, max_denoising_steps
    TINY_FLUX_TRAIN_STEPS, on the draws of seed 0, on `mesh` (this rank's tp
    shard of every block) or unsharded; the weights, LoRA and pairs drawn on
    the CPU from fixed seeds. Returns [(metrics, LoRA on the CPU)] per
    iteration."""
    import torch

    from sliders_tpu_torch.diffusion.schedulers import make_flowmatch_sampler
    from sliders_tpu_torch.lora import network as lnet
    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.parallel import mesh as pm
    from sliders_tpu_torch.training import flux_slider, optimizers
    from sliders_tpu_torch.training.text_slider import SliderTrainState, stack_prompt_pairs

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, gen = flux.TINY, torch.Generator().manual_seed(23)
    params = flux.init_params(gen, cfg)
    lora = lnet.create_slider_network(gen, params, rank=4, alpha=1.0, train_method="xattn",
                                      ortho_up=True)
    pairs = stack_prompt_pairs([{
        **{f"{r}_t5": torch.randn(16, cfg.joint_attention_dim, generator=gen)
           for r in flux_slider.ROLES},
        **{f"{r}_pooled": torch.randn(cfg.pooled_projection_dim, generator=gen)
           for r in flux_slider.ROLES},
        "guidance_signed": torch.tensor(sign)} for sign in (2.0, -1.0)])
    params = tree_to(params, "cuda")
    if mesh is not None:
        params = flux.keep_blocks(params, pm.tp_keep(mesh))
    mask = lnet.trainable_mask(lora, ortho_up=True)
    tx = optimizers.make_optimizer(
        "adamw", optimizers.make_lr_schedule("constant", TINY_FLUX_LR, 100), trainable_mask=mask)
    px = MESH_FLUX_TINY_PX
    step = flux_slider.make_flux_slider_step(
        cfg, make_flowmatch_sampler(num_steps=TINY_FLUX_TRAIN_STEPS, image_seq_len=(px // 16) ** 2),
        tx, resolution=px, batch_size=2, compute_dtype=torch.float32, remat=True, mesh=mesh,
        trainable_mask=mask)
    state = SliderTrainState.create(0, tree_to(lora, "cuda"), tx)
    pairs = {k: v.cuda() for k, v in pairs.items()}
    out = []
    for _ in range(MESH_FLUX_TINY_ITERATIONS):
        state, m = step(state, params, pairs)
        out.append(({k: m[k] for k in ("t_to", "pair", "loss", "grad_norm")},
                    {n: {k: t.cpu() for k, t in e.items()} for n, e in state.lora.items()}))
    return out


def draw_flux_models(gen, keep, tokenizers, vae_too: bool):
    """FLUX-dev in bf16 on the card drawn from `gen` in `build_flux_engine`'s
    order (transformer, T5-XXL, CLIP-L, VAE), each transformer block passed
    through `keep` as it is drawn. Without `tokenizers` (the CLIP and T5
    tokenizer directories) only the transformer (a pipeline follower's),
    else the FluxModels, with the VAE when `vae_too`."""
    import torch

    from sliders_tpu_torch.models import clip_text, flux, t5, vae
    from sliders_tpu_torch.models.loader import FluxModels, TextEncoderBundle
    from sliders_tpu_torch.text.t5_tokenizer import T5Tokenizer
    from sliders_tpu_torch.text.tokenizer import ClipTokenizer

    bf16 = torch.bfloat16
    transformer = flux.init_params(gen, flux.FLUX_DEV, dtype=bf16, device="cuda", keep=keep)
    if tokenizers is None:
        return transformer
    tok_dir, t5_dir = tokenizers
    tok = ClipTokenizer.from_pretrained(tok_dir)
    tok.model_max_length = clip_text.CLIP_L.max_positions
    t5_params = t5.init_params(gen, t5.T5_XXL, dtype=bf16, device="cuda")
    clip = TextEncoderBundle(tok, clip_text.init_params(gen, clip_text.CLIP_L, dtype=bf16,
                                                        device="cuda"), clip_text.CLIP_L)
    return FluxModels(
        transformer, flux.FLUX_DEV, clip, t5_params, t5.T5_XXL,
        T5Tokenizer.from_pretrained(t5_dir),
        vae_params=vae.init_params(gen, vae.FLUX_VAE, dtype=bf16, device="cuda")
        if vae_too else None, vae_config=vae.FLUX_VAE if vae_too else None)


def mesh_flux_train(tmp: str, tokenizers: tuple, rank: int, heads: dict) -> dict:
    """(a) of "mesh flux": `train_flux_sliders` (the CLI's loop) at FLUX-dev's
    full width on the `training_mesh` of `tpu: {dp: 1, tp: 2}` (the CLI's
    mesh: the surplus ranks wait), each rank drawing the weights in the
    world-1 order and keeping its tp shard (`parallel.mesh.tp_keep`), with
    phase_flux_train's 512 px config and seed."""
    import torch

    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.parallel import mesh as pm
    from sliders_tpu_torch.parallel.mesh import main_rank_output, training_mesh
    from sliders_tpu_torch.training.driver import train_flux_sliders

    config, prompts, _ = flux_train_config(tmp, 512, tp=2)
    batch = prompts[0].batch_size
    mesh, device = training_mesh(torch.device("cuda"), config.tpu.dp, config.tpu.tp,
                                 fit_dp=lambda dp, world: dp if batch % dp == 0 else 1)
    if not mesh.active:
        mesh.finish()
        return {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = draw_flux_models(torch.Generator(device="cuda").manual_seed(11),
                              pm.tp_keep(mesh), tokenizers, False)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(models.transformer_params))
    drawn = time.perf_counter() - t0
    records = []
    reset_flux_counts()
    heads.clear()
    t0 = time.perf_counter()
    with main_rank_output(mesh):
        final = train_flux_sliders(config, prompts, models, seed=0, t5_len=512, mesh=mesh,
                                   on_step=lambda i, st, m: records.append(
                                       {k: m[k] for k in ("t_to", "pair", "loss", "grad_norm")}))
    torch.cuda.synchronize()
    out = {"records": records, "counts": flux_counts(), "heads": dict(heads),
           "seconds": time.perf_counter() - t0, "draw_s": drawn, "transformer_params": n_params,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        torch.save(final, os.path.join(tmp, "mesh_flux_lora.pt"))
    del models, final
    mesh.finish()
    return out


def mesh_flux_serve(tokenizers: tuple) -> dict:
    """(b) of "mesh flux": `serve --flux --pp 2` at 1024 px and
    FLUX_STEPS[1024] steps through the CLI's functions (`pipeline_mesh`,
    `make_engine`, `make_follower`) on in-memory weights: each rank draws
    the weights in the world-1 order and keeps its stage (`pp_keep`); rank
    0 also draws the encoders, the VAE and the two sliders (on the whole
    transformer's names), serves phase_flux_http's sweep (a) and
    NO_SLIDER_REQUEST over HTTP and closes; rank 1 follows."""
    import torch

    from sliders_tpu_torch.cli import serve as serve_cli
    from sliders_tpu_torch.lora.network import create_slider_network
    from sliders_tpu_torch.models import flux
    from sliders_tpu_torch.parallel.pipeline import pp_keep
    from sliders_tpu_torch.serving.server import make_http_server

    args = serve_cli.build_parser().parse_args(
        ["--flux", "--pp", "2", "--base", "(in memory)", "--image_size", "1024",
         "--ddim_steps", str(FLUX_STEPS[1024]), "--no_warmup"])
    mesh, device = serve_cli.pipeline_mesh(args)
    if not mesh.active:
        mesh.finish()
        return {}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    stage = mesh.coord("pp")
    models = draw_flux_models(gen, pp_keep(mesh, flux.FLUX_DEV), None if stage else tokenizers,
                              True)
    transformer = models if stage else models.transformer_params
    torch.cuda.synchronize()
    blocks = {f: sorted(int(i) for i in transformer[f])
              for f in ("transformer_blocks", "single_transformer_blocks")}
    n_params = sum(t.numel() for t in _leaves(transformer))
    drawn = time.perf_counter() - t0
    reset_flux_counts()
    t0 = time.perf_counter()
    out = {"blocks": blocks, "transformer_params": n_params, "draw_s": drawn}
    if stage:
        follower = serve_cli.make_follower(args, mesh, device, stage=(models, flux.FLUX_DEV))
        follower.run()
        out["forwards"] = follower.stats["forwards"]
    else:
        engine = serve_cli.make_engine(args, models=models, mesh=mesh, device=device)
        skeleton = flux.init_params(None, flux.FLUX_DEV, device="meta")
        for name in ("s1", "s2"):
            w = create_slider_network(gen, skeleton, rank=4, alpha=1.0, train_method="xattn",
                                      device="cuda")
            for e in w.values():
                e["up"] = torch.randn(e["up"].shape, generator=gen, device="cuda") * 0.05
            engine.register_slider(name, w)
        server = make_http_server(engine, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        try:
            replies = {key: post(port, "/generate", payload) for key, payload in (
                ("a", {"prompt": "a photo of a person", "seed": 1, "slider": "s1",
                       "scales": SWEEP}), ("none", NO_SLIDER_REQUEST))}
        finally:
            server.shutdown()
            server.server_close()
            engine.close(timeout=60)
        out["latency_ms"] = {k: r["latency_ms"] for k, r in replies.items()}
        out["pngs"] = {k: [im["png"] for im in r["images"]] for k, r in replies.items()}
        out["stats"] = dict(engine.stats)
        del engine
    torch.cuda.synchronize()
    out.update(counts=flux_counts(), seconds=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del models
    mesh.finish()
    return out


def mesh_flux_rank(argv: list) -> int:
    """One rank of the "mesh flux" launch (`chip_smoke.py --mesh-flux-rank
    OUT TMP TOKENIZER_DIR T5_TOKENIZER_DIR` under torch.distributed.run, 4
    ranks on this card): the rank joins the process group, runs (c) the
    TINY 2 x 2 step, (a) the tp = 2 FLUX-dev training and (b) the pp = 2
    FLUX-dev server, counting #1 (by heads), #2 and #4 around each, and
    writes OUT.{rank}.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from sliders_tpu_torch.parallel import mesh as pm

    out, tmp, tokenizers = argv[0], argv[1], (argv[2], argv[3])
    pm.maybe_initialize_distributed(torch.device("cuda"))
    rank = dist.get_rank()
    heads = count_heads()
    result = {"rank": rank}
    mesh = pm.make_mesh(dp=2, tp=2, device=torch.device("cuda"))
    t0 = time.perf_counter()
    seen = tiny_flux_mesh_steps(mesh)
    result["tiny"] = {"metrics": [m for m, _ in seen], "seconds": time.perf_counter() - t0}
    if rank == 0:
        torch.save(seen[-1][1], os.path.join(tmp, "mesh_flux_tiny_lora.pt"))
    mesh.finish()
    gc.collect()
    torch.cuda.empty_cache()
    result["train"] = mesh_flux_train(tmp, tokenizers, rank, heads)
    gc.collect()
    torch.cuda.empty_cache()
    result["serve"] = mesh_flux_serve(tokenizers)
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def phase_mesh_flux(flux: dict, tmp: str) -> dict:
    """FLUX-dev over the process mesh, one torchrun launch of 4 ranks on the
    card over gloo (`mesh_flux_rank`), against phase_flux's world-1 records
    (its models freed first): (c) TINY at dp 2 x tp 2, f32 with TF32 off,
    against a world-1 run of the same step here (loss and grad norm within
    MESH_FLUX_TINY_REL, the LoRA within MESH_FLUX_TINY_ATOL); (a)
    `train_flux_sliders` at tp = 2, bf16, 512 px, with phase_flux_train's
    config and seed: t_to equal, loss and grad norm within MESH_REL, #1
    (57 x sum(t_to + 3), all at MESH_FLUX_HEADS heads) and #2 (57 an
    iteration) per rank exact, every down moved and every up / alpha equal
    to the init bit for bit; (b) `serve --flux --pp 2` at 1024 px
    answering phase_flux_http's sweep and NO_SLIDER_REQUEST: PSNR at least
    CONT_JOIN_PSNR against the world-1 PNGs (bit equality printed), #1 per
    rank MESH_FLUX_STAGE_BLOCKS x steps x batches, #4 once a decode on rank
    0; each rank's peak device memory."""
    import torch

    t0 = time.perf_counter()
    ref = tiny_flux_mesh_steps()
    say("mesh", f"flux (c) world 1, TINY {MESH_FLUX_TINY_PX} px f32: "
        f"{[m for m, _ in ref]} ({time.perf_counter() - t0:.1f} s)")
    out = os.path.join(tmp, "mesh_flux")
    ranks = launch_ranks("flux: 2 x 2 TINY, tp = 2 training, pp = 2 serving", 4, out,
                         [tmp, os.path.join(tmp, "tokenizer"), os.path.join(tmp, "tokenizer_2")],
                         entry="--mesh-flux-rank",
                         timeout=MESH_FLUX_LAUNCH_TIMEOUT_S)

    # (c)
    tiny = [r["tiny"]["metrics"] for r in ranks]
    lora = torch.load(os.path.join(tmp, "mesh_flux_tiny_lora.pt"))
    rel = max(max(abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm"))
              for a, (b, _) in zip(tiny[0], ref))
    err = max((lora[n][k] - ref[-1][1][n][k]).abs().max().item() for n in lora for k in lora[n])
    say("mesh", f"flux (c) 2 x 2 TINY: {tiny[0]}; largest relative difference of loss or grad "
        f"norm against world 1 {rel:.3g} (tol {MESH_FLUX_TINY_REL}), LoRA max|diff| {err:.3g} "
        f"(tol {MESH_FLUX_TINY_ATOL}); {ranks[0]['tiny']['seconds']:.1f} s a rank")
    if any(t != tiny[0] for t in tiny) or [(m["t_to"], m["pair"]) for m in tiny[0]] != [
            (m["t_to"], m["pair"]) for m, _ in ref] or rel > MESH_FLUX_TINY_REL \
            or err > MESH_FLUX_TINY_ATOL:
        raise AssertionError("the 2 x 2 TINY FLUX run does not repeat world 1")

    # (a)
    train = [r["train"] for r in ranks[:2]]
    recs, w1 = train[0]["records"], flux["train"][512]["metrics"]
    t_tos = [m["t_to"] for m in recs]
    fwd = FLUX_BLOCKS * sum(t + 3 for t in t_tos)
    bwd = FLUX_BLOCKS * len(recs)
    rel = max(max(abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm"))
              for a, b in zip(recs, w1))
    init, final = flux["train"]["init"], torch.load(os.path.join(tmp, "mesh_flux_lora.pt"))
    moved = sum(not torch.equal(final[m]["down"], init[m]["down"]) for m in init)
    frozen = sum(torch.equal(final[m]["up"], init[m]["up"])
                 and torch.equal(final[m]["alpha"], init[m]["alpha"]) for m in init)
    say("mesh", f"flux (a) tp = 2 training, 512 px bf16: {recs} against world 1 {w1}: largest "
        f"relative difference of loss or grad norm {rel:.3g} (tol {MESH_REL}); per rank #1 "
        f"{[t['counts']['sd'] for t in train]} by heads {[t['heads'] for t in train]} (expected "
        f"{fwd} at {MESH_FLUX_HEADS}), #2 {[t['counts']['sd_bwd'] for t in train]} (expected "
        f"{bwd}); {moved} of {len(init)} down factors moved, {frozen} up/alpha pairs equal to "
        f"the init; transformer params a rank {[t['transformer_params'] for t in train]}; draw "
        f"s {[round(t['draw_s'], 1) for t in train]}, loop s "
        f"{[round(t['seconds'], 1) for t in train]}; peak GB "
        f"{[round(t['peak_gb'], 2) for t in train]}")
    if any(t["records"] != recs for t in train) or t_tos != [m["t_to"] for m in w1] \
            or rel > MESH_REL:
        raise AssertionError("the tp = 2 FLUX-dev training does not repeat world 1")
    if any(t["counts"]["sd"] != fwd or t["counts"]["sd_bwd"] != bwd
           or t["heads"] != {str(MESH_FLUX_HEADS): fwd} for t in train):
        raise AssertionError(f"a tp = 2 rank's joint attentions did not all go through #1 and "
                             f"#2 at {MESH_FLUX_HEADS} heads")
    if moved != len(init) or frozen != len(init):
        raise AssertionError("the tp = 2 run's LoRA moved a frozen factor or left a down")

    # (b)
    serve = [r["serve"] for r in ranks[:2]]
    lead = serve[0]
    batches = lead["stats"]["batches"]
    want = [FLUX_STEPS[1024] * batches * n for n in MESH_FLUX_STAGE_BLOCKS]
    diffs = {k: [png_diff(base64.b64decode(a), b) for a, b in zip(lead["pngs"][k],
                                                                  flux["serve_1024"]["pngs"][k])]
             for k in ("a", "none")}
    equal = all(d[0] == 0 for ds in diffs.values() for d in ds)
    psnr = min(d[2] for ds in diffs.values() for d in ds)
    say("mesh", f"flux (b) serve --flux --pp 2, 1024 px, {FLUX_STEPS[1024]} steps: blocks a "
        f"stage {[{f: (b[0], b[-1], len(b)) for f, b in t['blocks'].items()} for t in serve]}, "
        f"transformer params {[t['transformer_params'] for t in serve]}; latency ms "
        f"{lead['latency_ms']}; against world 1: bit-equal {equal}, min PSNR {psnr:.2f} dB "
        f"(limit {CONT_JOIN_PSNR}); #1 per rank {[t['counts']['sd'] for t in serve]} (expected "
        f"{want}), #4 {[t['counts']['flash'] for t in serve]} (expected [{batches}, 0]); "
        f"follower forwards {serve[1]['forwards']}; draw s "
        f"{[round(t['draw_s'], 1) for t in serve]}, serving s "
        f"{[round(t['seconds'], 1) for t in serve]}; peak GB "
        f"{[round(t['peak_gb'], 2) for t in serve]}")
    if len(lead["pngs"]["a"]) != len(SWEEP) or psnr < CONT_JOIN_PSNR:
        raise AssertionError("the pp = 2 engine's images are not the world-1 engine's")
    if [t["counts"]["sd"] for t in serve] != want \
            or [t["counts"]["flash"] for t in serve] != [batches, 0] \
            or serve[1]["forwards"] != FLUX_STEPS[1024] * batches:
        raise AssertionError("a pp = 2 stage's joint attentions did not all go through #1")
    return {"tp_fwd": train[0]["counts"]["sd"], "tp_bwd": train[0]["counts"]["sd_bwd"],
            "pp_fwd": [t["counts"]["sd"] for t in serve], "pp_flash": lead["counts"]["flash"],
            "bit_equal": equal, "psnr": psnr}


def nccl_world1_check() -> dict:
    """A world-1 NCCL process group on the card: `make_mesh` (its line
    names the backend), one all_reduce and one all_gather of CUDA tensors,
    and `copy_to_tp` / `reduce_from_tp` forward and backward through it."""
    import torch
    import torch.distributed as dist

    from sliders_tpu_torch.parallel import collectives as pc
    from sliders_tpu_torch.parallel import mesh as pm

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda:0"))
    try:
        mesh = pm.make_mesh(dp=1, tp=1)
        x = torch.arange(8.0, device="cuda")
        summed, gathered = pc.all_reduce_sum(x, mesh), pc.all_gather_rows(x[None], mesh)
        z = x.clone().requires_grad_()
        (pc.copy_to_tp(z, mesh) * 2).sum().backward()
        u = x.clone().requires_grad_()
        reduced = pc.reduce_from_tp(u, mesh)
        (reduced * 3).sum().backward()
        torch.cuda.synchronize()
        ok = (mesh.backend == "nccl" and all(t.is_cuda for t in (summed, gathered, z.grad))
              and torch.equal(summed, x) and torch.equal(gathered[0], x)
              and torch.equal(z.grad, torch.full_like(x, 2.0)) and torch.equal(reduced, x)
              and torch.equal(u.grad, torch.full_like(x, 3.0)))
        say("mesh", f"NCCL at world 1: backend {mesh.backend}, all_reduce, all_gather, "
            f"copy_to_tp / reduce_from_tp forward and backward on cuda: {ok}")
        if not ok:
            raise AssertionError("the world-1 NCCL collectives disagree")
        return {"backend": mesh.backend}
    finally:
        dist.destroy_process_group()


def phase_mesh(snap: str, tmp: str, base_cfg: dict) -> dict:
    """The process mesh on the card at SD1.5's full width, 512 px (the
    snapshot of `phase_train`): NCCL at world 1; `train_text_slider` on a
    2 x 2 mesh (tpu.dp 2, tpu.tp 2: 4 ranks sharing the card over gloo),
    MESH_ITERATIONS iterations with state_checkpoint_every 1, each
    iteration's loss and LoRA grad norm within MESH_REL of a world-1 run of
    the same config and draws (per_device_batch 2: the same 2-row batch),
    the launches of #1 (all at MESH_HEADS local heads) and #2 per rank
    exact; the step-2 `.dcp` state restored at world 1 equal to rank 0's
    state bit for bit, then resumed at world 1 for one iteration; and, on
    the same launch's ranks (two of them idle), `train_fleet` with K = 2 at
    dp = 2 (f32, TF32 off, lr TINY_LR, one iteration) against the dp = 1
    fleet, rows within FLEET_ROW_TOL."""
    import copy

    import torch

    from sliders_tpu_torch.cli import train_fleet as fleet_cli
    from sliders_tpu_torch.training.driver import load_train_state
    from sliders_tpu_torch.training.text_slider import SliderTrainState

    nccl = nccl_world1_check()
    cfg = copy.deepcopy(base_cfg)
    cfg["train"].update(iterations=MESH_ITERATIONS, max_denoising_steps=MESH_DENOISE_STEPS)
    cfg["save"].update(path=os.path.join(tmp, "mesh"), per_steps=0)
    cfg["tpu"].update(dp=2, tp=2, state_checkpoint_every=1, profile_dir="")
    cfg["logging"]["use_wandb"] = False
    path = os.path.join(tmp, "mesh.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    # the dp-sharded fleet: K = 2 over dp = 2 of the same 4 ranks (2 idle)
    fcfg = copy.deepcopy(cfg)
    fcfg["train"].update(iterations=1, precision="float32", lr=TINY_LR)
    fcfg["tpu"].update(dp=2, tp=1, state_checkpoint_every=0)
    prompt_files, _ = fleet_prompt_files(tmp)
    fleet_argv = {}
    for dp in (2, 1):
        fcfg["save"]["path"] = os.path.join(tmp, f"mesh_fleet_dp{dp}")
        fpath = os.path.join(tmp, f"mesh_fleet_dp{dp}.yaml")
        with open(fpath, "w") as f:
            f.write(dump_yaml(fcfg) + "\n")
        fleet_argv[dp] = ["--config_file", fpath, "--device", "0", "--prompts_file",
                          *prompt_files[:2]]
    out = os.path.join(tmp, "mesh_ranks")
    ranks = launch_ranks("2x2 text, then the fleet at dp=2", 4, out,
                         ["--config_file", path, "--device", "0", "--fleet", *fleet_argv[2]])
    remat = bool(cfg["tpu"]["remat"])
    text = [r["text"] for r in ranks]
    recs = text[0]["records"]
    fwd_expected = expected_fwd([(0, 0, m) for m in recs], remat)
    bwd_expected = ROUTED_PER_FORWARD * len(recs)
    host_s = [b["host_s"] - a["host_s"] for a, b in zip(recs, recs[1:])]
    say("mesh", f"2 x 2 mesh, {len(recs)} iterations: t_to {[m['t_to'] for m in recs]}, losses "
        f"{[m['loss'] for m in recs]}, grad norms {[m['grad_norm'] for m in recs]}; iteration 1 "
        f"host wall {host_s} s; per rank #1 {[t['fwd'] for t in text]} by heads "
        f"{[t['heads'] for t in text]} (expected {fwd_expected} at {MESH_HEADS} heads), #2 "
        f"{[t['bwd'] for t in text]} (expected {bwd_expected}); the CLI's seconds a rank "
        f"{[round(t['seconds'], 1) for t in text]}, peak GB "
        f"{[round(r['peak_gb'], 2) for r in ranks]}")
    strip = [[{k: v for k, v in m.items() if k != "host_s"} for m in t["records"]] for t in text]
    if any(st != strip[0] for st in strip):
        raise AssertionError("the mesh ranks disagree on the iterations' metrics")
    if any(t["fwd"] != fwd_expected or t["bwd"] != bwd_expected
           or t["heads"] != {str(MESH_HEADS): fwd_expected} for t in text):
        raise AssertionError("a rank's routed self-attentions did not all go through #1 and #2 "
                             f"at {MESH_HEADS} heads")

    w1 = copy.deepcopy(cfg)
    w1["tpu"].update(dp=-1, tp=1, per_device_batch=2, state_checkpoint_every=0)
    w1["save"]["path"] = os.path.join(tmp, "mesh_w1")
    ref = run_training(w1, os.path.join(tmp, "mesh_w1.yaml"), [])
    rrecs = [m for _, _, m in ref["records"]]
    rel = [max(abs(a["loss"] - b["loss"]) / abs(b["loss"]),
               abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))
           for a, b in zip(recs, rrecs)]
    say("mesh", f"world 1 (per_device_batch 2): t_to {[m['t_to'] for m in rrecs]}, losses "
        f"{[m['loss'] for m in rrecs]}, grad norms {[m['grad_norm'] for m in rrecs]}; largest "
        f"relative difference of the mesh's loss or grad norm {max(rel):.3g} (tol {MESH_REL})")
    if [m["t_to"] for m in rrecs] != [m["t_to"] for m in recs] or max(rel) > MESH_REL:
        raise AssertionError("the 2 x 2 mesh does not repeat the world-1 run")

    name = (f"{cfg['save']['name']}_alpha{float(cfg['network']['alpha'])}"
            f"_rank{cfg['network']['rank']}_{cfg['network']['training_method']}")
    dcp = os.path.join(tmp, "mesh", name, f"{name}_trainstate.dcp")
    saved = torch.load(f"{out}.state.pt")

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0

    zero = SliderTrainState.from_state_dict(zeros(saved), "cuda")
    restored = load_train_state(dcp, torch.device("cuda"), template=zero).state_dict()

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, torch.Tensor):
            return a.dtype == b.dtype and torch.equal(a, b)
        return a == b

    exact = same(restored, saved)
    resume = copy.deepcopy(w1)
    resume["train"]["iterations"] = MESH_ITERATIONS + 1
    resume["save"]["path"] = os.path.join(tmp, "mesh_resume")
    resumed = run_training(resume, os.path.join(tmp, "mesh_resume.yaml"), ["--resume", dcp])
    res = [(i, m["loss"]) for i, _, m in resumed["records"]]
    say("mesh", f"the step-{saved['step']} .dcp state ({sorted(os.listdir(dcp))}) restored at "
        f"world 1 equals rank 0's state bit for bit: {exact}; resumed at world 1: iterations "
        f"{res}, launches #1 {resumed['fwd']} / #2 {resumed['bwd']}")
    if not exact or [i for i, _ in res] != [MESH_ITERATIONS] \
            or not all(math.isfinite(x) for _, x in res):
        raise AssertionError("the mesh's train state did not restore and resume at world 1")

    # the dp-sharded fleet against dp = 1
    saved_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {1: fleet_cli.main(fleet_cli.build_parser().parse_args(fleet_argv[1])),
                2: torch.load(f"{out}.rows.pt")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    franks = [r["fleet"] for r in ranks]
    worst = max((runs[2][r][m][k].float() - runs[1][r][m][k].float()).abs().max().item()
                for r in range(2) for m in runs[1][r] for k in ("down", "up", "alpha"))
    frecs = franks[0]["records"]
    f_fwd = [ROUTED_PER_FORWARD * (t + 2 + int(remat)) for t in frecs[0]["t_to"]] + [0, 0]
    say("mesh", f"fleet K = 2 at dp = 2: t_to {frecs[0]['t_to']}, losses {frecs[0]['loss']}; "
        f"per rank #1 {[r['fwd'] for r in franks]} (expected {f_fwd}: ranks 2 and 3 idle), #2 "
        f"{[r['bwd'] for r in franks]}; the CLI's seconds a rank "
        f"{[round(r['seconds'], 1) for r in franks]}; rows against the dp = 1 fleet: max|diff| "
        f"{worst:.3g} (tol {FLEET_ROW_TOL})")
    if worst > FLEET_ROW_TOL or [r["fwd"] for r in franks] != f_fwd \
            or [r["bwd"] for r in franks] != [ROUTED_PER_FORWARD] * 2 + [0, 0]:
        raise AssertionError("the dp = 2 fleet does not match the dp = 1 fleet")
    return {"nccl": nccl, "text_fwd": text[0]["fwd"], "text_bwd": text[0]["bwd"],
            "fleet_fwd": franks[0]["fwd"], "fleet_bwd": franks[0]["bwd"],
            "resume_fwd": resumed["fwd"], "resume_bwd": resumed["bwd"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import sliders_tpu_torch

    if not os.path.abspath(sliders_tpu_torch.__file__).startswith(REPO + os.sep):
        print(f"chip_smoke: sliders_tpu_torch imported from outside {REPO}", file=sys.stderr)
        return 1
    timed("device", phase_device)
    timed("build", phase_build)
    results = timed("kernel #1", phase_kernel)
    bwd_results = timed("kernel #2", phase_kernel_bwd)
    conv_results = timed("conv kernels", phase_conv_kernels)
    gn_results = timed("GroupNorm kernel", phase_group_norm_kernel)
    flash_checks, flash_times = timed("kernel #4", phase_flash_kernel)
    flash_bwd = timed("kernel #4 backward", phase_flash_bwd_kernel)
    encode_rows = timed("kernel #4 at the encode shapes", phase_encode_kernel)
    encode_ab = timed("VAE encoder 'auto' / 'xla'", phase_encode_ab)
    pin_results = timed("kernel #9", phase_layout_pin_kernel)
    f16 = timed("f16 kernels", phase_f16_kernels)
    with tempfile.TemporaryDirectory() as tok_dir:
        write_tokenizer(tok_dir)
        timed("tiny slice", phase_tiny_slice, tok_dir)
        timed("tiny training", phase_tiny_train)
        tiny_fused = timed("tiny training 'fused'", phase_tiny_train, "fused")
        tiny_fp16 = timed("tiny training fp16", phase_tiny_train_fp16)
        tiny_flux = timed("tiny FLUX serving", phase_tiny_flux)
        tiny_flux_train = timed("tiny FLUX training", phase_tiny_flux_train)
        tiny_xl = timed("tiny SDXL", phase_tiny_sdxl)
        tiny_image = timed("tiny image training", phase_tiny_image)
        tiny_edit = timed("tiny edit", phase_tiny_edit)
        engine = timed("SD1.5 engine", build_engine, tok_dir)
    sd15_decode, sd15_decode_conv = timed("SD1.5 step", phase_step, engine)
    conv_step = timed("SD1.5 conv impls", phase_conv_step, engine)
    timed("SD1.5 grad pass", phase_grad_ab, engine)
    grad_f32 = timed("SD1.5 grad pass f32", phase_grad_ab, engine, "float32")
    serve_launches, serve_flash, serve_conv = timed("SD1.5 http", phase_http, engine)
    cont = timed("SD1.5 continuous", phase_continuous, engine.models, engine.sliders)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    train = timed("SD1.5 training", phase_train)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        flux = phase_flux(tmp)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_flux = timed("mesh flux", phase_mesh_flux, flux, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        sdxl = phase_sdxl(tmp)

    # launches: each kernel's main path (SD1.5 training for the attention
    # kernels #1, #2 and #6, serving under its impl for #5 and #7, FLUX
    # serving at 2048 px for #4, FLUX training at 2048 px for #4's
    # backward, SDXL serving with the pin on for #9); the other paths that
    # ran it are listed beside. #8 is routed nowhere, as in the JAX package.
    # ms / plain_ms / library_ms / bound_ms are at the first shape each
    # kernel phase lists (#4: 2048 px serving; its backward: the 2048 px
    # grad pass; #9: the (16, 4096, 640) bf16 boundary, contiguous); #1
    # and #2 give their SDXL shapes' times beside, and #1, #2 and #4's
    # backward every shape's under "shapes".
    level0, bwd_level0, gn0, flash0 = results[0], bwd_results[0], gn_results[0], flash_times[0]
    gen = train["generate"]

    def timing(r):
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def conv_entry(name, source_line, main, by_path, **more):
        rs = conv_results[name]
        return {"name": name, "route": "cuda", "source": "sliders_tpu_torch/csrc/conv3x3.cu",
                "mainloop": "sliders_tpu_torch/csrc/conv3x3_sm90.cuh",
                "replaces": f"sliders_tpu/ops/pallas_conv.py:{source_line}", "launches": main,
                "launches_by_path": by_path, "max_abs_err": max(r["err"] for r in rs),
                **timing(rs[0]),
                "shapes": [dict(timing(r), shape=r["shape"], mode=r["mode"], dtype=r["dtype"],
                                variant=r["variant"], cudnn_conv_ms=r["cudnn_conv_ms"],
                                **{k: r[k] for k in ("fma_bound_ms", "tf32x3_bound_ms") if k in r})
                           for r in rs if "ms" in r],
                "generic_shapes": [{k: r[k] for k in ("shape", "mode", "dtype", "err")}
                                   for r in rs if r["variant"] == "generic"], **more}

    split512 = next(r for r in conv_results["tf32_split"]
                    if "ms" in r and r["shape"] == (512, 512, 3, 3))
    per_step = {impl: v["per_forward"] for impl, v in conv_step.items()}
    xl_step = {impl: v["per_forward"] for impl, v in sdxl["conv"].items()}
    print(json.dumps({"kernels": [{
        "name": "sd_attention_fwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/sd_attention.cu",
        "replaces": "sliders_tpu/ops/pallas_attention.py:43",
        "launches": train["fwd"],
        "launches_by_path": {"train": train["fwd"], "train_resume": train["resume_fwd"],
                             "train_fused": train["fused_fwd"], "serve": serve_launches,
                             "flux_serve_1024": flux["serve_1024"]["sd"],
                             "flux_step_per_forward": flux["step"]["sd_per_step"],
                             "flux_train_512": flux["train"][512]["counts"]["sd"],
                             "sdxl_serve_1024": sdxl["http"]["sd"],
                             "sdxl_step_per_forward": sdxl["step"]["sd_per_step"],
                             "sdxl_train_512": sdxl["train"]["sd"], "tiny_sdxl": tiny_xl["sd"],
                             "image_train_256": train["image"]["sd"],
                             "sdxl_image_train_512": sdxl["image"]["sd"],
                             "tiny_image_64": tiny_image["sd"],
                             "tiny_image_stylecheck": tiny_image["style"]["sd"],
                             **{f"generate_sd15{'' if k == 'ddim' else '_' + k}": gen[k]["sd"]
                                for k in GENERATE_RUNS},
                             "turbo_sdxl_512": sdxl["turbo"]["sd"],
                             "flux_scalar_1024": flux["scalar"]["sd"],
                             **{f"serve_continuous_sd15_{k}": v["sd"] for k, v in cont.items()},
                             "serve_continuous_sdxl_1024": sdxl["continuous"]["sd"],
                             "edit_sd15_f32": train["edit"]["sd"],
                             "attention_maps_attn2_tap": train["maps"]["attn2"]["sd"],
                             "attention_maps_full_tap": train["maps"]["all"]["sd"],
                             "tiny_edit": tiny_edit["sd"],
                             "uce_sd15_lms": train["uce"]["sd"], "ti_sd15": train["ti"]["sd"],
                             "custom_diffusion_sdxl_1024": sdxl["custom_diffusion"]["sd"],
                             "scores_clip_lpips": train["scores"]["sd"],
                             **{f"fleet_sd15_{k}": train["fleet"][k]["sd"] for k in FLEET_MODES},
                             "fleet_image_sd15_256": train["fleet_image"]["sd"],
                             "generate_fleet_sd15": train["generate_fleet"]["sd"],
                             "train_prodigy_sd15": train["adaptive"]["fwd"],
                             "single_file_sd15": train["single_file"]["sd"],
                             "validate_real_weights_sd15": train["validate"]["sd"],
                             "validate_real_weights_sd15_sweep": train["validate"]["sweep_sd"],
                             "train_resume_traced_kernel_events":
                                 train["trace"]["found"]["attn_sm90"],
                             "mesh_sd15_2x2_rank0_4_heads": train["mesh"]["text_fwd"],
                             "mesh_sd15_resume_world1": train["mesh"]["resume_fwd"],
                             "mesh_fleet_dp2_rank0": train["mesh"]["fleet_fwd"],
                             "mesh_flux_tp2_rank0_12_heads": mesh_flux["tp_fwd"],
                             "mesh_flux_pp2_stage0": mesh_flux["pp_fwd"][0],
                             "mesh_flux_pp2_stage1": mesh_flux["pp_fwd"][1]},
        "max_abs_err": max([r["err"] for r in results]
                           + [r["sd_err"] for r in flash_checks if "sd_err" in r]),
        **timing(level0),
        "sdxl_serve_shapes": [dict(timing(r), shape=r["shape"]) for r in results
                              if r["shape"] in SDXL_SD_SHAPES],
        "shapes": [dict(timing(r), shape=r["shape"], dtype=r["dtype"],
                        **{k: r[k] for k in ("fma_bound_ms", "tf32x3_bound_ms") if k in r})
                   for r in results],
        "grad_pass_f32_ms_by_route": grad_f32,
    }, {
        "name": "sd_attention_bwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/sd_attention_bwd.cu",
        "mainloop": "sliders_tpu_torch/csrc/attention_bwd_sm90.cuh",
        "replaces": "sliders_tpu/ops/pallas_attention.py:156",
        "launches": train["bwd"],
        "launches_by_path": {"train": train["bwd"], "train_resume": train["resume_bwd"],
                             "train_fused": train["fused_bwd"],
                             "flux_train_512": flux["train"][512]["counts"]["sd_bwd"],
                             "sdxl_train_512": sdxl["train"]["sd_bwd"],
                             "tiny_sdxl": tiny_xl["sd_bwd"],
                             "image_train_256": train["image"]["sd_bwd"],
                             "sdxl_image_train_512": sdxl["image"]["sd_bwd"],
                             "tiny_image_64": tiny_image["sd_bwd"],
                             "tiny_image_stylecheck": tiny_image["style"]["sd_bwd"],
                             "edit_sd15_null_text_f32": train["edit"]["sd_bwd"],
                             "tiny_edit": tiny_edit["sd_bwd"],
                             **{f"fleet_sd15_{k}": train["fleet"][k]["sd_bwd"]
                                for k in FLEET_MODES},
                             "fleet_image_sd15_256": train["fleet_image"]["sd_bwd"],
                             "train_prodigy_sd15": train["adaptive"]["bwd"],
                             "train_resume_traced_kernel_events":
                                 train["trace"]["found"]["attn_bwd_sm90"],
                             "mesh_sd15_2x2_rank0_4_heads": train["mesh"]["text_bwd"],
                             "mesh_sd15_resume_world1": train["mesh"]["resume_bwd"],
                             "mesh_fleet_dp2_rank0": train["mesh"]["fleet_bwd"],
                             "mesh_flux_tp2_rank0_12_heads": mesh_flux["tp_bwd"]},
        "max_abs_err": max(r["err"] for r in bwd_results),
        **timing(bwd_level0),
        "sdxl_train_shape": timing(next(r for r in bwd_results if r["shape"] == SDXL_BWD_SHAPE)),
        "shapes": [dict(timing(r), shape=r["shape"], dtype=r["dtype"],
                        **{k: r[k] for k in ("fma_bound_ms", "tf32x3_bound_ms") if k in r})
                   for r in bwd_results],
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sliders_tpu/ops/flash_attention.py:50",
        "launches": flux["serve_2048"]["flash"],
        "launches_by_path": {"flux_serve_2048": flux["serve_2048"]["flash"],
                             "flux_serve_2048_sweep": flux["serve_2048"]["flash_sweep"],
                             "flux_serve_1024_vae": flux["serve_1024"]["flash"],
                             "tiny_flux_1280": tiny_flux["flash"], "serve_vae": serve_flash,
                             "flux_train_2048": flux["train"][2048]["counts"]["flash"],
                             "tiny_flux_train_1280": tiny_flux_train["flash"],
                             "sdxl_serve_1024_vae": sdxl["http"]["flash"],
                             "image_train_256_encode": train["image"]["flash"],
                             "sdxl_image_train_512_encode": sdxl["image"]["flash"],
                             **{f"generate_sd15{'' if k == 'ddim' else '_' + k}_vae":
                                gen[k]["flash"] for k in GENERATE_RUNS},
                             "turbo_sdxl_512_vae": sdxl["turbo"]["flash"],
                             **{f"serve_continuous_sd15_{k}_vae": v["flash"]
                                for k, v in cont.items()},
                             "serve_continuous_sdxl_1024_vae": sdxl["continuous"]["flash"],
                             "edit_sd15_encode_decode": train["edit"]["flash"],
                             "uce_sd15_vae": train["uce"]["flash"],
                             "ti_sd15_vae": train["ti"]["flash"],
                             "custom_diffusion_sdxl_1024_vae":
                                 sdxl["custom_diffusion"]["flash"],
                             "scores_clip_lpips": train["scores"]["flash"],
                             "fleet_image_sd15_256_encode": train["fleet_image"]["flash"],
                             "generate_fleet_sd15_vae": train["generate_fleet"]["flash"],
                             "single_file_sd15_vae": train["single_file"]["flash"],
                             "validate_real_weights_sd15_vae": train["validate"]["flash"],
                             "mesh_flux_pp2_stage0_vae": mesh_flux["pp_flash"]},
        "launches_by_plan": {"tiny_flux_1280": tiny_flux["fwd_plans"],
                             "tiny_flux_train_1280": tiny_flux_train["fwd_plans"],
                             "flux_train_2048": flux["train"][2048]["counts"]["fwd_plans"]},
        "max_abs_err": max(r["err"] for r in flash_checks + encode_rows),
        **timing(flash0),
        "sd_attention_ms_same_inputs": flash0["sd_ms"],
        "vae_decode_shapes": [dict(timing(r), shape=r["shape"]) for r in flash_checks
                              if r["shape"] in VAE_DECODE_SHAPES],
        "vae_encode_shapes": [dict(timing(r), shape=r["shape"], err=r["err"], xla_ms=r["xla_ms"],
                                   xla_products_ms=r["xla_products_ms"]) for r in encode_rows],
        "encode_ms_auto_vs_xla": {f"{model}_{IMAGE_PX[model]}": {k: v[k] for k in ("auto", "xla")}
                                  for model, v in encode_ab.items()},
        "sdpa_shapes": [dict(timing(r), shape=r["shape"], dtype=r["dtype"], plan=r["plan"],
                             **{k: r[k] for k in ("fma_bound_ms", "tf32x3_bound_ms") if k in r})
                        for r in flash_checks
                        if r["shape"] in FLASH_SDPA_SHAPES and "plain_ms" in r],
        "decode_ms_auto_vs_xla": {"sd15_512": sd15_decode, "sdxl_1024": sdxl["step"]["decode"]},
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "sliders_tpu_torch/csrc/flash_attention.cu",
        "mainloop": "sliders_tpu_torch/csrc/attention_bwd_sm90.cuh",
        "replaces": "sliders_tpu/ops/flash_attention.py:50 (the stock kernel's custom_vjp "
                    "backward: _flash_attention_bwd_dkv :941 and _flash_attention_bwd_dq :1287 "
                    "of jax/experimental/pallas/ops/tpu/flash_attention.py)",
        "launches": min(flux["train"][2048]["counts"]["dkv"], flux["train"][2048]["counts"]["dq"]),
        "launches_by_kernel": {"dkv": flux["train"][2048]["counts"]["dkv"],
                               "dq": flux["train"][2048]["counts"]["dq"]},
        "launches_by_path": {"flux_train_2048": flux["train"][2048]["counts"]["dkv"],
                             "tiny_flux_train_1280": tiny_flux_train["dkv"]},
        "launches_by_plan": {"flux_train_2048": flux["train"][2048]["counts"]["bwd_plans"],
                             "tiny_flux_train_1280": tiny_flux_train["bwd_plans"]},
        "max_abs_err": max(r["err"] for r in flash_bwd),
        "max_err_bf16_ulps": max(r["err_ulps"] for r in flash_bwd),
        **timing(flash_bwd[0]),
        "shapes": [dict(timing(r), shape=r["shape"], dtype=r["dtype"], plan=r["plan"],
                        **{k: r[k] for k in ("fma_bound_ms", "tf32x3_bound_ms") if k in r})
                   for r in flash_bwd],
    },
        conv_entry("conv3x3", 44, serve_conv["conv3x3"],
                   {"serve_auto": serve_conv["conv3x3"],
                    "unet_step_auto_per_forward": per_step["auto"]["conv3x3"],
                    "sdxl_step_auto_per_forward": xl_step["auto"]["conv3x3"]},
                   decode_ms_conv_auto_vs_xla={"sd15_512": sd15_decode_conv,
                                               "sdxl_1024": sdxl["step"]["decode_conv"]},
                   generate_ms_conv_auto_vs_xla=serve_conv["generate_ms"]),
        conv_entry("epi_conv3x3", 409, serve_conv["epi_conv3x3"],
                   {"serve_fused_ep": serve_conv["epi_conv3x3"],
                    "unet_step_fused_ep_per_forward": per_step["fused_ep"]["epi_conv3x3"],
                    "sdxl_step_fused_ep_per_forward": xl_step["fused_ep"]["epi_conv3x3"]}),
        conv_entry("fused_conv3x3", 208, train["fused_conv"],
                   {"train_fused": train["fused_conv"], "serve_fused": serve_conv["fused_conv3x3"],
                    "tiny_train_fused": tiny_fused,
                    "unet_step_fused_per_forward": per_step["fused"]["fused_conv3x3"],
                    "sdxl_step_fused_per_forward": xl_step["fused"]["fused_conv3x3"]}),
        {"name": "tf32_split", "route": "cuda", "source": "sliders_tpu_torch/csrc/conv3x3.cu",
         "replaces": "sliders_tpu/ops/pallas_conv.py:44 (the f32 weight operand of "
                     "_conv_kernel's products, split for the 3xTF32 mainloop of #5-#7)",
         "launches": serve_conv["tf32_split"],
         "launches_by_path": {"serve_auto": serve_conv["tf32_split"],
                              "tiny_train_fused": tiny_fused},
         "max_abs_err": max(r["err"] for r in conv_results["tf32_split"]),
         # at the SD VAE decoder's 512 x 512 weight
         **{k: split512[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "graph_ms")},
         "shapes": [dict(timing(r), shape=r["shape"], graph_ms=r["graph_ms"])
                    for r in conv_results["tf32_split"] if "ms" in r]},
        {"name": "fused_group_norm", "route": "cuda",
         "source": "sliders_tpu_torch/csrc/group_norm.cu",
         "replaces": "sliders_tpu/ops/pallas_groupnorm.py:43", "launches": 0,
         "launches_by_path": {}, "routed": False,
         "max_abs_err": max(r["err"] for r in gn_results), **timing(gn0)},
        {"name": "layout_pin", "route": "cuda", "source": "sliders_tpu_torch/csrc/layout_pin.cu",
         "replaces": "sliders_tpu/ops/basic.py:339", "launches": sdxl["http"]["pin"],
         "launches_by_path": {"sdxl_serve_1024_pin_on": sdxl["http"]["pin"],
                              "sdxl_step_per_forward_pin_on": sdxl["step"]["pin_per_step"],
                              "sdxl_train_512_pin_on": sdxl["train"]["pin"],
                              "tiny_sdxl": tiny_xl["pin"]},
         "routed": "opt-in: ops.basic.set_layout_pin(True), off by default as in the JAX package",
         "max_abs_err": max(r["err"] for r in pin_results), **timing(pin_results[0])},
        *f16_entries(f16, train, sdxl, tiny_fp16),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase_mesh's launch
        sys.exit(mesh_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-flux-rank"]:  # one rank of phase_mesh_flux's launch
        sys.exit(mesh_flux_rank(sys.argv[2:]))
    sys.exit(main())
