"""Smoke run of the PyTorch/CUDA port (``jolideco_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one or more lines:

0. the device: ``torch.cuda.get_device_name(0)`` and the card's name and
   power limit as ``nvidia-smi`` reports them;
1. build the CUDA kernels from ``jolideco_torch/csrc`` with ``nvcc``, one
   compiler per source, all at once (the fused scorer's MAP backward,
   K1 and K4 of every mode, the bf16 modes' MAP row scorers and the
   probe's marginalised row kernels of every mode on the warpgroup
   instructions, the patch-level float32 kernels, the matrix-DFT
   convolution's three passes on the warpgroup instructions in every
   mode), each kernel's registers, spills and shared memory as
   ``ptxas`` reports them, and the count of ``HGMMA`` instructions in
   the MAP scorers' and K3's warpgroup kernels' machine code
   (``cuobjdump -sass``; neither may be 0), also in each of the three
   float32 passes and the four instances of the bf16 modes' pass 1
   (``pfft_cols_fwd_wg_kernel<products, columns>``), which must spill
   nothing, and
   in the instances of K1 (``"highest"``'s MAP) and of K1 lse and K4 of
   every mode, with their registers and spills; ptxas may inject no
   wgmma wait (C7517) in either library;
2. each kernel against its plain PyTorch version on the card, with the
   time per call of both: the fused scorer (K1, K2) at the main path's
   shape (1024², the ``astro-snr-v1`` GMM, K = 200) and on a ragged
   1000x904 image with a block of zero-flux sentinel pixels (K1 of
   ``"highest"``: the six-product core on ``wgmma``, its time beside
   both bounds), then K1's ``"split"`` kernel on the tensor cores
   (``wgmma``) on the same two images against the split plain version
   and, with the float32 plain version beside it, against the logits in
   float64, and on the ragged image under two GMMs of 256 components
   (two of the kernel's tiles of 200), the logits of one of them much
   cancelled sums, there also K1 of ``"highest"`` against the float32
   plain version and float64; the
   patch-level scorer, unit gradient and Hessian action (K5, K6, K7) on
   the rows of those two images (65,025 rows, the flux-error probe's
   shape, and a ragged 56,025), K5's ``"split"`` kernel on the tensor
   cores (both instances) as K1's, also under the two GMMs of 256
   components on the ragged rows, and K6 and K7 also where the rows of
   each block select 128 components; the matrix-DFT convolution's three
   kernels (K3), forward and adjoint, at the main path's batch (5 pairs
   of 1024², n = 1152, the 33² PSFs) and at 5 pairs of 1024 x 896, each
   pass and the whole pipeline against the plain version run in
   float64, beside cuFFT's packed pair (the yardstick, timed with the
   per-observation ``rfft2`` of the same 10 images; pass 1 also beside
   the one ``torch.fft.fft`` that computes its function, pass 3 beside
   the one ``torch.fft.ifft`` that computes its, pass 2 beside the
   packed pair, each with its float32 and its six-product bound); the
   same for the tensor-core kernels of
   the three passes and the ``"split"`` pipeline, held to the split
   plain version's error and to 1e-4 of the max-abs; pass 1 of
   ``"split"`` and ``"bf16"`` also at the x2 path's batch (5 pairs of
   2048², n = 2176), with its time and bound; K2, K6 and K7
   twice on the same inputs, bitwise equal;
3. the main path: joint MAP deconvolution of 10 observations of 1024²
   Poisson counts (33² Gaussian PSFs) under the GMM patch prior
   (stride 4, cycle spin), 20 Adam steps through ``MAPDeconvolver``
   under the default dial (K1 split) and 20 under ``"highest"`` (K1's
   six-product instance), their flux held together, and how
   many distinct components the patches of one of K2's tiles select at
   the final flux, with K2's, K6's and K7's times there. The
   kernels' launch counts are set to zero just before and read just
   after each run; then a small run (4 x 128², 20 steps) on the card is
   held against the same run on the CPU's plain path;
4. the flux-error path: the same deconvolution with
   ``compute_error=True`` and 5 steps, so that the run ends with one
   Hessian probe on the patch-level kernels, under the default dial
   (K5 split) and under ``"highest"`` (the float32 K5); counts set to
   zero just before and read just after each; then the errors of a
   small run on the card against the CPU's plain path;
5. the marginalised path: phases 3 and 4 again under
   ``GMMPatchPrior(marginalize=True)``: training under the default dial
   on the logsumexp forward and the marginalise backward (K1 lse split,
   K4 split: the warpgroup core's three-product instances) and under
   ``"highest"`` on its six-product ones (K1 lse and K4, six bf16
   products of three-way splits), each with exact
   counts, the two runs' flux difference and the argmax of K1 lse's two
   kernels at the final flux (at most 1e-4 of the patches differ); then
   the probe under both dials: under the default dial (training on K1
   lse split and K4 split) K5's logsumexp, the marginalise unit gradient
   (K8) and the first stage of its Hessian action (K9a) on the
   warpgroup core's three-product instances (K5 lse split, K8 split,
   K9a split), under ``"highest"`` its six-product ones, the second
   stage (K9b) under both, each with its
   own counts, and the two runs' errors against each other; then a
   small run's flux and errors on the card against the CPU's plain
   path;
6. the matrix-DFT path: phase 3 again with ``conv_mode="pfft"`` under
   the default dial (``"split"``: the three passes on the tensor cores)
   and under ``"highest"`` (``"f32"``: the float32 kernels, passes 1
   and 3 on ``wgmma``), each
   with its own exact counts; phase 4 again
   under the default dial (in the probe, the adjoint's adjoint too);
   flux and errors held against phases 3 and 4; then a small run's flux
   and errors on the card against the CPU's plain path, ``"split"`` on
   both;
7. the dial's ``"default"`` setting (``"bf16"``: single bf16 products on
   the tensor cores): the main path (20 steps, fft), the marginalised
   path (20 steps), the pfft path (20 steps) and the MAP and
   marginalised probes (5 steps), each with exact counts (the bf16
   kernels launched, the split and float32 ones never), its flux or
   errors against the ``"high"`` run and K1 bf16's argmax flips against
   K1 split at its final flux (printed beside the JAX package's
   documented 0.5%); then a small run, card against the CPU's plain path
   under ``"default"``;
8. the default entry point: ``MAPDeconvolver(n_epochs=20)`` with every
   other keyword at its default (``update_strategy="sequential"``,
   ``trace_every=1``, ``display_progress=True``, the card) at the main
   path under the default dial, with exact counts (K1 split 20 x (10 +
   1): a step per observation and the trace row's forward each epoch;
   K2 20 x 10), twenty finite trace rows whose data term falls, and its
   epochs/s and optimiser steps/s beside the card's name and power
   limit; then a small run (4 x 128², cycle spin) with ``trace_every=3``,
   validation data and ``stop_early``, resumed from its result for 5
   more epochs with ``compute_error=True``: trace and errors on the card
   against the CPU's plain path within phase 3's bars, the flux within
   1e-3 of its max-abs (phase 6's bar, for the same reason: Adam's
   steps), both stopped after the same epoch;
9. upsampled fluxes and calibrations: the main path's data at a x2
   component (a 2048² log-flux from the data's mean estimate) with one
   ``NPredCalibration`` per observation, the first one's shift frozen,
   under the default dial: 20 joint steps three times, each with exact
   counts (K1 split 20, K2 20), the total loss falling over the run,
   the calibrations finite and the frozen shift unmoved, steps/s
   (median of the three, with the spread) and peak memory beside the
   card's name and power limit; K1 split and
   K2 at the trained 2048² flux (262,144 patches) against their plain
   versions by phase 2's bars (K1 split's sums on cancelled logits by
   ``K1_SPLIT_SUM_ERR_FLUX``), K1 split's ms and bound there; the same
   run with ``compute_error=True`` and 5 steps (K5 split, K6, K7 once),
   its errors finite and positive, the probe's seconds and peak memory;
   the quick-start entry point, ``MAPDeconvolver(n_epochs=5)`` with every
   other keyword at its default (K1 split 5 x 11, K2 5 x 10, five finite
   trace rows); then small runs (4 x 128² counts seen at known sub-pixel
   offsets, x2, cycle spin, the probe): joint, sequential and joint
   with ``conv_mode="pfft"``, card against the CPU's plain path, flux,
   calibrations and errors within the bars of ``UPS_CAL_ATOL``'s
   comment;
10. the rest of the prior layer at the main path, each run with exact
   counts and every prior tensor on the card: (a) ``MultiScalePrior``
   over three levels of the GMM prior under an asinh norm, 20 joint
   steps (K1 split and K2 at 1024², 512² and 256² each step), its level
   weights and the norm's alpha and beta trained and held by the
   result's prior, then its probe (K5 split, K6, K7 once a level); (b)
   jitter, 20 joint steps (K5 split and K6 a step, on the patch-level
   branch); (c) one offset class of the marginalised prior
   (``patch_fraction=0.25``), 20 joint steps (K5 lse split and K8 split a
   step); (d) ``MAPDeconvolver(n_epochs=5)``'s defaults under the first
   example's ``GMMPatchPrior(norm=MaxImageNorm(),
   cycle_spin_subpix=True)`` (K1 split 55, K2 50); (e) the parametric
   priors (smoothness, LIRA, inverse Gamma, exponential, image), 5 joint
   steps each, no GMM kernel; (f) (a) and (b) at 4 x 128², card against
   the CPU's plain path;
11. the rest of the forward model, each run with exact counts and every
   component tensor on the card, each rate the median of three runs: (a)
   four event classes of three-band stacks at 1024² with a 3x3 energy
   redistribution matrix (King PSFs of 129² to 49²), one 2-D flux from
   the data's estimate, 20 joint steps under ``conv_mode="fft"`` and
   under ``"pfft"`` (K3's passes take the (pair, band) blocks in one
   launch a direction), the probe (5 steps) and
   ``MAPDeconvolver(n_epochs=5)``'s defaults, the band sums at the
   trained flux against an identity matrix's; (b) the same data with one
   class's matrix dropped: the joint strategy falls back to per-dataset
   models (its warning logged each run); (c) the main path's data with
   256 point sources, a ``SparseSpatialFluxComponent`` beside the
   diffuse component, 20 joint steps (the median position error falls)
   and the probe; (d) a GMM of 16x16 patches on the plain scorer, no
   GMM kernel launched; (e) small runs of (a)-(d) and the sparse
   example, card against the CPU's plain path;
12. the command line and the files: the main path's ten datasets
   written to FITS, run through the body of ``jolideco-torch run``
   (``jolideco_torch.cli.run_config``: joint, 20 epochs with a trace row
   each, a checkpoint each epoch, ``compute_error``) with exact counts
   (K1 split 40, K2 20, K5 split, K6 and K7 once), 20 checkpoint files
   named in the trace, the FITS and ASDF outputs and the last checkpoint
   holding the flux (and the error) bit for bit and reading back within
   one unit in the last place, the click command in process on a YAML
   configuration, and epochs/s with and without checkpoints;
13. several ranks on the one card (``MAPDeconvolver(mesh=...)``, ranks
   spawned by ``jolideco_torch.parallel.launch.run_ranks`` after the
   build, so that no rank runs ``nvcc``), at the main path under the
   default dial, each rank's launches exact (K1 split and K2 once a step
   on its strip block of the prior, the plain versions never) and every
   rank's parameters the same bits: (a) one rank on NCCL, 20 steps,
   against phase 3's run, bit for bit or not, printed; (b) two ranks on
   gloo (NCCL refuses two ranks on one device), an obs mesh, 20 steps;
   (c) four ranks, a 2 x 2 obs-row mesh through the pencil FFT, 10
   steps; (d) the pfft path on the two-rank mesh with 8 of the 10
   observations (two K3 pairs a rank); (e) the probe after 5 of (b)'s
   steps (K5 split, K6, K7 once on rank 0), its errors against phase
   4's; (g) ``conv_mode="ct"`` on (b)'s mesh with 8 of the 10
   observations (two pairs a rank, kept on the rank); (h) ``"ct"`` and
   (i) ``"mxu"`` on (c)'s 2 x 2 mesh, 10 steps each (a rank gathers its
   row group's rows); each run's flux within ``P13_FLUX_SHARE`` of its
   max-abs and its losses within ``SMALL_FLUX_RTOL`` of the unsharded
   run's, its steps/s per rank beside the card's name and power limit
   (ranks sharing one card: not a scaling figure); (f) in one process,
   the strip blocks' partial sums over 2, 4 and 3 shards (K1 split and
   K2 once a shard) against one whole-image call at phase 3's trained
   flux and on phase 2's ragged image, within phase 2's bars.
14. the joint path's other convolution backends, ``conv_mode`` ``"ct"``
   (the pair-packed Cooley-Tukey matrix DFT), ``"mxu"`` (the
   per-observation 4-step matrix DFT) and ``"direct"`` (a grouped
   ``conv2d``), at the main path under the default dial, each: (a) the
   convolution of ten 1024² images and its adjoint against the float64
   FFT convolution of the same inputs (``P14_ERR_SHARE``), with cuFFT's
   error and ms a direction beside its own, measured in the same call;
   (b) 20 joint steps three times, each with exact counts (K1 split and
   K2 20, nothing else, the plain versions never), the flux within
   ``PFFT_FLUX_SHARE`` of phase 3's, steps/s (median of the three, with
   the spread) and peak memory; (c) under ``"ct"`` the probe after 5
   steps (K5 split, K6, K7 once), its errors against phase 4's within
   ``PFFT_ERROR_RTOL``; (d) phase 9's small run (4 x 128², the x2 flux
   and calibrations, the probe) on the card against the CPU's path by
   phase 9's bars; every line beside the card's name and power limit.

Phase 2 also holds the marginalise kernels (K1 logsumexp, K4, K8, K9a,
K9b) against their plain versions. Their softmax weights of logits of
order 1e5 to 1e8 are ill-conditioned in float32, so K4, K8 and K9 are
held against the plain version run in float64 on the same inputs: the
kernel's max-abs error must be at most twice the float32 plain
version's, plus 1e-6 of the result's max-abs; K4 and K9b also give the
same bits on two calls, K9b is timed by its device time too, and K4 is
held once more fed K1 lse's own patches and logsumexp (the pipeline
training runs), against the float64 pipeline. K1 lse's and K4's times
come with two bounds, of six bf16 products on the tensor cores and of
the float32 CUDA cores, and the share of each; the same checks run on
the ragged image under ``wide_gmm()`` (two tiles of components). Under
``astro-snr-v1`` the weights are one-hot (dp is then exactly zero), so
the same checks run once more on the 1024² image and its rows under a
random SPD GMM with K = 200 whose weights are mixed; the run fails
unless they are. K4 of every mode is also launched on a 256² crop of
the 1024² image with a CTA a tile of rows, its weights' scratch read
back: every one-hot patch weighed exactly 1 at K1 lse's argmax
(:func:`k4_weight_checks`).
Then the marginalise kernels of the ``"split"`` mode on the tensor
cores, on both images under ``astro-snr-v1``, ``wide_gmm()`` and
``mixed_gmm()``: K1 lse split against the split plain version (K1
split's bars) and float64, K4 split as training runs it (fed K1 lse
split's logsumexp) against the float64 pipeline, twice bitwise equal,
and on the images'
rows K8 split and K9a split as the probe runs them (fed K5 lse split's
logsumexp; K9a split's dp exactly 0 on every row whose weight is
one-hot), with
times, bounds and registers beside the float32 kernels'. The same again
for the ``"bf16"`` kernels (the one-product instances of the same
code): K1 bf16 and K5 bf16 (both instances) against the bf16 plain
versions by K1 split's bars, with the split plain values as a control
that must fail them; K4 bf16 (fed K1 lse bf16), K8 bf16 and K9a bf16
(fed K5 lse bf16) against the float64 sums of the same bf16-rounded
operands within ``MARG_SPLIT_FACTOR`` times the bf16 plain pipeline's
error, with the split plain pipeline as a control refused wherever the
weights are mixed; K3's bf16 passes and pipeline by
:func:`bf16_anchored`, with the split pipeline as a control refused.

It then prints a JSON line with K3's errors and times, a JSON line with
the mixed case's errors, times and bounds, a ``{"marg_f32": ...}`` JSON
line with the float32 K1 lse's and K4's errors, times and both bounds,
a JSON line with the
marginalise split kernels' errors, times and bounds and the two dials'
marginalised training and probe, a JSON line with K1's split kernel's
errors,
time and bound and the two dials' flux difference, a JSON line with K5
split's errors, times and bound, the row map's cases and the probe
under both dials, a ``{"default_dial": ...}`` JSON line with the bf16
kernels' checks and phase 7's paths, a ``{"default_entry": ...}`` JSON
line with phase 8's numbers, an ``{"upsampled": ...}`` JSON line with
phase 9's, a ``{"priors": ...}`` JSON line with phase 10's, a
``{"forward_model": ...}`` JSON line with phase 11's, an ``{"io": ...}``
JSON line with phase 12's, a ``{"mesh": ...}`` JSON line with phase 13's,
a ``{"conv_modes": ...}`` JSON line with phase 14's, a JSON line with
each kernel's numbers
(thirty-three, each with its launches in phase 9's three runs at the
2048² flux, in phase 10's, 11's and 12's runs, a list by rank in each
of phase 13's runs, and in phase 14's timed runs and ``"ct"`` probe) and,
last, the
device line ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero without the last line; it also exits
non-zero when there is no CUDA device or no ``jolideco_torch`` package
beside it. It imports nothing of JAX.
"""

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMALL_FLUX_RTOL = 1e-4
# errors of the small run, card against CPU: float32 FFTs and sums in
# other orders, at flux maps that differ by up to 4e-5 after 20 steps;
# the errors moved far less than that on an H100 (9.7e-7), so the flux
# maps' own bar holds with room to spare
SMALL_ERROR_RTOL = 1e-4
STEPS = 20
ERROR_STEPS = 5
# float64-anchored bar of the marginalise kernels: error <= 2 x the
# float32 plain version's, plus this share of the result's max-abs
MARG_ERR_FACTOR, MARG_ERR_FLOOR = 2.0, 1e-6
# K3 against the float64 plain version: the anchored bar above, and the
# whole pipeline also within this share of the result's max-abs
PFFT_ERR_SHARE = 1e-5
# the pfft path against the fft path after the same 20 steps: flux
# within this share of its max-abs. The two convolutions differ by about
# 2e-6 of their max-abs (phase 2), but Adam's first step, -lr g / (|g| +
# eps), turns that into a different step wherever a pixel's gradient is
# near zero: 3.3e-4 of the max-abs (4.5e-4 elementwise) on an H100, so
# the bar is 1e-3. Errors within this relative tolerance.
PFFT_FLUX_SHARE, PFFT_ERROR_RTOL = 1e-3, 1e-4
# the main path's field and observation count, and the ragged image of
# the kernel checks
FIELD, N_OBS, RAGGED = 1024, 10, (1000, 904)
MAIN = f"{FIELD}x{FIELD}"
# K3's rectangular batch: what an image of up to 1024 x 896 pads to, at
# the main path's transform size
PFFT_RECT = (1024, 896)
# K3's tall batch: the x2 path's 2048² flux (phase 9), n = 2176, m = 17
PFFT_TALL = (2048, 2048)
# the tensor-core kernels of K3's "split" mode against the float64 plain
# version: the anchored bar above (against the float32 split plain
# version), and also within this share of the max-abs (split's own error
# is about 3.1e-5; bf16 alone is 1.3e-2)
PFFT_SPLIT_SHARE = 1e-4
# the JAX package's documented error of its matmul-DFT convolution in
# "split" mode against the float32 FFT (jolideco_tpu/ops/pallas_fft.py:
# 86-102), printed beside the split pipeline's
JAX_SPLIT_ERR = 3.1e-5
# K3's "bf16" kernels against the float64 plain version: within the
# anchored bar (MARG_ERR_FACTOR x the bf16 plain version's error plus
# MARG_ERR_FLOOR of the max-abs), the pipeline also within the JAX
# package's documented error of the mode, 1.3e-2 of the max-abs; and at
# least BF16_HONOURED x the bf16 plain version's error, so that a kernel
# of another mode (the split pipeline, the control, lies some 100 times
# closer to float64) is refused: the kernels round the same bf16
# operands as the plain version, so their errors nearly coincide.
PFFT_BF16_SHARE, BF16_HONOURED = 1.3e-2, 0.5
# K1's "split" kernel against the split plain version, which sums the
# same bf16 products with cuBLAS. The tensor cores' float32 sums are not
# IEEE sums: at 1024^2 on an H100 the shipped kernel's values lie up to
# 1.5e-5 (astro-snr-v1) and 4.8e-5 (builtin-8x8-v1) from the split plain
# version's, where a variant that keeps every sum of a logit inside the
# mma (the design add_split replaced) lies 1.7e-5 and 1.1e-4 from it
# (jolideco_torch/utils/gmm_tc_variants.py of commit 4a9e377, since
# removed), so rtol 1e-5 does not hold and values are held within
# K1_SPLIT_RTOL, between the two. That variant's sums were also biased:
# its mean signed relative difference from the exact (float64) sum of
# the same products was 4.5e-6 (astro-snr-v1) and 8.6e-7
# (builtin-8x8-v1), the shipped kernel's 4.7e-8 and 5.5e-8; so the mean
# is held within K1_SPLIT_BIAS. Argmax flips at most K1_SPLIT_FLIPS of
# the valid rows, the normalised patches within 1e-5; against float64,
# the marginalise kernels' bar (MARG_ERR_FACTOR x the split plain
# version's error plus MARG_ERR_FLOOR of the max-abs): the split's own
# error, 6.4e-5 and 1.5e-4 of the values there, is what both carry.
K1_SPLIT_RTOL, K1_SPLIT_BIAS, K1_SPLIT_FLIPS = 7e-5, 5e-7, 1e-4
# The rounding of a float32 sum scales with the magnitudes of its terms,
# not with its value, so a relative bar fails on logits that are much
# cancelled sums. Against the sum of the products' magnitudes the
# kernel's largest difference from the exact sum was 6.0e-7 to 6.8e-7
# (cuBLAS's sums 2.0e-7 to 2.3e-7) at 1024^2 and 1000 x 904 under
# astro-snr-v1 and wide_gmm() on an H100; every case is held to this.
K1_SPLIT_SUM_ERR = 2e-6
# Phase 9's trained x2 flux (a noisy data estimate at the start) holds
# rows whose logits are sums of much larger products: there K1 split's
# largest difference from the exact sum was 3.08e-6 of the products'
# magnitudes over 261,121 rows (4.43e-6 at the start flux; 17 and 273
# rows beyond K1_SPLIT_SUM_ERR), cuBLAS's 2.8e-7 (4.3e-7), on an H100.
# A CPU emulation that rounds each k16 step's exact sum once stays
# within 1.1e-6 on the same kind of rows: the excess is the mma's own
# float32 sums (not IEEE sums; flushing each product or k8 products did
# not change it, add_split's comment), and the split mode's own error
# against float64 is larger still (held by the float64 bar). Those rows
# are held within K1_SPLIT_SUM_ERR_FLUX, a fixed factor above the
# largest reading.
K1_SPLIT_SUM_ERR_FLUX = 1e-5
# K1 of "highest" (the six-product core) is held to rtol 1e-5 of the
# float32 plain version, but not under cancelled_gmm(): there the
# winning logits are sums of terms thousands of times their value, and
# the float32 plain version's own values lie further than 1e-5 (relative)
# from float64 (k1_f32_checks prints both), so no float32 evaluation
# meets rtol 1e-5 against another. A float32 sum's rounding scales with
# its terms: there k1_f32_checks holds the kernel to the anchored bar
# against float64 and, under every GMM, to K1_F32_SUM_ERR of the terms'
# magnitudes, the bar of K1 split's own sums.
K1_F32_SUM_ERR = K1_SPLIT_SUM_ERR
# The MAP gradient reads the logits only through the argmax, so the
# default dial ("split") and "highest" train alike until an argmax flips.
# The JAX package's own HIGH and HIGHEST runs (its fused kernel in the
# Pallas interpreter, 4 x 128^2, astro-snr-v1, cycle spin, 20 steps)
# gave identical flux on the CPU (tests/test_torch_gmm_fused_split.py::
# test_dial_flux_difference_matches_jax): a reading of no flip, which
# bounds nothing at phase 3's 64 times as many patches. So phase 3
# holds the share of valid patches whose argmax differs between K1's
# two kernels at the final flux to K1_SPLIT_FLIPS, and prints the two
# runs' flux difference beside it and beside the JAX package's.
JAX_DIAL_FLUX_SHARE = 0.0
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def check(condition, message):
    if not condition:
        raise AssertionError(message)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps, *kernels):
    """Mean device milliseconds per call of ``fn``: every kernel, memset
    and copy it runs on the card (torch.profiler), so that a call whose
    host side takes longer than its kernels is timed by its device work.

    The profiler may miss an event of a record (on the H100 it once saw a
    call's first kernel 19 times in 20 calls, in three records in a row).
    So each kind of event counts with its mean time over the events seen,
    times the events a call makes (its count over ``reps``, rounded: a
    kind seen in fewer than half the calls is not work of a call). Each
    kernel named by a substring in ``kernels`` must make one a call: seen
    in more than half the calls and in no more than ``reps``. It has also
    once seen none of a kernel's events in a record, so a record that
    fails that is taken again, at most twice more."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.count and e.self_device_time_total > 0]
        missed = []
        for name in kernels:
            seen = [e.count for e in events if name in e.key]
            if not (len(seen) == 1 and reps // 2 < seen[0] <= reps):
                missed.append(f"{name} {seen} times")
        if not missed:
            break
    check(not missed, f"the profiler saw {', '.join(missed)} in {reps} "
          f"calls (three records)")
    us = sum(e.self_device_time_total / e.count * round(e.count / reps)
             for e in events)
    return us / 1e3


# K3's float32 passes on the warpgroup instructions
F32_KERNELS = ("pfft_cols_fwd_f32_kernel", "pfft_rows_f32_kernel",
               "pfft_cols_inv_f32_kernel")
# K3's pass 1 of the bf16 modes: the instances of pfft_cols_fwd_wg_kernel<
# products, columns an item>, their names in ptxas_summary and in the
# machine code (mangled template arguments)
FWD_WG_KERNELS = tuple(
    (f"pfft_cols_fwd_wg_kernel<{prod}, {cols}>",
     f"pfft_cols_fwd_wg_kernelILi{prod}ELi{cols}E")
    for prod in (3, 1) for cols in (16, 8))
# the instances of gmm_score_wg_kernel<image, products, epilogue> beside
# the bf16 modes' MAP ones: K1 MAP of "highest", K1 lse and K4 of every
# mode, and the probe's K5 lse, K8 and K9a of every mode (epilogues 1, 3
# and 4 on rows); their names in ptxas_summary and in the machine code
# (mangled template arguments)
WG_FUSED_KERNELS = tuple(
    (f"gmm_score_wg_kernel<{str(image).lower()}, {prod}, {epi}>",
     f"gmm_score_wg_kernelILb{int(image)}ELi{prod}ELi{epi}E")
    for image, prod, epi in ((True, 6, 0), (True, 6, 1), (False, 6, 2),
                             (True, 3, 1), (False, 3, 2), (True, 1, 1),
                             (False, 1, 2))
    + tuple((False, prod, epi) for prod in (6, 3, 1) for epi in (1, 3, 4)))
# K2's two kernels, by the names the profiler gives them
K2_KERNELS = ("::gmm_bwd_kernel(", "::gmm_bwd_add_kernel(")
# K9b's kernel, by the name the profiler gives it
K9B_KERNEL = "::gmm_hvp_marg_mix_kernel("


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"phase 0 device: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build():
    from jolideco_torch.utils.cuda_build import (
        BUILD_INFO,
        LIBRARIES,
        load_libraries,
    )

    t0 = time.perf_counter()
    load_libraries(*LIBRARIES)
    seconds = time.perf_counter() - t0
    for name in LIBRARIES:
        print(f"phase 1 build: {name} in {BUILD_INFO[name]['seconds']:.2f} s "
              f"(all in {seconds:.2f} s); "
              + " | ".join(ptxas_summary(BUILD_INFO[name]["ptxas"])))
    # the warpgroup kernels must be wgmma in the machine code (HGMMA)
    for name in ("gmm_score_wg", "pfft_conv_wg"):
        hgmma = sass_count(BUILD_INFO[name]["path"], "HGMMA")
        warnings = [line.strip() for line in
                    BUILD_INFO[name]["ptxas"].splitlines()
                    if "warning" in line]
        print(f"phase 1 sass: {name} HGMMA {hgmma}; ptxas warnings "
              f"{warnings or 'none'}")
        check(hgmma > 0, f"{name} has no HGMMA instruction")
    # K1, K4 and the probe's K5 lse, K8 and K9a of every mode
    # (gmm_score_wg's instances beside the bf16 modes' MAP ones): wgmma
    # each, and no wait that ptxas had to inject between products
    info = BUILD_INFO["gmm_score_wg"]
    check(not any("C7517" in line for line in info["ptxas"].splitlines()),
          "ptxas injected a wgmma wait in gmm_score_wg")
    summary = ptxas_summary(info["ptxas"])
    for kernel, mangled in WG_FUSED_KERNELS:
        hgmma = sass_count(info["path"], "HGMMA", mangled)
        lines = [line for line in summary if line.startswith(kernel + ":")]
        print(f"phase 1 sass: {kernel} HGMMA {hgmma}; {'; '.join(lines)}")
        check(hgmma > 0, f"{kernel} has no HGMMA instruction")
    # K3's float32 passes and the bf16 modes' pass 1: wgmma each, no
    # spills, no warning, and no wait that ptxas had to inject between
    # products (its C7517)
    info = BUILD_INFO["pfft_conv_wg"]
    check(not any("warning" in line or "C7517" in line
                  for line in info["ptxas"].splitlines()),
          "ptxas warned on pfft_conv_wg or injected a wgmma wait")
    summary = ptxas_summary(info["ptxas"])
    for kernel, mangled in ([(k, k) for k in F32_KERNELS]
                            + list(FWD_WG_KERNELS)):
        hgmma = sass_count(info["path"], "HGMMA", mangled)
        spills = [line for line in summary if line.startswith(kernel + ":")
                  and "spill" in line]
        print(f"phase 1 sass: {kernel} HGMMA {hgmma}; {'; '.join(spills)}")
        check(hgmma > 0, f"{kernel} has no HGMMA instruction")
        check(spills and all(re.search(r"\b0 bytes spill stores, 0 bytes "
                                       r"spill loads", line)
                             for line in spills), f"{kernel} spills")


@functools.lru_cache(maxsize=None)
def sass_text(path):
    """A library's machine code (``cuobjdump -sass``), dumped once."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(Path(cuda_home) / "bin" /
                                            "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def sass_count(path, opcode, kernel=None):
    """Instructions of ``opcode`` in a library's machine code
    (``cuobjdump -sass``), or in its functions whose (mangled) names hold
    ``kernel``."""
    sass = sass_text(path)
    count, inside = 0, kernel is None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel is None or kernel in line
        elif inside and f" {opcode}" in line:
            count += 1
    return count


def ptxas_summary(text):
    """Per kernel of ``nvcc -Xptxas -v`` output: its registers, shared
    memory and spills, under a readable name
    (``gmm_score_wg_kernel<true, 6, 1>``, ``pfft_cols_fwd_wg_kernel<1, 8>``)."""
    out, kernel = [], None
    for line in text.splitlines():
        if "Function properties for" in line:
            m = re.search(r"\d+((?:gmm|pfft)_\w+?_kernel)((?:I|L[bi]\d+E)*)",
                          line)
            kernel = m.group(1) if m else line.split()[-1]
            args = re.findall(r"L([bi])(\d+)E", m.group(2)) if m else []
            if args:
                kernel += "<" + ", ".join(
                    ("true" if v == "1" else "false") if t == "b" else v
                    for t, v in args) + ">"
        elif kernel and ("spill" in line or "registers" in line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def bound(flop, nbytes, peak=PEAK_FP32_FLOPS):
    """Least time in ms on the card, and what sets it."""
    t_ops, t_bytes = flop / peak, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def split_bound(flop, nbytes, products=3):
    """:func:`bound` of the same work under the dial's ``"split"`` mode:
    three bf16 products for each float32 one, at the bf16 peak; with
    ``products=1``, under ``"bf16"`` (one product each)."""
    return bound(products * flop, nbytes, PEAK_BF16_FLOPS)


def products(mode):
    """bf16 products a k16 step of the tensor-core kernels of ``mode``."""
    from jolideco_torch.ops.gmm_fused import TC_PRODUCTS

    return TC_PRODUCTS[mode]


def launcher(module, name):
    """The wrapper of the kernel counted as ``name`` (``counts()``)."""
    return getattr(module, name + "_cuda")


def phase_kernels(torch, device):
    """Each kernel against its plain version; returns per-kernel numbers."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    gmm = GaussianMixtureModel.from_registry("astro-snr-v1")
    bufs = gmm.kernel_buffers(device)
    rs = np.random.RandomState(0)
    ragged = rs.uniform(0.1, 2.0, RAGGED).astype(np.float32)
    ragged[96:160, 200:260] = 2.0 * ZERO_FLUX_SENTINEL
    cases = {
        MAIN: rs.uniform(0.1, 2.0, (FIELD, FIELD)).astype(np.float32),
        "{}x{}".format(*RAGGED): ragged,
    }
    stride, sentinel = 4, ZERO_FLUX_SENTINEL
    out = {}
    for label, img in cases.items():
        image = torch.as_tensor(img, device=device)
        vk, ak, valk, xk = gf.gmm_fused_fwd_cuda(image, bufs, stride, sentinel)
        vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride,
                                                   sentinel)
        torch.cuda.synchronize()
        check(torch.equal(valk, valp), f"{label}: valid differs")
        m = valp > 0.5
        check(bool(m.any()), f"{label}: no valid patch")
        # K1 of "highest" (the six-product core on wgmma): values rtol
        # 1e-5 elementwise on valid patches (float32 sums in different
        # orders on the tensor cores and in the matmul)
        value_err = (vk - vp).abs()[m]
        check(bool((value_err <= 1e-5 * vp.abs()[m]).all()),
              f"{label}: values beyond rtol 1e-5 "
              f"(max rel {float((value_err / vp.abs()[m]).max()):.3g})")
        flips = int((ak != ap)[m].sum())
        n_valid = int(m.sum())
        check(flips <= 1e-4 * n_valid,
              f"{label}: argmax flips {flips} of {n_valid}")
        xtn_err = float((xk - xp).abs().max())
        check(xtn_err <= 1e-5, f"{label}: normalised patches differ "
              f"by {xtn_err:.3g}")
        # backward on identical inputs: gradient to 1e-4 of its max-abs
        gen = torch.Generator(device=device).manual_seed(1)
        dv = torch.randn(vp.shape, generator=gen, device=device) * valp
        gk = gf.gmm_fused_bwd_cuda(xp, ap, valp, dv, bufs, img.shape, stride)
        gk2 = gf.gmm_fused_bwd_cuda(xp, ap, valp, dv, bufs, img.shape,
                                    stride)
        gp = gf.fused_backward_plain(xp, ap, valp, dv, bufs, img.shape,
                                     stride)
        torch.cuda.synchronize()
        check(torch.equal(gk, gk2), f"{label}: two K2 calls differ")
        grad_err = float((gk - gp).abs().max())
        grad_scale = float(gp.abs().max())
        check(grad_err <= 1e-4 * grad_scale,
              f"{label}: gradient error {grad_err:.3g} vs max {grad_scale:.3g}")
        out[label] = {
            "value_max_abs_err": float(value_err.max()),
            "value_max_rel_err": float((value_err / vp.abs()[m]).max()),
            "argmax_flips": flips, "n_valid": n_valid,
            "grad_max_abs_err": grad_err, "grad_max_abs": grad_scale,
        }
        if label == MAIN:
            out["timing"] = {
                "fwd_ms": cuda_ms(torch, lambda: gf.gmm_fused_fwd_cuda(
                    image, bufs, stride, sentinel), 10),
                "fwd_plain_ms": cuda_ms(torch, lambda: gf.fused_forward_plain(
                    image, bufs, stride, sentinel), 3),
                "bwd_ms": cuda_ms(torch, lambda: gf.gmm_fused_bwd_cuda(
                    xp, ap, valp, dv, bufs, img.shape, stride), 10),
                # K2's call takes longer on the host than on the card
                "bwd_device_ms": device_ms(
                    torch, lambda: gf.gmm_fused_bwd_cuda(
                        xp, ap, valp, dv, bufs, img.shape, stride), 10,
                    *K2_KERNELS),
                "bwd_plain_ms": cuda_ms(torch, lambda: gf.fused_backward_plain(
                    xp, ap, valp, dv, bufs, img.shape, stride), 3),
            }
            # K2 where each tile's 128 patches select 128 components, one
            # patch a run: its costliest argmax
            every = (torch.arange(vp.numel(), device=device)
                     % bufs["a_bwd"].shape[0]).to(torch.int32)
            out["k2_many"] = k2_case(torch, xp, every, valp, dv, bufs,
                                     img.shape)
            print(f"phase 2 K2 {label}, argmax = patch index mod K: "
                  f"{k2_case_line(out['k2_many'])}")
            # K1: every patch against every component (the pair form and
            # b . x) as six bf16 products at the bf16 peak, and beside it
            # on the float32 CUDA cores; reads the image, the three planes
            # of the pairs and the linear terms, writes values, argmax,
            # valid and the normalised patches
            n, k = vp.numel(), bufs["rec"].shape[0]
            work = (2.0 * n * k * (2080 + 64),
                    4 * (img.size + n * (3 + 64)) + wg_bytes(bufs, "f32"))
            out["fwd_bound"] = split_bound(*work, products=6)
            out["fwd_bound_fp32"] = bound(*work)
            # K2: A_{k*} x for each valid patch; reads the valid patches,
            # argmax, valid, dv and the components they select, writes
            # the image gradient
            used = int(torch.unique(ap[m]).numel())
            out["bwd_bound"] = bound(
                2.0 * n_valid * 64 * 64,
                4 * (n_valid * 64 + 3 * n + used * (64 * 64 + 64)
                     + img.size))
        print(f"phase 2 kernels {label}: valid identical; "
              f"values max rel err {out[label]['value_max_rel_err']:.3g}; "
              f"argmax flips {flips}/{n_valid}; "
              f"grad max abs err {grad_err:.3g} (max {grad_scale:.3g}), "
              "two K2 calls bitwise equal")
        for mode in ("split", "bf16"):
            out[label][mode] = k1_split_checks(
                torch, label, image, bufs, (vp, ap, valp, xp), mode=mode)
    # K1's kernels past one tile of components: K = 256 on the ragged
    # image, and under a GMM whose logits are much cancelled sums (no
    # relative bar)
    label = "{}x{}".format(*RAGGED)
    image = torch.as_tensor(cases[label], device=device)
    for key, gmm, relative in (("wide", wide_gmm(), True),
                               ("cancelled", cancelled_gmm(), False)):
        wbufs = gmm.kernel_buffers(device)
        fp32_plain = gf.fused_forward_plain(image, wbufs, stride, sentinel)
        out[f"{key}_f32"] = k1_f32_checks(torch, f"{label} K=256 {key}",
                                          image, wbufs, fp32_plain, relative)
        out[key] = k1_split_checks(torch, f"{label} K=256 {key}", image,
                                   wbufs, fp32_plain, relative)
        out[f"{key}_bf16"] = k1_split_checks(
            torch, f"{label} K=256 {key}", image, wbufs, fp32_plain,
            relative, mode="bf16")
    t, fb, fb32 = out["timing"], out["fwd_bound"], out["fwd_bound_fp32"]
    print(f"phase 2 timing {MAIN} K=200: fwd kernel (K1 of \"highest\" on "
          f"wgmma) {t['fwd_ms']:.3f} ms, bound {fb['bound_ms']:.4f} ms as "
          f"six bf16 products ({fb['bound_ms'] / t['fwd_ms']:.1%}), "
          f"{fb32['bound_ms']:.4f} ms on the float32 CUDA cores "
          f"({fb32['bound_ms'] / t['fwd_ms']:.1%}); "
          f"plain {t['fwd_plain_ms']:.3f} ms; bwd {t['bwd_ms']:.4f} ms a "
          f"call ({t['bwd_device_ms']:.4f} ms of device time), plain "
          f"{t['bwd_plain_ms']:.3f} ms")
    out["patch"] = phase_patch_kernels(torch, device, bufs, cases)
    out["marg"] = phase_marg_kernels(torch, device, bufs, cases)
    out["marg_split"] = phase_marg_split_kernels(torch, device, bufs, cases,
                                                 out["marg"])
    out["marg_bf16"] = phase_marg_split_kernels(torch, device, bufs, cases,
                                                out["marg"], "bf16")
    out["pfft"] = phase_pfft_kernels(torch, device)
    return out


def max_logits64(torch, xtn, bufs, marginalize=False):
    """Maximum (or, with ``marginalize``, logsumexp) and argmax over the
    components of the logits of ``xtn`` (float32 rows) in float64, from
    the float32 buffers."""
    aq, bq, c2 = (bufs[name].double() for name in ("aq", "bq", "const2"))
    values, argmax = [], []
    for start in range(0, xtn.shape[0], 4096):
        x = xtn[start:start + 4096].double()
        u = (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], -1)
        logits = -0.5 * (u @ aq) + x @ bq + c2
        v, k = logits.max(dim=1)
        values.append(torch.logsumexp(logits, dim=1) if marginalize else v)
        argmax.append(k.to(torch.int32))
    return torch.cat(values), torch.cat(argmax)


def exact_chunks(torch, xtn, bufs, mode="split"):
    """Per chunk of 4096 rows of ``xtn`` (float32), ``(slice, logits,
    size)``: the float64 sums of the bf16 products of ``mode`` (the
    logits both the tensor-core kernels and the plain version of the mode
    round: the pair products formed in float32 and split, or rounded, to
    bf16), and the sums of the products' magnitudes (what a float32
    sum's rounding scales with)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops.linalg import bf16_split

    pa = torch.as_tensor(gf.PAIR_A, device=xtn.device)
    pb = torch.as_tensor(gf.PAIR_B, device=xtn.device)
    a_hi, a_lo = bufs["pair_hi"].double(), bufs["pair_lo"].double()
    bq, c2 = bufs["bq"].double(), bufs["const2"].double()
    for start in range(0, xtn.shape[0], 4096):
        sl = slice(start, start + 4096)
        x = xtn[sl].double()
        u_hi, u_lo = (p.double() for p in bf16_split(xtn[sl][:, pa]
                                                     * xtn[sl][:, pb]))
        if mode == "split":
            quad = u_hi @ a_hi + u_hi @ a_lo + u_lo @ a_hi
            qsize = (u_hi.abs() @ (a_hi.abs() + a_lo.abs())
                     + u_lo.abs() @ a_hi.abs())
        else:
            quad, qsize = u_hi @ a_hi, u_hi.abs() @ a_hi.abs()
        yield (sl, -0.5 * quad + x @ bq + c2,
               0.5 * qsize + x.abs() @ bq.abs() + c2.abs())


def exact_split_values(torch, xtn, bufs, argmax, marginalize=False,
                       mode="split"):
    """The exact logits of ``mode`` (:func:`exact_chunks`) of rows
    ``xtn`` at the components ``argmax``, and the sums of the products'
    magnitudes. With ``marginalize``, the logsumexp of those exact
    logits, and the magnitudes averaged by their softmax weights (the
    logsumexp's derivative in each logit)."""
    out, mag = [], []
    for sl, logits, size in exact_chunks(torch, xtn, bufs, mode):
        k = argmax[sl].long()[:, None]
        if marginalize:
            out.append(torch.logsumexp(logits, dim=1))
            mag.append((torch.softmax(logits, dim=1) * size).sum(dim=1))
        else:
            out.append(logits.gather(1, k)[:, 0])
            mag.append(size.gather(1, k)[:, 0])
    return torch.cat(out), torch.cat(mag)


def split_value_checks(torch, tag, rows, bufs, tc, split_plain, fp32,
                       fp32_plain, relative=True, marginalize=False,
                       mode="split", control=None,
                       sum_err_limit=K1_SPLIT_SUM_ERR):
    """A tensor-core scorer of the ``"split"`` mode (K1 split, K5 split),
    or of ``"bf16"`` with ``mode``, on the normalised rows ``rows``: its
    ``(values, argmax)`` ``tc`` against the plain version's of its mode
    (``split_plain``; values rtol ``K1_SPLIT_RTOL``, argmax flips at most
    ``K1_SPLIT_FLIPS`` of the rows), its mean signed relative difference
    from the exact sum of its products (``K1_SPLIT_BIAS``) and its
    largest difference over the products' magnitudes
    (``sum_err_limit``), then the errors of both and of the float32
    kernel and plain version against the logits in float64 (the maximum,
    or with ``marginalize`` the logsumexp). Without ``relative`` the two
    bars relative to the values are printed, not held. Past one tile of
    components (208), both tiles must hold winning rows. ``control``, the
    ``(values, argmax)`` of another mode's plain version (the split ones
    where the kernel is ``"bf16"``'s), must fail those bars. ``fp32``,
    the float32 kernel's ``(values, argmax)``, is printed beside them,
    or left out when None. Returns the numbers and the line to print."""
    from jolideco_torch.ops import gmm_fused as gf

    (vt, at), (vs, as_) = tc, split_plain
    vp = fp32_plain[0]
    kernels32 = () if fp32 is None else (("fp32", fp32[0]),)
    n_rows = rows.shape[0]
    rel = float(((vt - vs).abs() / vs.abs()).max())
    check(not relative or rel <= K1_SPLIT_RTOL, f"{tag}: values beyond "
          f"rtol {K1_SPLIT_RTOL} (max rel {rel:.3g})")
    flips = int((at != as_).sum())
    check(flips <= K1_SPLIT_FLIPS * n_rows,
          f"{tag}: argmax flips {flips} of {n_rows}")
    if bufs["rec"].shape[0] > gf.KP_WG:
        tile1 = int((at >= gf.KP_WG).sum())
        check(0 < tile1 < n_rows, f"{tag}: {tile1} of {n_rows} rows won in "
              f"the second tile of components")
        tag += f" ({tile1} of {n_rows} rows won in the second tile)"
    exact, mag = exact_split_values(torch, rows, bufs, at, marginalize,
                                    mode)
    bias = {name: float(((v.double() - exact) / exact.abs()).mean())
            for name, v in (("tc", vt), ("split_plain", vs))}
    # the rounding of the sums against the size of what they sum
    cancel = float((mag / exact.abs()).max())
    sum_err = {name: float(((v.double() - exact).abs() / mag).max())
               for name, v in (("tc", vt), ("split_plain", vs))}
    check(sum_err["tc"] <= sum_err_limit, f"{tag}: difference from the "
          f"exact sum {sum_err['tc']:.3g} of the products' magnitudes, "
          f"beyond {sum_err_limit}")
    check(not relative or abs(bias["tc"]) <= K1_SPLIT_BIAS,
          f"{tag}: mean signed relative "
          f"difference from the exact sum {bias['tc']:.3g} beyond "
          f"{K1_SPLIT_BIAS}")
    v64, a64 = max_logits64(torch, rows, bufs, marginalize)
    scale = float(v64.abs().max())
    errs = {name: float((v.double() - v64).abs().max())
            for name, v in (("tc", vt), ("split_plain", vs), *kernels32,
                            ("fp32_plain", vp))}
    flips64 = {name: int((a != a64).sum())
               for name, a in (("tc", at), ("split_plain", as_),
                               *(() if fp32 is None else (("fp32", fp32[1]),)))}
    limit = MARG_ERR_FACTOR * errs["split_plain"] + MARG_ERR_FLOOR * scale
    check(errs["tc"] <= limit, f"{tag}: error against float64 "
          f"{errs['tc']:.3g} above {limit:.3g}")
    if control is not None:
        # the other mode's values in place of the kernel's must fail the
        # bars that the kernel passed
        vc = control[0]
        ctrl = {"value_max_rel_err": float(((vc - vs).abs() / vs.abs()).max()),
                "mean_rel_diff_from_exact": float(
                    ((vc.double() - exact) / exact.abs()).mean()),
                "max_diff_from_exact_over_magnitudes": float(
                    ((vc.double() - exact).abs() / mag).max())}
        refused = (ctrl["max_diff_from_exact_over_magnitudes"]
                   > K1_SPLIT_SUM_ERR
                   or (relative and (
                       ctrl["value_max_rel_err"] > K1_SPLIT_RTOL
                       or abs(ctrl["mean_rel_diff_from_exact"])
                       > K1_SPLIT_BIAS)))
        check(refused, f"{tag}: the control (the other mode's values) "
              f"passed the bars: {ctrl}")
    out = {"value_max_rel_err": rel, "argmax_flips": flips,
           "mean_rel_diff_from_exact": bias,
           "max_diff_from_exact_over_magnitudes": sum_err,
           "max_magnitudes_over_value": cancel, "n_valid": n_rows,
           "value_max_abs_err": float((vt - vs).abs().max()),
           "errors_against_float64": errs, "max_abs": scale,
           "argmax_flips_against_float64": flips64}
    if control is not None:
        out["control"] = ctrl
    line = (f"phase 2 {tag}: against the {mode} plain version values max rel "
            f"{rel:.3g} (limit {K1_SPLIT_RTOL if relative else None}), "
            f"argmax flips {flips}/{n_rows}; mean signed rel "
            f"difference from the exact sum of the products tc "
            f"{bias['tc']:.3g} (limit {K1_SPLIT_BIAS if relative else None}), "
            f"{mode} plain "
            f"{bias['split_plain']:.3g}; largest difference from it over "
            f"the sum of the products' magnitudes tc {sum_err['tc']:.3g} "
            f"(limit {sum_err_limit}), {mode} plain "
            f"{sum_err['split_plain']:.3g} (magnitudes up to "
            f"{cancel:.3g} x the value); against float64 "
            f"(max-abs {scale:.6g}): tc {errs['tc']:.3g}, {mode} plain "
            f"{errs['split_plain']:.3g}"
            + (f", fp32 kernel {errs['fp32']:.3g}" if fp32 is not None
               else "")
            + f", fp32 plain {errs['fp32_plain']:.3g}; argmax flips against "
            f"float64: tc {flips64['tc']}, {mode} plain "
            f"{flips64['split_plain']}"
            + (f", fp32 kernel {flips64['fp32']}" if fp32 is not None
               else ""))
    if control is not None:
        line += (f"; control (split plain values) refused: max rel "
                 f"{ctrl['value_max_rel_err']:.3g}, mean rel diff "
                 f"{ctrl['mean_rel_diff_from_exact']:.3g}, over magnitudes "
                 f"{ctrl['max_diff_from_exact_over_magnitudes']:.3g}")
    return out, line


def k1_split_checks(torch, label, image, bufs, fp32_plain, relative=True,
                    mode="split", timed=False, sum_err_limit=K1_SPLIT_SUM_ERR):
    """K1's ``"split"`` kernel (tensor cores), or its ``"bf16"`` kernel
    with ``mode``, on one image: ``valid`` and the normalised patches
    against the plain version's of the mode, then
    :func:`split_value_checks` at the valid patches (under ``"bf16"`` with
    the split plain values as the control; the float32 plain version's
    ``fp32_plain`` beside them); at the main path's shape (or with
    ``timed``), times and bound."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL
    from jolideco_torch.utils.cuda_build import BUILD_INFO

    stride, sentinel = 4, ZERO_FLUX_SENTINEL
    kernel = launcher(gf, K1_KERNELS[mode])
    vt, at, valt, xt = kernel(image, bufs, stride, sentinel)
    vs, as_, vals, xs = gf.fused_forward_plain(image, bufs, stride, sentinel,
                                               mode=mode)
    vp, ap, valp, xp = fp32_plain
    torch.cuda.synchronize()
    tag = f"{label} K1 {mode}"
    check(torch.equal(valt, valp) and torch.equal(vals, valp),
          f"{tag}: valid differs")
    m = valp > 0.5
    xtn_err = float((xt - xs).abs().max())
    check(xtn_err <= 1e-5, f"{tag}: normalised patches differ by "
          f"{xtn_err:.3g}")
    rows, plain, control = xs[m], (vs[m], as_[m]), None
    if mode == "bf16":
        # a single bf16 rounding is not continuous: the kernel's
        # normalised patches (within 1e-5 of the plain version's, held
        # above; they differ in the last bits of the mean) flip the
        # rounding of a pair product now and then, which moves its logit
        # by up to about 1e-3 of itself. So the bf16 plain scorer, and the
        # split one as the control, score the kernel's own patches.
        rows = xt[m]
        plain = gf.score_bf16_plain(rows, bufs)
        control = gf.score_split_plain(rows, bufs)
    out, line = split_value_checks(
        torch, tag, rows, bufs, (vt[m], at[m]), plain, None, (vp[m], ap[m]),
        relative, mode=mode, control=control, sum_err_limit=sum_err_limit)
    out["xtn_max_abs_err"] = xtn_err
    line += f"; xtn {xtn_err:.3g}"
    if label == MAIN or timed:
        n, k = vs.numel(), bufs["rec"].shape[0]
        out["ms"] = cuda_ms(torch, lambda: kernel(image, bufs, stride,
                                                  sentinel), 10)
        out["plain_ms"] = cuda_ms(torch, lambda: gf.fused_forward_plain(
            image, bufs, stride, sentinel, mode=mode), 3)
        # three bf16 products (one under "bf16") of every patch against
        # every component (the 2,080 pairs and b . x) at the bf16 peak;
        # reads the image and the pairs' bf16 planes, b and c, writes
        # values, argmax, valid and xtn
        out["bound"] = split_bound(
            2.0 * n * k * (2080 + 64),
            4 * (image.numel() + n * (3 + 64)) + wg_bytes(bufs, mode),
            products(mode))
        out["ptxas"] = ptxas_summary(BUILD_INFO["gmm_score_wg"]["ptxas"])
        line += (f"; {out['ms']:.3f} ms per call ({mode} plain "
                 f"{out['plain_ms']:.3f} ms), {mode} bound "
                 f"{out['bound']['bound_ms']:.4f} ms "
                 f"({out['bound']['bound_by']}, "
                 f"{out['bound']['bound_ms'] / out['ms']:.1%}); "
                 + " | ".join(out["ptxas"]))
    print(line)
    return out


def f32_sum_err(torch, x, bufs, values, argmax):
    """The largest difference of float32 MAP ``values`` from the float64
    logit of rows ``x`` at ``argmax`` (the float32 buffers), over the sum
    of that logit's terms' magnitudes (what a float32 sum's rounding
    scales with), and the largest ratio of the magnitudes to the value."""
    aq, bq, c2 = (bufs[name].double() for name in ("aq", "bq", "const2"))
    errs, ratios = [], []
    for start in range(0, x.shape[0], 4096):
        sl = slice(start, start + 4096)
        x64 = x[sl].double()
        u = (x64[:, :, None] * x64[:, None, :]).reshape(x64.shape[0], -1)
        k = argmax[sl].long()[:, None]
        exact = (-0.5 * (u @ aq) + x64 @ bq + c2).gather(1, k)[:, 0]
        mag = (0.5 * (u.abs() @ aq.abs()) + x64.abs() @ bq.abs()
               + c2.abs()).gather(1, k)[:, 0]
        errs.append(((values[sl].double() - exact).abs() / mag).max())
        ratios.append((mag / exact.abs()).max())
    return float(torch.stack(errs).max()), float(torch.stack(ratios).max())


def k1_f32_checks(torch, label, image, bufs, fp32_plain, relative=True):
    """K1 of ``"highest"`` (``gmm_fused_fwd_cuda``, the six-product core
    on ``wgmma``) on one image against the float32 plain version
    ``fp32_plain``: ``valid`` identical, the patches within 1e-5, argmax
    flips at most ``K1_SPLIT_FLIPS`` of the valid patches, values rtol
    1e-5 (without ``relative`` printed, not held: ``K1_F32_SUM_ERR``
    says why), within ``K1_F32_SUM_ERR`` of their terms' magnitudes from
    the float64 sum; against float64 the anchored bar. Returns the
    numbers."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    vk, ak, valk, xk = gf.gmm_fused_fwd_cuda(image, bufs, 4,
                                             ZERO_FLUX_SENTINEL)
    vp, ap, valp, xp = fp32_plain
    torch.cuda.synchronize()
    tag = f"{label} K1 f32"
    check(torch.equal(valk, valp), f"{tag}: valid differs")
    m = valp > 0.5
    n_valid = int(m.sum())
    xtn_err = float((xk - xp).abs().max())
    check(xtn_err <= 1e-5, f"{tag}: normalised patches differ by "
          f"{xtn_err:.3g}")
    rel = float(((vk - vp).abs() / vp.abs())[m].max())
    check(not relative or rel <= 1e-5, f"{tag}: values beyond rtol 1e-5 "
          f"(max rel {rel:.3g})")
    flips = int((ak != ap)[m].sum())
    check(flips <= K1_SPLIT_FLIPS * n_valid,
          f"{tag}: argmax flips {flips} of {n_valid}")
    v64, a64 = max_logits64(torch, xp[m], bufs)
    err, err32, scale = anchored(tag, "values", vk[m], vp[m], v64)
    rel64 = {name: float(((v.double() - v64).abs() / v64.abs()).max())
             for name, v in (("kernel", vk[m]), ("fp32_plain", vp[m]))}
    sum_err = {name: f32_sum_err(torch, xp[m], bufs, v, a64)
               for name, v in (("kernel", vk[m]), ("plain", vp[m]))}
    check(sum_err["kernel"][0] <= K1_F32_SUM_ERR, f"{tag}: difference "
          f"from the exact sum {sum_err['kernel'][0]:.3g} of the terms' "
          f"magnitudes, beyond {K1_F32_SUM_ERR}")
    out = {"value_max_rel_err": rel, "argmax_flips": flips,
           "n_valid": n_valid, "xtn_max_abs_err": xtn_err,
           "errors_against_float64": {"kernel": err, "fp32_plain": err32},
           "max_rel_errors_against_float64": rel64, "max_abs": scale,
           "max_diff_from_exact_over_magnitudes": {
               name: e[0] for name, e in sum_err.items()},
           "max_magnitudes_over_value": sum_err["kernel"][1]}
    print(f"phase 2 {tag}: against the float32 plain version values max "
          f"rel {rel:.3g} (limit {1e-5 if relative else None}), argmax "
          f"flips {flips}/{n_valid}, xtn {xtn_err:.3g}; against float64 "
          f"(max-abs {scale:.6g}) kernel {err:.3g}, float32 plain "
          f"{err32:.3g} (max rel {rel64['kernel']:.3g}, "
          f"{rel64['fp32_plain']:.3g}); largest difference from the exact sum over its "
          f"terms' magnitudes kernel {sum_err['kernel'][0]:.3g} (limit "
          f"{K1_F32_SUM_ERR}), float32 plain {sum_err['plain'][0]:.3g} "
          f"(magnitudes up to {sum_err['kernel'][1]:.3g} x the value)")
    return out


def wg_bytes(bufs, mode):
    """Bytes of the pairs' planes and ``lin_wg`` that the warpgroup
    kernels of ``mode`` read: both bf16 planes of each chunk of
    ``pair_wg`` under ``"split"``, the hi plane under ``"bf16"``, the
    three of ``pair_wg3`` under ``"f32"``, and the linear terms."""
    from jolideco_torch.ops.gmm_fused import WG_PLANE

    if mode == "f32":
        return bufs["pair_wg3"].numel() + bufs["lin_wg"].numel()
    tiles, chunks, record = bufs["pair_wg"].shape
    return (tiles * chunks * (record - (WG_PLANE if mode == "bf16" else 0))
            + bufs["lin_wg"].numel())


def normalised_rows(torch, image, sentinel):
    """The probe's rows of an image: grouped patches, masked, mean-free."""
    from jolideco_torch.ops.patches import view_as_overlapping_patches_grouped

    patches = view_as_overlapping_patches_grouped(image, (8, 8), 4)
    valid = (patches > sentinel).all(dim=1)
    patches = torch.where(valid[:, None], patches, torch.zeros_like(patches))
    return (patches - patches.mean(dim=1, keepdim=True)).contiguous()


# rows a block of the row map (csrc/gmm_patch.cu kMapTile): each
# half-warp reads A_k once per run of k* among its 8 places
ROW_TILE = 128


def k5_split_checks(torch, label, x, bufs, relative=True, mode="split"):
    """K5 split (tensor cores), or K5 bf16 with ``mode``, both instances,
    on rows ``x``: :func:`split_value_checks` against the plain versions
    of the mode (under ``"bf16"`` with the split plain values as the
    control), beside the float32 K5 and its plain version."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp

    out = {}
    for marginalize, name in ((False, "map"), (True, "lse")):
        tc = launcher(gp, MARG_PROBE_KERNELS[mode][0] if marginalize
                      else K5_KERNELS[mode])(x, bufs)
        fp32 = gp.gmm_score_rows_cuda(x, bufs, marginalize)
        split_plain = gf.PLAIN_SCORES[mode, marginalize](x, bufs)
        fp32_plain = gp.score_rows_plain(x, bufs, marginalize)
        control = (gf.PLAIN_SCORES["split", marginalize](x, bufs)
                   if mode == "bf16" else None)
        torch.cuda.synchronize()
        out[name], line = split_value_checks(
            torch, f"{label} K5 {mode} {name}", x, bufs, tc, split_plain,
            fp32, fp32_plain, relative, marginalize, mode, control)
        print(line)
    return out


def row_map_case(torch, x, argmax, bufs, plain=False):
    """K6 and K7 at rows ``x`` and ``argmax`` (K7 along a random tangent):
    each within 1e-4 of the max-abs of its plain version, two calls
    bitwise equal, its ms a call (CUDA events) and of device time
    (:func:`device_ms`: a call's host side may outlast its kernel)
    beside its bound (the rows in and out, the argmax and the selected
    components' A, and b for K6); the distinct components per block of
    ``ROW_TILE`` rows; with ``plain``, the plain versions' ms."""
    from jolideco_torch.ops import gmm_pallas as gp

    n = x.shape[0]
    gen = torch.Generator(device=x.device).manual_seed(2)
    t = torch.randn(x.shape, generator=gen, device=x.device)
    tile = torch.arange(n, device=x.device) // ROW_TILE
    width = int(argmax.max()) + 1
    pairs = torch.unique(tile * width + argmax.long())
    per_tile = torch.bincount(pairs // width).float()
    used = int(torch.unique(argmax).numel())
    out = {"rows": n, "used_components": used,
           "per_tile_mean": float(per_tile.mean()),
           "per_tile_max": int(per_tile.max())}
    for name, kern, fn, arg, b_floats, instance in (
            ("unit", gp.gmm_unit_map_cuda, gp.unit_map_plain, x, 64, "true"),
            ("hvp", gp.gmm_hvp_map_cuda, gp.hvp_map_plain, t, 0, "false")):
        got, again = kern(arg, argmax, bufs), kern(arg, argmax, bufs)
        want = fn(arg, argmax, bufs)
        torch.cuda.synchronize()
        tag = f"K{'6' if name == 'unit' else '7'} at {n} rows"
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-4 * scale, f"{tag}: error {err:.3g} vs max "
              f"{scale:.3g}")
        check(torch.equal(got, again), f"{tag}: two calls differ")
        out[name] = {
            "max_abs_err": err, "max_abs": scale,
            "ms": cuda_ms(torch, lambda: kern(arg, argmax, bufs), 20),
            "device_ms": device_ms(torch, lambda: kern(arg, argmax, bufs), 20,
                                   f"::gmm_row_map_kernel<{instance}>("),
            **bound(2.0 * n * 64 * 64, 4 * (2 * n * 64 + n)
                    + 4 * used * (64 * 64 + b_floats))}
        if plain:
            out[name]["plain_ms"] = cuda_ms(torch, lambda: fn(arg, argmax,
                                                              bufs), 3)
    return out


def row_map_line(case):
    return (f"{case['rows']} rows select {case['used_components']} "
            f"components, per block of {ROW_TILE} mean "
            f"{case['per_tile_mean']:.2f}, max {case['per_tile_max']}; "
            + "; ".join(
                f"K{k} {case[name]['ms']:.4f} ms a call, "
                f"{case[name]['device_ms']:.4f} of device time (bound "
                f"{case[name]['bound_ms']:.4f}, "
                f"{case[name]['bound_ms'] / case[name]['device_ms']:.1%}), "
                f"error "
                f"{case[name]['max_abs_err']:.3g} (max "
                f"{case[name]['max_abs']:.3g})"
                for k, name in (("6", "unit"), ("7", "hvp")))
            + ", two calls bitwise equal")


def phase_patch_kernels(torch, device, bufs, cases):
    """K5, K6 and K7 against their plain versions on the rows of the
    phase's images: the float32 K5's values rtol 1e-5 (float32 sums in
    other orders), argmax flips at most 1e-4 of the rows; K5 split
    (:func:`k5_split_checks`), also past one tile of components on the
    ragged rows; K6 and K7 (:func:`row_map_case`) at the float32 plain
    argmax and, on the main path's rows, at argmax = row index mod K
    (128 components a block)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    out = {}
    rows = {}
    for label, img in cases.items():
        x = normalised_rows(torch, torch.as_tensor(img, device=device),
                            ZERO_FLUX_SENTINEL)
        rows[label] = x
        n = x.shape[0]
        errs = {}
        for marginalize in (False, True):
            vk, ak = gp.gmm_score_rows_cuda(x, bufs, marginalize)
            vp, ap = gp.score_rows_plain(x, bufs, marginalize)
            torch.cuda.synchronize()
            rel = float(((vk - vp).abs() / vp.abs()).max())
            check(rel <= 1e-5, f"{label}: K5 values (marginalize="
                  f"{marginalize}) beyond rtol 1e-5 ({rel:.3g})")
            flips = int((ak != ap).sum())
            check(flips <= 1e-4 * n, f"{label}: K5 argmax flips {flips}/{n}")
            errs[f"score_marg{int(marginalize)}"] = (
                float((vk - vp).abs().max()), rel, flips)
        _, ap = gp.score_rows_plain(x, bufs)
        case = row_map_case(torch, x, ap, bufs, plain=label == MAIN)
        for name in ("unit", "hvp"):
            errs[name] = (case[name]["max_abs_err"], case[name]["max_abs"])
        errs["row_map"] = case
        out[label] = errs
        print(f"phase 2 patch kernels {label} ({n} rows): K5 values max rel "
              f"err {errs['score_marg0'][1]:.3g} (logsumexp "
              f"{errs['score_marg1'][1]:.3g}), argmax flips "
              f"{errs['score_marg0'][2]}; " + row_map_line(case))
        errs["split"] = k5_split_checks(torch, label, x, bufs)
        errs["bf16"] = k5_split_checks(torch, label, x, bufs, mode="bf16")
        if label != MAIN:
            continue
        k = bufs["rec"].shape[0]
        every = (torch.arange(n, device=device) % k).to(torch.int32)
        out["many"] = row_map_case(torch, x, every, bufs)
        print(f"phase 2 K6/K7 {label}, argmax = row index mod K: "
              + row_map_line(out["many"]))
        out["timing"] = {
            "score_ms": cuda_ms(torch, lambda: gp.gmm_score_rows_cuda(
                x, bufs), 10),
            "score_plain_ms": cuda_ms(torch, lambda: gp.score_rows_plain(
                x, bufs), 3),
            "lse_ms": cuda_ms(torch, lambda: gp.gmm_score_rows_marg_cuda(
                x, bufs), 10),
            "lse_plain_ms": cuda_ms(torch, lambda: gp.score_rows_plain(
                x, bufs, True), 3),
            **{f"{mode}_ms": cuda_ms(
                torch, lambda m=mode: gp._SCORES_TC[m, False](x, bufs), 10)
               for mode in ("split", "bf16")},
            "split_lse_ms": cuda_ms(
                torch, lambda: gp.gmm_score_rows_marg_tc_cuda(x, bufs), 10),
            "split_plain_ms": cuda_ms(torch, lambda: gf.score_split_plain(
                x, bufs), 3),
            "split_lse_plain_ms": cuda_ms(
                torch, lambda: gf.score_split_marg_plain(x, bufs), 3),
            "bf16_lse_ms": cuda_ms(
                torch, lambda: gp.gmm_score_rows_marg_bf16_cuda(x, bufs), 10),
            "bf16_plain_ms": cuda_ms(torch, lambda: gf.score_bf16_plain(
                x, bufs), 3),
            "bf16_lse_plain_ms": cuda_ms(
                torch, lambda: gf.score_bf16_marg_plain(x, bufs), 3),
            **{f"{name}_{key}": case[name][key] for name in ("unit", "hvp")
               for key in ("ms", "plain_ms")},
        }
        work = (2.0 * n * k * (2080 + 64),
                4 * (n * 64 + bufs["rec"].numel() + 2 * n))
        out["bounds"] = {
            # every row against every component; reads rows and records,
            # writes values and argmax; and the same as six bf16 products,
            # the least time of the "highest" logits on the tensor cores
            "score": bound(*work),
            "score_six": split_bound(*work, products=6),
            # the same in three bf16 products; reads rows, the split
            # pairs, b and c
            "score_split": split_bound(
                work[0], 4 * (n * 64 + 2 * n) + wg_bytes(bufs, "split")),
            # one product under "bf16", reading the hi planes
            "score_bf16": split_bound(
                work[0], 4 * (n * 64 + 2 * n) + wg_bytes(bufs, "bf16"), 1),
            "unit": {key: case["unit"][key]
                     for key in ("bound_ms", "bound_by")},
            "hvp": {key: case["hvp"][key]
                    for key in ("bound_ms", "bound_by")},
        }
        tm, sb = out["timing"], out["bounds"]["score_split"]
        bb = out["bounds"]["score_bf16"]
        print(f"phase 2 timing patch kernels {n} rows K={k}: K5 "
              f"{tm['score_ms']:.3f} ms (plain {tm['score_plain_ms']:.3f}), "
              f"logsumexp on wgmma {tm['lse_ms']:.3f} (plain "
              f"{tm['lse_plain_ms']:.3f}; six-product bound "
              f"{out['bounds']['score_six']['bound_ms']:.4f} ms, "
              f"{out['bounds']['score_six']['bound_ms'] / tm['lse_ms']:.1%}); "
              f"K5 split {tm['split_ms']:.3f} ms, logsumexp "
              f"{tm['split_lse_ms']:.3f} (split plain "
              f"{tm['split_plain_ms']:.3f}; split bound "
              f"{sb['bound_ms']:.4f} ms, {sb['bound_ms'] / tm['split_ms']:.1%})"
              f"; K5 bf16 {tm['bf16_ms']:.3f} ms, logsumexp "
              f"{tm['bf16_lse_ms']:.3f} (bf16 plain "
              f"{tm['bf16_plain_ms']:.3f}, {tm['bf16_lse_plain_ms']:.3f}; "
              f"one-product bound {bb['bound_ms']:.4f} ms, "
              f"{bb['bound_ms'] / tm['bf16_ms']:.1%})"
              f"; K6 plain {tm['unit_plain_ms']:.3f} ms, K7 plain "
              f"{tm['hvp_plain_ms']:.3f} ms")
    # K5 split past one tile of components: K = 256 on the ragged rows,
    # and under a GMM whose logits are much cancelled sums (no relative
    # bar)
    label = "{}x{}".format(*RAGGED)
    for key, gmm, relative in (("wide", wide_gmm(), True),
                               ("cancelled", cancelled_gmm(), False)):
        wbufs = gmm.kernel_buffers(device)
        out[key] = k5_split_checks(torch, f"{label} K=256 {key}",
                                   rows[label], wbufs, relative)
        out[f"{key}_bf16"] = k5_split_checks(
            torch, f"{label} K=256 {key}", rows[label], wbufs, relative,
            mode="bf16")
    return out


def anchored(label, name, got, plain32, plain64, factor=MARG_ERR_FACTOR):
    """The float64-anchored check; returns (kernel err, plain err, max)."""
    err = float((got.to(plain64.dtype) - plain64).abs().max())
    err32 = float((plain32.to(plain64.dtype) - plain64).abs().max())
    scale = float(plain64.abs().max())
    check(err <= factor * err32 + MARG_ERR_FLOOR * scale,
          f"{label}: {name} error {err:.3g} against float64, plain float32 "
          f"{err32:.3g}, max {scale:.3g}")
    return err, err32, scale


def support(torch, x, lse, bufs, mode="f32"):
    """Row-component pairs with a nonzero softmax weight (float32 plain,
    the logits of ``mode``), the pairs whose A_k x terms the marginalise
    kernels compute, and the number of components that have one."""
    from jolideco_torch.ops.gmm_fused import softmax_chunks

    nnz, hit = 0, torch.zeros(bufs["rec"].shape[0], dtype=torch.bool,
                              device=x.device)
    for _, p in softmax_chunks(x, lse, bufs, mode):
        nnz += int((p > 0).sum())
        hit |= (p > 0).any(dim=0)
    return nnz, int(hit.sum())


def mixed_gmm(k=200):
    """A random SPD GMM, by default with the main path's K = 200, whose
    softmax weights of the phase's images are mixed: about 200 nonzero
    weights per patch and row (the largest near 0.3), where
    ``astro-snr-v1``'s are one-hot. With it the marginalise kernels mix
    components for real."""
    from jolideco_torch.utils.interop import gmm_from_arrays

    rs = np.random.RandomState(1)
    a = rs.randn(k, 64, 64) / 8.0
    covariances = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(64)
    return gmm_from_arrays(rs.rand(k, 64), covariances,
                           rs.dirichlet(np.ones(k)), None)


def wide_gmm_arrays(k=256):
    """Means, covariances, weights and stride of a GMM wider than one
    tile of K1's tensor-core kernel (208 components): ``astro-snr-v1``'s
    200, then copies of its first ``k - 200`` with the means moved by
    three times their spread in seeded noise. Its 48th component, the
    one that wins most patches of a uniform image in [0.1, 2], and its
    copy (index 248, the second tile) then share those patches."""
    from jolideco_torch.priors import GaussianMixtureModel

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    extra = k - astro.n_components
    noise = np.random.RandomState(2).randn(extra, astro.n_features)
    moved = astro.means[:extra] + 3.0 * astro.means[:extra].std() * noise
    weights = np.concatenate([astro.weights, astro.weights[:extra]])
    return (np.concatenate([astro.means, moved.astype(np.float32)]),
            np.concatenate([astro.covariances, astro.covariances[:extra]]),
            weights / weights.sum(), astro.meta.stride)


def wide_gmm(k=256):
    """The port's GMM of :func:`wide_gmm_arrays`."""
    from jolideco_torch.utils.interop import gmm_from_arrays

    return gmm_from_arrays(*wide_gmm_arrays(k))


def cancelled_gmm(k=256):
    """A GMM of ``k`` components whose winning logits are far more
    cancelled sums than the shipped GMMs' (the products' magnitudes up to
    thousands of times the value, against about 100): ``astro-snr-v1``'s
    200 and the first ``k - 200`` of ``builtin-8x8-v1``'s, without pixel
    weights, rolled by 170 so that winners fall in both tiles. A float32
    sum's rounding scales with its terms, so here only the bar against
    the products' magnitudes (``K1_SPLIT_SUM_ERR``) applies."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.interop import gmm_from_arrays

    parts = [GaussianMixtureModel.from_registry(name)
             for name in ("astro-snr-v1", "builtin-8x8-v1")]
    extra = k - parts[0].n_components
    arrays = [np.roll(np.concatenate([getattr(parts[0], name),
                                      getattr(parts[1], name)[:extra]]),
                      170, axis=0)
              for name in ("means", "covariances", "weights")]
    return gmm_from_arrays(*arrays[:2], arrays[2] / arrays[2].sum(), None)


def marg_checks(torch, device, label, img, bufs):
    """K1 (logsumexp), K5 (logsumexp), K4, K8, K9a and K9b against their
    plain versions on one image and its rows: K1's and K5's values rtol
    1e-5, argmax flips at most 1e-4 of the valid patches, patches to
    1e-5; K4, K8 and K9 against float64 (anchored). Returns the errors
    and the inputs, for timing."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    b64 = {name: t.double() for name, t in bufs.items()}
    stride, sentinel = 4, ZERO_FLUX_SENTINEL
    image = torch.as_tensor(img, device=device)
    vk, ak, valk, xk = gf.gmm_fused_fwd_marg_cuda(image, bufs, stride,
                                                  sentinel)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, sentinel,
                                               True)
    torch.cuda.synchronize()
    check(torch.equal(valk, valp), f"{label}: K1 logsumexp valid differs")
    m = valp > 0.5
    value_err = (vk - vp).abs()[m]
    rel = float((value_err / vp.abs()[m]).max())
    check(rel <= 1e-5, f"{label}: K1 logsumexp values beyond rtol 1e-5 "
          f"({rel:.3g})")
    n_valid = int(m.sum())
    flips = int((ak != ap)[m].sum())
    check(flips <= 1e-4 * n_valid,
          f"{label}: K1 logsumexp argmax flips {flips} of {n_valid}")
    xtn_err = float((xk - xp).abs().max())
    check(xtn_err <= 1e-5, f"{label}: K1 logsumexp patches differ by "
          f"{xtn_err:.3g}")
    errs = {"fwd": (float(value_err.max()), rel, flips, n_valid)}

    # K4 on the plain forward's outputs, random cotangents
    gen = torch.Generator(device=device).manual_seed(3)
    dv = torch.randn(vp.shape, generator=gen, device=device) * valp
    args = (xp, vp, valp, dv)
    gk = gf.gmm_fused_bwd_marg_cuda(*args, bufs, img.shape, stride)
    g32 = gf.fused_backward_marg_plain(*args, bufs, img.shape, stride)
    g64 = gf.fused_backward_marg_plain(*(a.double() for a in args), b64,
                                       img.shape, stride)
    torch.cuda.synchronize()
    errs["bwd"] = anchored(label, "K4", gk, g32, g64)
    check(torch.equal(gk, gf.gmm_fused_bwd_marg_cuda(*args, bufs, img.shape,
                                                     stride)),
          f"{label}: K4 differs between two calls on the same inputs")
    # K4 as the prior runs it: fed K1 lse's own patches and logsumexp,
    # whose logits it recomputes bit for bit, against float64
    own = (xk, vk, valk, dv)
    errs["bwd_pipeline"] = anchored(
        label, "K1 lse -> K4", gf.gmm_fused_bwd_marg_cuda(
            *own, bufs, img.shape, stride),
        gf.fused_backward_marg_plain(*own, bufs, img.shape, stride),
        gf.fused_backward_marg_plain(*(a.double() for a in own), b64,
                                     img.shape, stride))

    # K5 (logsumexp), K8, K9a, K9b on the rows of the image, random
    # tangents
    x = normalised_rows(torch, image, sentinel)
    n = x.shape[0]
    lse_k, _ = gp.gmm_score_rows_cuda(x, bufs, True)
    lse, _ = gp.score_rows_plain(x, bufs, True)
    torch.cuda.synchronize()
    rel_rows = float(((lse_k - lse).abs() / lse.abs()).max())
    check(rel_rows <= 1e-5, f"{label}: K5 logsumexp values beyond rtol 1e-5 "
          f"({rel_rows:.3g})")
    t = torch.randn(x.shape, generator=gen, device=device)
    x64, t64, lse64 = x.double(), t.double(), lse.double()
    uk = gp.gmm_unit_marg_cuda(x, lse, bufs)
    errs["unit"] = anchored(label, "K8", uk,
                            gp.unit_marg_plain(x, lse, bufs),
                            gp.unit_marg_plain(x64, lse64, b64))
    pk, dpk = gp.gmm_hvp_marg_weights_cuda(x, t, lse, bufs)
    p32, dp32 = gp.hvp_marg_weights_plain(x, t, lse, bufs)
    p64, dp64 = gp.hvp_marg_weights_plain(x64, t64, lse64, b64)
    errs["weights_p"] = anchored(label, "K9a p", pk, p32, p64)
    errs["weights_dp"] = anchored(label, "K9a dp", dpk, dp32, dp64)
    # K9b on the float32 plain weights, against their float64 mixture;
    # a second call gives the same bits (no atomics, a fixed order)
    hk = gp.gmm_hvp_marg_mix_cuda(x, t, p32, dp32, bufs)
    errs["mix"] = anchored(
        label, "K9b", hk, gp.hvp_marg_mix_plain(x, t, p32, dp32, bufs),
        gp.hvp_marg_mix_plain(x64, t64, p32.double(), dp32.double(), b64))
    check(torch.equal(hk, gp.gmm_hvp_marg_mix_cuda(x, t, p32, dp32, bufs)),
          f"{label}: K9b differs between two calls on the same inputs")
    # K9 as the probe runs it: both kernels, against float64
    h64 = gp.hvp_marg_mix_plain(x64, t64, p64, dp64, b64)
    errs["hvp"] = anchored(
        label, "K9", gp.gmm_hvp_marg_mix_cuda(x, t, pk, dpk, bufs),
        gp.hvp_marg_mix_plain(x, t, p32, dp32, bufs), h64)
    print(f"phase 2 marginalise kernels {label}: K1 logsumexp values max "
          f"rel err {rel:.3g}, argmax flips {flips}/{n_valid}; K5 logsumexp "
          f"{rel_rows:.3g}; K4 twice bitwise equal; against float64 "
          f"(kernel, plain float32, max): "
          + "; ".join(f"{name} {e[0]:.3g}, {e[1]:.3g}, {e[2]:.3g}"
                      for name, e in errs.items() if name != "fwd"))
    nnz_fused, used_fused = support(torch, xp[m], vp[m], bufs)
    nnz_rows, used_rows = support(torch, x, lse, bufs)
    inputs = {
        "image": image, "args": args, "x": x, "t": t, "lse": lse,
        "pk": pk, "dpk": dpk, "n_valid": n_valid,
        "nnz_fused": nnz_fused, "nnz_rows": nnz_rows,
        "nnz_mix": int(((p32 != 0) | (dp32 != 0)).sum()),
        "used": max(used_fused, used_rows),
        "max_dp": float(dp64.abs().max()),
        "median_p_max": float(p64.max(dim=0).values.median()),
    }
    return errs, inputs


def marg_timing(torch, bufs, img, s, plain=True):
    """Milliseconds per call of the marginalise kernels (and of their
    plain versions) on a case's inputs, and each kernel's bound.

    Operations: every (row, component) logit over the symmetric triangle
    (2,080 + 64 multiply-adds), and, only for the pairs with a nonzero
    weight (the kernels skip the rest, exactly), A_k x or A_k t (4,096)
    and their dot products with b_k or t (64). Bytes: each input read
    once, each output written once, and of the A_k only those that some
    weight selects."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    stride, sentinel = 4, ZERO_FLUX_SENTINEL
    image, args, x, t, lse = s["image"], s["args"], s["x"], s["t"], s["lse"]
    pk, dpk = s["pk"], s["dpk"]
    calls = {
        "fwd": (lambda: gf.gmm_fused_fwd_marg_cuda(image, bufs, stride,
                                                   sentinel),
                lambda: gf.fused_forward_plain(image, bufs, stride, sentinel,
                                               True)),
        "bwd": (lambda: gf.gmm_fused_bwd_marg_cuda(*args, bufs, img.shape,
                                                   stride),
                lambda: gf.fused_backward_marg_plain(*args, bufs, img.shape,
                                                     stride)),
        "unit": (lambda: gp.gmm_unit_marg_cuda(x, lse, bufs),
                 lambda: gp.unit_marg_plain(x, lse, bufs)),
        "weights": (lambda: gp.gmm_hvp_marg_weights_cuda(x, t, lse, bufs),
                    lambda: gp.hvp_marg_weights_plain(x, t, lse, bufs)),
        "mix": (lambda: gp.gmm_hvp_marg_mix_cuda(x, t, pk, dpk, bufs),
                lambda: gp.hvp_marg_mix_plain(x, t, pk, dpk, bufs)),
    }
    timing = {}
    for name, (kernel, plain_fn) in calls.items():
        timing[name + "_ms"] = cuda_ms(torch, kernel, 10)
        if plain:
            timing[name + "_plain_ms"] = cuda_ms(torch, plain_fn, 3)
    # K9b's host side (checks, an allocation, the launch) may outlast its
    # kernel at one-hot weights: its device time too
    timing["mix_device_ms"] = device_ms(torch, calls["mix"][0], 20,
                                        K9B_KERNEL)
    k = bufs["rec"].shape[0]
    n, n_valid, n_patches = x.shape[0], s["n_valid"], args[0].shape[0]
    logit_flop = 2.0 * (2080 + 64) * k
    rec_bytes = 4 * bufs["rec"].numel()
    a_bytes = 4 * s["used"] * 64 * 64
    work = {
        "fwd": (logit_flop * n_patches,
                4 * (img.size + n_patches * (3 + 64)) + rec_bytes),
        "bwd": (logit_flop * n_valid + 2.0 * (4096 + 64) * s["nnz_fused"],
                4 * (n_valid * 64 + 3 * n_patches + img.size)
                + rec_bytes + a_bytes),
        "unit": (logit_flop * n + 2.0 * (4096 + 64) * s["nnz_rows"],
                 4 * (2 * n * 64 + n) + rec_bytes + a_bytes),
        "weights": (logit_flop * n + 2.0 * (4096 + 64) * s["nnz_rows"],
                    4 * (2 * n * 64 + n + 2 * k * n) + rec_bytes + a_bytes),
        "mix": (2.0 * (4096 + 3 * 64) * s["nnz_mix"],
                4 * (3 * n * 64 + 2 * k * n) + a_bytes),
    }
    bounds = {name: bound(*w) for name, w in work.items()}
    # the same work under "split", for the ranking by the dial's bound,
    # and as six bf16 products, the bound of K1 lse and K4 on wgmma
    bounds.update({name + "_split": split_bound(*w)
                   for name, w in work.items()})
    bounds.update({name + "_six": split_bound(*w, products=6)
                   for name, w in work.items()})
    return timing, bounds


def phase_marg_kernels(torch, device, bufs, cases):
    """The marginalise kernels against their plain versions on the
    phase's images under ``astro-snr-v1``, whose weights are one-hot, and
    on the 1024² image under :func:`mixed_gmm`, whose weights are not."""
    k = bufs["rec"].shape[0]
    out = {}
    for label, img in cases.items():
        out[label], s = marg_checks(torch, device, label, img, bufs)
        if label != MAIN:
            continue
        out["timing"], out["bounds"] = marg_timing(torch, bufs, img, s)
        out["k4_weights"] = k4_weight_checks(
            torch, f"{MAIN}[:256, :256]",
            torch.as_tensor(np.ascontiguousarray(img[:256, :256]),
                            device=device), bufs, "f32")
        out["support"] = {"fused": s["nnz_fused"], "rows": s["nnz_rows"],
                          "mix": s["nnz_mix"], "n_valid": s["n_valid"],
                          "n_rows": s["x"].shape[0]}
        tm, bd = out["timing"], out["bounds"]
        print(f"phase 2 timing K1 lse and K4 on wgmma {MAIN} K={k}: "
              + "; ".join(
                  f"{name} {tm[key + '_ms']:.3f} ms, bound "
                  f"{bd[key + '_six']['bound_ms']:.4f} ms as six bf16 "
                  f"products ({bd[key + '_six']['bound_ms'] / tm[key + '_ms']:.1%}"
                  f"), {bd[key]['bound_ms']:.4f} ms on the float32 CUDA "
                  f"cores ({bd[key]['bound_ms'] / tm[key + '_ms']:.1%})"
                  for name, key in (("K1 lse", "fwd"), ("K4", "bwd"))))
        print(f"phase 2 timing marginalise kernels {MAIN} K={k}: "
              + "; ".join(f"{name} {tm[name + '_ms']:.3f} ms (plain "
                          f"{tm[name + '_plain_ms']:.3f})"
                          for name in ("fwd", "bwd", "unit", "weights",
                                       "mix"))
          + f"; mix device {tm['mix_device_ms']:.4f} ms"
              + f"; nonzero weights: {s['nnz_fused']} of {s['n_valid']} x "
              f"{k} patches, {s['nnz_rows']} of {s['x'].shape[0]} x {k} rows")

    # the same checks where the weights are mixed: there the A_k x terms
    # of many components meet in each row, and dp is not zero
    label = f"{MAIN} mixed"
    mbufs = mixed_gmm().kernel_buffers(device)
    errs, s = marg_checks(torch, device, label, cases[MAIN], mbufs)
    n = s["x"].shape[0]
    check(s["nnz_fused"] >= 10 * s["n_valid"] and s["nnz_rows"] >= 10 * n,
          f"{label}: weights not mixed ({s['nnz_fused']} nonzero of "
          f"{s['n_valid']} patches, {s['nnz_rows']} of {n} rows)")
    check(s["max_dp"] > 0.0, f"{label}: every dp is zero")
    timing, bounds = marg_timing(torch, mbufs, cases[MAIN], s, plain=False)
    out["mixed"] = {"errors": errs, "timing": timing, "bounds": bounds,
                    "support": {"fused": s["nnz_fused"],
                                "rows": s["nnz_rows"], "mix": s["nnz_mix"],
                                "n_valid": s["n_valid"], "n_rows": n},
                    "max_dp": s["max_dp"],
                    "median_p_max": s["median_p_max"]}
    print(f"phase 2 timing marginalise kernels {label} K="
          f"{mbufs['rec'].shape[0]}: "
          + "; ".join(f"{name} {timing[name + '_ms']:.3f} ms (bound "
                      f"{bounds[name]['bound_ms']:.3f})"
                      for name in ("fwd", "bwd", "unit", "weights", "mix"))
          + f"; mix device {timing['mix_device_ms']:.3f} ms"
          + f"; nonzero weights: {s['nnz_fused']} of {s['n_valid']} x "
          f"{mbufs['rec'].shape[0]} patches, {s['nnz_rows']} of {n} rows; "
          f"median largest weight {s['median_p_max']:.3g}; max |dp| "
          f"{s['max_dp']:.3g}")
    # past one tile of components (K = 256): K1 lse's merge across tiles,
    # K4's sums carried from one tile to the next
    ragged = "{}x{}".format(*RAGGED)
    out["wide"], _ = marg_checks(torch, device, f"{ragged} K=256 wide",
                                 cases[ragged],
                                 wide_gmm().kernel_buffers(device))
    return out


# K4 split (the pipeline K1 lse split -> K4 split) is held against the
# float64 pipeline by the anchored bar, its factor MARG_ERR_FACTOR times
# split_lse_ratio. K4's weights are exp(logit - lse) of the tensor cores'
# logits, whose float32 sums are not IEEE sums (K1_SPLIT_RTOL); where the
# weights are mixed, the logits' rounding moves the weights and the
# gradient inherits it. Under mixed_gmm() on an H100 the pipeline lay 3.5
# and 3.4 times as far from float64 as the split plain pipeline (1024^2,
# 1000 x 904; 1.2e-5 and 1.6e-5 of the max-abs), K1 lse split 2.3 times
# as far; under astro-snr-v1 and wide_gmm() 1.06 to 1.37 times, the
# logsumexp no further. The mixture itself is float32 in both, so the
# factor 2 holds as far as the logits hold it; K1 lse split's own bar
# caps the ratio (at 4.6 there).
def split_lse_ratio(errs):
    """How much further K1 lse split's logsumexp lies from float64 than
    the split plain version's, at least 1 (1 where the split plain
    version's is exact, as for rows that are all zero)."""
    if errs["split_plain"] == 0.0:
        return 1.0
    return max(1.0, errs["tc"] / errs["split_plain"])


# K8 split, K9a split and K9 (K9b on K9a split's weights), fed K5 lse
# split's logsumexp as the probe runs them, are held against the float64
# pipeline within MARG_SPLIT_FACTOR times the split plain pipeline's
# error plus MARG_ERR_FLOOR of the max-abs. Their weights p_k =
# exp(logit_k - lse) carry the tensor cores' logit sums, which are not
# IEEE sums (K1_SPLIT_RTOL), and no single number of K5 split (the
# logsumexp, a softmax average of the logits' rounding, or the maxima)
# says how far: on an H100 the kernels lay 1.5 to 3.9 times as far from
# float64 as the split plain pipeline on phase 2's image rows (dp under
# wide_gmm() aside: see LOGIT_SPACINGS), and up to 12.9 times on the
# card tests' rows of uniform noise under a random SPD GMM and mixed
# weights (tests/test_torch_gpu.py::
# test_marginalise_split_probe_kernels_match_float64 prints them). The
# factor is fixed above the largest reading. The control of
# probe_split_compare, the same pipeline with the logits of single bf16
# products, must fail it wherever the weights are mixed: there it lay 23
# to 39 times above it.
MARG_SPLIT_FACTOR = 16.0
# dp_k = p_k (g_k - gbar) also inherits, entry by entry, the float32
# rounding of the logits (dp_rounding), which the split plain pipeline
# shares only on average. A float32 logit of magnitude L stands within
# a spacing (at most 2^-23 L) of the sum it rounds: a half for its own
# rounding, a half for the sums before it. With each logit within d, every
# p_k moves by a factor within exp(+-2 d), and dp_k by at most expm1(2 d)
# (|dp_k| + exp(2 d) p_k sum_j |dp_j|): 1.6e-2 of dp at logits of 1e5,
# more than dp itself beyond about 4e6, where no float32 logit resolves a
# shared weight. dp's max-abs may sit on such a row, where dp is a
# residue far below the g_k: under wide_gmm() at 1024^2 on an H100 the
# largest |dp|, 5.1e-10, is on a row with logits near 6.5e5 (spacing
# 0.077) and a second weight of 9.8e-16 (component 48 and its copy 248).
# There the kernel's logit difference lay 0.83 spacings from float64's
# and its dp 6.2% from float64's, the split plain pipeline's 0.023
# spacings and 0.18%; over that image's 8 rows with two weights the
# kernel's logit differences lay within 0.87 spacings, the split plain
# version's within 1.1. g_k, float32 in both, lay within 1.4e-7 of
# float64's g differences there. d is LOGIT_SPACINGS spacings of the
# row's largest logit that has a weight; an entry of dp passes within
# the bar above or within that rounding.
LOGIT_SPACINGS = 1.0


def bf16_reference(torch, x, bufs, t=None):
    """The float64 pipeline of the ``"bf16"`` mode on float32 rows ``x``:
    the exact sums of the same bf16-rounded operands
    (:func:`exact_chunks`), their logsumexp and argmax, the softmax
    weights and the unit gradient; with tangents ``t`` also p and dp (K,
    N; g taken against the heaviest component's, as the kernels take it)
    and the Hessian action (the float64 K9b)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp

    b64 = {name: v.double() for name, v in bufs.items()}
    out = {"lse": [], "argmax": [], "unit": [], "p": [], "dp": []}
    for sl, logits, _ in exact_chunks(torch, x, bufs, "bf16"):
        x64 = x[sl].double()
        p = torch.softmax(logits, dim=1)
        out["lse"].append(torch.logsumexp(logits, dim=1))
        out["argmax"].append(logits.argmax(dim=1).to(torch.int32))
        out["unit"].append(p @ b64["b_rows"] - gf.mix_rows(p, x64, b64))
        if t is not None:
            t64 = t[sl].double()
            cross = (t64[:, :, None] * x64[:, None, :]).reshape(len(x64), -1)
            g = t64 @ b64["bq"] - cross @ b64["aq"]
            g = g - g.gather(1, p.argmax(dim=1, keepdim=True))
            out["p"].append(p)
            out["dp"].append(p * (g - (p * g).sum(dim=1, keepdim=True)))
    ref = {name: torch.cat(v) for name, v in out.items() if v}
    if t is not None:
        ref["p"], ref["dp"] = (ref[name].T.contiguous()
                               for name in ("p", "dp"))
        ref["hvp"] = gp.hvp_marg_mix_plain(x.double(), t.double(), ref["p"],
                                           ref["dp"], b64)
    return ref


def marg_split_pipelines(torch, image, bufs, dv, mode="split"):
    """The marginalised scorer in the ``"split"`` mode (or ``mode``) as
    training runs it, forward then backward with cotangents ``dv``: by
    the tensor-core kernels (K1 lse split, whose logsumexp K4 split takes)
    and by the plain versions of the mode; and the float64 pipeline, the
    exact logits of the plain version's patches (their logsumexp, argmax
    and the float64 marginalise backward): under ``"split"`` the logits of
    the float32 buffers, under ``"bf16"`` those of the same bf16-rounded
    operands (:func:`bf16_reference`)."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    stride, sentinel, shape = 4, ZERO_FLUX_SENTINEL, tuple(image.shape)
    fwd, bwd = (launcher(gf, name) for name in MARG_KERNELS[mode])
    tc = fwd(image, bufs, stride, sentinel)
    g_tc = bwd(tc[3], tc[0], tc[2], dv, bufs, shape, stride)
    if mode == "bf16":
        # the plain pipeline and the float64 one on the kernel's own
        # normalised patches (k1_split_checks says why)
        sp = (*gf.score_bf16_marg_plain(tc[3], bufs), tc[2], tc[3])
    else:
        sp = gf.fused_forward_plain(image, bufs, stride, sentinel, True,
                                    mode=mode)
    g_sp = gf.fused_backward_marg_plain(sp[3], sp[0], sp[2], dv, bufs, shape,
                                        stride, mode=mode)
    b64 = {name: t.double() for name, t in bufs.items()}
    x64 = sp[3].double()
    if mode == "bf16":
        ref = bf16_reference(torch, sp[3], bufs)
        lse64, a64 = ref["lse"], ref["argmax"]
        g64 = gf._patches_to_image(ref["unit"] * dv.double()[:, None],
                                   sp[2].double(), shape, stride)
        return tc, g_tc, sp, g_sp, (lse64, a64, g64)
    lse64, a64 = gf.score_plain(x64, b64["aq"], b64["bq"], b64["const2"],
                                True)
    g64 = gf.fused_backward_marg_plain(x64, lse64, sp[2].double(),
                                       dv.double(), b64, shape, stride)
    return tc, g_tc, sp, g_sp, (lse64, a64, g64)


def marg_split_checks(torch, device, label, img, bufs, mode="split"):
    """K1 lse split and K4 split (tensor cores), or their ``"bf16"``
    kernels with ``mode``, on one image: the logsumexp against the plain
    version of the mode (values rtol ``K1_SPLIT_RTOL``, argmax flips at
    most ``K1_SPLIT_FLIPS`` of the valid patches, patches to 1e-5) and
    against float64 (at most ``MARG_ERR_FACTOR`` x the plain version's
    error plus ``MARG_ERR_FLOOR`` of the max-abs); the image gradient of
    the pipeline K1 lse -> K4 against the float64 pipeline
    (:func:`marg_split_pipelines`), within the plain pipeline's error
    times ``MARG_ERR_FACTOR`` scaled by :func:`split_lse_ratio` under
    ``"split"``, times ``MARG_SPLIT_FACTOR`` under ``"bf16"``, plus
    ``MARG_ERR_FLOOR`` of the max-abs. Under ``"bf16"`` the plain and
    float64 pipelines take the kernel's own normalised patches, which
    K1 bf16's check holds to the plain version's, and the split plain
    pipeline's gradient, the control, must fail that bar wherever the
    weights are mixed. Returns the numbers and the inputs, for timing."""
    from jolideco_torch.ops import gmm_fused as gf

    image = torch.as_tensor(img, device=device)
    n = gf.fused_patch_count(img.shape, 4)
    gen = torch.Generator(device=device).manual_seed(3)
    dv = torch.randn(n, generator=gen, device=device)
    tc, g_tc, sp, g_sp, (lse64, a64, g64) = marg_split_pipelines(
        torch, image, bufs, dv, mode)
    vt, at, valt, xt = tc
    vs, as_, vals, xs = sp
    tag = f"{label} marginalise {mode}"
    g_again = launcher(gf, MARG_KERNELS[mode][1])(
        xt, vt, valt, dv, bufs, tuple(image.shape), 4)
    torch.cuda.synchronize()
    check(torch.equal(g_tc, g_again), f"{tag}: two K4 calls differ")
    check(torch.equal(valt, vals), f"{tag}: valid differs")
    m = vals > 0.5
    n_valid = int(m.sum())
    xtn_err = float((xt - xs).abs().max())
    check(xtn_err <= 1e-5, f"{tag}: normalised patches differ by "
          f"{xtn_err:.3g}")
    rel = float(((vt - vs).abs() / vs.abs())[m].max())
    check(rel <= K1_SPLIT_RTOL, f"{tag}: K1 lse values beyond rtol "
          f"{K1_SPLIT_RTOL} (max rel {rel:.3g})")
    flips = int((at != as_)[m].sum())
    check(flips <= K1_SPLIT_FLIPS * n_valid,
          f"{tag}: K1 lse argmax flips {flips} of {n_valid}")
    scale = float(lse64[m].abs().max())
    errs = {name: float((v[m].double() - lse64[m]).abs().max())
            for name, v in (("tc", vt), ("split_plain", vs))}
    limit = MARG_ERR_FACTOR * errs["split_plain"] + MARG_ERR_FLOOR * scale
    check(errs["tc"] <= limit, f"{tag}: K1 lse error against float64 "
          f"{errs['tc']:.3g} above {limit:.3g}")
    flips64 = {name: int((a[m] != a64[m]).sum())
               for name, a in (("tc", at), ("split_plain", as_))}
    factor = (MARG_SPLIT_FACTOR if mode == "bf16"
              else MARG_ERR_FACTOR * split_lse_ratio(errs))
    bwd = anchored(tag, f"K4 {mode} (pipeline)", g_tc, g_sp, g64, factor)
    nnz, used = support(torch, xs[m], vs[m], bufs, mode)
    control = ""
    if mode == "bf16":
        lse_c, _ = gf.score_split_marg_plain(xs, bufs)
        g_c = gf.fused_backward_marg_plain(xs, lse_c, vals, dv, bufs,
                                           tuple(image.shape), 4,
                                           mode="split")
        err_c = float((g_c.double() - g64).abs().max())
        limit_c = factor * bwd[1] + MARG_ERR_FLOOR * bwd[2]
        check(err_c > limit_c or nnz < 10 * n_valid,
              f"{tag}: the control (the split plain pipeline) passed the "
              f"bar under mixed weights ({err_c:.3g} within {limit_c:.3g})")
        control = (f"; control (split plain pipeline) {err_c:.3g}, "
                   f"{err_c / limit_c:.3g} x the limit")
    print(f"phase 2 {tag}: K1 lse {mode} against the {mode} plain version "
          f"values max rel {rel:.3g} (limit {K1_SPLIT_RTOL}), argmax flips "
          f"{flips}/{n_valid}, xtn {xtn_err:.3g}; against float64 (max-abs "
          f"{scale:.6g}): tc {errs['tc']:.3g}, {mode} plain "
          f"{errs['split_plain']:.3g} (limit {limit:.3g}); argmax flips "
          f"against float64: tc {flips64['tc']}, {mode} plain "
          f"{flips64['split_plain']}; K4 {mode} twice bitwise equal, "
          f"pipeline against float64 "
          f"{bwd[0]:.3g}, {mode} plain {bwd[1]:.3g} (limit {factor:.3g} x "
          f"it + {MARG_ERR_FLOOR} x max), max {bwd[2]:.3g}{control}; "
          f"nonzero weights {nnz} of {n_valid} x {bufs['rec'].shape[0]}")
    out = {"value_max_rel_err": rel, "argmax_flips": flips,
           "n_valid": n_valid, "xtn_max_abs_err": xtn_err,
           "value_max_abs_err": float((vt - vs).abs()[m].max()),
           "errors_against_float64": errs, "max_abs": scale,
           "argmax_flips_against_float64": flips64,
           "bwd_against_float64": dict(zip(("tc", "split_plain", "max_abs"),
                                           bwd)),
           "bwd_factor": factor,
           "nonzero_weights": nnz}
    inputs = {"image": image, "dv": dv, "tc": tc, "split": sp,
              "n_valid": n_valid, "nnz": nnz, "used": used}
    return out, inputs


def k4_weight_checks(torch, label, image, bufs, mode):
    """K4 of ``mode`` fed K1 lse's own outputs on ``image``, launched
    through its C entry with a CTA a tile of 128 rows, so that the
    weights' scratch ends holding every row's: the gradient the bits of
    the wrapper's launch (whose CTAs take several tiles), and, read back,
    every valid patch whose weights are one-hot weighed exactly 1 (the
    same instance of the core gives K4 K1 lse's logits bit for bit) at K1
    lse's argmax, an invalid patch 0. Returns the counts."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    fwd, bwd = (launcher(gf, name) for name in MARG_KERNELS[mode])
    lse, argmax, valid, xtn = fwd(image, bufs, 4, ZERO_FLUX_SENTINEL)
    n, k = lse.numel(), bufs["b_rows"].shape[0]
    h, w = image.shape
    gen = torch.Generator(device=image.device).manual_seed(4)
    dv = torch.randn(n, generator=gen, device=image.device) * valid
    ctas = -(-n // gf.WG_ROWS)
    wts = torch.full((ctas, gf.WG_ROWS, gf.KP_WG), float("nan"),
                     device=image.device)
    units = torch.empty((n, 64), device=image.device)
    wsum = torch.empty(n, device=image.device)
    grad = torch.empty((h, w), device=image.device)
    pairs = bufs["pair_wg3" if mode == "f32" else "pair_wg"]
    lib = gf._wg_library()
    code = lib.gmm_score_wg_mix(
        xtn.data_ptr(), lse.data_ptr(), valid.data_ptr(), dv.data_ptr(),
        pairs.data_ptr(), bufs["lin_wg"].data_ptr(),
        bufs["a_full"].data_ptr(), bufs["b_rows"].data_ptr(), h, w, 4,
        h // 8, w // 8, k, gf.WG_PRODUCTS[mode], wts.data_ptr(), ctas,
        wsum.data_ptr(), units.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream(image.device).cuda_stream)
    check(code == 0, f"{label}: K4 {mode} launch failed ({code})")
    want = bwd(xtn, lse, valid, dv, bufs, (h, w), 4)
    torch.cuda.synchronize()
    tag = f"{label} K4 {mode} weights"
    check(torch.equal(grad, want), f"{tag}: a CTA a tile of rows and the "
          f"wrapper's launch differ")
    wk = wts.reshape(-1, gf.KP_WG)[:n, :k]
    m = valid > 0.5
    one_hot = m & ((wk > 0).sum(dim=1) == 1)
    n_valid, n_one_hot = int(m.sum()), int(one_hot.sum())
    check(n_one_hot >= 0.9 * n_valid, f"{tag}: {n_one_hot} of {n_valid} "
          f"valid patches one-hot")
    check(torch.equal(wk[one_hot].max(dim=1).values,
                      torch.ones_like(lse[one_hot]))
          and torch.equal(wk[one_hot].argmax(dim=1).to(torch.int32),
                          argmax[one_hot]),
          f"{tag}: a one-hot patch's weight is not exactly 1 at its argmax")
    check(not wk[~m].any(), f"{tag}: an invalid patch has a weight")
    print(f"phase 2 {tag} ({h}x{w}, {ctas} CTAs): {n_one_hot} of {n_valid} "
          f"valid patches one-hot, each weighed exactly 1 at K1 lse's "
          f"argmax; invalid patches 0; the gradient the bits of the "
          f"wrapper's launch")
    return {"n_valid": n_valid, "one_hot": n_one_hot}


def marg_split_timing(torch, bufs, s, plain=True, mode="split"):
    """Milliseconds per call of K1 lse split and K4 split, or their
    ``"bf16"`` kernels with ``mode`` (and of their plain versions) on a
    case's inputs, and their bounds: the logits' three bf16 products (one
    under ``"bf16"``) at the bf16 peak (``split_bound``), K4's float32
    A_k x terms of the nonzero weights at the fp32 peak on top. Bytes:
    each input read once (the pairs' planes and linear terms that the
    warpgroup core reads, ``wg_bytes``), each output written once, of the
    A_k only those that some weight selects."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    image, dv = s["image"], s["dv"]
    shape = tuple(image.shape)
    vt, _, valt, xt = s["tc"]
    vs, _, vals, xs = s["split"]
    fwd, bwd = (launcher(gf, name) for name in MARG_KERNELS[mode])
    calls = {
        "fwd": (lambda: fwd(image, bufs, 4, ZERO_FLUX_SENTINEL),
                lambda: gf.fused_forward_plain(
                    image, bufs, 4, ZERO_FLUX_SENTINEL, True, mode=mode)),
        "bwd": (lambda: bwd(xt, vt, valt, dv, bufs, shape, 4),
                lambda: gf.fused_backward_marg_plain(
                    xs, vs, vals, dv, bufs, shape, 4, mode=mode)),
    }
    timing = {}
    for name, (kernel, plain_fn) in calls.items():
        timing[name + "_ms"] = cuda_ms(torch, kernel, 10)
        if plain:
            timing[name + "_plain_ms"] = cuda_ms(torch, plain_fn, 3)
    k = bufs["rec"].shape[0]
    n, n_valid = xt.shape[0], s["n_valid"]
    logit_flop = 2.0 * (2080 + 64) * k
    split_bytes = wg_bytes(bufs, mode)
    ax_flop = 2.0 * (4096 + 64) * s["nnz"]
    bwd_bytes = (4 * (n_valid * 64 + 3 * n + image.numel())
                 + split_bytes + 4 * s["used"] * (64 * 64 + 64))
    t_ops = (products(mode) * logit_flop * n_valid / PEAK_BF16_FLOPS
             + ax_flop / PEAK_FP32_FLOPS)
    t_bytes = bwd_bytes / PEAK_BYTES_PER_S
    bounds = {
        "fwd": split_bound(logit_flop * n,
                           4 * (image.numel() + n * (3 + 64)) + split_bytes,
                           products(mode)),
        "bwd": {"bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"},
    }
    return timing, bounds


def dp_rounding(torch, x64, b64, p64, dp64):
    """Per entry (K, N) of dp, how far the logits' float32 rounding may
    move it (see ``LOGIT_SPACINGS``): ``expm1(2 d) (|dp_k| + exp(2 d) p_k
    sum_j |dp_j|)`` of the float64 p and dp, d LOGIT_SPACINGS spacings
    of the row's largest logit that has a weight. Also returns that
    logit's magnitude per row."""
    from jolideco_torch.ops import gmm_fused as gf

    logits = torch.cat(list(gf.logit_chunks(x64, b64["aq"], b64["bq"],
                                            b64["const2"])))
    big = torch.where(p64.T > 0, logits.abs(),
                      torch.zeros_like(logits)).amax(dim=1)
    d = LOGIT_SPACINGS * 2.0 ** -23 * big
    total = dp64.abs().sum(dim=0)
    return (torch.expm1(2 * d) * (dp64.abs() + torch.exp(2 * d) * p64 * total),
            big)


def control_pipeline(torch, x, t, bufs, logits="split", g_with_b=True):
    """A plain pipeline of the probe (unit gradient, p, dp, the Hessian
    action) with one part changed, a control that the kernels' bar must
    refuse: the logits of ``logits`` (``"split"``, or ``"bf16"``, the
    single bf16 products of ``gf.bf16_logit_chunks``) where the kernels
    take the other mode's, or ``g_with_b=False``, which drops t . b_k
    from g_k. Float32, chunk by chunk; p and dp (K, N) as the
    kernels'."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp

    units, ps, dps = [], [], []
    for start in range(0, x.shape[0], gf.PLAIN_CHUNK):
        xs = x[start:start + gf.PLAIN_CHUNK]
        ts = t[start:start + gf.PLAIN_CHUNK]
        lg = next(gf.mode_logit_chunks(xs, bufs, logits))
        p = torch.softmax(lg, dim=1)
        units.append(p @ bufs["b_rows"] - gf.mix_rows(p, xs, bufs))
        cross = (ts[:, :, None] * xs[:, None, :]).reshape(len(xs), -1)
        g = -(cross @ bufs["aq"])
        if g_with_b:
            g = g + ts @ bufs["bq"]
        g = g - g.gather(1, p.argmax(dim=1, keepdim=True))
        ps.append(p)
        dps.append(p * (g - (p * g).sum(dim=1, keepdim=True)))
    p, dp = torch.cat(ps).T.contiguous(), torch.cat(dps).T.contiguous()
    return {"unit": torch.cat(units), "weights_p": p, "weights_dp": dp,
            "hvp": gp.hvp_marg_mix_plain(x, t, p, dp, bufs)}


def multi_weight_rows(torch, pipelines, x64, t64, b64, p64, dp64, big):
    """On the rows where a pipeline has more than one nonzero weight, how
    far each pipeline's (name -> (p, dp)) logit differences log(p_k /
    p_ref) and g differences dp_k / p_k - dp_ref / p_ref (ref the float64
    pipeline's heaviest component) lie from float64's: the largest over
    the rows, the logits' in spacings (2^-23 of the row's largest
    logit), g's relative; and the same on the row of the largest |dp|,
    with its second weight, that component's g difference and the
    largest |g_k| of the row."""
    rows = torch.zeros(p64.shape[1], dtype=torch.bool, device=p64.device)
    for p, _ in pipelines.values():
        rows |= (p != 0).sum(dim=0) > 1
    idx = rows.nonzero()[:, 0]
    out = {"rows": int(idx.numel())}
    if not out["rows"]:
        return out
    p64, dp64 = p64[:, idx], dp64[:, idx]
    ref = p64.argmax(dim=0, keepdim=True)
    spacing = 2.0 ** -23 * big[idx]
    worst = int(dp64.abs().amax(dim=0).argmax())

    def diffs(p, dp):
        ld = p.log() - p.gather(0, ref).log()
        gd = dp / p - (dp / p).gather(0, ref)
        return ld, gd

    ld64, gd64 = diffs(p64, dp64)
    r = int(idx[worst])
    g = t64[r] @ b64["bq"] - torch.outer(t64[r], x64[r]).reshape(-1) @ b64["aq"]
    second = int(p64[:, worst].clone().scatter_(0, ref[:, worst], 0.0).argmax())
    out["worst"] = {"row": r, "logit": float(big[idx][worst]),
                    "max_dp": float(dp64[:, worst].abs().max()),
                    "p_second": float(p64[second, worst]),
                    "g_diff": float(gd64[second, worst].abs()),
                    "g_abs": float(g[p64[:, worst] > 0].abs().max())}
    for name, (p, dp) in pipelines.items():
        p, dp = p[:, idx].double(), dp[:, idx].double()
        ld, gd = diffs(p, dp)
        m = (p > 0) & (p64 > 0)
        m.scatter_(0, ref, False)
        lerr = torch.where(m, (ld - ld64).abs() / spacing, 0.0)
        gerr = torch.where(m, (gd - gd64).abs() / gd64.abs(), 0.0)
        derr = (dp - dp64).abs()
        out[name] = {"logit_spacings": float(lerr.max()),
                     "g_rel": float(gerr.max()),
                     "worst_logit_spacings": float(lerr[:, worst].max()),
                     "worst_g_rel": float(gerr[:, worst].max()),
                     "worst_dp_rel": float(derr[:, worst].max()
                                           / out["worst"]["max_dp"])}
    return out


def probe_split_compare(torch, x, t, bufs, mode="split"):
    """K8 split and K9a split (the marginalised probe's unit gradient and
    first Hessian stage on the tensor cores), or their ``"bf16"`` kernels
    with ``mode``, on rows ``x`` along tangents ``t``, as the probe runs
    them, fed K5 lse's logsumexp of the same mode, against the float64
    pipeline (the exact logits, their logsumexp and the float64 plain
    versions, K4's reference; under ``"bf16"`` the exact sums of the same
    bf16-rounded operands, :func:`bf16_reference`): every entry within
    ``MARG_SPLIT_FACTOR`` times the plain pipeline's max-abs error
    (``score_split_marg_plain``, ``marg_unit_split_plain``,
    ``hvp_marg_weights_split_plain``, or the ``"bf16"`` ones) plus
    ``MARG_ERR_FLOOR`` of the max-abs, or for dp within its own float32
    rounding (:func:`dp_rounding`); K9b on K9a's weights (the Hessian
    action) the same. On every row whose weight sits on one component dp
    must be exactly 0. Two controls must fail the bar: the logits of the
    other mode (single bf16 products where the kernels are split, split
    ones where they are bf16) where the weights are mixed (at least 10
    nonzero a row), and g without t . b_k where a row has more than one
    weight and dp is not 0. Returns the numbers, K5 lse's logsumexp and
    the one-hot rows; raises AssertionError on a failure."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp

    score, unit, weights = (launcher(gp, name)
                            for name in MARG_PROBE_KERNELS[mode])
    lse_tc, _ = score(x, bufs)
    pt, dpt = weights(x, t, lse_tc, bufs)
    kernel = {"unit": unit(x, lse_tc, bufs),
              "weights_p": pt, "weights_dp": dpt,
              "hvp": gp.gmm_hvp_marg_mix_cuda(x, t, pt, dpt, bufs)}
    lse_sp, _ = gf.PLAIN_SCORES[mode, True](x, bufs)
    ps, dps = gp.PLAIN_WEIGHTS[mode](x, t, lse_sp, bufs)
    plain = {"unit": gf.PLAIN_UNITS[mode](x, lse_sp, bufs),
             "weights_p": ps, "weights_dp": dps,
             "hvp": gp.hvp_marg_mix_plain(x, t, ps, dps, bufs)}
    b64 = {name: v.double() for name, v in bufs.items()}
    x64, t64 = x.double(), t.double()
    if mode == "bf16":
        r = bf16_reference(torch, x, bufs, t)
        lse64, p64, dp64 = r["lse"], r["p"], r["dp"]
        ref = {"unit": r["unit"], "weights_p": p64, "weights_dp": dp64,
               "hvp": r["hvp"]}
    else:
        lse64, _ = gp.score_rows_plain(x64, b64, True)
        p64, dp64 = gp.hvp_marg_weights_plain(x64, t64, lse64, b64)
        ref = {"unit": gp.unit_marg_plain(x64, lse64, b64),
               "weights_p": p64, "weights_dp": dp64,
               "hvp": gp.hvp_marg_mix_plain(x64, t64, p64, dp64, b64)}
    floor, big = dp_rounding(torch, x64, b64, p64, dp64)
    nnz, used = support(torch, x, lse_sp, bufs, mode)
    n = x.shape[0]

    def bars(got):
        out = {}
        for name, want in ref.items():
            err = (got[name].double() - want).abs()
            net = (torch.where(err <= floor, 0.0, err)
                   if name == "weights_dp" else err)
            err32 = float((plain[name].double() - want).abs().max())
            scale = float(want.abs().max())
            out[name] = {"err": float(err.max()), "net": float(net.max()),
                         "split_plain": err32, "scale": scale,
                         "limit": MARG_SPLIT_FACTOR * err32
                         + MARG_ERR_FLOOR * scale}
        return out

    errs = bars(kernel)
    other = "bf16" if mode == "split" else "split"
    logits_control = f"{other}_logits"
    controls = {logits_control: bars(control_pipeline(torch, x, t, bufs,
                                                      other)),
                "g_without_b": bars(control_pipeline(torch, x, t, bufs, mode,
                                                     g_with_b=False))}
    rows = multi_weight_rows(torch, {"tc": (pt, dpt), "split_plain":
                                     (ps, dps)}, x64, t64, b64, p64, dp64,
                             big)
    rows["mode"] = mode
    one_hot = (pt != 0).sum(dim=0) == 1
    dp_nonzero = int((dpt[:, one_hot] != 0).sum())
    lse_errs = {name: float((v.double() - lse64).abs().max())
                for name, v in (("tc", lse_tc), ("split_plain", lse_sp))}
    out = {"lse_against_float64": lse_errs, "errors_against_float64": errs,
           "controls": controls, "multi_weight_rows": rows,
           "one_hot_rows": int(one_hot.sum()), "nonzero_weights": nnz,
           "components_used": used, "n_rows": n, "max_dp": float(dp64.abs().max()),
           "dp_rounding_max": float(floor.max())}
    refused = {name: any(e["net"] > e["limit"] for e in c.values())
               for name, c in controls.items()}
    faults = [f"{name} error {e['net']:.3g} against float64 above "
              f"{e['limit']:.3g}" for name, e in errs.items()
              if e["net"] > e["limit"]]
    if dp_nonzero:
        faults.append(f"{dp_nonzero} entries of K9a {mode}'s dp are not 0 "
                      f"on the {out['one_hot_rows']} rows whose weight is "
                      f"one-hot")
    if not refused[logits_control] and nnz >= 10 * n:
        faults.append(f"the control with {other} logits passed the bar "
                      f"under mixed weights")
    if not (refused["g_without_b"] or not rows["rows"]
            or out["max_dp"] == 0.0):
        faults.append("the control with g without t . b passed dp's bar")
    check(not faults, "; ".join(faults) + " | " + describe_probe_split(out))
    return out, lse_tc, one_hot


def over_limit(e):
    """An error's share of its limit (inf above a limit of 0)."""
    if e["limit"] > 0:
        return e["net"] / e["limit"]
    return float("inf") if e["net"] > 0 else 0.0


def describe_probe_split(out):
    """One line of :func:`probe_split_compare`'s numbers."""
    errs, rows = out["errors_against_float64"], out["multi_weight_rows"]
    mode = rows["mode"]
    text = (f"K5 lse {mode} against float64 "
            f"{out['lse_against_float64']['tc']:.3g}, {mode} plain "
            f"{out['lse_against_float64']['split_plain']:.3g}; "
            f"against float64 (kernel, {mode} plain, ratio, limit): "
            + "; ".join(f"{name} {e['err']:.3g}, {e['split_plain']:.3g}, "
                        f"{e['err'] / max(e['split_plain'], 1e-300):.3g}, "
                        f"{e['limit']:.3g}" for name, e in errs.items())
            + f" (dp outside its rounding {errs['weights_dp']['net']:.3g}, "
            f"the rounding up to {out['dp_rounding_max']:.3g}); controls, "
            f"largest error over its limit: "
            + ", ".join(f"{name} "
                        f"{max(over_limit(e) for e in c.values()):.3g}"
                        for name, c in out["controls"].items())
            + f"; max |dp| {out['max_dp']:.3g}, exactly 0 on the "
            f"{out['one_hot_rows']} one-hot rows; nonzero weights "
            f"{out['nonzero_weights']} of {out['n_rows']} rows; "
            f"{rows['rows']} rows with more than one weight")
    if rows["rows"]:
        w = rows["worst"]
        text += (f" (logit differences against float64 in spacings, g "
                 f"differences relative: "
                 + ", ".join(f"{name} {rows[name]['logit_spacings']:.3g}, "
                             f"{rows[name]['g_rel']:.3g}"
                             for name in ("tc", "split_plain"))
                 + f"; on row {w['row']}, logit {w['logit']:.6g}, |dp| "
                 f"{w['max_dp']:.3g}, second weight {w['p_second']:.3g}, its "
                 f"g difference {w['g_diff']:.3g}, |g| up to "
                 f"{w['g_abs']:.3g}: "
                 + ", ".join(f"{name} {rows[name]['worst_logit_spacings']:.3g}"
                             f", {rows[name]['worst_g_rel']:.3g}, dp "
                             f"{rows[name]['worst_dp_rel']:.3g} of |dp|"
                             for name in ("tc", "split_plain"))
                 + ")")
    return text


def probe_split_checks(torch, device, label, img, bufs, mode="split"):
    """:func:`probe_split_compare` on the probe's rows of one image along
    a random tangent. Returns the numbers and the inputs, for timing."""
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    x = normalised_rows(torch, torch.as_tensor(img, device=device),
                        ZERO_FLUX_SENTINEL)
    gen = torch.Generator(device=device).manual_seed(4)
    t = torch.randn(x.shape, generator=gen, device=device)
    tag = f"{label} marginalised probe {mode}"
    try:
        out, lse_tc, _ = probe_split_compare(torch, x, t, bufs, mode)
    except AssertionError as exc:
        raise AssertionError(f"{tag}: {exc}") from None
    print(f"phase 2 {tag} ({x.shape[0]} rows): {describe_probe_split(out)}")
    return out, {"x": x, "t": t, "lse": lse_tc,
                 "nnz": out["nonzero_weights"],
                 "used": out["components_used"]}


def probe_split_timing(torch, bufs, s, plain=True, mode="split"):
    """Milliseconds per call of K8 split and K9a split, or their
    ``"bf16"`` kernels with ``mode`` (and of their plain versions) on a
    case's rows, fed K5 lse's logsumexp of the mode, and their bounds:
    the logits' three bf16 products (one under ``"bf16"``) at the bf16
    peak, the float32 A_k x terms of the nonzero weights (and their dot
    products with b_k or t) at the fp32 peak on top. Bytes: rows (and
    tangents) and the logsumexp read once, the output written once (K9a:
    p and dp, (K, N)), the warpgroup core's planes and linear terms read
    (``wg_bytes``), and of the A_k and b_k those that some weight
    selects."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp

    x, t, lse = s["x"], s["t"], s["lse"]
    _, unit, weights = (launcher(gp, name)
                        for name in MARG_PROBE_KERNELS[mode])
    calls = {
        "unit": (lambda: unit(x, lse, bufs),
                 lambda: gf.PLAIN_UNITS[mode](x, lse, bufs)),
        "weights": (lambda: weights(x, t, lse, bufs),
                    lambda: gp.PLAIN_WEIGHTS[mode](x, t, lse, bufs)),
    }
    timing = {}
    for name, (kernel, plain_fn) in calls.items():
        timing[name + "_ms"] = cuda_ms(torch, kernel, 10)
        if plain:
            timing[name + "_plain_ms"] = cuda_ms(torch, plain_fn, 3)
    k, n = bufs["rec"].shape[0], x.shape[0]
    t_ops = (products(mode) * 2.0 * (2080 + 64) * k * n / PEAK_BF16_FLOPS
             + 2.0 * (4096 + 64) * s["nnz"] / PEAK_FP32_FLOPS)
    fixed = wg_bytes(bufs, mode) + 4 * s["used"] * (64 * 64 + 64)
    bounds = {}
    for name, nbytes in (("unit", 4 * (2 * n * 64 + n)),
                         ("weights", 4 * (2 * n * 64 + n + 2 * k * n))):
        t_bytes = (nbytes + fixed) / PEAK_BYTES_PER_S
        bounds[name] = {
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return timing, bounds


def phase_marg_split_kernels(torch, device, bufs, cases, marg, mode="split"):
    """K1 lse split and K4 split (or their ``"bf16"`` kernels with
    ``mode``) against their plain versions and float64 on the phase's two
    images, and K8 and K9a of the mode on their rows
    (:func:`probe_split_checks`), under ``astro-snr-v1`` (one-hot
    weights), ``wide_gmm()`` (K = 256, two tiles) and ``mixed_gmm()``
    (mixed weights; the run fails unless they are); times at the main
    path's shape beside the float32 kernels' (``marg``, this call), and
    under ``mixed_gmm()``."""
    from jolideco_torch.utils.cuda_build import BUILD_INFO

    out = {}
    for key, gmm_bufs in (("astro", bufs),
                          ("wide", wide_gmm().kernel_buffers(device)),
                          ("mixed", mixed_gmm().kernel_buffers(device))):
        for label, img in cases.items():
            k = gmm_bufs["rec"].shape[0]
            res, s = marg_split_checks(torch, device, f"{label} K={k} {key}",
                                       img, gmm_bufs, mode)
            out[f"{label} {key}"] = res
            probe, rows = probe_split_checks(
                torch, device, f"{label} K={k} {key}", img, gmm_bufs, mode)
            out[f"{label} {key} probe"] = probe
            if label == MAIN and key == "astro":
                out["k4_weights"] = k4_weight_checks(
                    torch, f"{MAIN}[:256, :256]",
                    torch.as_tensor(np.ascontiguousarray(img[:256, :256]),
                                    device=device), gmm_bufs, mode)
            if key == "mixed":
                check(res["nonzero_weights"] >= 10 * res["n_valid"]
                      and probe["nonzero_weights"] >= 10 * probe["n_rows"],
                      f"{label} mixed: weights not mixed "
                      f"({res['nonzero_weights']} nonzero of "
                      f"{res['n_valid']} patches, "
                      f"{probe['nonzero_weights']} of {probe['n_rows']} "
                      f"rows)")
            if label != MAIN or key == "wide":
                continue
            ptiming, pbounds = probe_split_timing(torch, gmm_bufs, rows,
                                                  plain=key == "astro",
                                                  mode=mode)
            out[f"probe_timing_{key}"] = ptiming
            out[f"probe_bounds_{key}"] = pbounds
            timing, bounds = marg_split_timing(torch, gmm_bufs, s,
                                               plain=key == "astro",
                                               mode=mode)
            out[f"timing_{key}"], out[f"bounds_{key}"] = timing, bounds
            line = (f"phase 2 timing marginalise {mode} {MAIN} K={k} {key}: "
                    f"K1 lse {mode} {timing['fwd_ms']:.3f} ms, K4 {mode} "
                    f"{timing['bwd_ms']:.3f} ms; {mode} bounds "
                    f"{bounds['fwd']['bound_ms']:.4f} "
                    f"({bounds['fwd']['bound_ms'] / timing['fwd_ms']:.1%}), "
                    f"{bounds['bwd']['bound_ms']:.4f} "
                    f"({bounds['bwd']['bound_ms'] / timing['bwd_ms']:.1%})")
            tm = marg["timing"] if key == "astro" else marg["mixed"]["timing"]
            line += (f"; K8 {mode} {ptiming['unit_ms']:.3f} ms, K9a {mode} "
                     f"{ptiming['weights_ms']:.3f} ms; {mode} bounds "
                     + ", ".join(
                         f"{pbounds[name]['bound_ms']:.4f} ("
                         f"{pbounds[name]['bound_ms'] / ptiming[name + '_ms']:.1%})"
                         for name in ("unit", "weights")))
            if key == "astro":
                instances = tuple(
                    f"gmm_score_wg_kernel<{image}, {products(mode)}, {epi}>:"
                    for image, epi in (("true", 1), ("false", 2),
                                       ("false", 1), ("false", 3),
                                       ("false", 4)))
                line += (f"; {mode} plain {timing['fwd_plain_ms']:.3f}, "
                         f"{timing['bwd_plain_ms']:.3f}, "
                         f"{ptiming['unit_plain_ms']:.3f}, "
                         f"{ptiming['weights_plain_ms']:.3f} ms; float32 "
                         f"kernels (this call) K1 lse {tm['fwd_ms']:.3f}, K4 "
                         f"{tm['bwd_ms']:.3f}, K8 {tm['unit_ms']:.3f}, K9a "
                         f"{tm['weights_ms']:.3f} ms; "
                         + " | ".join(
                             entry for entry in ptxas_summary(
                                 BUILD_INFO["gmm_score_wg"]["ptxas"])
                             if entry.startswith(instances)))
            else:
                line += (f"; float32 kernels (this call) K1 lse "
                         f"{tm['fwd_ms']:.3f}, K4 {tm['bwd_ms']:.3f}, K8 "
                         f"{tm['unit_ms']:.3f}, K9a {tm['weights_ms']:.3f} "
                         f"ms; {s['nnz']} nonzero weights of the patches, "
                         f"{rows['nnz']} of the rows")
            print(line)
    return out


def pfft_inputs(torch, device, shape, seed):
    """5 pairs of ``shape`` images and the spectra of the main path's 33²
    PSF pairs at n = 1152 (``bench_data``'s widening Gaussians)."""
    from jolideco_torch.ops import pallas_fft as pf
    from jolideco_torch.utils.kernels import gaussian_kernel_2d

    psfs = torch.as_tensor(np.stack([
        gaussian_kernel_2d(2.0 + 0.3 * i, x_size=33, y_size=33)
        for i in range(N_OBS)]).astype(np.float32), device=device)
    n = pf.pfft_size(max(shape) + 32)
    planes = pf.pfft_pair_spectra_device(psfs[0::2], psfs[1::2], shape, n)
    rs = np.random.RandomState(seed)
    x0, x1 = (torch.as_tensor(rs.uniform(0.0, 2.0, (N_OBS // 2,) + shape)
                              .astype(np.float32), device=device)
              for _ in range(2))
    return x0, x1, planes, psfs, n


def split_anchored(label, name, got, plain32, plain64):
    """The tensor-core kernels' bar: :func:`anchored` against the float32
    ``"split"`` plain version, and within ``PFFT_SPLIT_SHARE`` of the
    max-abs."""
    err, err32, scale = anchored(label, name, got, plain32, plain64)
    check(err <= PFFT_SPLIT_SHARE * scale,
          f"{label}: {name} error {err:.3g} beyond {PFFT_SPLIT_SHARE} of "
          f"the max-abs {scale:.3g}")
    return err, err32, scale


def bf16_anchored(label, name, got, plain32, plain64, share=None):
    """The ``"bf16"`` kernels' bar: :func:`anchored` against the float32
    bf16 plain version, at least ``BF16_HONOURED`` of that version's
    error, and with ``share`` within that share of the max-abs."""
    err, err32, scale = anchored(label, name, got, plain32, plain64)
    check(err >= BF16_HONOURED * err32, f"{label}: {name} error {err:.3g} "
          f"below {BF16_HONOURED} x the bf16 plain version's {err32:.3g}: "
          f"not the bf16 mode's rounding")
    check(share is None or err <= share * scale, f"{label}: {name} error "
          f"{err:.3g} beyond {share} of the max-abs {scale:.3g}")
    return err, err32, scale


def worst(errs):
    """The error tuple whose share of its max-abs is the largest."""
    return max(errs, key=lambda e: e[0] / e[2])


def pfft_checks(torch, device, label, shape, seed):
    """K3's kernels, and the pipeline in each mode, against the plain
    version in float64 on one batch, forward and adjoint; cuFFT's packed
    pair beside them. The float32 kernels (the three passes on ``wgmma``,
    six bf16 products of three-way splits a step) are held to the float32
    plain version's error, the tensor-core kernels of ``"split"`` to the
    split plain version's. Returns the errors (kernel, float32 plain, max-abs)
    and the inputs."""
    from jolideco_torch.ops import pallas_fft as pf
    from jolideco_torch.ops.fft import (
        convolve_fft_packed_pair,
        kernel_fft_pair,
    )

    x0, x1, planes, psfs, n = pfft_inputs(torch, device, shape, seed)
    h = shape[0]
    c128, f64 = torch.complex128, torch.float64
    x64 = (x0.double(), x1.double())
    fs = (shape[0] + 32, shape[1] + 32)
    a, b = kernel_fft_pair(psfs[0::2], psfs[1::2], shape, fs)
    errs = {}
    u = pf.pfft_cols_fwd_cuda(x0, x1, n)
    u64 = pf.cols_fwd_plain(*x64, n, f64)
    errs["cols_fwd"] = anchored(label, "K3 cols_fwd", u,
                                pf.cols_fwd_plain(x0, x1, n), u64)
    errs["cols_fwd_tc"] = split_anchored(
        label, "K3 cols_fwd tc", pf.pfft_cols_fwd_tc_cuda(x0, x1, n),
        pf.cols_fwd_plain(x0, x1, n, mode="split"), u64)
    errs["cols_fwd_bf16"] = bf16_anchored(
        label, "K3 cols_fwd bf16", pf.pfft_cols_fwd_bf16_cuda(x0, x1, n),
        pf.cols_fwd_plain(x0, x1, n, mode="bf16"), u64)
    for conj in (False, True):
        tag = "adjoint" if conj else "forward"
        v = pf.pfft_rows_combine_cuda(u, *planes, conj)
        v32 = pf.rows_combine_plain(u, *planes, conj)
        v64 = pf.rows_combine_plain(u.to(c128), *planes, conj, f64)
        errs[f"rows_{tag}"] = max(
            (anchored(label, f"K3 rows {tag} V{i + 1}", *vs)
             for i, vs in enumerate(zip(v, v32, v64))),
            key=lambda e: e[0] / e[2])
        y = pf.pfft_cols_inv_cuda(*v, h)
        y32 = pf.cols_inv_plain(*v, h)
        y64 = pf.cols_inv_plain(*(t.to(c128) for t in v), h, f64)
        errs[f"cols_inv_{tag}"] = max(
            (anchored(label, f"K3 cols_inv {tag} y{i}", *ys)
             for i, ys in enumerate(zip(y, y32, y64))),
            key=lambda e: e[0] / e[2])
        # the tensor-core kernels on the same U, against the split plain
        # version and float64 (v64 is the float64 pass on U)
        vt = pf.pfft_rows_combine_tc_cuda(u, *planes, conj)
        vs = pf.rows_combine_plain(u, *planes, conj, mode="split")
        errs[f"rows_tc_{tag}"] = worst(
            split_anchored(label, f"K3 rows tc {tag} V{i + 1}", *vv)
            for i, vv in enumerate(zip(vt, vs, v64)))
        yt = pf.pfft_cols_inv_tc_cuda(*vt, h)
        ys = pf.cols_inv_plain(*vt, h, mode="split")
        yt64 = pf.cols_inv_plain(*(t.to(c128) for t in vt), h, f64)
        errs[f"cols_inv_tc_{tag}"] = worst(
            split_anchored(label, f"K3 cols_inv tc {tag} y{i}", *yy)
            for i, yy in enumerate(zip(yt, ys, yt64)))
        # the bf16 kernels the same way, against the bf16 plain version
        vb = pf.pfft_rows_combine_bf16_cuda(u, *planes, conj)
        vbp = pf.rows_combine_plain(u, *planes, conj, mode="bf16")
        errs[f"rows_bf16_{tag}"] = worst(
            bf16_anchored(label, f"K3 rows bf16 {tag} V{i + 1}", *vv)
            for i, vv in enumerate(zip(vb, vbp, v64)))
        yb = pf.pfft_cols_inv_bf16_cuda(*vb, h)
        ybp = pf.cols_inv_plain(*vb, h, mode="bf16")
        yb64 = pf.cols_inv_plain(*(t.to(c128) for t in vb), h, f64)
        errs[f"cols_inv_bf16_{tag}"] = worst(
            bf16_anchored(label, f"K3 cols_inv bf16 {tag} y{i}", *yy)
            for i, yy in enumerate(zip(yb, ybp, yb64)))
        # the whole pipeline and cuFFT's packed pair against float64
        y = pf.pfft_conv_cuda(x0, x1, *planes, n, conj)
        y32 = pf.conv_packed_pfft_plain(x0, x1, *planes, n, conj)
        y64 = pf.conv_packed_pfft_plain(*x64, *planes, n, conj, f64)
        spec = (a.conj(), b.conj()) if conj else (a, b)
        yc = convolve_fft_packed_pair(x0, x1, *spec, fs)
        torch.cuda.synchronize()
        scale = max(float(t.abs().max()) for t in y64)
        err = max(float((k.double() - r).abs().max()) for k, r in zip(y, y64))
        err32 = max(float((k.double() - r).abs().max())
                    for k, r in zip(y32, y64))
        errc = max(float((k.double() - r).abs().max())
                   for k, r in zip(yc, y64))
        check(err <= PFFT_ERR_SHARE * scale
              and err <= MARG_ERR_FACTOR * err32 + MARG_ERR_FLOOR * scale,
              f"{label}: K3 {tag} error {err:.3g} against float64, plain "
              f"float32 {err32:.3g}, cuFFT {errc:.3g}, max {scale:.3g}")
        errs[f"pipeline_{tag}"] = (err, err32, scale, errc)
        # the split pipeline: the three tensor-core kernels
        yt = pf.pfft_conv_cuda(x0, x1, *planes, n, conj, "split")
        ys = pf.conv_packed_pfft_plain(x0, x1, *planes, n, conj,
                                       mode="split")
        torch.cuda.synchronize()
        e = [split_anchored(label, f"K3 split pipeline {tag} y{i}", *yy)
             for i, yy in enumerate(zip(yt, ys, y64))]
        errs[f"pipeline_split_{tag}"] = (max(t[0] for t in e),
                                         max(t[1] for t in e), scale, errc)
        # the bf16 pipeline; its control, the split pipeline in its
        # place, must be refused by the bar the bf16 pipeline passed
        yb = pf.pfft_conv_cuda(x0, x1, *planes, n, conj, "bf16")
        ybp = pf.conv_packed_pfft_plain(x0, x1, *planes, n, conj,
                                        mode="bf16")
        torch.cuda.synchronize()
        e = [bf16_anchored(label, f"K3 bf16 pipeline {tag} y{i}", *yy,
                           share=PFFT_BF16_SHARE)
             for i, yy in enumerate(zip(yb, ybp, y64))]
        try:
            for i, yy in enumerate(zip(yt, ybp, y64)):
                bf16_anchored(label, f"control {tag} y{i}", *yy,
                              share=PFFT_BF16_SHARE)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"{label}: K3 {tag}: the control (the "
                                 f"split pipeline) passed the bf16 bar")
        errs[f"pipeline_bf16_{tag}"] = (max(t[0] for t in e),
                                        max(t[1] for t in e), scale, errc)
    print(f"phase 2 K3 {label} (5 pairs, n = {n}): against float64 (kernel, "
          "plain float32 or split, max-abs): "
          + "; ".join(f"{name} {e[0]:.3g}, {e[1]:.3g}, {e[2]:.3g}"
                      for name, e in errs.items())
          + "; cuFFT packed pair "
          + ", ".join(f"{errs[f'pipeline_{t}'][3]:.3g} ({t})"
                      for t in ("forward", "adjoint")))
    split, f32 = (max(errs[f"{key}_{t}"][0] / errs[f"{key}_{t}"][2]
                      for t in ("forward", "adjoint"))
                  for key in ("pipeline_split", "pipeline"))
    bf16 = max(errs[f"pipeline_bf16_{t}"][0] / errs[f"pipeline_bf16_{t}"][2]
               for t in ("forward", "adjoint"))
    print(f"phase 2 K3 {label}: split pipeline error {split:.3g} of the "
          f"max-abs (the JAX package documents {JAX_SPLIT_ERR} for its split "
          f"mode); bf16 pipeline {bf16:.3g} (documented {PFFT_BF16_SHARE}, "
          f"the split pipeline as its control refused); float32 kernels "
          f"{f32:.3g}")
    inputs = {"x0": x0, "x1": x1, "planes": planes, "psfs": psfs, "n": n,
              "u": u, "v": pf.pfft_rows_combine_cuda(u, *planes),
              "vt": pf.pfft_rows_combine_tc_cuda(u, *planes),
              "vb": pf.pfft_rows_combine_bf16_cuda(u, *planes),
              "a": a, "b": b, "fs": fs}
    return errs, inputs


def pfft_bounds(p_, h, w, n):
    """Bounds of K3's passes and of the whole convolution, one direction,
    operations counted as the TPU kernel does them: 3 real products per
    complex one, 98,304 flop per 128-vector and 128 x 128 matrix; m of
    them per column (pass 1), 3 m per row (pass 2), 2 m per column (pass
    3). Bytes: images, U, V1 and V2 as complex float32, the four spectrum
    planes and the stage tables (mf, mi) read once.

    The ``"split"`` rows (``*_split``) count the same operations three
    times (three bf16 products each) at the bf16 tensor-core peak, and
    the same bytes, the stage tables as their bf16 hi and lo planes;
    the three passes make their pipeline's. ``cols_fwd``, ``rows``,
    ``cols_inv`` and ``pipeline`` count the operations six times at the
    bf16 peak, as the float32 kernels compute them (six bf16 products of
    three-way splits on the tensor cores); ``cols_fwd_fp32``,
    ``rows_fp32`` and ``cols_inv_fp32`` are the float32 CUDA cores' bound
    of the same work. The operations are counted as the TPU kernel does
    them, not as the kernels do (4 real products per complex one), so
    that the yardstick does not move with the design."""
    m = n // 128
    vec = 98_304
    tables = 8 * m * 128 * 128
    flop = {"cols_fwd": p_ * m * vec * w, "rows": p_ * 3 * m * vec * n,
            "cols_inv": p_ * 2 * m * vec * w}
    nbytes = {"cols_fwd": 8 * p_ * h * w + 8 * p_ * n * w + tables,
              "rows": 8 * p_ * n * w + 16 * p_ * n * n + 16 * p_ * n * w
              + 2 * tables,
              "cols_inv": 16 * p_ * n * w + 8 * p_ * h * w + tables}
    out = {}
    for name in flop:
        out[name + "_fp32"] = bound(flop[name], nbytes[name])
        out[name] = bound(6 * flop[name], nbytes[name], PEAK_BF16_FLOPS)
    out["pipeline"] = bound(6 * sum(flop.values()),
                            16 * p_ * h * w + 16 * p_ * n * n + 2 * tables,
                            PEAK_BF16_FLOPS)
    for name in ("cols_fwd", "rows", "cols_inv"):
        out[name + "_split"] = bound(3 * flop[name], nbytes[name],
                                     PEAK_BF16_FLOPS)
    out["pipeline_split"] = {
        "bound_ms": sum(out[name + "_split"]["bound_ms"]
                        for name in ("cols_fwd", "rows", "cols_inv")),
        "bound_by": "bytes"}
    # "bf16": one bf16 product each, the tables as their hi planes
    for name in ("cols_fwd", "rows", "cols_inv"):
        out[name + "_bf16"] = bound(flop[name], nbytes[name],
                                    PEAK_BF16_FLOPS)
    out["pipeline_bf16"] = {
        "bound_ms": sum(out[name + "_bf16"]["bound_ms"]
                        for name in ("cols_fwd", "rows", "cols_inv")),
        "bound_by": "bytes"}
    return out


def pfft_timing(torch, s):
    """Milliseconds per call of K3's passes, the pipeline (both
    directions), the plain version, cuFFT's packed pair and the
    per-observation ``rfft2`` of the same 10 images, at the main path's
    batch."""
    from jolideco_torch.ops import pallas_fft as pf
    from jolideco_torch.ops.fft import (
        convolve_fft_packed_pair,
        convolve_fft_precomputed,
        kernel_fft,
    )

    x0, x1, planes, n, u, v, vt, vb = (
        s[k] for k in ("x0", "x1", "planes", "n", "u", "v", "vt", "vb"))
    h, w = x0.shape[1:]
    vpm = torch.stack((vt[0] + vt[1].conj(), vt[0] - vt[1].conj()))
    fs, a, b = s["fs"], s["a"], s["b"]
    images = torch.stack([x0, x1], dim=1).reshape(N_OBS, h, w)
    kft = kernel_fft(s["psfs"], (h, w), fs)
    calls = {
        "cols_fwd": lambda: pf.pfft_cols_fwd_cuda(x0, x1, n),
        "rows": lambda: pf.pfft_rows_combine_cuda(u, *planes),
        "cols_inv": lambda: pf.pfft_cols_inv_cuda(*v, h),
        "pipeline": lambda: pf.pfft_conv_cuda(x0, x1, *planes, n),
        "pipeline_adjoint": lambda: pf.pfft_conv_cuda(x0, x1, *planes, n,
                                                      True),
        "cols_fwd_split": lambda: pf.pfft_cols_fwd_tc_cuda(x0, x1, n),
        "pipeline_split": lambda: pf.pfft_conv_cuda(x0, x1, *planes, n,
                                                    False, "split"),
        "pipeline_split_adjoint": lambda: pf.pfft_conv_cuda(
            x0, x1, *planes, n, True, "split"),
        "cols_fwd_bf16": lambda: pf.pfft_cols_fwd_bf16_cuda(x0, x1, n),
        "pipeline_bf16": lambda: pf.pfft_conv_cuda(x0, x1, *planes, n,
                                                   False, "bf16"),
        "pipeline_bf16_adjoint": lambda: pf.pfft_conv_cuda(
            x0, x1, *planes, n, True, "bf16"),
        "cufft_pair": lambda: convolve_fft_packed_pair(x0, x1, a, b, fs),
        "cufft_pair_adjoint": lambda: convolve_fft_packed_pair(
            x0, x1, a.conj(), b.conj(), fs),
        "cufft_rfft2": lambda: convolve_fft_precomputed(images, kft, fs),
        # pass 1's function in one call: the axis-0 DFT of x0 + i x1
        # zero-padded to n (in natural, not permuted, row order)
        "torch_fft_cols": lambda: torch.fft.fft(torch.complex(x0, x1), n=n,
                                                dim=1),
        # pass 3's function in one call: the axis-0 inverse DFT of V1 +
        # conj V2 and V1 - conj V2 (in natural, not permuted, row order)
        "torch_ifft_cols": lambda: torch.fft.ifft(vpm, dim=-2),
    }
    for mode, vm in (("split", vt), ("bf16", vb)):
        rows, cols = pf.PASSES[mode][1:]
        calls[f"rows_{mode}"] = lambda rows=rows: rows(u, *planes)
        calls[f"cols_inv_{mode}"] = lambda cols=cols, vm=vm: cols(*vm, h)
    timing = {name: cuda_ms(torch, fn, 10) for name, fn in calls.items()}
    plain = {
        "cols_fwd": lambda: pf.cols_fwd_plain(x0, x1, n),
        "rows": lambda: pf.rows_combine_plain(u, *planes),
        "cols_inv": lambda: pf.cols_inv_plain(*v, h),
        "pipeline": lambda: pf.conv_packed_pfft_plain(x0, x1, *planes, n),
        "cols_fwd_split": lambda: pf.cols_fwd_plain(x0, x1, n, mode="split"),
        "rows_split": lambda: pf.rows_combine_plain(u, *planes,
                                                    mode="split"),
        "cols_inv_split": lambda: pf.cols_inv_plain(*vt, h, mode="split"),
        "pipeline_split": lambda: pf.conv_packed_pfft_plain(
            x0, x1, *planes, n, mode="split"),
        "cols_fwd_bf16": lambda: pf.cols_fwd_plain(x0, x1, n, mode="bf16"),
        "rows_bf16": lambda: pf.rows_combine_plain(u, *planes, mode="bf16"),
        "cols_inv_bf16": lambda: pf.cols_inv_plain(*vb, h, mode="bf16"),
        "pipeline_bf16": lambda: pf.conv_packed_pfft_plain(
            x0, x1, *planes, n, mode="bf16"),
    }
    timing.update({name + "_plain": cuda_ms(torch, fn, 3)
                   for name, fn in plain.items()})
    return timing


def pfft_tall_checks(torch, device):
    """Pass 1 of ``"split"`` and ``"bf16"`` at the x2 path's batch (5
    pairs of 2048², n = 2176: items of 8 columns, 16 row blocks of x in
    registers) against the plain version of each mode and float64, with
    phase 2's bars; its ms beside one ``torch.fft.fft`` and its bound."""
    from jolideco_torch.ops import pallas_fft as pf

    rs = np.random.RandomState(6)
    x0, x1 = (torch.as_tensor(rs.uniform(0.0, 2.0, (N_OBS // 2,) + PFFT_TALL)
                              .astype(np.float32), device=device)
              for _ in range(2))
    n = pf.pfft_size(max(PFFT_TALL) + 32)
    label = "{}x{}".format(*PFFT_TALL)
    u64 = pf.cols_fwd_plain(x0.double(), x1.double(), n, torch.float64)
    bounds = pfft_bounds(N_OBS // 2, *PFFT_TALL, n)
    out = {"batch": f"5 pairs of {label}, n = {n}"}
    for mode, fn, anchor in (
            ("split", pf.pfft_cols_fwd_tc_cuda, split_anchored),
            ("bf16", pf.pfft_cols_fwd_bf16_cuda, bf16_anchored)):
        err = anchor(label, f"K3 cols_fwd {mode}", fn(x0, x1, n),
                     pf.cols_fwd_plain(x0, x1, n, mode=mode), u64)
        out[mode] = {"err": err,
                     "ms": cuda_ms(torch, lambda fn=fn: fn(x0, x1, n), 10),
                     "bound": bounds[f"cols_fwd_{mode}"]}
    out["torch_fft_cols_ms"] = cuda_ms(
        torch, lambda: torch.fft.fft(torch.complex(x0, x1), n=n, dim=1), 10)
    print(f"phase 2 K3 {label} (5 pairs, n = {n}): pass 1 against float64 "
          "(kernel, plain, max-abs), ms, bound: " + "; ".join(
              f"{mode} {e[0]:.3g}, {e[1]:.3g}, {e[2]:.3g}, {o['ms']:.3f} ms, "
              f"{o['bound']['bound_ms']:.4f} ({o['bound']['bound_by']})"
              for mode in ("split", "bf16")
              for o in (out[mode],) for e in (o["err"],))
          + f"; one torch.fft.fft {out['torch_fft_cols_ms']:.3f} ms")
    return out


def phase_pfft_kernels(torch, device):
    """K3 at the main path's batch and at a rectangular one, with the main
    batch's times and bounds, and pass 1 of the bf16 modes at the x2
    path's batch."""
    out = {}
    for label, shape, seed in ((MAIN, (FIELD, FIELD), 4),
                               ("{}x{}".format(*PFFT_RECT), PFFT_RECT, 5)):
        out[label], s = pfft_checks(torch, device, label, shape, seed)
        if label == MAIN:
            out["timing"] = pfft_timing(torch, s)
            out["bounds"] = pfft_bounds(N_OBS // 2, FIELD, FIELD, s["n"])
    out["tall"] = pfft_tall_checks(torch, device)
    tm, bd = out["timing"], out["bounds"]
    print(f"phase 2 timing K3 {MAIN} (5 pairs, n = 1152): "
          + "; ".join(f"{name} {tm[name]:.3f} ms (plain "
                      f"{tm[name + '_plain']:.3f}, bound "
                      f"{bd[name]['bound_ms']:.3f})"
                      for name in ("cols_fwd", "rows", "cols_inv",
                                   "pipeline", "cols_fwd_split", "rows_split",
                                   "cols_inv_split", "pipeline_split",
                                   "cols_fwd_bf16", "rows_bf16",
                                   "cols_inv_bf16", "pipeline_bf16"))
          + f"; split adjoint {tm['pipeline_split_adjoint']:.3f} ms"
          + f"; bf16 adjoint {tm['pipeline_bf16_adjoint']:.3f} ms"
          + f"; adjoint {tm['pipeline_adjoint']:.3f} ms; cuFFT packed pair "
          f"{tm['cufft_pair']:.3f} ms (adjoint "
          f"{tm['cufft_pair_adjoint']:.3f}), per-observation rfft2 "
          f"{tm['cufft_rfft2']:.3f} ms")
    # the float32 passes on wgmma beside the one torch.fft call that
    # computes the function of passes 1 and 3 (pass 2's has none), with
    # both bounds and both shares
    against = {"cols_fwd": "one torch.fft.fft {:.3f} ms".format(
                   tm["torch_fft_cols"]),
               "rows": "no one torch call (cuFFT's packed pair, the whole "
                       "convolution, {:.3f} ms)".format(tm["cufft_pair"]),
               "cols_inv": "one torch.fft.ifft {:.3f} ms".format(
                   tm["torch_ifft_cols"])}
    print(f"phase 2 timing K3 f32 on wgmma {MAIN}: " + "; ".join(
        f"{name} {tm[name]:.3f} ms against {call}; bound (six bf16 "
        f"products) {bd[name]['bound_ms']:.4f} ms "
        f"({bd[name]['bound_ms'] / tm[name]:.1%}), float32 CUDA-core "
        f"bound {bd[name + '_fp32']['bound_ms']:.4f} ms "
        f"({bd[name + '_fp32']['bound_ms'] / tm[name]:.1%})"
        for name, call in against.items()))
    return out


def reset_counts():
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.ops import pallas_fft as pf

    gf.reset_counters()
    gp.reset_counters()
    pf.reset_counters()


def counts():
    """Kernel launches by name, and the plain versions' calls in all."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.ops import pallas_fft as pf

    launches = {
        "gmm_fused_fwd": gf.gmm_fused_fwd_cuda.launches,
        "gmm_fused_fwd_marg": gf.gmm_fused_fwd_marg_cuda.launches,
        "gmm_fused_fwd_tc": gf.gmm_fused_fwd_tc_cuda.launches,
        "gmm_fused_fwd_marg_tc": gf.gmm_fused_fwd_marg_tc_cuda.launches,
        "gmm_fused_fwd_bf16": gf.gmm_fused_fwd_bf16_cuda.launches,
        "gmm_fused_fwd_marg_bf16": gf.gmm_fused_fwd_marg_bf16_cuda.launches,
        "gmm_fused_bwd": gf.gmm_fused_bwd_cuda.launches,
        "gmm_fused_bwd_marg": gf.gmm_fused_bwd_marg_cuda.launches,
        "gmm_fused_bwd_marg_tc": gf.gmm_fused_bwd_marg_tc_cuda.launches,
        "gmm_fused_bwd_marg_bf16": gf.gmm_fused_bwd_marg_bf16_cuda.launches,
        "gmm_score_rows": gp.gmm_score_rows_cuda.launches,
        "gmm_score_rows_marg": gp.gmm_score_rows_marg_cuda.launches,
        "gmm_score_rows_tc": gp.gmm_score_rows_tc_cuda.launches,
        "gmm_score_rows_marg_tc": gp.gmm_score_rows_marg_tc_cuda.launches,
        "gmm_score_rows_bf16": gp.gmm_score_rows_bf16_cuda.launches,
        "gmm_score_rows_marg_bf16": gp.gmm_score_rows_marg_bf16_cuda.launches,
        "gmm_unit_map": gp.gmm_unit_map_cuda.launches,
        "gmm_hvp_map": gp.gmm_hvp_map_cuda.launches,
        "gmm_unit_marg": gp.gmm_unit_marg_cuda.launches,
        "gmm_unit_marg_tc": gp.gmm_unit_marg_tc_cuda.launches,
        "gmm_unit_marg_bf16": gp.gmm_unit_marg_bf16_cuda.launches,
        "gmm_hvp_marg_weights": gp.gmm_hvp_marg_weights_cuda.launches,
        "gmm_hvp_marg_weights_tc": gp.gmm_hvp_marg_weights_tc_cuda.launches,
        "gmm_hvp_marg_weights_bf16":
            gp.gmm_hvp_marg_weights_bf16_cuda.launches,
        "gmm_hvp_marg_mix": gp.gmm_hvp_marg_mix_cuda.launches,
        "pfft_cols_fwd": pf.pfft_cols_fwd_cuda.launches,
        "pfft_rows_combine": pf.pfft_rows_combine_cuda.launches,
        "pfft_cols_inv": pf.pfft_cols_inv_cuda.launches,
        "pfft_cols_fwd_tc": pf.pfft_cols_fwd_tc_cuda.launches,
        "pfft_rows_combine_tc": pf.pfft_rows_combine_tc_cuda.launches,
        "pfft_cols_inv_tc": pf.pfft_cols_inv_tc_cuda.launches,
        "pfft_cols_fwd_bf16": pf.pfft_cols_fwd_bf16_cuda.launches,
        "pfft_rows_combine_bf16": pf.pfft_rows_combine_bf16_cuda.launches,
        "pfft_cols_inv_bf16": pf.pfft_cols_inv_bf16_cuda.launches,
    }
    plain = sum(fn.calls for fn in (
        gf.fused_forward_plain, gf.fused_backward_plain,
        gf.fused_backward_marg_plain, gf.score_plain, gf.score_split_plain,
        gf.score_split_marg_plain, gf.marg_unit_split_plain,
        gf.score_bf16_plain, gf.score_bf16_marg_plain,
        gf.marg_unit_bf16_plain, gp.score_rows_plain,
        gp.unit_map_plain, gp.hvp_map_plain, gp.unit_marg_plain,
        gp.hvp_marg_weights_plain, gp.hvp_marg_weights_split_plain,
        gp.hvp_marg_weights_bf16_plain, gp.hvp_marg_mix_plain,
        pf.conv_packed_pfft_plain))
    return launches, plain


def expect(**nonzero):
    """Expected launches: the given counts, every other kernel 0."""
    launches, _ = counts()
    return {name: nonzero.get(name, 0) for name in launches}


def run_slice(datasets, gmm, device, cycle_spin, n_steps=STEPS,
              compute_error=False, marginalize=False, conv_mode="fft",
              mesh=None):
    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
    )

    size = next(iter(datasets.values()))["counts"].shape
    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=cycle_spin,
                          marginalize=marginalize)
    component = SpatialFluxComponent.from_numpy(
        np.ones(size, np.float32), prior=prior
    )
    deco = MAPDeconvolver(
        n_epochs=n_steps, learning_rate=0.1, update_strategy="joint",
        conv_mode=conv_mode, trace_every=0, seed=0, device=device,
        compute_error=compute_error, mesh=mesh,
    )
    return deco.run(datasets, components=component)


def data_term(datasets, flux, device):
    """Summed Poisson NLL of the datasets at a 2-D ``flux``."""
    import torch

    from jolideco_torch import FluxComponents, SpatialFluxComponent
    from jolideco_torch.parallel.stacked import StackedPoissonLoss

    components = FluxComponents(
        {"flux": SpatialFluxComponent.from_numpy(flux, device=device)})
    poisson = StackedPoissonLoss.from_datasets(datasets, components,
                                               device=device)
    with torch.no_grad():
        return poisson(components.fluxes_from()).item()


# K1's kernel under each mode of the precision dial
K1_KERNELS = {"split": "gmm_fused_fwd_tc", "bf16": "gmm_fused_fwd_bf16",
              "f32": "gmm_fused_fwd"}
# the marginalised prior's K1 (logsumexp) and K4 under each mode
MARG_KERNELS = {"split": ("gmm_fused_fwd_marg_tc", "gmm_fused_bwd_marg_tc"),
                "bf16": ("gmm_fused_fwd_marg_bf16",
                         "gmm_fused_bwd_marg_bf16"),
                "f32": ("gmm_fused_fwd_marg", "gmm_fused_bwd_marg")}
# K3's kernels under each mode of the precision dial
K3_KERNELS = {
    "split": ("pfft_cols_fwd_tc", "pfft_rows_combine_tc", "pfft_cols_inv_tc"),
    "bf16": ("pfft_cols_fwd_bf16", "pfft_rows_combine_bf16",
             "pfft_cols_inv_bf16"),
    "f32": ("pfft_cols_fwd", "pfft_rows_combine", "pfft_cols_inv"),
}


def dial_training(torch, device, datasets, gmm, dial, conv_mode="fft"):
    """20 steps of the main path under the dial ``dial``, counts set to
    zero just before and read just after: K1's kernel of the dial's mode
    and K2 20 times, the convolution's K3 kernels 40 times (``"pfft"``),
    every other kernel never, no plain call. The data term must fall."""
    from jolideco_torch import config

    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        k1, k3 = config.gmm_mode(), config.pfft_mode()
        run = dict(cycle_spin=True, conv_mode=conv_mode)
        run_slice(datasets, gmm, device, n_steps=2, **run)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result = run_slice(datasets, gmm, device, **run)
        launches, plain_calls = counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        config.set_gmm_precision(saved)
    tag = f"{conv_mode} ({dial!r}, K1 {k1}" + (
        f", K3 {k3})" if conv_mode == "pfft" else ")")
    loss, flux = result.loss_per_step, result.flux_upsampled_total
    check(loss.shape == (STEPS,) and bool(np.isfinite(loss).all()),
          f"{tag}: non-finite loss: {loss}")
    check(flux.shape == (FIELD, FIELD)
          and bool(np.isfinite(flux).all() and (flux > 0).all()),
          f"{tag}: flux not finite and positive")
    # The total loss is not a progress measure over 20 steps here: the
    # flat start is the mode of the patch prior (every mean-subtracted
    # patch is zero), so the first steps leave it and the total rises
    # in both packages. The data term is: it must fall.
    data_start = float(data_term(datasets, np.ones_like(flux), device))
    data_end = float(data_term(datasets, flux, device))
    check(data_end < data_start, f"{tag}: Poisson data term did not fall: "
          f"{data_start} -> {data_end}")
    k3_kernels = K3_KERNELS[k3] if conv_mode == "pfft" else ()
    expected = expect(gmm_fused_bwd=STEPS, **{K1_KERNELS[k1]: STEPS},
                      **{name: 2 * STEPS for name in k3_kernels})
    check(launches == expected, f"{tag}: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"{tag}: plain versions ran {plain_calls} times")
    return {"tag": tag, "launches": launches, "plain_calls": plain_calls,
            "steps_per_s": STEPS / result.train_seconds, "peak_bytes": peak,
            "loss": loss, "data": (data_start, data_end), "flux": flux}


def training_line(run):
    return (f"{STEPS} steps at {run['steps_per_s']:.3f} steps/s; loss "
            f"{run['loss'][0]:.6f} -> {run['loss'][-1]:.6f}; data term "
            f"{run['data'][0]:.6f} -> {run['data'][1]:.6f}; launches "
            f"{run['launches']}; plain calls {run['plain_calls']}; peak "
            f"memory {run['peak_bytes']} B")


def argmax_flips(torch, device, flux, gmm, marginalize=False,
                 modes=("split", "f32")):
    """Patches whose argmax differs between K1's kernels of the two
    ``modes`` (of the logsumexp mode with ``marginalize``) at ``flux``
    (the prior's image norm is the identity, its spin left out), and the
    valid patches."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                            device=device)
    bufs = gmm.kernel_buffers(device)
    tc, f32 = (launcher(gf, MARG_KERNELS[mode][0] if marginalize
                        else K1_KERNELS[mode]) for mode in modes)
    _, a_tc, valid, _ = tc(image, bufs, 4, ZERO_FLUX_SENTINEL)
    _, a_32, _, _ = f32(image, bufs, 4, ZERO_FLUX_SENTINEL)
    m = valid > 0.5
    return int((a_tc != a_32)[m].sum()), int(m.sum())


# patches per block of K2's product kernel (csrc/gmm_fused.cu kBwdTile):
# each half-warp reads A_k once per run of k* among its 8 places
K2_TILE = 128


def k2_case(torch, xtn, argmax, valid, dv, bufs, shape, names=K2_KERNELS):
    """K2 on the card at these inputs: the distinct components its tiles'
    patches select, its ms a call and of device time (the kernels
    ``names`` once a call), and its error against the float32 plain
    version (1e-4 of the max-abs)."""
    from jolideco_torch.ops import gmm_fused as gf

    def call():
        return gf.gmm_fused_bwd_cuda(xtn, argmax, valid, dv, bufs, shape, 4)

    got = call()
    want = gf.fused_backward_plain(xtn, argmax, valid, dv, bufs, shape, 4)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    check(err <= 1e-4 * scale, f"K2 at {argmax.numel()} patches: error "
          f"{err:.3g} vs max {scale:.3g}")
    m = valid > 0.5
    tile = torch.arange(argmax.numel(), device=argmax.device) // K2_TILE
    n_tiles = int(tile[-1]) + 1
    width = int(argmax.max()) + 1
    pairs = torch.unique(tile[m] * width + argmax.long()[m])
    per_tile = torch.bincount(pairs // width, minlength=n_tiles).float()
    return {"tile": K2_TILE, "tiles": n_tiles, "valid": int(m.sum()),
            "pairs": int(pairs.numel()),
            "used_components": int(torch.unique(argmax[m]).numel()),
            "mean": float(per_tile.mean()),
            "median": float(per_tile.median()), "max": int(per_tile.max()),
            "grad_max_abs_err": err, "grad_max_abs": scale,
            "k2_ms": cuda_ms(torch, call, 20),
            "k2_device_ms": device_ms(torch, call, 20, *names)}


def k2_case_line(tiles):
    return (f"{tiles['valid']} valid patches in {tiles['tiles']} tiles of "
            f"{tiles['tile']} select {tiles['used_components']} components; "
            f"distinct per tile mean {tiles['mean']:.2f}, median "
            f"{tiles['median']:.0f}, max {tiles['max']}; K2 "
            f"{tiles['k2_ms']:.4f} ms a call, {tiles['k2_device_ms']:.4f} ms "
            f"of device time, error {tiles['grad_max_abs_err']:.3g} (max "
            f"{tiles['grad_max_abs']:.3g})")


def k2_tile_components(torch, device, flux, gmm):
    """K2 (:func:`k2_case`) at the patches and argmax (K1 split's,
    unspun) of ``flux``."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                            device=device)
    bufs = gmm.kernel_buffers(device)
    _, argmax, valid, xtn = gf.gmm_fused_fwd_tc_cuda(image, bufs, 4,
                                                     ZERO_FLUX_SENTINEL)
    gen = torch.Generator(device=device).manual_seed(3)
    dv = torch.randn(valid.shape, generator=gen, device=device) * valid
    return k2_case(torch, xtn, argmax, valid, dv, bufs, image.shape)


def row_map_trained(torch, device, flux, gmm):
    """K6 and K7 (:func:`row_map_case`) at the probe's rows of ``flux``
    (its grouped patches, unspun) and K5 split's argmax of them."""
    from jolideco_torch.ops import gmm_pallas as gp
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                            device=device)
    x = normalised_rows(torch, image, ZERO_FLUX_SENTINEL)
    bufs = gmm.kernel_buffers(device)
    _, argmax = gp.gmm_score_rows_tc_cuda(x, bufs)
    return row_map_case(torch, x, argmax, bufs)


def phase_slice(torch, device):
    """The main path under the default dial (K1 on the tensor cores) and
    under ``"highest"`` (the float32 K1); their flux held together."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    runs = {dial: dial_training(torch, device, datasets, astro, dial)
            for dial in ("high", "highest")}
    for run in runs.values():
        print(f"phase 3 {run['tag']} slice {N_OBS}x{FIELD}^2 K=200: "
              + training_line(run))
    flux, flux_32 = runs["high"]["flux"], runs["highest"]["flux"]
    dial_diff = float(np.abs(flux - flux_32).max() / np.abs(flux_32).max())
    flips, n_valid = argmax_flips(torch, device, flux, astro)
    check(flips <= K1_SPLIT_FLIPS * n_valid, f"K1's two kernels' argmax at "
          f"the final flux: {flips} of {n_valid} valid patches differ "
          f"(limit {K1_SPLIT_FLIPS} of them); flux under 'high' against "
          f"'highest': max-abs difference {dial_diff:.3g} of the max")
    print(f"phase 3 dials: K1's two kernels' argmax at the final flux: "
          f"{flips} of {n_valid} valid patches differ (limit "
          f"{K1_SPLIT_FLIPS} of them); flux under 'high' against 'highest' "
          f"max-abs difference {dial_diff:.3g} of the max (the JAX "
          f"package's own at 4x128^2: {JAX_DIAL_FLUX_SHARE})")
    tiles = k2_tile_components(torch, device, flux, astro)
    print(f"phase 3 K2 at the final flux: {k2_case_line(tiles)}")
    row_map = row_map_trained(torch, device, flux, astro)
    print(f"phase 3 K6/K7 at the final flux: {row_map_line(row_map)}")

    # small input: the card's run against the CPU's plain path
    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    on_card = run_slice(small, builtin, device, cycle_spin=False)
    on_cpu = run_slice(small, builtin, "cpu", cycle_spin=False)
    a, b = on_card.flux_upsampled_total, on_cpu.flux_upsampled_total
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    check(rel <= SMALL_FLUX_RTOL,
          f"4x128^2 flux on the card vs CPU: max rel err {rel:.3g}")
    print(f"phase 3 small 4x128^2 card vs CPU plain path: flux max rel err "
          f"{rel:.3g} (limit {SMALL_FLUX_RTOL})")
    return {**runs, "dial_flux_diff": dial_diff, "final_flips": flips,
            "k2_tiles": tiles, "row_map": row_map}


# the probe's MAP scorer (K5) under each mode of the precision dial
K5_KERNELS = {"split": "gmm_score_rows_tc", "bf16": "gmm_score_rows_bf16",
              "f32": "gmm_score_rows"}


def probe_run(torch, device, datasets, gmm, dial, phase=4):
    """The main path's training, then one Hessian probe, under the dial
    ``dial``, counts set to zero just before and read just after: K1 of
    the dial's mode and K2 ``ERROR_STEPS`` times; K5 of the dial's mode,
    K6 and K7 once; every other kernel never, no plain call."""
    from jolideco_torch import config

    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        mode = config.gmm_mode()
        run_slice(datasets, gmm, device, cycle_spin=True, n_steps=1,
                  compute_error=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result = run_slice(datasets, gmm, device, cycle_spin=True,
                           n_steps=ERROR_STEPS, compute_error=True)
        launches, plain_calls = counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        config.set_gmm_precision(saved)
    tag = f"({dial!r}, K1 and K5 {mode})"
    expected = expect(gmm_fused_bwd=ERROR_STEPS, gmm_unit_map=1,
                      gmm_hvp_map=1, **{K1_KERNELS[mode]: ERROR_STEPS,
                                        K5_KERNELS[mode]: 1})
    check(launches == expected, f"{tag}: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"{tag}: plain versions ran {plain_calls} times")
    errors = result.components["flux"].flux_upsampled_error_numpy
    check(errors.shape == (FIELD, FIELD), f"{tag}: error shape "
          f"{errors.shape}")
    # H . 1 is positive at every pixel of this data (the Poisson term's
    # curvature; the prior adds nothing along ones), so every error
    # must be finite and positive
    check(bool(np.isfinite(errors).all() and (errors > 0).all()),
          f"{tag}: errors not finite and positive at "
          f"{int((~(np.isfinite(errors) & (errors > 0))).sum())} pixels")
    print(f"phase {phase} errors {tag} {N_OBS}x{FIELD}^2 K=200: {ERROR_STEPS} "
          f"steps in {result.train_seconds:.4f} s, probe "
          f"{result.error_seconds:.4f} s; errors {float(errors.min()):.6g} "
          f".. {float(errors.max()):.6g}; launches {launches}; plain calls "
          f"{plain_calls}; peak memory {peak} B")
    return {"launches": launches, "error_seconds": result.error_seconds,
            "peak_bytes": peak, "errors": errors}


def phase_errors(torch, device):
    """``compute_error=True`` through ``MAPDeconvolver``: the main path's
    training, then one Hessian probe on K5, K6 and K7, under the default
    dial (K1 split, K5 split) and under ``"highest"`` (their float32
    kernels); then a small run, card against the CPU's plain path."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    runs = {dial: probe_run(torch, device, datasets, astro, dial)
            for dial in ("high", "highest")}
    # the probe reads the MAP scorer only through the argmax, so the two
    # dials' errors differ where training or the probe flipped one
    a, b = runs["high"]["errors"], runs["highest"]["errors"]
    runs["dial_error_rel"] = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"phase 4 dials: errors under 'high' against 'highest' max rel "
          f"difference {runs['dial_error_rel']:.3g}")

    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    on_card, on_cpu = (
        run_slice(small, builtin, dev, cycle_spin=False, compute_error=True)
        .components["flux"].flux_upsampled_error_numpy
        for dev in (device, "cpu")
    )
    rel = float(np.max(np.abs(on_card - on_cpu) / np.abs(on_cpu)))
    check(rel <= SMALL_ERROR_RTOL,
          f"4x128^2 errors on the card vs CPU: max rel err {rel:.3g}")
    print(f"phase 4 small 4x128^2 card vs CPU plain path: errors max rel err "
          f"{rel:.3g} (limit {SMALL_ERROR_RTOL})")
    return runs


def marg_training(torch, device, datasets, gmm, dial, phase=5):
    """20 marginalised steps of the main path under the dial ``dial``,
    counts set to zero just before and read just after: K1 (logsumexp)
    and K4 of the dial's mode 20 times each, every other kernel never, no
    plain call. The data term must fall, as in phase 3."""
    from jolideco_torch import config

    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        mode = config.gmm_mode()
        run = dict(cycle_spin=True, marginalize=True)
        run_slice(datasets, gmm, device, n_steps=2, **run)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result = run_slice(datasets, gmm, device, **run)
        launches, plain_calls = counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        config.set_gmm_precision(saved)
    tag = f"({dial!r}, {mode})"
    loss, flux = result.loss_per_step, result.flux_upsampled_total
    check(loss.shape == (STEPS,) and bool(np.isfinite(loss).all()),
          f"marginalised {tag}: non-finite loss: {loss}")
    check(flux.shape == (FIELD, FIELD)
          and bool(np.isfinite(flux).all() and (flux > 0).all()),
          f"marginalised {tag}: flux not finite and positive")
    data_start = float(data_term(datasets, np.ones_like(flux), device))
    data_end = float(data_term(datasets, flux, device))
    check(data_end < data_start, f"marginalised {tag}: Poisson data term "
          f"did not fall: {data_start} -> {data_end}")
    expected = expect(**{name: STEPS for name in MARG_KERNELS[mode]})
    check(launches == expected, f"marginalised {tag}: launches {launches}, "
          f"not {expected}")
    check(plain_calls == 0, f"marginalised {tag}: plain versions ran "
          f"{plain_calls} times")
    steps_per_s = STEPS / result.train_seconds
    print(f"phase {phase} marginalised {tag} slice {N_OBS}x{FIELD}^2 K=200: "
          f"{STEPS} steps at {steps_per_s:.3f} steps/s; loss {loss[0]:.6f} "
          f"-> {loss[-1]:.6f}; data term {data_start:.6f} -> "
          f"{data_end:.6f}; launches {launches}; plain calls {plain_calls}; "
          f"peak memory {peak} B")
    return {"launches": launches, "steps_per_s": steps_per_s,
            "peak_bytes": peak, "flux": flux}


# the marginalised probe's K5 (logsumexp), K8 and K9a under each mode of
# the precision dial; K9b (no mode) under both
MARG_PROBE_KERNELS = {
    "split": ("gmm_score_rows_marg_tc", "gmm_unit_marg_tc",
              "gmm_hvp_marg_weights_tc"),
    "bf16": ("gmm_score_rows_marg_bf16", "gmm_unit_marg_bf16",
             "gmm_hvp_marg_weights_bf16"),
    "f32": ("gmm_score_rows_marg", "gmm_unit_marg", "gmm_hvp_marg_weights"),
}


def marg_probe_run(torch, device, datasets, gmm, dial, phase=5):
    """The marginalised main path's training, then one Hessian probe,
    under the dial ``dial`` (after a warm-up of one step and a probe),
    counts set to zero just before and read just after: K1 lse and K4 of
    the dial's mode ``ERROR_STEPS`` times; K5 lse, K8 and K9a of the
    dial's mode and K9b once; every other kernel never, no plain call."""
    from jolideco_torch import config

    saved = config.gmm_precision()
    config.set_gmm_precision(dial)
    try:
        mode = config.gmm_mode()
        run = dict(cycle_spin=True, marginalize=True, compute_error=True)
        run_slice(datasets, gmm, device, n_steps=1, **run)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result = run_slice(datasets, gmm, device, n_steps=ERROR_STEPS, **run)
        launches, plain_calls = counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        config.set_gmm_precision(saved)
    tag = f"({dial!r}, {mode})"
    expected = expect(gmm_hvp_marg_mix=1,
                      **{name: ERROR_STEPS for name in MARG_KERNELS[mode]},
                      **{name: 1 for name in MARG_PROBE_KERNELS[mode]})
    check(launches == expected, f"marginalised probe {tag}: launches "
          f"{launches}, not {expected}")
    check(plain_calls == 0, f"marginalised probe {tag}: plain versions ran "
          f"{plain_calls} times")
    errors = result.components["flux"].flux_upsampled_error_numpy
    check(errors.shape == (FIELD, FIELD)
          and bool(np.isfinite(errors).all() and (errors > 0).all()),
          f"marginalised probe {tag}: errors not finite and positive at "
          f"{int((~(np.isfinite(errors) & (errors > 0))).sum())} pixels")
    print(f"phase {phase} marginalised errors {tag} {N_OBS}x{FIELD}^2 "
          f"K=200: "
          f"{ERROR_STEPS} steps in {result.train_seconds:.4f} s, probe "
          f"{result.error_seconds:.4f} s; errors {float(errors.min()):.6g} .. "
          f"{float(errors.max()):.6g}; launches {launches}; plain calls "
          f"{plain_calls}; peak memory {peak} B")
    return {"launches": launches, "error_seconds": result.error_seconds,
            "peak_bytes": peak, "errors": errors}


def phase_marginalised(torch, device):
    """Phases 3 and 4 under ``GMMPatchPrior(marginalize=True)``: training
    under the default dial (K1 lse split and K4 split on the tensor
    cores) and under ``"highest"`` (the float32 K1 lse and K4), their
    flux difference and the argmax of K1 lse's two kernels at the final
    flux, then the probe (:func:`marg_probe_run`) under both dials: K5
    lse split, K8 split and K9a split on the tensor cores under the
    default dial, their float32 kernels under ``"highest"``, K9b under
    both; each path's counts set to zero just before and read just
    after."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    train = {dial: marg_training(torch, device, datasets, astro, dial)
             for dial in ("high", "highest")}
    flux, flux_32 = train["high"]["flux"], train["highest"]["flux"]
    dial_diff = float(np.abs(flux - flux_32).max() / np.abs(flux_32).max())
    flips, n_valid = argmax_flips(torch, device, flux, astro,
                                  marginalize=True)
    check(flips <= K1_SPLIT_FLIPS * n_valid, f"marginalised: K1 lse's two "
          f"kernels' argmax at the final flux: {flips} of {n_valid} valid "
          f"patches differ (limit {K1_SPLIT_FLIPS} of them); flux under "
          f"'high' against 'highest': max-abs difference {dial_diff:.3g} "
          f"of the max")
    print(f"phase 5 dials: K1 lse's two kernels' argmax at the final flux: "
          f"{flips} of {n_valid} valid patches differ (limit "
          f"{K1_SPLIT_FLIPS} of them); flux under 'high' against 'highest' "
          f"max-abs difference {dial_diff:.3g} of the max")
    train["dial_flux_diff"], train["final_flips"] = dial_diff, flips

    probe = {dial: marg_probe_run(torch, device, datasets, astro, dial)
             for dial in ("high", "highest")}
    a, b = probe["high"].pop("errors"), probe["highest"].pop("errors")
    train["probe_errors_high"] = a
    probe["dial_error_rel"] = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"phase 5 dials: marginalised errors under 'high' against "
          f"'highest' max rel difference {probe['dial_error_rel']:.3g}; "
          f"probe {probe['high']['error_seconds']:.4f} s against "
          f"{probe['highest']['error_seconds']:.4f} s, peak memory "
          f"{probe['high']['peak_bytes']} B against "
          f"{probe['highest']['peak_bytes']} B")

    # small input, flux and errors: the card against the CPU's plain path
    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    on_card, on_cpu = (
        run_slice(small, builtin, dev, cycle_spin=False, compute_error=True,
                  marginalize=True).components["flux"]
        for dev in (device, "cpu")
    )
    rels = {}
    for name, limit in (("flux_upsampled_numpy", SMALL_FLUX_RTOL),
                        ("flux_upsampled_error_numpy", SMALL_ERROR_RTOL)):
        a, b = getattr(on_card, name), getattr(on_cpu, name)
        rels[name] = float(np.max(np.abs(a - b) / np.abs(b)))
        check(rels[name] <= limit, f"marginalised 4x128^2 {name} on the card "
              f"vs CPU: max rel err {rels[name]:.3g}")
    print(f"phase 5 small 4x128^2 card vs CPU plain path: flux max rel err "
          f"{rels['flux_upsampled_numpy']:.3g} (limit {SMALL_FLUX_RTOL}), "
          f"errors {rels['flux_upsampled_error_numpy']:.3g} (limit "
          f"{SMALL_ERROR_RTOL})")
    return train, probe


def pfft_training(torch, device, datasets, gmm, flux_fft, dial):
    """20 pfft steps under the dial ``dial`` (:func:`dial_training`: each
    K3 kernel of the dial's mode 40 times, the other mode's never); flux
    against phase 3's fft run under the same dial."""
    run = dial_training(torch, device, datasets, gmm, dial, "pfft")
    flux, tag = run["flux"], run["tag"]
    flux_diff = float(np.abs(flux - flux_fft).max() / np.abs(flux_fft).max())
    flux_rel = float(np.max(np.abs(flux - flux_fft) / np.abs(flux_fft)))
    check(flux_diff <= PFFT_FLUX_SHARE, f"{tag} flux against fft: max-abs "
          f"difference {flux_diff:.3g} of the max (elementwise "
          f"{flux_rel:.3g})")
    print(f"phase 6 {tag} slice {N_OBS}x{FIELD}^2 K=200: "
          + training_line(run) + f"; flux against phase 3 ({dial!r}): "
          f"max-abs difference {flux_diff:.3g} of the max (limit "
          f"{PFFT_FLUX_SHARE}), elementwise {flux_rel:.3g}")
    return {"launches": run["launches"], "steps_per_s": run["steps_per_s"],
            "peak_bytes": run["peak_bytes"], "flux_diff": flux_diff,
            "flux_rel": flux_rel}


def phase_pfft(torch, device, slice_, errors_fft):
    """Phases 3 and 4 with ``conv_mode="pfft"``: the convolution's
    forward and adjoint on K3's kernels, once each per step, and in the
    probe the forward, the adjoint, then the adjoint's adjoint and the
    adjoint again. Training runs twice: under the default dial
    (``"high"``, the ``"split"`` mode: the three passes on the tensor
    cores) and under ``"highest"`` (``"f32"``: the float32 kernels,
    the three passes on ``wgmma``). The probe and the small run, card
    against the CPU's plain path, run under the default dial."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    train = {dial: pfft_training(torch, device, datasets, astro,
                                 slice_[dial]["flux"], dial)
             for dial in ("high", "highest")}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = run_slice(datasets, astro, device, n_steps=ERROR_STEPS,
                       compute_error=True, cycle_spin=True, conv_mode="pfft")
    launches, plain_calls = counts()
    peak = torch.cuda.max_memory_allocated()
    expected = expect(gmm_fused_fwd_tc=ERROR_STEPS,
                      gmm_fused_bwd=ERROR_STEPS, gmm_score_rows_tc=1,
                      gmm_unit_map=1, gmm_hvp_map=1,
                      **{name: 2 * ERROR_STEPS + 4
                         for name in K3_KERNELS["split"]})
    check(launches == expected, f"pfft probe: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"pfft probe: plain versions ran {plain_calls} "
          "times")
    errors = result.components["flux"].flux_upsampled_error_numpy
    check(errors.shape == (FIELD, FIELD)
          and bool(np.isfinite(errors).all() and (errors > 0).all()),
          "pfft probe: errors not finite and positive")
    error_rel = float(np.max(np.abs(errors - errors_fft) / errors_fft))
    check(error_rel <= PFFT_ERROR_RTOL, f"pfft errors against fft: max rel "
          f"{error_rel:.3g}")
    print(f"phase 6 pfft errors ('high', split) {N_OBS}x{FIELD}^2 K=200: "
          f"{ERROR_STEPS} steps in {result.train_seconds:.4f} s, probe "
          f"{result.error_seconds:.4f} s; errors against phase 4: max rel "
          f"{error_rel:.3g} (limit {PFFT_ERROR_RTOL}); launches {launches}; "
          f"plain calls {plain_calls}; peak memory {peak} B")
    probe = {"launches": launches, "error_seconds": result.error_seconds,
             "peak_bytes": peak, "error_rel": error_rel}

    # small input (n = 256, m = 2, no padding) under the default dial:
    # the card's split kernels against the CPU's split plain path, flux
    # and errors
    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    reset_counts()
    on_card = run_slice(small, builtin, device, cycle_spin=False,
                        compute_error=True, conv_mode="pfft")
    launches, _ = counts()
    check(all(launches[name] == 2 * STEPS + 4 for name in K3_KERNELS["split"])
          and not any(launches[name] for name in K3_KERNELS["f32"]),
          f"pfft 4x128^2: launches {launches}")
    on_card = on_card.components["flux"]
    on_cpu = run_slice(small, builtin, "cpu", cycle_spin=False,
                       compute_error=True,
                       conv_mode="pfft").components["flux"]
    rels = {}
    for name, limit in (("flux_upsampled_numpy", SMALL_FLUX_RTOL),
                        ("flux_upsampled_error_numpy", SMALL_ERROR_RTOL)):
        a, b = getattr(on_card, name), getattr(on_cpu, name)
        rels[name] = float(np.max(np.abs(a - b) / np.abs(b)))
        check(rels[name] <= limit, f"pfft 4x128^2 {name} on the card vs "
              f"CPU: max rel err {rels[name]:.3g}")
    print(f"phase 6 small 4x128^2 ('high', split) card vs CPU plain path: "
          f"flux max rel err {rels['flux_upsampled_numpy']:.3g} (limit "
          f"{SMALL_FLUX_RTOL}), errors "
          f"{rels['flux_upsampled_error_numpy']:.3g} (limit "
          f"{SMALL_ERROR_RTOL})")
    return train, probe


# the share of patches whose MAP argmax the JAX package documents as
# flipping under its "default" setting on the TPU (jolideco_tpu/config.py:
# "argmax flips on ~0.5% of patches"), printed beside phase 7's
JAX_DEFAULT_FLIPS = 5e-3


def flux_share(a, b):
    """Max-abs difference of two maps as a share of the second's max."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_default(torch, device, slice_, errors, marg_train, marg_probe):
    """The dial's ``"default"`` setting (``"bf16"``: the GMM logits and
    K3's products as single bf16 products on the tensor cores): the main
    path (20 steps, fft), the marginalised path (20 steps), the pfft path
    (20 steps) and the MAP and marginalised probes (5 steps), each with
    exact counts (the bf16 kernels; the split and float32 GMM and K3
    kernels and every plain version 0), its flux (or errors) against the
    ``"high"`` run of phases 3-5 and the argmax flips of K1 bf16 against
    K1 split at its final flux, printed beside the JAX package's
    documented share; then a small run, card against the CPU's plain
    path under ``"default"``."""
    from jolideco_torch import config
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    out, fluxes = {}, {}
    for name, marginalize, conv, ref in (
            ("map", False, "fft", slice_["high"]["flux"]),
            ("marginalised", True, "fft", marg_train["high"]["flux"]),
            ("pfft", False, "pfft", slice_["high"]["flux"])):
        if marginalize:
            run = marg_training(torch, device, datasets, astro, "default",
                                phase=7)
            tag = "marginalised ('default', bf16)"
        else:
            run = dial_training(torch, device, datasets, astro, "default",
                                conv)
            tag = run["tag"]
        fluxes[name] = run["flux"]
        flips, n_valid = argmax_flips(torch, device, run["flux"], astro,
                                      marginalize, ("bf16", "split"))
        out[name] = {"launches": run["launches"],
                     "steps_per_s": run["steps_per_s"],
                     "peak_bytes": run["peak_bytes"],
                     "flux_share_from_high": flux_share(run["flux"], ref),
                     "argmax_flips": flips, "n_valid": n_valid}
        # marg_training printed its run's line
        line = (f"phase 7 {tag}" if marginalize else
                f"phase 7 {tag} slice {N_OBS}x{FIELD}^2 K=200: "
                + training_line(run))
        print(line + f"; flux against the 'high' run: max-abs difference "
              f"{out[name]['flux_share_from_high']:.3g} of the max; K1"
              f"{' lse' if marginalize else ''} bf16 against split at the "
              f"final flux: argmax differs on {flips} of {n_valid} valid "
              f"patches ({flips / n_valid:.3%}; the JAX package documents "
              f"about {JAX_DEFAULT_FLIPS:.1%} on the TPU)")
    # the two convolutions under the same dial (phase 6's bar, which
    # Adam's first step sets, holds for "high"; under "default" the
    # argmax flips of the two runs differ, so it is printed)
    out["pfft"]["flux_share_from_fft"] = flux_share(fluxes["pfft"],
                                                    fluxes["map"])
    print(f"phase 7 pfft ('default') flux against the fft run of the same "
          f"dial: max-abs difference {out['pfft']['flux_share_from_fft']:.3g}"
          f" of the max")
    for name, probe, ref in (
            ("map_probe", probe_run, errors["high"]["errors"]),
            ("marginalised_probe", marg_probe_run,
             marg_train["probe_errors_high"])):
        res = probe(torch, device, datasets, astro, "default", phase=7)
        errs = res.pop("errors")
        res["error_rel_from_high"] = float(np.max(np.abs(errs - ref)
                                                  / np.abs(ref)))
        out[name] = res
        print(f"phase 7 {name.replace('_', ' ')} ('default', bf16): errors "
              f"against the 'high' run max rel difference "
              f"{res['error_rel_from_high']:.3g}")

    # small input: the card's bf16 kernels against the CPU's bf16 plain
    # path, flux and errors
    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    saved = config.gmm_precision()
    config.set_gmm_precision("default")
    try:
        reset_counts()
        on_card = run_slice(small, builtin, device, cycle_spin=False,
                            compute_error=True)
        launches, _ = counts()
        on_cpu = run_slice(small, builtin, "cpu", cycle_spin=False,
                           compute_error=True)
    finally:
        config.set_gmm_precision(saved)
    check(launches["gmm_fused_fwd_bf16"] == STEPS
          and launches["gmm_score_rows_bf16"] == 1
          and not launches["gmm_fused_fwd_tc"], f"default 4x128^2: "
          f"launches {launches}")
    rels = {}
    for name, limit in (("flux_upsampled_numpy", SMALL_FLUX_RTOL),
                        ("flux_upsampled_error_numpy", SMALL_ERROR_RTOL)):
        a = getattr(on_card.components["flux"], name)
        b = getattr(on_cpu.components["flux"], name)
        rels[name] = float(np.max(np.abs(a - b) / np.abs(b)))
        check(rels[name] <= limit, f"default 4x128^2 {name} on the card vs "
              f"CPU: max rel err {rels[name]:.3g}")
    out["small"] = rels
    print(f"phase 7 small 4x128^2 ('default', bf16) card vs CPU plain path: "
          f"flux max rel err {rels['flux_upsampled_numpy']:.3g} (limit "
          f"{SMALL_FLUX_RTOL}), errors "
          f"{rels['flux_upsampled_error_numpy']:.3g} (limit "
          f"{SMALL_ERROR_RTOL})")
    return out


# phase 8: the default deconvolver's epochs at the main path, and the
# small run's stop: 20 epochs asked; the flat start lies above the
# small run's flux, which falls, so the validation data's total (twice
# the counts of other observations of the field) rises from the start
SEQ_EPOCHS, SMALL_STOP_EPOCHS, SMALL_N_AVERAGE, SMALL_RESUME = 20, 20, 3, 5
SMALL_TRACE_EVERY = 3
# The small run's flux on the card against the CPU, as a share of the
# max-abs (phase 6's bar, PFFT_FLUX_SHARE, for the same reason). Adam's
# steps, m / (sqrt(v) + eps), turn the float32 differences of the two
# paths (cuFFT against pocketfft, K2's sums against the plain version's)
# into different steps wherever a pixel's gradient nearly vanishes, and
# the sequential strategy's per-observation gradients cross zero more
# often than the joint one's: on an NVIDIA H100 80GB HBM3 (700 W) the
# flux parted by 1.2e-4 (elementwise) after one epoch at 4 x 128^2,
# 1.43e-4 (9.8e-5 of the max-abs) after nine, the same under every
# dial, while the trace stayed within 4.6e-5 and the errors 5.1e-6:
# those keep phase 3's bars, the flux is held here and its elementwise
# difference printed.
SEQ_FLUX_SHARE = 1e-3


def brighter(datasets, factor, seed):
    """The datasets with Poisson counts of ``factor`` times theirs."""
    rs = np.random.RandomState(seed)
    return {name: {**d, "counts": rs.poisson(factor * d["counts"])
                   .astype(np.float32)} for name, d in datasets.items()}


def small_default_runs(device):
    """Phase 8's small run on ``device``: the default deconvolver at 4 x
    128^2 (``builtin-8x8-v1``, cycle spin) with ``trace_every=3``,
    validation data and ``stop_early``, then ``resume_from`` its result
    for 5 more epochs with ``compute_error=True``."""
    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
    )
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    validation = brighter(make_datasets(n_obs=2, size=128, psf_size=9,
                                        seed=2), 2.0, seed=3)
    component = SpatialFluxComponent.from_numpy(
        np.ones((128, 128), np.float32),
        prior=GMMPatchPrior(gmm=builtin, stride=4, cycle_spin=True))
    first = MAPDeconvolver(
        n_epochs=SMALL_STOP_EPOCHS, trace_every=SMALL_TRACE_EVERY,
        stop_early=True, stop_early_n_average=SMALL_N_AVERAGE, device=device,
    ).run(small, datasets_validation=validation, components=component)
    second = MAPDeconvolver(
        n_epochs=SMALL_RESUME, trace_every=SMALL_TRACE_EVERY,
        compute_error=True, device=device,
    ).run(small, datasets_validation=validation,
          components=first.components.copy(), resume_from=first)
    return first, second


def max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_default_entry(torch, device, card):
    """Phase 8, the default entry point: ``MAPDeconvolver(n_epochs=20)``
    with every other keyword at its default (``"sequential"``,
    ``trace_every=1``, ``display_progress=True``, the card) at the main
    path, counts set to zero just before and read just after: K1 split
    20 x (10 + 1) times (a step per observation and the trace row's
    forward each epoch), K2 20 x 10 times, every other kernel and plain
    version never; twenty finite trace rows, the data term lower at the
    last than at the first. Then the small run on the card against the
    CPU's plain path: the same stop, trace and errors within phase 3's
    bars, flux within ``SEQ_FLUX_SHARE`` of its max-abs."""
    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
        config,
    )
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    check(config.gmm_precision() == "high", "phase 8 runs the default dial")
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)

    def component():
        prior = GMMPatchPrior(gmm=astro, stride=4, cycle_spin=True)
        return SpatialFluxComponent.from_numpy(
            np.ones((FIELD, FIELD), np.float32), prior=prior)

    MAPDeconvolver(n_epochs=1).run(datasets, components=component())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = MAPDeconvolver(n_epochs=SEQ_EPOCHS).run(datasets,
                                                     components=component())
    launches, plain_calls = counts()
    peak = torch.cuda.max_memory_allocated()
    check(result.config["update_strategy"] == "sequential"
          and result.config["trace_every"] == 1
          and result.config["display_progress"], "phase 8: not the defaults")
    n_steps = SEQ_EPOCHS * N_OBS
    expected = expect(**{K1_KERNELS[config.gmm_mode()]: SEQ_EPOCHS
                         * (N_OBS + 1), "gmm_fused_bwd": n_steps})
    check(launches == expected, f"phase 8: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"phase 8: plain versions ran {plain_calls} "
          "times")
    trace = result.trace_loss
    names = trace.colnames[:-1]
    rows = np.array([trace[name] for name in names]).T
    data = trace["datasets-total"]
    check(rows.shape == (SEQ_EPOCHS, 3 + 1 + N_OBS)
          and bool(np.isfinite(rows).all()), f"phase 8: trace {rows.shape}"
          f" not {SEQ_EPOCHS} finite rows")
    check(data[-1] < data[0], f"phase 8: data term did not fall: "
          f"{data[0]} -> {data[-1]}")
    loss, flux = result.loss_per_step, result.flux_upsampled_total
    check(loss.shape == (n_steps,) and bool(np.isfinite(loss).all()),
          "phase 8: non-finite step losses")
    check(bool(np.isfinite(flux).all() and (flux > 0).all()),
          "phase 8: flux not finite and positive")
    out = {"epochs_per_s": SEQ_EPOCHS / result.train_seconds,
           "steps_per_s": n_steps / result.train_seconds,
           "train_seconds": result.train_seconds, "launches": launches,
           "plain_calls": plain_calls, "peak_bytes": peak,
           "total": [float(trace["total"][0]), float(trace["total"][-1])],
           "data_term": [float(data[0]), float(data[-1])], "card": card}
    print(f"phase 8 MAPDeconvolver(n_epochs={SEQ_EPOCHS}) defaults "
          f"(sequential, trace_every=1) {N_OBS}x{FIELD}^2 K=200 on {card}: "
          f"{out['epochs_per_s']:.3f} epochs/s, {out['steps_per_s']:.3f} "
          f"optimiser steps/s ({result.train_seconds:.4f} s); trace total "
          f"{out['total'][0]:.6f} -> {out['total'][1]:.6f}, data term "
          f"{data[0]:.6f} -> {data[-1]:.6f}; launches {launches}; plain "
          f"calls {plain_calls}; peak memory {peak} B")

    reset_counts()
    on_card = small_default_runs(device)
    launches, _ = counts()
    on_cpu = small_default_runs("cpu")
    check(launches[K1_KERNELS[config.gmm_mode()]] > 0
          and launches["gmm_score_rows_tc"] == 1, f"phase 8 small: "
          f"launches {launches}")
    stops = [run[0].n_epochs for run in (on_card, on_cpu)]
    check(stops[0] == stops[1] < SMALL_STOP_EPOCHS, f"phase 8 small: "
          f"stopped after {stops} epochs (card, CPU) of {SMALL_STOP_EPOCHS}")
    shares = {tag: flux_share(on_card[i].flux_upsampled_total,
                              on_cpu[i].flux_upsampled_total)
              for i, tag in enumerate(("flux_stop", "flux_resumed"))}
    for tag, share in shares.items():
        check(share <= SEQ_FLUX_SHARE, f"phase 8 small {tag} on the card vs "
              f"CPU: max-abs difference {share:.3g} of the max (limit "
              f"{SEQ_FLUX_SHARE})")
    rels = {tag: max_rel(on_card[i].flux_upsampled_total,
                         on_cpu[i].flux_upsampled_total)
            for i, tag in enumerate(("flux_stop", "flux_resumed"))}
    for i, tag in enumerate(("trace_stop", "trace_resumed")):
        a, b = on_card[i].trace_loss, on_cpu[i].trace_loss
        check(a.colnames == b.colnames and len(a) == len(b) > 0,
              f"phase 8 small {tag}: traces differ in shape")
        rels[tag] = max(max_rel(a[n], b[n]) for n in a.colnames[:-1])
    rels["errors"] = max_rel(
        on_card[1].components["flux"].flux_upsampled_error_numpy,
        on_cpu[1].components["flux"].flux_upsampled_error_numpy)
    for tag, rel in rels.items():
        limit = SMALL_ERROR_RTOL if tag == "errors" else SMALL_FLUX_RTOL
        check(tag.startswith("flux") or rel <= limit, f"phase 8 small {tag} "
              f"on the card vs CPU: max rel err {rel:.3g} (limit {limit})")
    out["small"] = {**rels, **{f"{k}_share": v for k, v in shares.items()},
                    "stopped_after": stops[0]}
    print(f"phase 8 small 4x128^2 (trace_every={SMALL_TRACE_EVERY}, "
          f"stop_early, then {SMALL_RESUME} epochs resumed with "
          f"compute_error) card vs CPU plain path: both stopped after "
          f"{stops[0]} of {SMALL_STOP_EPOCHS} epochs; flux max-abs "
          "difference " + ", ".join(f"{k} {v:.3g}" for k, v in shares.items())
          + f" of the max (limit {SEQ_FLUX_SHARE}); max rel err "
          + ", ".join(f"{k} {v:.3g}" for k, v in rels.items())
          + f" (trace limit {SMALL_FLUX_RTOL}, errors {SMALL_ERROR_RTOL})")
    return out


# Phase 9: upsampled fluxes and per-observation calibrations. The main
# path's data at a x2 component (a 2048^2 log-flux from the data's mean
# estimate) with one NPredCalibration per observation, the first one's
# shift frozen (examples/chandra_e0102_like.py:222-226).
UPS_FACTOR, UPS_STEPS, UPS_ERROR_STEPS, UPS_EPOCHS = 2, 20, 5, 5
# the joint run is timed UPS_REPEATS times: steps/s is their median
UPS_REPEATS = 3
UPS_SMALL = 128
# The small runs, card against the CPU's plain path, under cycle spin
# (the same shifts: the generator is the CPU's on both) and trained
# shifts. Flux within SEQ_FLUX_SHARE of its max-abs (phase 8's bar, for
# its reason: Adam's steps part the two paths' float32 rounding where a
# pixel's gradient nearly vanishes, and a MAP argmax near a tie turns
# that into a different step), its elementwise difference printed;
# errors within SMALL_ERROR_RTOL (phase 4's bar). The calibrations'
# trained values within UPS_CAL_ATOL: the flux maps' bar, rtol 1e-4
# (SMALL_FLUX_RTOL), taken of a shift of order one data pixel and of a
# log norm of order one.
UPS_CAL_ATOL = 1e-4


def upsampled_inputs(datasets, gmm, cycle_spin=True):
    """The x2 component from the datasets' mean flux estimate, and one
    calibration per dataset, the first one's shift frozen."""
    from jolideco_torch import (
        GMMPatchPrior,
        NPredCalibration,
        NPredCalibrations,
        SpatialFluxComponent,
    )

    component = SpatialFluxComponent.from_flux_init_datasets(
        list(datasets.values()), upsampling_factor=UPS_FACTOR,
        prior=GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=cycle_spin))
    calibrations = NPredCalibrations({
        name: NPredCalibration(frozen_shift=idx == 0)
        for idx, name in enumerate(datasets)})
    return component, calibrations


def upsampled_run(datasets, gmm, device, n_epochs, compute_error=False,
                  conv_mode="fft", update_strategy="joint", trace_every=0):
    from jolideco_torch import MAPDeconvolver

    component, calibrations = upsampled_inputs(datasets, gmm)
    deco = MAPDeconvolver(
        n_epochs=n_epochs, learning_rate=0.1, update_strategy=update_strategy,
        conv_mode=conv_mode, trace_every=trace_every, seed=0, device=device,
        compute_error=compute_error)
    return deco.run(datasets, components=component, calibrations=calibrations)


def calibration_arrays(result):
    """The trained shifts ``(N, 2)`` and log norms ``(N,)`` on the host."""
    cals = result.calibrations.values()
    return (np.concatenate([c.shift_xy.cpu().numpy() for c in cals]),
            np.concatenate([c._background_norm.cpu().numpy() for c in cals]))


def check_calibrations(torch, tag, result):
    """Every trained shift and norm finite; the frozen shift equal to its
    initial value bit for bit."""
    shifts, log_norms = calibration_arrays(result)
    check(bool(np.isfinite(shifts).all() and np.isfinite(log_norms).all()),
          f"{tag}: calibrations not finite: {shifts} {log_norms}")
    first = next(iter(result.calibrations))
    frozen = result.calibrations[first].shift_xy.cpu()
    check(torch.equal(frozen, result.calibrations_init[first].shift_xy.cpu()),
          f"{tag}: the frozen shift moved: {frozen}")
    return shifts, log_norms


def upsampled_small_runs(device):
    """Phase 9's small runs on ``device``: 4 x 128^2 counts of a field
    seen at known sub-pixel offsets, the x2 component and calibrations,
    ``builtin-8x8-v1`` with cycle spin, 20 epochs with the flux-error
    probe: joint, sequential (``trace_every=1``) and joint with
    ``conv_mode="pfft"``."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_shifted_datasets

    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_shifted_datasets(size=UPS_SMALL, psf_size=9, seed=1)
    return {
        "joint": upsampled_run(small, builtin, device, STEPS,
                               compute_error=True),
        "sequential": upsampled_run(small, builtin, device, STEPS,
                                    compute_error=True,
                                    update_strategy="sequential",
                                    trace_every=1),
        "pfft": upsampled_run(small, builtin, device, STEPS,
                              compute_error=True, conv_mode="pfft"),
    }


def phase_upsampled(torch, device, card):
    """Phase 9: the x2 component and the calibrations through the joint
    strategy (20 steps, exact counts, UPS_REPEATS times), K1 split and K2
    at the trained 2048^2 flux against their plain versions, the probe (5
    steps), the quick-start entry point (5 epochs of the defaults), then
    the small runs, card against the CPU's plain path."""
    from jolideco_torch import MAPDeconvolver, config
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL
    from jolideco_torch.utils.bench_data import make_datasets

    check(config.gmm_precision() == "high", "phase 9 runs the default dial")
    mode = config.gmm_mode()
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    up = UPS_FACTOR * FIELD
    label = f"{N_OBS}x{FIELD}^2 x{UPS_FACTOR} (flux {up}^2)"
    out = {"card": card}

    # 1. the joint run
    upsampled_run(datasets, astro, device, 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, result = [], None
    for _ in range(UPS_REPEATS):
        reset_counts()
        result = upsampled_run(datasets, astro, device, UPS_STEPS)
        launches, plain_calls = counts()
        expected = expect(gmm_fused_bwd=UPS_STEPS,
                          **{K1_KERNELS[mode]: UPS_STEPS})
        check(launches == expected, f"phase 9 joint: launches {launches}, "
              f"not {expected}")
        check(plain_calls == 0, f"phase 9 joint: plain versions ran "
              f"{plain_calls} times")
        rates.append(UPS_STEPS / result.train_seconds)
    peak = torch.cuda.max_memory_allocated()
    loss, flux = result.loss_per_step, result.flux_upsampled_total
    # The total falls over the run. The first Adam step, 0.1 on every
    # log-flux pixel, takes the noisy start estimate away from the patch
    # prior's modes, so the total rises at that step (in the JAX package
    # too) before it falls (printed).
    check(loss.shape == (UPS_STEPS,) and bool(np.isfinite(loss).all())
          and loss[-1] < loss[0], f"phase 9 joint: losses not finite and "
          f"falling: total {loss[0]}, {loss[1]} -> {loss[-1]}")
    check(flux.shape == (up, up) and bool(np.isfinite(flux).all()
                                          and (flux > 0).all()),
          "phase 9 joint: flux not finite and positive")
    shifts, log_norms = check_calibrations(torch, "phase 9 joint", result)
    out["joint"] = {
        "launches": launches, "plain_calls": plain_calls,
        "steps_per_s": float(np.median(rates)),
        "steps_per_s_repeats": rates,
        "steps_per_s_spread": float(max(rates) - min(rates)),
        "peak_bytes": peak,
        "loss": [float(loss[0]), float(loss[1]), float(loss[-1])],
        "shift_max_abs": float(np.abs(shifts).max()),
        "background_norms": np.exp(log_norms).tolist()}
    print(f"phase 9 joint {label} K=200 ('high', K1 {mode}) on {card}: "
          f"{out['joint']['steps_per_s']:.3f} steps/s (median of "
          f"{UPS_REPEATS}: {', '.join(f'{r:.3f}' for r in rates)}; spread "
          f"{out['joint']['steps_per_s_spread']:.3f}); loss {loss[0]:.6f}, "
          f"{loss[1]:.6f} -> {loss[-1]:.6f}; shifts max-abs "
          f"{np.abs(shifts).max():.4g} px, frozen shift unmoved; launches "
          f"{launches}; plain calls "
          f"{plain_calls}; peak memory {peak} B")

    # 2. K1 split and K2 at the trained flux: 262,144 patches
    image = torch.as_tensor(np.ascontiguousarray(flux, np.float32),
                            device=device)
    bufs = astro.kernel_buffers(device)
    fp32_plain = gf.fused_forward_plain(image, bufs, 4, ZERO_FLUX_SENTINEL)
    # At the trained flux some patches' best logits are much cancelled
    # sums (their magnitudes many times their value: printed), so the
    # values are held as phase 2 holds cancelled_gmm(): against the exact
    # sum over the products' magnitudes (K1_SPLIT_SUM_ERR_FLUX), and
    # against float64
    out["k1_split"] = k1_split_checks(
        torch, f"{up}x{up} trained (phase 9)", image, bufs, fp32_plain,
        relative=False, timed=True, sum_err_limit=K1_SPLIT_SUM_ERR_FLUX)
    out["k2"] = k2_tile_components(torch, device, flux, astro)
    print(f"phase 9 K2 at the trained {up}^2 flux: "
          f"{k2_case_line(out['k2'])}")

    # 3. the probe
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = upsampled_run(datasets, astro, device, UPS_ERROR_STEPS,
                           compute_error=True)
    launches, plain_calls = counts()
    peak = torch.cuda.max_memory_allocated()
    expected = expect(gmm_fused_bwd=UPS_ERROR_STEPS, gmm_unit_map=1,
                      gmm_hvp_map=1, **{K1_KERNELS[mode]: UPS_ERROR_STEPS,
                                        K5_KERNELS[mode]: 1})
    check(launches == expected, f"phase 9 probe: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"phase 9 probe: plain versions ran "
          f"{plain_calls} times")
    errors = result.components["flux"].flux_upsampled_error_numpy
    check(errors.shape == (up, up) and bool(np.isfinite(errors).all()
                                            and (errors > 0).all()),
          "phase 9 probe: errors not finite and positive")
    check_calibrations(torch, "phase 9 probe", result)
    out["probe"] = {"launches": launches, "plain_calls": plain_calls,
                    "error_seconds": result.error_seconds,
                    "peak_bytes": peak,
                    "errors": [float(errors.min()), float(errors.max())]}
    print(f"phase 9 probe {label} ('high', K5 {mode}) on {card}: "
          f"{UPS_ERROR_STEPS} steps, probe {result.error_seconds:.4f} s; "
          f"errors {errors.min():.6g} .. {errors.max():.6g}; launches "
          f"{launches}; plain calls {plain_calls}; peak memory {peak} B")

    # 4. the quick-start entry point: every other keyword at its default
    component, calibrations = upsampled_inputs(datasets, astro)
    MAPDeconvolver(n_epochs=1).run(datasets, components=component,
                                   calibrations=calibrations)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    component, calibrations = upsampled_inputs(datasets, astro)
    reset_counts()
    result = MAPDeconvolver(n_epochs=UPS_EPOCHS).run(
        datasets, components=component, calibrations=calibrations)
    launches, plain_calls = counts()
    peak = torch.cuda.max_memory_allocated()
    expected = expect(**{K1_KERNELS[mode]: UPS_EPOCHS * (N_OBS + 1),
                         "gmm_fused_bwd": UPS_EPOCHS * N_OBS})
    check(launches == expected, f"phase 9 sequential: launches {launches}, "
          f"not {expected}")
    check(plain_calls == 0, f"phase 9 sequential: plain versions ran "
          f"{plain_calls} times")
    trace = result.trace_loss
    rows = np.array([trace[name] for name in trace.colnames[:-1]]).T
    check(rows.shape == (UPS_EPOCHS, 3 + 1 + N_OBS)
          and bool(np.isfinite(rows).all()), f"phase 9 sequential: trace "
          f"{rows.shape} not {UPS_EPOCHS} finite rows")
    check_calibrations(torch, "phase 9 sequential", result)
    n_steps = UPS_EPOCHS * N_OBS
    out["sequential"] = {
        "launches": launches, "plain_calls": plain_calls,
        "epochs_per_s": UPS_EPOCHS / result.train_seconds,
        "steps_per_s": n_steps / result.train_seconds, "peak_bytes": peak,
        "total": [float(trace["total"][0]), float(trace["total"][-1])]}
    print(f"phase 9 MAPDeconvolver(n_epochs={UPS_EPOCHS}) defaults "
          f"(sequential, trace_every=1) {label} on {card}: "
          f"{out['sequential']['epochs_per_s']:.3f} epochs/s, "
          f"{out['sequential']['steps_per_s']:.3f} optimiser steps/s; trace "
          f"total {trace['total'][0]:.6f} -> {trace['total'][-1]:.6f}; "
          f"launches {launches}; plain calls {plain_calls}; peak memory "
          f"{peak} B")

    # 5. the small runs, card against the CPU's plain path
    reset_counts()
    on_card = upsampled_small_runs(device)
    launches, _ = counts()
    check(launches[K1_KERNELS[mode]] > 0 and all(
        launches[name] > 0 for name in K3_KERNELS[config.pfft_mode()]),
        f"phase 9 small: launches {launches}")
    on_cpu = upsampled_small_runs("cpu")
    small = {}
    for case in on_card:
        a, b = on_card[case], on_cpu[case]
        flux_a, flux_b = a.flux_upsampled_total, b.flux_upsampled_total
        err_a, err_b = (r.components["flux"].flux_upsampled_error_numpy
                        for r in (a, b))
        cal_a, cal_b = calibration_arrays(a), calibration_arrays(b)
        res = {"flux_share": flux_share(flux_a, flux_b),
               "flux_rel": max_rel(flux_a, flux_b),
               "errors_rel": max_rel(err_a, err_b),
               "shift_abs": float(np.abs(cal_a[0] - cal_b[0]).max()),
               "log_norm_abs": float(np.abs(cal_a[1] - cal_b[1]).max())}
        check(res["flux_share"] <= SEQ_FLUX_SHARE, f"phase 9 small {case}: "
              f"flux max-abs difference {res['flux_share']:.3g} of the max "
              f"(limit {SEQ_FLUX_SHARE})")
        check(res["errors_rel"] <= SMALL_ERROR_RTOL, f"phase 9 small "
              f"{case}: errors max rel err {res['errors_rel']:.3g} (limit "
              f"{SMALL_ERROR_RTOL})")
        check(max(res["shift_abs"], res["log_norm_abs"]) <= UPS_CAL_ATOL,
              f"phase 9 small {case}: calibrations differ by "
              f"{res['shift_abs']:.3g} px and {res['log_norm_abs']:.3g} "
              f"(limit {UPS_CAL_ATOL})")
        if case == "sequential":
            res["trace_rel"] = max(
                max_rel(a.trace_loss[n], b.trace_loss[n])
                for n in a.trace_loss.colnames[:-1])
            check(res["trace_rel"] <= SMALL_FLUX_RTOL, f"phase 9 small "
                  f"sequential: trace max rel err {res['trace_rel']:.3g}")
        small[case] = res
    out["small"] = small
    print(f"phase 9 small 4x{UPS_SMALL}^2 x{UPS_FACTOR} calibrated card vs "
          "CPU plain path: " + "; ".join(
              f"{case} flux {r['flux_share']:.3g} of the max (elementwise "
              f"{r['flux_rel']:.3g}), errors {r['errors_rel']:.3g}, shifts "
              f"{r['shift_abs']:.3g} px, log norms {r['log_norm_abs']:.3g}"
              + (f", trace {r['trace_rel']:.3g}" if "trace_rel" in r else "")
              for case, r in small.items())
          + f" (limits {SEQ_FLUX_SHARE} of the max, {SMALL_ERROR_RTOL}, "
          f"{UPS_CAL_ATOL}, trace {SMALL_FLUX_RTOL})")
    return out


# phase 10: the rest of the prior layer at the main path's width
PRIOR_STEPS, PRIOR_WARMUP, PRIOR_EPOCHS, LEVELS = 20, 2, 5, 3
# (f): the small runs' flux on the card against the CPU within
# SEQ_FLUX_SHARE of its max-abs (phase 6's bar, for Adam's first step,
# which turns float32 differences into other steps where a pixel's
# gradient nearly vanishes; under jitter the card's patch gather adds
# its gradient with atomics, in no fixed order), the trained prior
# leaves (level log weights, the asinh norm's alpha and beta, of order
# one) within PRIOR_LEAF_ATOL
PRIOR_LEAF_ATOL = 1e-4
PARAMETRIC = ("smooth", "lira", "inverse-gamma", "exponential", "image")


def prior_leaf_values(prior):
    """The prior's trainable leaves, flattened in the optimiser's order
    (keys sorted at every level), as host numbers."""
    def flat(tree):
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                yield from flat(value)
            else:
                yield from value.detach().cpu().numpy().ravel().tolist()

    return list(flat(prior.parameters()))


def prior_run(datasets, prior, device, n_steps, compute_error=False,
              estimate=False):
    """``n_steps`` joint steps under ``prior`` from a flux of ones, or
    with ``estimate`` from the data's mean estimate."""
    from jolideco_torch import MAPDeconvolver, SpatialFluxComponent

    size = next(iter(datasets.values()))["counts"].shape
    if estimate:
        component = SpatialFluxComponent.from_flux_init_datasets(
            list(datasets.values()), prior=prior)
    else:
        component = SpatialFluxComponent.from_numpy(
            np.ones(size, np.float32), prior=prior)
    deco = MAPDeconvolver(
        n_epochs=n_steps, learning_rate=0.1, update_strategy="joint",
        trace_every=0, seed=0, device=device, compute_error=compute_error)
    return deco.run(datasets, components=component)


def device_tensors(obj, seen=None):
    """Every tensor a prior holds (its norms', wrapped priors' and GMM
    buffers' too), with where it was found."""
    import torch

    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif type(obj).__module__.startswith("jolideco_torch"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for item in items for t in device_tensors(item, seen)]


def check_prior_on(tag, prior, device):
    tensors = device_tensors(prior)
    off = [tuple(t.shape) for t in tensors if t.device != device]
    check(not off, f"{tag}: prior tensors off {device}: {off}")
    return len(tensors)


def prior_training(torch, device, datasets, tag, prior, expected,
                   n_steps=PRIOR_STEPS):
    """A warm-up, then ``n_steps`` joint steps under a fresh ``prior()``,
    counts set to zero just before and read just after; exact counts,
    finite falling losses, every prior tensor on the card."""
    prior_run(datasets, prior(), device, PRIOR_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = prior()
    before = prior_leaf_values(model)
    reset_counts()
    result = prior_run(datasets, model, device, n_steps)
    launches, plain_calls = counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == expected, f"phase 10 {tag}: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"phase 10 {tag}: plain versions ran "
          f"{plain_calls} times")
    loss, flux = result.loss_per_step, result.flux_upsampled_total
    # the data term at the start and the end, printed: neither it nor
    # the total need fall (a flat start is the GMM prior's most likely
    # image, and a strong prior trades data fit for its own term)
    data = (data_term(datasets, np.ones_like(flux), device),
            data_term(datasets, flux, device))
    check(loss.shape == (n_steps,) and bool(np.isfinite(loss).all())
          and bool(np.isfinite(data).all()), f"phase 10 {tag}: losses "
          f"{loss[0]} -> {loss[-1]}, data term {data[0]} -> {data[1]}")
    check(bool(np.isfinite(flux).all() and (flux > 0).all()),
          f"phase 10 {tag}: flux not finite and positive")
    n_tensors = check_prior_on(f"phase 10 {tag}",
                               result.components["flux"].prior, device)
    return {"launches": launches, "plain_calls": plain_calls,
            "steps_per_s": n_steps / result.train_seconds,
            "peak_bytes": peak, "loss": [float(loss[0]), float(loss[-1])],
            "data_term": list(data), "leaves_before": before,
            "leaves_after": prior_leaf_values(result.components["flux"]
                                              .prior),
            "prior_tensors": n_tensors, "result": result}


def prior_small_runs(device):
    """(f): configurations (a) and (b) at 4 x 128^2, 20 joint steps from
    the data's mean estimate. Not from a flat flux: its patches are flat,
    and the multiscale smoothing's float32 rounding (cuFFT's against the
    CPU's FFT) gives them a structure of 1e-7 that decides the MAP
    argmaxes: on the CPU a perturbation of 1e-6 of a flat start parts
    two runs by 0.31 (multiscale) and 0.43 (jitter) of the flux's max
    within 5 steps, of the data estimate by 1.5e-6 and 1.4e-6
    (``python tests/test_torch_multiscale.py``)."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets
    from jolideco_torch.utils.profile_step import make_prior

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    small = make_datasets(n_obs=4, size=128, psf_size=9, seed=1)
    runs = {}
    for kind in ("multiscale", "jitter"):
        result = prior_run(small, make_prior(kind, astro), device,
                           PRIOR_STEPS, estimate=True)
        runs[kind] = (result.flux_upsampled_total,
                      np.array(prior_leaf_values(
                          result.components["flux"].prior)))
    return runs


def phase_priors(torch, device, card):
    """Phase 10: (a) MultiScalePrior over three levels under an asinh
    norm, 20 joint steps (K1 split and K2 at 1024², 512² and 256² each
    step) and its probe (K5 split, K6, K7 once a level); (b) jitter, 20
    joint steps (K5 split and K6 a step); (c) one offset class of the
    marginalised prior, 20 joint steps (K5 lse split and K8 split a
    step); (d) the first example's prior under MAPDeconvolver()'s
    defaults (K1 split 11 and K2 10 an epoch); (e) the parametric priors
    (no GMM kernel); (f) (a) and (b) at 4 x 128^2, card against CPU."""
    from jolideco_torch import (
        GMMPatchPrior,
        ImagePrior,
        InverseGammaPrior,
        LIRAPrior,
        MAPDeconvolver,
        MaxImageNorm,
        SpatialFluxComponent,
        config,
    )
    from jolideco_torch.priors import ExponentialPrior, GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets
    from jolideco_torch.utils.profile_step import make_prior

    check(config.gmm_precision() == "high", "phase 10 runs the default dial")
    mode = config.gmm_mode()
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    label = f"{N_OBS}x{FIELD}^2 K=200"
    out = {"card": card}

    # (a) multiscale: training, then the probe
    run = prior_training(
        torch, device, datasets, "(a) multiscale",
        lambda: make_prior("multiscale", astro),
        expect(gmm_fused_bwd=LEVELS * PRIOR_STEPS,
               **{K1_KERNELS[mode]: LEVELS * PRIOR_STEPS}))
    prior = run.pop("result").components["flux"].prior
    before, after = run["leaves_before"], run["leaves_after"]
    moved = float(np.abs(np.subtract(after, before)).max())
    # fault 2: the trained leaves are in the result's prior
    held = [float(v) for v in prior._log_weights.cpu().numpy()] + [
        prior.prior.norm.alpha, prior.prior.norm.beta]
    check(moved > 1e-3 and np.allclose(held, after, rtol=0, atol=0),
          f"phase 10 (a): leaves {before} -> {after}, prior holds {held}")
    run["weights"] = prior.weights.cpu().numpy().tolist()
    out["multiscale"] = run
    print(f"phase 10 (a) MultiScalePrior({LEVELS} levels, asinh) joint "
          f"{label} on {card}: {run['steps_per_s']:.3f} steps/s; loss "
          f"{run['loss'][0]:.6f} -> {run['loss'][1]:.6f}, data term "
          f"{run['data_term'][0]:.6f} -> {run['data_term'][1]:.6f}; level "
          f"weights "
          f"{np.round(np.exp(before[:LEVELS]) / np.exp(before[:LEVELS]).sum(), 6).tolist()} "
          f"-> {np.round(run['weights'], 6).tolist()}, asinh alpha, beta "
          f"{before[LEVELS:]} -> {after[LEVELS:]} (the result's prior holds "
          f"them); launches {run['launches']}; plain calls "
          f"{run['plain_calls']}; {run['prior_tensors']} prior tensors on "
          f"the card; peak memory {run['peak_bytes']} B")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = prior_run(datasets, make_prior("multiscale", astro), device,
                       ERROR_STEPS, compute_error=True)
    launches, plain_calls = counts()
    expected = expect(gmm_fused_bwd=LEVELS * ERROR_STEPS, gmm_unit_map=LEVELS,
                      gmm_hvp_map=LEVELS,
                      **{K1_KERNELS[mode]: LEVELS * ERROR_STEPS,
                         K5_KERNELS[mode]: LEVELS})
    check(launches == expected and plain_calls == 0, f"phase 10 (a) probe: "
          f"launches {launches}, not {expected}; plain calls {plain_calls}")
    # sqrt(1 / (H 1)): under the asinh norm the prior's part of H 1 is
    # negative at some pixels (the norm's Jacobian varies over a patch,
    # so the ones tangent is no longer a flat patch), where the error is
    # NaN; the JAX package's H 1 is the same (tests/test_torch_multiscale
    # .py::test_multiscale_probe). The others are finite and positive.
    errors = result.components["flux"].flux_upsampled_error_numpy
    defined = errors[~np.isnan(errors)]
    check(defined.size > 0 and bool(np.isfinite(defined).all()
                                    and (defined > 0).all()),
          "phase 10 (a) probe: errors not finite and positive where H 1 > 0")
    out["multiscale_probe"] = {
        "launches": launches, "error_seconds": result.error_seconds,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "errors": [float(defined.min()), float(defined.max())],
        "nan_share": float(np.isnan(errors).mean())}
    print(f"phase 10 (a) probe: {ERROR_STEPS} steps, probe "
          f"{result.error_seconds:.4f} s over {LEVELS} levels; errors "
          f"{defined.min():.6g} .. {defined.max():.6g} (NaN, where H 1 < 0, "
          f"at {np.isnan(errors).mean():.4f} of the pixels); launches "
          f"{launches}")

    # (b) jitter and (c) one offset class, marginalised
    for key, tag, kind, marginalize, expected in (
            ("jitter", "(b) jitter", "jitter", False,
             expect(gmm_unit_map=PRIOR_STEPS,
                    **{K5_KERNELS[mode]: PRIOR_STEPS})),
            ("group", "(c) patch_fraction=0.25 marginalised", "group", True,
             expect(gmm_score_rows_marg_tc=PRIOR_STEPS,
                    gmm_unit_marg_tc=PRIOR_STEPS))):
        run = prior_training(
            torch, device, datasets, tag,
            lambda kind=kind, m=marginalize: make_prior(kind, astro, m),
            expected)
        run.pop("result")
        out[key] = run
        print(f"phase 10 {tag} joint {label} on {card}: "
              f"{run['steps_per_s']:.3f} steps/s; loss {run['loss'][0]:.6f} "
              f"-> {run['loss'][1]:.6f}, data term {run['data_term'][0]:.6f} "
              f"-> {run['data_term'][1]:.6f}; launches {run['launches']}; plain "
              f"calls {run['plain_calls']}; peak memory "
              f"{run['peak_bytes']} B")

    # (d) the first example's prior under the default deconvolver
    def example_component():
        prior = GMMPatchPrior(gmm=astro, norm=MaxImageNorm(),
                              cycle_spin_subpix=True)
        return SpatialFluxComponent.from_numpy(
            np.ones((FIELD, FIELD), np.float32), prior=prior)

    MAPDeconvolver(n_epochs=1).run(datasets, components=example_component())
    torch.cuda.synchronize()
    reset_counts()
    result = MAPDeconvolver(n_epochs=PRIOR_EPOCHS).run(
        datasets, components=example_component())
    launches, plain_calls = counts()
    expected = expect(**{K1_KERNELS[mode]: PRIOR_EPOCHS * (N_OBS + 1),
                         "gmm_fused_bwd": PRIOR_EPOCHS * N_OBS})
    check(launches == expected and plain_calls == 0, f"phase 10 (d): "
          f"launches {launches}, not {expected}; plain calls {plain_calls}")
    total = result.trace_loss["total"]
    check(len(total) == PRIOR_EPOCHS and bool(np.isfinite(total).all()),
          f"phase 10 (d): trace {list(total)}")
    out["example"] = {"launches": launches,
                      "epochs_per_s": PRIOR_EPOCHS / result.train_seconds,
                      "total": [float(total[0]), float(total[-1])]}
    print(f"phase 10 (d) MAPDeconvolver(n_epochs={PRIOR_EPOCHS}) defaults "
          f"under GMMPatchPrior(norm=MaxImageNorm(), cycle_spin_subpix=True) "
          f"{label} on {card}: {out['example']['epochs_per_s']:.3f} "
          f"epochs/s; trace total {total[0]:.6f} -> {total[-1]:.6f}; "
          f"launches {launches}")

    # (e) the parametric priors: no GMM kernel, every tensor on the card
    makers = {
        "smooth": lambda: make_prior("smooth", astro),
        "lira": lambda: LIRAPrior(alphas=(2.0, 2.0, 2.0)),
        "inverse-gamma": InverseGammaPrior,
        "exponential": ExponentialPrior,
        "image": lambda: ImagePrior(np.ones((1, 1, FIELD, FIELD),
                                            np.float32)),
    }
    out["parametric"] = {}
    for name in PARAMETRIC:
        run = prior_training(torch, device, datasets, f"(e) {name}",
                             makers[name], expect(), n_steps=ERROR_STEPS)
        run.pop("result")
        out["parametric"][name] = run
    print(f"phase 10 (e) parametric priors {label} on {card}, "
          f"{ERROR_STEPS} joint steps each, no GMM kernel launched: " +
          "; ".join(f"{name} {run['steps_per_s']:.3f} steps/s, loss "
                    f"{run['loss'][0]:.6g} -> {run['loss'][1]:.6g}, "
                    f"{run['prior_tensors']} prior tensors on the card"
                    for name, run in out["parametric"].items()))

    # (f) the small runs, card against the CPU's plain path
    on_card, on_cpu = prior_small_runs(device), prior_small_runs("cpu")
    out["small"] = {}
    for kind in on_card:
        (flux_a, leaves_a), (flux_b, leaves_b) = on_card[kind], on_cpu[kind]
        res = {"flux_share": flux_share(flux_a, flux_b),
               "flux_rel": max_rel(flux_a, flux_b),
               "leaves_abs": float(np.abs(leaves_a - leaves_b).max())
               if leaves_a.size else 0.0}
        check(res["flux_share"] <= SEQ_FLUX_SHARE
              and res["leaves_abs"] <= PRIOR_LEAF_ATOL,
              f"phase 10 (f) {kind}: flux {res['flux_share']:.3g} of the max "
              f"(limit {SEQ_FLUX_SHARE}), leaves {res['leaves_abs']:.3g} "
              f"(limit {PRIOR_LEAF_ATOL})")
        out["small"][kind] = res
    print("phase 10 (f) small 4x128^2 card vs CPU plain path: " + "; ".join(
        f"{kind} flux {r['flux_share']:.3g} of the max (elementwise "
        f"{r['flux_rel']:.3g}), leaves {r['leaves_abs']:.3g}"
        for kind, r in out["small"].items())
        + f" (limits {SEQ_FLUX_SHARE} of the max, {PRIOR_LEAF_ATOL})")
    return out


# phase 11: the rest of the forward model at the main path's width
FM_STEPS, FM_ERROR_STEPS, FM_EPOCHS, FM_REPEATS = 20, 5, 5, 3
FM_CLASSES, FM_BANDS, FM_SOURCES, FM_SMALL_EPOCHS = 4, 3, 256, 50
GMM16_K, GMM16_STRIDE = 20, 8
# (e): the small runs' flux on the card against the CPU within
# SEQ_FLUX_SHARE of its max-abs (phase 6's bar, for Adam's first step:
# the runs start from the data's estimate, where float32 differences
# become other steps at pixels whose gradient nearly vanishes), the
# sources' positions within FM_POS_ATOL pixels and their fluxes within
# FM_SOURCE_RTOL
FM_POS_ATOL, FM_SOURCE_RTOL = 1e-3, 1e-3


class LogCapture:
    """The messages ``jolideco_torch.core`` logs at WARNING while in the
    ``with`` block."""

    def __enter__(self):
        import logging

        self.messages = []
        capture = self

        class Handler(logging.Handler):
            def emit(self, record):
                capture.messages.append(record.getMessage())

        self.handler = Handler(logging.WARNING)
        self.logger = logging.getLogger("jolideco_torch.core")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def fm_joint(datasets, components, device, conv_mode="fft",
             compute_error=False):
    """``run(n)``: ``n`` joint steps (lr 0.1, no trace, seed 0) from
    ``components()``."""
    from jolideco_torch import MAPDeconvolver

    def run(n_steps):
        return MAPDeconvolver(
            n_epochs=n_steps, learning_rate=0.1, update_strategy="joint",
            conv_mode=conv_mode, trace_every=0, seed=0, device=device,
            compute_error=compute_error).run(datasets,
                                             components=components())
    return run


def fm_timed(torch, tag, run, expected, n_steps, plain=0,
             repeats=FM_REPEATS, rate="steps"):
    """A warm-up of 2 steps, then ``repeats`` runs of ``run(n_steps)``,
    counts set to zero just before each and read just after: launches
    exactly ``expected`` and the plain versions called ``plain`` times;
    the median and spread of the rates and the peak memory."""
    run(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, result = [], None
    for _ in range(repeats):
        reset_counts()
        result = run(n_steps)
        launches, plain_calls = counts()
        check(launches == expected, f"phase 11 {tag}: launches {launches}, "
              f"not {expected}")
        check(plain_calls == plain, f"phase 11 {tag}: plain versions ran "
              f"{plain_calls} times, not {plain}")
        rates.append(n_steps / result.train_seconds)
    return result, {
        "launches": launches, "plain_calls": plain_calls,
        f"{rate}_per_s": float(np.median(rates)),
        f"{rate}_per_s_repeats": rates,
        f"{rate}_per_s_spread": float(max(rates) - min(rates)),
        "peak_bytes": torch.cuda.max_memory_allocated()}


def nonzero(launches):
    """The kernels a run launched, with their counts."""
    return {name: n for name, n in launches.items() if n}


def fm_rate_line(stats, rate="steps"):
    rates = stats[f"{rate}_per_s_repeats"]
    return (f"{stats[f'{rate}_per_s']:.3f} {rate}/s (median of "
            f"{len(rates)}: {', '.join(f'{r:.3f}' for r in rates)}; spread "
            f"{stats[f'{rate}_per_s_spread']:.3f}); peak memory "
            f"{stats['peak_bytes']} B")


def fm_check_result(torch, tag, result, device, n_steps, fall=True):
    """Finite losses (falling with ``fall``), a finite positive flux of
    every component, every tensor of the components on the card."""
    loss = result.loss_per_step
    check(loss.shape == (n_steps,) and bool(np.isfinite(loss).all())
          and (not fall or loss[-1] < loss[0]), f"phase 11 {tag}: losses "
          f"{loss[0]} -> {loss[-1]}")
    flux = result.flux_upsampled_total
    check(bool(np.isfinite(flux).all()) and bool((flux >= 0).all()),
          f"phase 11 {tag}: flux not finite and non-negative")
    off = [tuple(t.shape) for t in device_tensors(result.components)
           if t.device != device]
    check(not off, f"phase 11 {tag}: component tensors off the card: {off}")
    return [float(loss[0]), float(loss[-1])]


def gmm16(k=GMM16_K, stride=GMM16_STRIDE, seed=4):
    """A random SPD GMM of 16x16 patches (d = 256)."""
    from jolideco_torch.utils.interop import gmm_from_arrays

    rs = np.random.RandomState(seed)
    covariances = np.stack([a @ a.T / 256 + 0.1 * np.eye(256)
                            for a in rs.randn(k, 256, 256)])
    return gmm_from_arrays(0.1 * rs.randn(k, 256), covariances,
                           rs.dirichlet(np.ones(k)), stride)


def band_sums(torch, dataset, flux, device, rmf=None):
    """The predicted counts of ``dataset`` at the 2-D ``flux``, summed
    over each band (with ``rmf`` in place of the dataset's)."""
    from jolideco_torch import FluxComponents, SpatialFluxComponent
    from jolideco_torch.models import NPredModels

    comps = FluxComponents({"flux": SpatialFluxComponent(
        flux[None, None], use_log_flux=False, device=device)})
    if rmf is not None:
        dataset = dict(dataset, rmf=rmf)
    models = NPredModels.from_dataset_numpy(dataset, comps, device=device)
    with torch.no_grad():
        npred = models.evaluate_per_component(comps.fluxes_from())["flux"]
    return npred.sum(dim=(-2, -1))[0].double().cpu().numpy()


def position_error(points, sources):
    """Median distance of the fitted sources from the true ones (px)."""
    return float(np.median(np.hypot(points.x_pos_numpy - sources["x_pos"],
                                    points.y_pos_numpy - sources["y_pos"])))


def fm_small_runs(device, data):
    """(e): (a) at 4 x 64^2 x 3 bands under both conv modes, (b), (c) and
    (d) at 4 x 128^2, 20 joint steps each, and the sparse example's own
    data and components for 50 epochs of its deconvolver (sequential,
    traced), on ``device``, from :func:`fm_small_data`'s ``data``."""
    from jolideco_torch import (
        FluxComponents,
        GMMPatchPrior,
        MAPDeconvolver,
        SmoothnessPrior,
        SparseSpatialFluxComponent,
        SpatialFluxComponent,
        UniformPrior,
    )
    from jolideco_torch.priors import GaussianMixtureModel

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")

    def prior():
        return GMMPatchPrior(gmm=astro, stride=4, cycle_spin=True)

    runs = {}
    bands, estimate = data["bands"]
    for mode in ("fft", "pfft"):
        runs[f"multiband_{mode}"] = fm_joint(
            bands, lambda: SpatialFluxComponent.from_numpy(
                estimate, prior=prior()), device, conv_mode=mode)(FM_STEPS)
    fallback, estimate = data["fallback"]
    runs["fallback"] = fm_joint(fallback, lambda: SpatialFluxComponent
                                .from_numpy(estimate, prior=prior()),
                                device)(FM_STEPS)
    sparse, _, components = data["sparse"]
    runs["sparse"] = fm_joint(sparse, lambda: components(prior()),
                              device)(FM_STEPS)
    main = data["gmm16"]
    runs["gmm16"] = fm_joint(main, lambda: SpatialFluxComponent.from_numpy(
        np.ones((128, 128), np.float32), prior=GMMPatchPrior(
            gmm=gmm16(), stride=GMM16_STRIDE, cycle_spin=True)),
        device)(FM_STEPS)
    example = data["example"]
    comps = FluxComponents({
        "diffuse": SpatialFluxComponent.from_numpy(
            np.ones((32, 32)), prior=SmoothnessPrior(width=2)),
        "points": SparseSpatialFluxComponent.from_numpy(
            flux=np.array([500.0, 200.0, 80.0, 30.0]),
            x_pos=np.array([16.0, 16.0, 26.0, 6.0]) + 0.5,
            y_pos=np.array([26.0, 6.0, 16.0, 16.0]) - 0.5,
            shape=(32, 32), prior=UniformPrior())})
    runs["example"] = MAPDeconvolver(
        n_epochs=FM_SMALL_EPOCHS, learning_rate=0.05, beta=1e-3,
        device=device).run({"obs": example}, components=comps)
    return runs


def fm_small_data():
    """The small runs' data, made on the CPU once for both devices."""
    from jolideco_torch.data import gauss_and_point_sources_gauss_psf
    from jolideco_torch.utils.bench_data import make_datasets
    from jolideco_torch.utils.profile_step import (
        multiband_setup,
        sparse_setup,
    )

    data = gauss_and_point_sources_gauss_psf(
        random_state=np.random.RandomState(642020))
    example = {key: data[key] for key in ("counts", "psf", "exposure",
                                          "background")}
    example["psf"] = {"diffuse": example["psf"], "points": example["psf"]}
    return {
        "bands": multiband_setup(64, FM_BANDS, FM_CLASSES, psf_scale=0.125,
                                 device="cpu"),
        "fallback": multiband_setup(128, FM_BANDS, FM_CLASSES,
                                    psf_scale=0.25, fallback=True,
                                    device="cpu"),
        "sparse": sparse_setup(4, 128, 9, n_sources=16, device="cpu"),
        "gmm16": make_datasets(n_obs=4, size=128, psf_size=9, seed=1),
        "example": example}


def phase_forward_model(torch, device, card):
    """Phase 11: (a) four event classes of three-band stacks with the RMF
    at 1024^2, 20 joint steps under each conv mode, the probe (5 steps)
    and MAPDeconvolver(n_epochs=5)'s defaults, the RMF moving counts
    between bands; (b) the same data with one class's RMF dropped: the
    fallback to per-dataset models, 20 joint steps; (c) the main path's
    data with 256 point sources, a SparseSpatialFluxComponent beside the
    diffuse one, 20 joint steps and the probe; (d) a GMM of 16x16 patches
    on the plain scorer, 5 joint steps, no GMM kernel; (e) small runs,
    card against the CPU's plain path."""
    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        SpatialFluxComponent,
        config,
    )
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import band_rmf, make_datasets
    from jolideco_torch.utils.profile_step import (
        multiband_setup,
        sparse_setup,
    )

    check(config.gmm_precision() == "high", "phase 11 runs the default dial")
    mode = config.gmm_mode()
    k1, k5 = K1_KERNELS[mode], K5_KERNELS[mode]
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    out = {"card": card}

    def prior():
        return GMMPatchPrior(gmm=astro, stride=4, cycle_spin=True)

    # (a) band stacks with the RMF
    t0 = time.perf_counter()
    datasets, estimate = multiband_setup(FIELD, FM_BANDS, FM_CLASSES,
                                         device=device)
    out["data_seconds"] = time.perf_counter() - t0
    label = (f"{FM_CLASSES}x{FIELD}^2 x{FM_BANDS} bands (King PSFs 129^2 "
             f"to 49^2, RMF {FM_BANDS}x{FM_BANDS}) K=200")

    def component():
        return SpatialFluxComponent.from_numpy(estimate, prior=prior())

    train = expect(gmm_fused_bwd=FM_STEPS, **{k1: FM_STEPS})
    probe = expect(gmm_fused_bwd=FM_ERROR_STEPS, gmm_unit_map=1,
                   gmm_hvp_map=1, **{k1: FM_ERROR_STEPS, k5: 1})
    results = {}
    for conv_mode in ("fft", "pfft"):
        expected = dict(train)
        if conv_mode == "pfft":
            # one launch of each pass a direction: the (pair, band)
            # blocks of the four classes share it
            expected.update({name: 2 * FM_STEPS
                             for name in K3_KERNELS[mode]})
        tag = f"(a) multiband {conv_mode}"
        result, stats = fm_timed(torch, tag, fm_joint(
            datasets, component, device, conv_mode), expected, FM_STEPS)
        stats["loss"] = fm_check_result(torch, tag, result, device,
                                        FM_STEPS)
        results[conv_mode] = result.flux_upsampled_total
        out[f"multiband_{conv_mode}"] = stats
        print(f"phase 11 {tag} joint {label} on {card}: "
              f"{fm_rate_line(stats)}; loss {stats['loss'][0]:.6f} -> "
              f"{stats['loss'][1]:.6f}; launches {nonzero(stats['launches'])}")
    share = flux_share(results["pfft"], results["fft"])
    check(share <= PFFT_FLUX_SHARE, f"phase 11 (a): pfft flux against fft "
          f"{share:.3g} of the max-abs (limit {PFFT_FLUX_SHARE})")
    out["multiband_pfft"]["flux_share_vs_fft"] = share

    # the RMF moves counts between bands: the band sums at the trained
    # flux are the identity RMF's times the matrix
    flux = results["fft"]
    first = next(iter(datasets.values()))
    with_rmf = band_sums(torch, first, flux, device)
    identity = band_sums(torch, first, flux, device,
                         rmf=np.eye(FM_BANDS, dtype=np.float32))
    moved = float(np.abs(with_rmf / identity - 1).max())
    folded = float(np.abs(with_rmf / (identity @ band_rmf(FM_BANDS)) - 1)
                   .max())
    check(moved > 0.05 and folded < 1e-5, f"phase 11 (a): band sums "
          f"{with_rmf} against the identity RMF's {identity}")
    out["rmf_band_sums"] = {"rmf": with_rmf.tolist(),
                            "identity": identity.tolist(),
                            "moved": moved, "folded_rel": folded}
    print(f"phase 11 (a) RMF: band sums of the first class at the trained "
          f"flux {np.round(with_rmf, 1).tolist()} against the identity "
          f"RMF's {np.round(identity, 1).tolist()} (moved up to {moved:.4f} "
          f"of a band; identity's times the RMF within {folded:.3g}); pfft "
          f"flux against fft {share:.3g} of the max-abs (limit "
          f"{PFFT_FLUX_SHARE})")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = fm_joint(datasets, component, device,
                      compute_error=True)(FM_ERROR_STEPS)
    launches, plain_calls = counts()
    check(launches == probe and plain_calls == 0, f"phase 11 (a) probe: "
          f"launches {launches}, not {probe}; plain calls {plain_calls}")
    errors = result.components["flux"].flux_upsampled_error_numpy
    check(bool(np.isfinite(errors).all() and (errors > 0).all()),
          "phase 11 (a) probe: errors not finite and positive")
    out["multiband_probe"] = {
        "launches": launches, "error_seconds": result.error_seconds,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "errors": [float(errors.min()), float(errors.max())]}
    print(f"phase 11 (a) probe: {FM_ERROR_STEPS} steps, probe "
          f"{result.error_seconds:.4f} s; errors {errors.min():.6g} .. "
          f"{errors.max():.6g}; peak memory "
          f"{out['multiband_probe']['peak_bytes']} B; launches "
          f"{nonzero(launches)}")

    def defaults(n_epochs):
        return MAPDeconvolver(n_epochs=n_epochs).run(
            datasets, components=component())

    result, stats = fm_timed(
        torch, "(a) defaults", defaults,
        expect(gmm_fused_bwd=FM_EPOCHS * FM_CLASSES,
               **{k1: FM_EPOCHS * (FM_CLASSES + 1)}),
        FM_EPOCHS, rate="epochs")
    total = result.trace_loss["total"]
    check(len(total) == FM_EPOCHS and bool(np.isfinite(total).all()),
          f"phase 11 (a) defaults: trace {list(total)}")
    stats["total"] = [float(total[0]), float(total[-1])]
    out["multiband_sequential"] = stats
    print(f"phase 11 (a) MAPDeconvolver(n_epochs={FM_EPOCHS}) defaults "
          f"{label} on {card}: {fm_rate_line(stats, 'epochs')}; trace total "
          f"{total[0]:.6f} -> {total[-1]:.6f}; launches "
          f"{nonzero(stats['launches'])}")

    # (b) the fallback: the first class without its RMF
    fallback = {name: dict(d) for name, d in datasets.items()}
    fallback[next(iter(fallback))].pop("rmf")
    with LogCapture() as log:
        result, stats = fm_timed(
            torch, "(b) fallback", fm_joint(fallback, component, device),
            train, FM_STEPS)
    said = sum("Cannot stack observations" in m and "falling back to "
               "per-dataset forward models" in m for m in log.messages)
    check(said == FM_REPEATS + 1, f"phase 11 (b): the fallback logged "
          f"{said} times: {log.messages}")
    stats["loss"] = fm_check_result(torch, "(b) fallback", result, device,
                                    FM_STEPS)
    out["fallback"] = stats
    print(f"phase 11 (b) fallback (the first class without its RMF: "
          f"\"Cannot stack observations\" logged each run) joint {label} on "
          f"{card}: {fm_rate_line(stats)}; loss {stats['loss'][0]:.6f} -> "
          f"{stats['loss'][1]:.6f}; launches {nonzero(stats['launches'])}")
    del datasets, fallback

    # (c) point sources beside the diffuse component
    t0 = time.perf_counter()
    sparse, sources, components = sparse_setup(N_OBS, FIELD, 33, FM_SOURCES,
                                               device=device)
    out["sparse_data_seconds"] = time.perf_counter() - t0
    start = components(prior())["points"]
    label = (f"{N_OBS}x{FIELD}^2 K=200 + {FM_SOURCES} point sources "
             f"(per-component 33^2 PSFs)")
    result, stats = fm_timed(
        torch, "(c) sparse", fm_joint(sparse, lambda: components(prior()),
                                      device), train, FM_STEPS)
    stats["loss"] = fm_check_result(torch, "(c) sparse", result, device,
                                    FM_STEPS)
    errors = [position_error(start, sources),
              position_error(result.components["points"], sources)]
    check(errors[1] < errors[0], f"phase 11 (c): median position error "
          f"{errors[0]} -> {errors[1]}")
    stats["position_error"] = errors
    stats["flux_ratio"] = float(np.median(
        result.components["points"].flux_values_numpy / sources["flux"]))
    out["sparse"] = stats
    print(f"phase 11 (c) sparse joint {label} on {card}: "
          f"{fm_rate_line(stats)}; loss {stats['loss'][0]:.6f} -> "
          f"{stats['loss'][1]:.6f}; median position error {errors[0]:.4f} "
          f"-> {errors[1]:.4f} px, median flux ratio "
          f"{stats['flux_ratio']:.4f}; launches {nonzero(stats['launches'])}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = fm_joint(sparse, lambda: components(prior()), device,
                      compute_error=True)(FM_ERROR_STEPS)
    launches, plain_calls = counts()
    check(launches == probe and plain_calls == 0, f"phase 11 (c) probe: "
          f"launches {launches}, not {probe}; plain calls {plain_calls}")
    diffuse = result.components["diffuse"].flux_upsampled_error_numpy
    points = result.components["points"]
    at_sources = points.flux_upsampled_error_numpy[
        np.round(points.y_pos_numpy).astype(int),
        np.round(points.x_pos_numpy).astype(int)]
    check(bool(np.isfinite(diffuse).all() and (diffuse > 0).all()
               and np.isfinite(at_sources).all() and (at_sources > 0).all()),
          "phase 11 (c) probe: errors not finite and positive")
    out["sparse_probe"] = {
        "launches": launches, "error_seconds": result.error_seconds,
        "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"phase 11 (c) probe: {FM_ERROR_STEPS} steps, probe "
          f"{result.error_seconds:.4f} s; diffuse errors "
          f"{diffuse.min():.6g} .. {diffuse.max():.6g}, at the sources "
          f"{at_sources.min():.6g} .. {at_sources.max():.6g}; peak memory "
          f"{out['sparse_probe']['peak_bytes']} B; launches "
          f"{nonzero(launches)}")
    del sparse

    # (d) a GMM of 16x16 patches: the plain scorer on the card, no kernel
    main = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    gmm = gmm16()

    def wide_component():
        return SpatialFluxComponent.from_numpy(
            np.ones((FIELD, FIELD), np.float32), prior=GMMPatchPrior(
                gmm=gmm, stride=GMM16_STRIDE, cycle_spin=True))

    result, stats = fm_timed(
        torch, "(d) 16x16 GMM", fm_joint(main, wide_component, device),
        expect(), FM_ERROR_STEPS, plain=2 * FM_ERROR_STEPS)
    stats["loss"] = fm_check_result(torch, "(d) 16x16 GMM", result, device,
                                    FM_ERROR_STEPS, fall=False)
    out["gmm16"] = stats
    print(f"phase 11 (d) GMM of 16x16 patches (K={GMM16_K}, stride "
          f"{GMM16_STRIDE}, the plain scorer) joint {N_OBS}x{FIELD}^2 on "
          f"{card}: {fm_rate_line(stats)}; loss {stats['loss'][0]:.6f} -> "
          f"{stats['loss'][1]:.6f}; launches "
          f"{nonzero(stats['launches'])} (none); "
          f"plain calls {stats['plain_calls']}")
    del main

    # (e) the small runs, card against the CPU's plain path
    small = fm_small_data()
    on_card = fm_small_runs(device, small)
    on_cpu = fm_small_runs("cpu", small)
    out["small"] = {}
    for run, card_result in on_card.items():
        cpu_result = on_cpu[run]
        res = {}
        for name, comp in card_result.components.items():
            a = comp.flux_upsampled_numpy
            b = cpu_result.components[name].flux_upsampled_numpy
            res[f"{name}_flux_share"] = flux_share(a, b)
            if comp.is_sparse:
                other = cpu_result.components[name]
                res[f"{name}_position_abs"] = float(max(
                    np.abs(comp.x_pos_numpy - other.x_pos_numpy).max(),
                    np.abs(comp.y_pos_numpy - other.y_pos_numpy).max()))
                res[f"{name}_source_flux_rel"] = max_rel(
                    comp.flux_values_numpy, other.flux_values_numpy)
        bad = {k: v for k, v in res.items() if
               (k.endswith("flux_share") and v > SEQ_FLUX_SHARE)
               or (k.endswith("position_abs") and v > FM_POS_ATOL)
               or (k.endswith("source_flux_rel") and v > FM_SOURCE_RTOL)}
        check(not bad, f"phase 11 (e) {run}: card against CPU {bad}")
        out["small"][run] = res
    print("phase 11 (e) small runs card vs CPU plain path (multiband "
          "4x64^2 x3 bands fft and pfft, fallback, sparse and 16x16 GMM at "
          f"4x128^2, the sparse example {FM_SMALL_EPOCHS} epochs): " +
          "; ".join(f"{run} " + ", ".join(f"{k} {v:.3g}" for k, v in
                                          res.items())
                    for run, res in out["small"].items())
          + f" (limits {SEQ_FLUX_SHARE} of the max, {FM_POS_ATOL} px, "
          f"{FM_SOURCE_RTOL})")
    return out


# Phase 12: the command line and the files. The main path as a run
# configuration (its ten 1024^2 datasets in FITS files, the GMM prior of
# phase 3), run through jolideco_torch.cli with a checkpoint each epoch and
# the flux-error probe, its outputs read back. Each rate is the median of
# IO_REPEATS runs.
IO_EPOCHS, IO_REPEATS = 20, 3


def io_run_config(folder, specs, component_config, checkpoint_path=None):
    """The run configuration of phase 12: the joint strategy, ``IO_EPOCHS``
    epochs each with a trace row, lr 0.1, the probe at the end, the card by
    default; a checkpoint each epoch under ``checkpoint_path``."""
    deconvolver = {"update_strategy": "joint", "n_epochs": IO_EPOCHS,
                   "trace_every": 1, "learning_rate": 0.1,
                   "compute_error": True}
    if checkpoint_path is not None:
        deconvolver["checkpoint_path"] = str(checkpoint_path)
    return {"datasets": specs, "components": {"flux": component_config},
            "deconvolver": deconvolver}


def phase_io(torch, device, card):
    """Phase 12: the CLI's ``run`` at the main path, the files it writes,
    and what reading them gives back.

    The ten datasets of ``bench_data.make_datasets`` (seed 0) go into FITS
    files, one image HDU a key, and the initial flux into a component FITS
    file; the run configuration names them. ``run_config`` (the body of
    ``jolideco-torch run``) runs it with a checkpoint each epoch and
    ``compute_error`` and writes the result to FITS (and to ASDF where
    pyyaml is there), counts set to zero just before and read just after:
    K1 split twice an epoch (the step and the trace row), K2 once, K5
    split, K6 and K7 once in the probe, the plain versions never. Then: 20
    checkpoint files, named in the trace's ``filename``; each output file
    holds the in-memory flux (and, in ASDF, its error) bit for bit, and
    reading it gives the flux within one unit in the last place (a log flux
    comes back as ``exp(log(v))``), the error bit for bit, the
    configuration as the format keeps it; ``read_checkpoint(19)`` the final
    flux likewise. Where click is there, the ``run`` command itself, in
    process, on a YAML configuration. Last, epochs/s with and without
    checkpoints (median of ``IO_REPEATS`` runs each) and the write's ms per
    epoch. Whether pyyaml and click are installed is decided once, before
    anything runs; the ASDF and YAML parts are left out without pyyaml, the
    command without click, and the line says so."""
    import importlib.util
    import shutil

    from jolideco_torch import (
        GMMPatchPrior,
        MAPDeconvolver,
        MAPDeconvolverResult,
        SpatialFluxComponent,
        config,
    )
    from jolideco_torch.cli import run_config
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets
    from jolideco_torch.utils.io.fits import _config_from_hdu, _config_to_hdu
    from jolideco_torch.utils.io.minifits import (
        ImageHDU,
        read_hdulist,
        write_hdulist,
    )

    check(config.gmm_precision() == "high", "phase 12 runs the default dial")
    has_yaml = importlib.util.find_spec("yaml") is not None
    has_click = importlib.util.find_spec("click") is not None
    left_out = []
    if not has_yaml:
        left_out.append("checkpoints, the ASDF output and the YAML "
                        "configuration (pyyaml is not installed)")
    if not has_click:
        left_out.append("the click command (click is not installed)")
    mode = config.gmm_mode()
    k1, k5 = K1_KERNELS[mode], K5_KERNELS[mode]
    folder = ROOT / "build" / "phase12"
    shutil.rmtree(folder, ignore_errors=True)
    (folder / "data").mkdir(parents=True)
    out = {"card": card, "pyyaml": has_yaml, "click": has_click,
           "left_out": left_out}

    # 1. the inputs
    t0 = time.perf_counter()
    specs = {}
    for name, dataset in make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33,
                                       seed=0).items():
        path = folder / "data" / f"{name}.fits"
        write_hdulist([ImageHDU()] + [ImageHDU(data=value, name=key)
                                      for key, value in dataset.items()],
                      path)
        specs[name] = {"filename": str(path)}
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    component = SpatialFluxComponent.from_numpy(
        np.ones((FIELD, FIELD), np.float32),
        prior=GMMPatchPrior(gmm=astro, stride=4, cycle_spin=True))
    component.write(folder / "flux-init.fits")
    component_config = component.to_dict()
    component_config["flux_upsampled"] = str(folder / "flux-init.fits")
    out["write_inputs_seconds"] = time.perf_counter() - t0

    def checkpoints_at(tag):
        return (folder / f"checkpoints-{tag}") if has_yaml else None

    # 2. the counted run, through the CLI's body
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    checkpoints = checkpoints_at("main")
    output = folder / "result.fits"
    reset_counts()
    result = run_config(io_run_config(folder, specs, component_config,
                                      checkpoints), output=output)
    launches, plain_calls = counts()
    expected = expect(gmm_fused_bwd=IO_EPOCHS, gmm_unit_map=1,
                      gmm_hvp_map=1, **{k1: 2 * IO_EPOCHS, k5: 1})
    check(launches == expected, f"phase 12: launches {launches}, not "
          f"{expected}")
    check(plain_calls == 0, f"phase 12: plain versions ran {plain_calls} "
          "times")
    out.update(launches=launches, plain_calls=plain_calls,
               peak_bytes=torch.cuda.max_memory_allocated())
    flux = result.components["flux"].flux_upsampled_numpy
    error = result.components["flux"].flux_upsampled_error_numpy
    check(bool(np.isfinite(flux).all() and (flux > 0).all()
               and np.isfinite(error).all() and (error > 0).all()),
          "phase 12: flux or errors not finite and positive")
    off = [tuple(t.shape) for t in device_tensors(result.components)
           if t.device != device]
    check(not off, f"phase 12: component tensors off the card: {off}")
    trace = result.trace_loss
    names = [MAPDeconvolver._default_checkpoint_filename.format(epoch=e)
             for e in range(IO_EPOCHS)] if has_yaml else [""] * IO_EPOCHS
    check(len(trace) == IO_EPOCHS and list(trace["filename"]) == names,
          f"phase 12: trace filenames {list(trace['filename'])}")
    if has_yaml:
        files = sorted(p.name for p in checkpoints.iterdir())
        check(files == sorted(names), f"phase 12: checkpoint files {files}")

    # 3. read back
    def within_ulp(got, want):
        return bool(np.all(np.abs(got - want) <= np.spacing(want)))

    hdus = {hdu.name: hdu for hdu in read_hdulist(output)}
    check(np.array_equal(hdus["FLUX"].data, flux), "phase 12: the FITS "
          "output does not hold the flux bit for bit")
    back = MAPDeconvolverResult.read(output)
    check(back.components["flux"].flux_upsampled.device == device,
          "phase 12: the read result is not on the card")
    reads = {"fits_flux_ulp": within_ulp(
        back.components["flux"].flux_upsampled_numpy, flux),
        "fits_config": back.config == _config_from_hdu(
            _config_to_hdu(result.config)),
        "fits_trace": back.trace_loss.to_dict() == trace.to_dict()}
    if has_yaml:
        from jolideco_torch.utils.io.asdf_lite import read_asdf

        result.write(folder / "result.asdf")
        tree = read_asdf(folder / "result.asdf")["components"]["flux"]
        reads["asdf_file_bits"] = bool(
            np.array_equal(tree["flux_upsampled"], flux)
            and np.array_equal(tree["flux_upsampled_error"], error))
        back = MAPDeconvolverResult.read(folder / "result.asdf")
        reads["asdf_flux_ulp"] = within_ulp(
            back.components["flux"].flux_upsampled_numpy, flux)
        reads["asdf_error_bits"] = bool(np.array_equal(
            back.components["flux"].flux_upsampled_error_numpy, error))
        reads["asdf_config"] = back.config == result.config
        reads["asdf_trace"] = back.trace_loss.to_dict() == trace.to_dict()
        last = read_asdf(checkpoints / names[-1])["components"]["flux"]
        reads["checkpoint_file_bits"] = bool(np.array_equal(
            last["flux_upsampled"], flux))
        last = result.read_checkpoint(IO_EPOCHS - 1)
        reads["checkpoint_flux_ulp"] = within_ulp(
            last.components["flux"].flux_upsampled_numpy, flux)
        reads["checkpoint_trace_rows"] = len(last.trace_loss) == (
            IO_EPOCHS - 1)
    failed = [name for name, ok in reads.items() if not ok]
    check(not failed, f"phase 12: read-back checks failed: {failed}")
    out["reads"] = reads

    # the command itself, in process, on a YAML configuration
    if has_yaml and has_click:
        from jolideco_torch.cli import cli
        from jolideco_torch.utils.io.yaml import write_yaml

        config_path = folder / "run.yaml"
        write_yaml(config_path, io_run_config(
            folder, specs, component_config, checkpoints_at("cli")),
            overwrite=True)
        t0 = time.perf_counter()
        cli.main(["--log-level", "warning", "run", str(config_path),
                  "--output", str(folder / "cli.fits")],
                 standalone_mode=False)
        out["cli_seconds"] = time.perf_counter() - t0
        cli_flux = read_hdulist(folder / "cli.fits")[1].data
        out["cli_flux_share"] = flux_share(cli_flux, flux)
        check(out["cli_flux_share"] <= SMALL_FLUX_RTOL, f"phase 12: the "
              f"command's flux against run_config's "
              f"{out['cli_flux_share']:.3g} of the max-abs")

    # 4. rates with and without checkpoints
    seconds = {"with": [], "without": []}
    for i in range(IO_REPEATS):
        for tag in ("without", "with") if i % 2 else ("with", "without"):
            path = checkpoints_at(f"{tag}-{i}") if tag == "with" else None
            if tag == "with" and path is None:
                continue
            timed = run_config(io_run_config(folder, specs,
                                             component_config, path))
            seconds[tag].append(timed.train_seconds)
    rates = {tag: [IO_EPOCHS / s for s in values]
             for tag, values in seconds.items() if values}
    out["epochs_per_s"] = {tag: float(np.median(r))
                           for tag, r in rates.items()}
    out["epochs_per_s_repeats"] = rates
    if "with" in rates:
        out["write_ms_per_epoch"] = 1e3 * (
            float(np.median(seconds["with"]))
            - float(np.median(seconds["without"]))) / IO_EPOCHS
    print(f"phase 12 jolideco-torch run (run_config) {N_OBS}x{FIELD}^2 "
          f"K=200 joint, {IO_EPOCHS} epochs, trace_every=1, "
          f"compute_error on {card}: launches {nonzero(launches)}; plain "
          f"calls {plain_calls}; {len(names)} checkpoints; read-backs "
          f"{reads}; epochs/s " + ", ".join(
              f"{tag} checkpoints {out['epochs_per_s'][tag]:.3f} (runs "
              + ", ".join(f"{r:.3f}" for r in rates[tag]) + ")"
              for tag in rates)
          + (f"; the write {out['write_ms_per_epoch']:.3f} ms an epoch"
             if "write_ms_per_epoch" in out else "")
          + (f"; the click command's flux against run_config's "
             f"{out['cli_flux_share']:.3g} of the max-abs"
             if "cli_flux_share" in out else "")
          + (f"; left out: {'; '.join(left_out)}" if left_out else ""))
    return out

# ----------------------------------------------------------------------
# phase 13: the main path on a mesh of ranks sharing the one card
#
# (a) one rank on NCCL, (b) two ranks on gloo with an obs mesh, (c) four
# ranks on gloo with a 2 x 2 (obs, row) mesh through the pencil FFT, (d)
# the matrix-DFT path on the two-rank obs mesh with 8 observations (two
# K3 pairs a rank), (e) the MAP probe after (b)'s training, (g) the "ct"
# path on the two-rank obs mesh with 8 observations (its pairs stay on
# their rank), (h) and (i) "ct" and "mxu" on (c)'s 2 x 2 mesh (a rank
# gathers its row group's rows, parallel.mesh.all_gather); each run's
# launches counted on each rank. NCCL refuses two ranks on one device,
# so (b)-(i) run on gloo, whose collectives carry CUDA tensors. Their
# steps/s say how fast ranks that share one card run, not how a mesh of
# cards scales.
P13_ROW_STEPS = 10
P13_PFFT_OBS = 8
P13_RUNS = {
    "a": {"backend": "nccl", "mesh": (1,), "steps": STEPS},
    "b": {"backend": "gloo", "mesh": (2,), "steps": STEPS},
    "c": {"backend": "gloo", "mesh": (2, 2), "steps": P13_ROW_STEPS},
    "d": {"backend": "gloo", "mesh": (2,), "steps": STEPS,
          "conv_mode": "pfft", "n_obs": P13_PFFT_OBS},
    "e": {"backend": "gloo", "mesh": (2,), "steps": ERROR_STEPS,
          "compute_error": True},
    "g": {"backend": "gloo", "mesh": (2,), "steps": STEPS,
          "conv_mode": "ct", "n_obs": P13_PFFT_OBS},
    "h": {"backend": "gloo", "mesh": (2, 2), "steps": P13_ROW_STEPS,
          "conv_mode": "ct"},
    "i": {"backend": "gloo", "mesh": (2, 2), "steps": P13_ROW_STEPS,
          "conv_mode": "mxu"},
}
# the runs of one spawned group (one process group each)
P13_GROUPS = (("a",), ("b", "d", "e", "g"), ("c", "h", "i"))
# the sharded runs against the unsharded ones: the losses within
# SMALL_FLUX_RTOL, the flux within phase 6's share of its max-abs, for
# phase 6's reason: the ranks' gradients are summed in another order,
# and Adam's first step, -lr g / (|g| + eps), turns that rounding into a
# different step wherever a pixel's gradient is near zero (6.1e-4
# elementwise at the main path on an H100 with two ranks)
P13_FLUX_SHARE = PFFT_FLUX_SHARE


def phase13_rank(rank, world, names, device, field=FIELD, n_obs=N_OBS):
    """One rank of phase 13's runs ``names`` (one mesh) on ``device``, at
    ``n_obs`` observations of ``field``² (the main path's by default):
    each run a warm-up of 2 steps, then the counted run, counts set to
    zero just before and read just after. Returns per run the rank's
    launches, plain calls, steps/s, loss, a digest of its parameters and,
    on rank 0, the flux and errors."""
    import hashlib

    import torch

    from jolideco_torch.parallel import make_obs_mesh, make_obs_row_mesh
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    shape = P13_RUNS[names[0]]["mesh"]
    mesh = (make_obs_mesh(world) if len(shape) == 1
            else make_obs_row_mesh(*shape))
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=n_obs, size=field, psf_size=33, seed=0)
    out = {}
    for name in names:
        run = P13_RUNS[name]
        data = dict(list(datasets.items())[:run.get("n_obs", n_obs)])
        kwargs = dict(cycle_spin=True, mesh=mesh,
                      conv_mode=run.get("conv_mode", "fft"),
                      compute_error=run.get("compute_error", False))
        run_slice(data, astro, device, n_steps=2, **kwargs)  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        result = run_slice(data, astro, device, n_steps=run["steps"],
                           **kwargs)
        launches, plain_calls = counts()
        log_flux = result.components["flux"].parameters()["flux"]
        out[name] = {
            "launches": launches, "plain_calls": plain_calls,
            "steps_per_s": run["steps"] / result.train_seconds,
            "loss": result.loss_per_step,
            "params_sha256": hashlib.sha256(
                log_flux.detach().cpu().numpy().tobytes()).hexdigest(),
        }
        if rank == 0:
            out[name]["flux"] = result.flux_upsampled_total
            if run.get("compute_error"):
                out[name]["errors"] = result.components[
                    "flux"].flux_upsampled_error_numpy
    return out


def p13_expected(name, rank, k1="gmm_fused_fwd_tc", k3=K3_KERNELS["split"]):
    """Run ``name``'s launches on ``rank``: K1 split and K2 once a step
    on the rank's strip block, K3's split passes twice a step (forward
    and adjoint) on the rank's pairs, the probe's K5 split, K6 and K7
    once on rank 0 (which adds the prior's Hessian term)."""
    run = P13_RUNS[name]
    steps = run["steps"]
    nonzero = {k1: steps, "gmm_fused_bwd": steps}
    if run.get("conv_mode") == "pfft":
        nonzero.update({kernel: 2 * steps for kernel in k3})
    if run.get("compute_error") and rank == 0:
        nonzero.update({"gmm_score_rows_tc": 1, "gmm_unit_map": 1,
                        "gmm_hvp_map": 1})
    return expect(**nonzero)


def p13_partial_sums(torch, device, flux):
    """(f) ``gmm_score_fused_partial_sum`` in one process: 2, 4 and 3
    shards, each a launch of K1 split and K2 on its strip block, against
    one whole-image call, at the trained 1024^2 flux of phase 3 and on
    the ragged 1000 x 904 image of phase 2 (a block of zero-flux
    sentinels): the summed values within phase 2's rtol 1e-5, the image
    gradient within its 1e-4 of the max-abs."""
    from jolideco_torch.ops import gmm_fused as gf
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.priors.patches import ZERO_FLUX_SENTINEL

    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        device)
    rs = np.random.RandomState(0)
    ragged = rs.uniform(0.1, 2.0, RAGGED).astype(np.float32)
    ragged[96:160, 200:260] = 2.0 * ZERO_FLUX_SENTINEL
    out = {}
    for label, img in ((MAIN, flux), ("{}x{}".format(*RAGGED), ragged)):
        image = torch.as_tensor(np.ascontiguousarray(img), device=device)
        x = image.clone().requires_grad_(True)
        values, _, valid = gf.gmm_score_fused_image(
            x, (8, 8), 4, bufs, ZERO_FLUX_SENTINEL, mode="split")
        whole = torch.where(valid, values, torch.zeros_like(values)).sum()
        whole.backward()
        for n_shards in (2, 4, 3):
            reset_counts()
            xs = image.clone().requires_grad_(True)
            total = sum(gf.gmm_score_fused_partial_sum(
                xs, (8, 8), 4, bufs, ZERO_FLUX_SENTINEL, n_shards, index,
                mode="split") for index in range(n_shards))
            total.backward()
            torch.cuda.synchronize()
            launches, plain_calls = counts()
            tag = f"phase 13 (f) {label}, {n_shards} shards"
            check(launches == expect(gmm_fused_fwd_tc=n_shards,
                                     gmm_fused_bwd=n_shards),
                  f"{tag}: launches {launches}")
            check(plain_calls == 0, f"{tag}: plain versions ran")
            value_rel = float(abs(total - whole) / abs(whole))
            grad_rel = float((xs.grad - x.grad).abs().max()
                             / x.grad.abs().max())
            check(value_rel <= 1e-5 and grad_rel <= 1e-4,
                  f"{tag}: summed values {value_rel:.3g} (limit 1e-5), "
                  f"gradient {grad_rel:.3g} of the max-abs (limit 1e-4)")
            out[f"{label} {n_shards}"] = {"value_rel_err": value_rel,
                                          "grad_err_share": grad_rel}
            print(f"{tag}: K1 split and K2 {n_shards} launches each; summed "
                  f"values rel err {value_rel:.3g} (limit 1e-5), gradient "
                  f"{grad_rel:.3g} of the max-abs (limit 1e-4)")
    return out


def phase_mesh(torch, device, card, slice_, errors):
    """Phase 13: the main path on a mesh of ranks sharing the card; the
    runs of ``P13_RUNS``, each rank's launches exact and its parameters
    the same bits as every other rank's; (f) the strip blocks in one
    process."""
    from jolideco_torch.parallel.launch import run_ranks
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    ranks = {}
    for names in P13_GROUPS:
        run = P13_RUNS[names[0]]
        world = int(np.prod(run["mesh"]))
        t0 = time.perf_counter()
        results = run_ranks(phase13_rank, world, args=(names, str(device)),
                            backend=run["backend"], timeout=400,
                            collective_timeout=300)
        print(f"phase 13 group {'+'.join(names)}: {world} rank(s) on "
              f"{run['backend']} in {time.perf_counter() - t0:.1f} s")
        for name in names:
            ranks[name] = [r[name] for r in results]

    # the unsharded references: phase 3's and phase 4's runs, and runs of
    # the other runs' steps, observations and conv modes
    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    reference = {
        "a": (slice_["high"]["flux"], slice_["high"]["loss"]),
        "b": (slice_["high"]["flux"], slice_["high"]["loss"]),
    }
    for name in ("c", "d", "g", "h", "i"):
        run = P13_RUNS[name]
        data = dict(list(datasets.items())[:run.get("n_obs", N_OBS)])
        result = run_slice(data, astro, device, cycle_spin=True,
                           n_steps=run["steps"],
                           conv_mode=run.get("conv_mode", "fft"))
        reference[name] = (result.flux_upsampled_total, result.loss_per_step)

    out = {}
    for name, per_rank in ranks.items():
        run = P13_RUNS[name]
        mesh = "x".join(str(n) for n in run["mesh"])
        tag = f"phase 13 ({name}) {len(per_rank)} rank(s) on {run['backend']}"
        for rank, got in enumerate(per_rank):
            want = p13_expected(name, rank)
            check(got["launches"] == want, f"{tag} rank {rank}: launches "
                  f"{got['launches']}, not {want}")
            check(got["plain_calls"] == 0, f"{tag} rank {rank}: plain "
                  f"versions ran {got['plain_calls']} times")
        digests = {got["params_sha256"] for got in per_rank}
        check(len(digests) == 1, f"{tag}: ranks' parameters differ")
        first = per_rank[0]
        check(bool(np.isfinite(first["loss"]).all()), f"{tag}: loss not "
              "finite")
        line = {"mesh": mesh, "backend": run["backend"],
                "steps": run["steps"],
                "steps_per_s": [got["steps_per_s"] for got in per_rank],
                "launches": [got["launches"] for got in per_rank],
                "parameters_bitwise_equal": True}
        if name == "e":
            err, want = first["errors"], errors["high"]["errors"]
            rel = float(np.max(np.abs(err - want) / np.abs(want)))
            check(rel <= SMALL_ERROR_RTOL, f"{tag}: errors against phase "
                  f"4's max rel {rel:.3g} (limit {SMALL_ERROR_RTOL})")
            line["errors_rel"] = rel
            compared = f"errors against phase 4's max rel {rel:.3g}"
        else:
            flux_want, loss_want = reference[name]
            diff = np.abs(first["flux"] - flux_want)
            flux_share = float(diff.max() / np.abs(flux_want).max())
            flux_rel = float(np.max(diff / np.abs(flux_want)))
            loss_rel = float(np.max(np.abs(first["loss"] - loss_want)
                                    / np.abs(loss_want)))
            bitwise = bool(np.array_equal(first["flux"], flux_want)
                           and np.array_equal(first["loss"], loss_want))
            check(flux_share <= P13_FLUX_SHARE
                  and loss_rel <= SMALL_FLUX_RTOL,
                  f"{tag}: flux {flux_share:.3g} of the max-abs (limit "
                  f"{P13_FLUX_SHARE}; max rel {flux_rel:.3g}), loss max rel "
                  f"{loss_rel:.3g} (limit {SMALL_FLUX_RTOL}) against the "
                  "unsharded run")
            line.update(flux_share=flux_share, flux_rel=flux_rel,
                        loss_rel=loss_rel, bitwise_equal_unsharded=bitwise)
            compared = (f"against the unsharded run: flux {flux_share:.3g} "
                        f"of the max-abs (limit {P13_FLUX_SHARE}; max rel "
                        f"{flux_rel:.3g}), loss max rel {loss_rel:.3g} (limit "
                        f"{SMALL_FLUX_RTOL}); bit for bit: {bitwise}")
        rates = ", ".join(f"{r:.3f}" for r in line["steps_per_s"])
        print(f"{tag}, mesh {mesh}, {run['steps']} steps: {compared}; "
              f"launches exact on every rank; parameters the same bits on "
              f"every rank; steps/s per rank {rates} ({card}; ranks sharing "
              f"one card: not a scaling figure)")
        out[name] = line
    out["f"] = p13_partial_sums(torch, device, slice_["high"]["flux"])
    return out


# Phase 14: the joint path's other convolution backends at the main path
# (jolideco_torch/ops/ct_conv.py, ops/fft_mxu.py, parallel/stacked.py's
# "direct"): no kernel of their own, float32 products on the CUDA cores
P14_MODES = ("ct", "mxu", "direct")
# (a) against the float64 FFT convolution of the same inputs, the share of
# the result's max-abs. "direct" takes float32 products: the float32
# pipeline's bar PFFT_ERR_SHARE. "ct" and "mxu" multiply bf16 hi/lo parts
# ("split3"), so their bar is the split modes', PFFT_SPLIT_SHARE: at this
# shape the JAX package's own "ct" pair convolution lies 8.21e-5 of the
# max-abs from float64 (its second image; the port's 8.25e-5), its "mxu"
# 7.0e-6, on the CPU (scripts/torch_conv_mode_errors.py)
P14_ERR_SHARE = {"ct": PFFT_SPLIT_SHARE, "mxu": PFFT_SPLIT_SHARE,
                 "direct": PFFT_ERR_SHARE}
# (b) is timed P14_REPEATS times: steps/s is their median
P14_REPEATS = 3
P14_TIMING_REPS = 5


def p14_convolution(torch, device, loss, mode, kernels64, seed=3):
    """(a) one convolution of the ten images of the main path's shape
    (``loss.convolve``) and its adjoint (autograd), against the float64
    FFT convolution of the same inputs, beside the float32 cuFFT
    convolution's error (the ``"fft"`` loss's); the ms of each direction
    beside cuFFT's, measured here."""
    from jolideco_torch.ops.fft import (
        _origin_centered,
        convolve_fft_precomputed,
    )

    rs = np.random.RandomState(seed)
    shape = tuple(loss.counts.shape[:2]) + (1, FIELD, FIELD)
    x = torch.as_tensor(rs.uniform(0.0, 2.0, shape).astype(np.float32),
                        device=device)
    g = torch.as_tensor(rs.standard_normal(shape).astype(np.float32),
                        device=device)
    fft_shape = loss.fft_shape
    k64 = torch.fft.rfft2(_origin_centered(kernels64, fft_shape),
                          s=fft_shape)

    def exact(v, spectrum):
        out = torch.fft.irfft2(torch.fft.rfft2(v.double(), s=fft_shape)
                               * spectrum, s=fft_shape)
        return out[..., :FIELD, :FIELD]

    y64, dx64 = exact(x, k64), exact(g, k64.conj())

    def run(conv):
        xr = x.clone().requires_grad_(True)
        y = conv(xr)
        (dx,) = torch.autograd.grad(y, xr, g)
        return y.detach(), dx

    def cufft(v):
        return convolve_fft_precomputed(v, loss.psf_ffts["flux"], fft_shape)

    def share(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    out = {}
    for label, conv in ((mode, lambda v: loss.convolve("flux", v)),
                        ("cufft", cufft)):
        y, dx = run(conv)
        fwd = cuda_ms(torch, lambda: conv(x), P14_TIMING_REPS)
        xr = x.clone().requires_grad_(True)
        both = cuda_ms(torch, lambda: torch.autograd.grad(conv(xr), xr, g),
                       P14_TIMING_REPS)
        out[label] = {"forward_err": share(y, y64),
                      "adjoint_err": share(dx, dx64),
                      "forward_ms": fwd, "adjoint_ms": both - fwd}
    err = max(out[mode]["forward_err"], out[mode]["adjoint_err"])
    check(err <= P14_ERR_SHARE[mode], f"phase 14 (a) {mode}: error against "
          f"float64 {err:.3g} of the max-abs (limit {P14_ERR_SHARE[mode]})")
    return out


def p14_training(torch, device, datasets, gmm, mode, flux_fft):
    """(b) 20 joint steps P14_REPEATS times, counts set to zero just before
    and read just after each: K1 split and K2 20 times, every other kernel
    and the plain versions never; the flux against phase 3's fft run."""
    run = dict(cycle_spin=True, conv_mode=mode)
    run_slice(datasets, gmm, device, n_steps=2, **run)  # warm-up
    rates, peaks = [], []
    for _ in range(P14_REPEATS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result = run_slice(datasets, gmm, device, **run)
        launches, plain_calls = counts()
        peaks.append(torch.cuda.max_memory_allocated())
        expected = expect(gmm_fused_fwd_tc=STEPS, gmm_fused_bwd=STEPS)
        check(launches == expected, f"phase 14 (b) {mode}: launches "
              f"{launches}, not {expected}")
        check(plain_calls == 0, f"phase 14 (b) {mode}: plain versions ran "
              f"{plain_calls} times")
        rates.append(STEPS / result.train_seconds)
    loss, flux = result.loss_per_step, result.flux_upsampled_total
    check(loss.shape == (STEPS,) and bool(np.isfinite(loss).all())
          and bool(np.isfinite(flux).all() and (flux > 0).all()),
          f"phase 14 (b) {mode}: loss or flux not finite and positive")
    diff = np.abs(flux - flux_fft)
    flux_diff = float(diff.max() / np.abs(flux_fft).max())
    flux_rel = float(np.max(diff / np.abs(flux_fft)))
    check(flux_diff <= PFFT_FLUX_SHARE, f"phase 14 (b) {mode}: flux against "
          f"phase 3's fft run {flux_diff:.3g} of the max-abs (limit "
          f"{PFFT_FLUX_SHARE}; elementwise {flux_rel:.3g})")
    return {"launches": launches, "steps_per_s": float(np.median(rates)),
            "steps_per_s_runs": rates, "peak_bytes": max(peaks),
            "loss": [float(loss[0]), float(loss[-1])],
            "flux_diff": flux_diff, "flux_rel": flux_rel}


def p14_probe(torch, device, datasets, gmm, errors_fft):
    """(c) under ``"ct"``: 5 joint steps, then the probe; K1 split and K2
    5 times, K5 split, K6 and K7 once; the errors against phase 4's."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = run_slice(datasets, gmm, device, n_steps=ERROR_STEPS,
                       compute_error=True, cycle_spin=True, conv_mode="ct")
    launches, plain_calls = counts()
    peak = torch.cuda.max_memory_allocated()
    expected = expect(gmm_fused_fwd_tc=ERROR_STEPS,
                      gmm_fused_bwd=ERROR_STEPS, gmm_score_rows_tc=1,
                      gmm_unit_map=1, gmm_hvp_map=1)
    check(launches == expected, f"phase 14 (c) ct probe: launches "
          f"{launches}, not {expected}")
    check(plain_calls == 0, "phase 14 (c) ct probe: plain versions ran")
    errors = result.components["flux"].flux_upsampled_error_numpy
    check(errors.shape == (FIELD, FIELD)
          and bool(np.isfinite(errors).all() and (errors > 0).all()),
          "phase 14 (c) ct probe: errors not finite and positive")
    error_rel = float(np.max(np.abs(errors - errors_fft) / errors_fft))
    check(error_rel <= PFFT_ERROR_RTOL, f"phase 14 (c) ct errors against "
          f"phase 4's: max rel {error_rel:.3g} (limit {PFFT_ERROR_RTOL})")
    return {"launches": launches, "error_seconds": result.error_seconds,
            "peak_bytes": peak, "errors_rel": error_rel}


def p14_small(torch, device, mode):
    """(d) phase 9's small run (4 x 128^2 seen at sub-pixel offsets, the
    x2 component and calibrations, 20 joint steps and the probe) under
    ``mode``, card against the CPU's path, by phase 9's bars."""
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_shifted_datasets

    builtin = GaussianMixtureModel.from_registry("builtin-8x8-v1")
    small = make_shifted_datasets(size=UPS_SMALL, psf_size=9, seed=1)
    a, b = (upsampled_run(small, builtin, dev, STEPS, compute_error=True,
                          conv_mode=mode) for dev in (device, "cpu"))
    flux_a, flux_b = a.flux_upsampled_total, b.flux_upsampled_total
    err_a, err_b = (r.components["flux"].flux_upsampled_error_numpy
                    for r in (a, b))
    cal_a, cal_b = calibration_arrays(a), calibration_arrays(b)
    res = {"flux_share": flux_share(flux_a, flux_b),
           "flux_rel": max_rel(flux_a, flux_b),
           "errors_rel": max_rel(err_a, err_b),
           "shift_abs": float(np.abs(cal_a[0] - cal_b[0]).max()),
           "log_norm_abs": float(np.abs(cal_a[1] - cal_b[1]).max())}
    check(res["flux_share"] <= SEQ_FLUX_SHARE
          and res["errors_rel"] <= SMALL_ERROR_RTOL
          and max(res["shift_abs"], res["log_norm_abs"]) <= UPS_CAL_ATOL,
          f"phase 14 (d) {mode} small: {res} (limits {SEQ_FLUX_SHARE} of "
          f"the max, {SMALL_ERROR_RTOL}, {UPS_CAL_ATOL})")
    return res


def phase_conv_modes(torch, device, card, slice_, errors):
    """Phase 14: ``conv_mode`` ``"ct"``, ``"mxu"`` and ``"direct"`` at the
    main path under the default dial: (a) the convolution and its adjoint
    against float64 with ms a direction beside cuFFT's, (b) 20 joint
    steps three times with exact counts, (c) the ``"ct"`` probe, (d) a
    small run, card against the CPU."""
    from jolideco_torch import FluxComponents, SpatialFluxComponent
    from jolideco_torch.parallel.stacked import StackedPoissonLoss
    from jolideco_torch.priors import GaussianMixtureModel
    from jolideco_torch.utils.bench_data import make_datasets

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    datasets = make_datasets(n_obs=N_OBS, size=FIELD, psf_size=33, seed=0)
    kernels64 = torch.as_tensor(np.stack([d["psf"] for d in datasets.values()])
                                [:, None, None], dtype=torch.float64,
                                device=device)
    components = FluxComponents({"flux": SpatialFluxComponent.from_numpy(
        np.ones((FIELD, FIELD), np.float32), device=device)})
    out = {}
    for mode in P14_MODES:
        t0 = time.perf_counter()
        loss = StackedPoissonLoss.from_datasets(datasets, components,
                                                conv_mode=mode, device=device)
        shape = {"ct": loss.ct_fft_shape, "mxu": loss.mxu_fft_shape,
                 "direct": tuple(loss.psfs["flux"].shape[-2:])
                 if loss.psfs else None}[mode]
        conv = p14_convolution(torch, device, loss, mode, kernels64)
        del loss
        train = p14_training(torch, device, datasets, astro, mode,
                             slice_["high"]["flux"])
        probe = (p14_probe(torch, device, datasets, astro,
                           errors["high"]["errors"]) if mode == "ct"
                 else None)
        small = p14_small(torch, device, mode)
        out[mode] = {"shape": shape, "convolution": conv, "training": train,
                     "probe": probe, "small": small,
                     "seconds": time.perf_counter() - t0}
        c, f = conv[mode], conv["cufft"]
        what = "kernel" if mode == "direct" else "transform"
        print(f"phase 14 {mode} ({what} {shape}) {N_OBS}x{FIELD}^2: (a) "
              f"error against float64 "
              f"forward {c['forward_err']:.3g}, adjoint {c['adjoint_err']:.3g}"
              f" of the max-abs (limit {P14_ERR_SHARE[mode]}; cuFFT "
              f"{f['forward_err']:.3g}, {f['adjoint_err']:.3g}); ms forward "
              f"{c['forward_ms']:.3f}, adjoint {c['adjoint_ms']:.3f} (cuFFT "
              f"{f['forward_ms']:.3f}, {f['adjoint_ms']:.3f}); (b) {STEPS} "
              f"steps at {train['steps_per_s']:.3f} steps/s (median of "
              f"{P14_REPEATS}: " + ", ".join(
                  f"{r:.3f}" for r in train["steps_per_s_runs"])
              + f"; fft {slice_['high']['steps_per_s']:.3f}), flux against "
              f"phase 3 {train['flux_diff']:.3g} of the max (limit "
              f"{PFFT_FLUX_SHARE}, elementwise {train['flux_rel']:.3g}), "
              f"launches exact, peak memory {train['peak_bytes']} B"
              + (f"; (c) probe {probe['error_seconds']:.4f} s, errors "
                 f"against phase 4 max rel {probe['errors_rel']:.3g} (limit "
                 f"{PFFT_ERROR_RTOL}), peak memory {probe['peak_bytes']} B"
                 if probe else "")
              + f"; (d) small 4x{UPS_SMALL}^2 x{UPS_FACTOR} calibrated card "
              f"vs CPU flux {small['flux_share']:.3g} of the max, errors "
              f"{small['errors_rel']:.3g}, shifts {small['shift_abs']:.3g} px,"
              f" log norms {small['log_norm_abs']:.3g}; {card}")
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "jolideco_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (no "
              "jolideco_torch package beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    device = torch.device("cuda", 0)
    device_name, card = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch, device)
    slice_ = phase_slice(torch, device)
    errors = phase_errors(torch, device)
    marg_train, marg_probe = phase_marginalised(torch, device)
    pfft_train, pfft_probe = phase_pfft(torch, device, slice_,
                                        errors["high"]["errors"])
    default = phase_default(torch, device, slice_, errors, marg_train,
                            marg_probe)
    entry = phase_default_entry(torch, device, card)
    upsampled = phase_upsampled(torch, device, card)
    priors = phase_priors(torch, device, card)
    forward_model = phase_forward_model(torch, device, card)
    io = phase_io(torch, device, card)
    mesh = phase_mesh(torch, device, card, slice_, errors)
    conv_modes = phase_conv_modes(torch, device, card, slice_, errors)

    timing, patch = kernels["timing"], kernels["patch"]
    rows = patch[MAIN]
    rtiming, rbounds = patch["timing"], patch["bounds"]
    marg = kernels["marg"]
    mrows, mtiming, mbounds = marg[MAIN], marg["timing"], marg["bounds"]
    msplit = kernels["marg_split"]
    msmain = msplit[f"{MAIN} astro"]
    mstiming, msbounds = msplit["timing_astro"], msplit["bounds_astro"]
    psmain = msplit[f"{MAIN} astro probe"]["errors_against_float64"]
    pstiming = msplit["probe_timing_astro"]
    psbounds = msplit["probe_bounds_astro"]
    fused_src = "jolideco_torch/csrc/gmm_fused.cu"
    patch_src = "jolideco_torch/csrc/gmm_patch.cu"
    wg_src = "jolideco_torch/csrc/gmm_score_wg.cu"
    pfft = kernels["pfft"]
    pmain, ptiming, pbound = pfft[MAIN], pfft["timing"], pfft["bounds"]
    split = kernels[MAIN]["split"]
    # K1: the float32 kernel's launches are those of the "highest" run of
    # phase 3, the tensor-core kernel's (and K2's) the default dial's
    table = [
        ("gmm_fused_fwd", wg_src, "jolideco_tpu/ops/gmm_fused.py:309",
         slice_["highest"], kernels[MAIN]["value_max_abs_err"],
         timing["fwd_ms"], timing["fwd_plain_ms"], kernels["fwd_bound"]),
        ("gmm_fused_fwd_tc", wg_src,
         "jolideco_tpu/ops/gmm_fused.py:309", slice_["high"],
         split["value_max_abs_err"], split["ms"], split["plain_ms"],
         split["bound"]),
        ("gmm_fused_bwd", fused_src, "jolideco_tpu/ops/gmm_fused.py:405",
         slice_["high"], kernels[MAIN]["grad_max_abs_err"],
         timing["bwd_ms"], timing["bwd_plain_ms"], kernels["bwd_bound"]),
        ("gmm_score_rows", patch_src, "jolideco_tpu/ops/gmm_pallas.py:237",
         errors["highest"], rows["score_marg0"][0], rtiming["score_ms"],
         rtiming["score_plain_ms"], rbounds["score_six"]),
        ("gmm_score_rows_tc", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:237", errors["high"],
         rows["split"]["map"]["value_max_abs_err"], rtiming["split_ms"],
         rtiming["split_plain_ms"], rbounds["score_split"]),
        ("gmm_unit_map", patch_src, "jolideco_tpu/ops/gmm_pallas.py:365",
         errors["high"], rows["unit"][0], rtiming["unit_ms"],
         rtiming["unit_plain_ms"], rbounds["unit"]),
        ("gmm_hvp_map", patch_src, "jolideco_tpu/ops/gmm_pallas.py:376",
         errors["high"], rows["hvp"][0], rtiming["hvp_ms"],
         rtiming["hvp_plain_ms"], rbounds["hvp"]),
        ("gmm_fused_fwd_marg", wg_src, "jolideco_tpu/ops/gmm_fused.py:341",
         marg_train["highest"], mrows["fwd"][0], mtiming["fwd_ms"],
         mtiming["fwd_plain_ms"], mbounds["fwd_six"]),
        ("gmm_fused_fwd_marg_tc", wg_src,
         "jolideco_tpu/ops/gmm_fused.py:341", marg_train["high"],
         msmain["value_max_abs_err"], mstiming["fwd_ms"],
         mstiming["fwd_plain_ms"], msbounds["fwd"]),
        ("gmm_fused_bwd_marg", wg_src, "jolideco_tpu/ops/gmm_fused.py:420",
         marg_train["highest"], mrows["bwd"][0], mtiming["bwd_ms"],
         mtiming["bwd_plain_ms"], mbounds["bwd_six"]),
        ("gmm_fused_bwd_marg_tc", wg_src,
         "jolideco_tpu/ops/gmm_fused.py:420", marg_train["high"],
         msmain["bwd_against_float64"]["tc"], mstiming["bwd_ms"],
         mstiming["bwd_plain_ms"], msbounds["bwd"]),
        ("gmm_score_rows_marg", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:237", marg_probe["highest"],
         rows["score_marg1"][0], rtiming["lse_ms"], rtiming["lse_plain_ms"],
         rbounds["score_six"]),
        ("gmm_score_rows_marg_tc", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:237", marg_probe["high"],
         rows["split"]["lse"]["value_max_abs_err"], rtiming["split_lse_ms"],
         rtiming["split_lse_plain_ms"], rbounds["score_split"]),
        ("gmm_unit_marg", wg_src, "jolideco_tpu/ops/gmm_pallas.py:384",
         marg_probe["highest"], mrows["unit"][0], mtiming["unit_ms"],
         mtiming["unit_plain_ms"], mbounds["unit_six"]),
        ("gmm_unit_marg_tc", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:384", marg_probe["high"],
         psmain["unit"]["err"], pstiming["unit_ms"],
         pstiming["unit_plain_ms"], psbounds["unit"]),
        ("gmm_hvp_marg_weights", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:406", marg_probe["highest"],
         max(mrows["weights_p"][0], mrows["weights_dp"][0]),
         mtiming["weights_ms"], mtiming["weights_plain_ms"],
         mbounds["weights_six"]),
        ("gmm_hvp_marg_weights_tc", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:406", marg_probe["high"],
         max(psmain["weights_p"]["err"], psmain["weights_dp"]["err"]),
         pstiming["weights_ms"], pstiming["weights_plain_ms"],
         psbounds["weights"]),
        ("gmm_hvp_marg_mix", patch_src, "jolideco_tpu/ops/gmm_pallas.py:449",
         marg_probe["high"], mrows["mix"][0], mtiming["mix_ms"],
         mtiming["mix_plain_ms"], mbounds["mix"]),
    ]
    # the "bf16" kernels (the "default" setting), launched by phase 7
    k1b = kernels[MAIN]["bf16"]
    mb = kernels["marg_bf16"]
    mbmain, pbmain = mb[f"{MAIN} astro"], mb[f"{MAIN} astro probe"]
    pbe = pbmain["errors_against_float64"]
    table += [
        ("gmm_fused_fwd_bf16", wg_src, "jolideco_tpu/ops/gmm_fused.py:309",
         default["map"], k1b["value_max_abs_err"], k1b["ms"], k1b["plain_ms"],
         k1b["bound"]),
        ("gmm_fused_fwd_marg_bf16", wg_src,
         "jolideco_tpu/ops/gmm_fused.py:341", default["marginalised"],
         mbmain["value_max_abs_err"], mb["timing_astro"]["fwd_ms"],
         mb["timing_astro"]["fwd_plain_ms"], mb["bounds_astro"]["fwd"]),
        ("gmm_fused_bwd_marg_bf16", wg_src,
         "jolideco_tpu/ops/gmm_fused.py:420", default["marginalised"],
         mbmain["bwd_against_float64"]["tc"], mb["timing_astro"]["bwd_ms"],
         mb["timing_astro"]["bwd_plain_ms"], mb["bounds_astro"]["bwd"]),
        ("gmm_score_rows_bf16", wg_src, "jolideco_tpu/ops/gmm_pallas.py:237",
         default["map_probe"], rows["bf16"]["map"]["value_max_abs_err"],
         rtiming["bf16_ms"], rtiming["bf16_plain_ms"], rbounds["score_bf16"]),
        ("gmm_score_rows_marg_bf16", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:237", default["marginalised_probe"],
         rows["bf16"]["lse"]["value_max_abs_err"], rtiming["bf16_lse_ms"],
         rtiming["bf16_lse_plain_ms"], rbounds["score_bf16"]),
        ("gmm_unit_marg_bf16", wg_src, "jolideco_tpu/ops/gmm_pallas.py:384",
         default["marginalised_probe"], pbe["unit"]["err"],
         mb["probe_timing_astro"]["unit_ms"],
         mb["probe_timing_astro"]["unit_plain_ms"],
         mb["probe_bounds_astro"]["unit"]),
        ("gmm_hvp_marg_weights_bf16", wg_src,
         "jolideco_tpu/ops/gmm_pallas.py:406", default["marginalised_probe"],
         max(pbe["weights_p"]["err"], pbe["weights_dp"]["err"]),
         mb["probe_timing_astro"]["weights_ms"],
         mb["probe_timing_astro"]["weights_plain_ms"],
         mb["probe_bounds_astro"]["weights"]),
    ]
    library = {name: None for name, *_ in table}
    # K3's passes, forward direction at the main path's batch; their
    # errors against float64, the larger of the two directions; library:
    # pass 1's and pass 3's functions are one torch.fft.fft and one
    # torch.fft.ifft, pass 2's (a lane transform, the spectrum combine
    # and two inverse ones) no one call (null; cufft_pair_ms: cuFFT's
    # packed pair, the whole convolution that the passes compute
    # together). The float32 kernels' launches are those of the
    # "highest" run (the three passes on wgmma, their bound that of six
    # bf16 products, the float32 CUDA cores' beside it as
    # bound_fp32_ms), the
    # tensor-core kernels' (and the split bound) those of the default
    # dial's "split" run.
    wg_pfft_src = "jolideco_torch/csrc/pfft_conv_wg.cu"
    for name, source, key, line, err, path in (
            ("pfft_cols_fwd", wg_pfft_src, "cols_fwd", 379,
             pmain["cols_fwd"][0], pfft_train["highest"]),
            ("pfft_rows_combine", wg_pfft_src, "rows", 398,
             max(pmain["rows_forward"][0], pmain["rows_adjoint"][0]),
             pfft_train["highest"]),
            ("pfft_cols_inv", wg_pfft_src, "cols_inv", 460,
             max(pmain["cols_inv_forward"][0],
                 pmain["cols_inv_adjoint"][0]), pfft_train["highest"]),
            ("pfft_cols_fwd_tc", wg_pfft_src, "cols_fwd_split", 379,
             pmain["cols_fwd_tc"][0], pfft_train["high"]),
            ("pfft_rows_combine_tc", wg_pfft_src, "rows_split", 398,
             max(pmain["rows_tc_forward"][0], pmain["rows_tc_adjoint"][0]),
             pfft_train["high"]),
            ("pfft_cols_inv_tc", wg_pfft_src, "cols_inv_split", 460,
             max(pmain["cols_inv_tc_forward"][0],
                 pmain["cols_inv_tc_adjoint"][0]), pfft_train["high"]),
            ("pfft_cols_fwd_bf16", wg_pfft_src, "cols_fwd_bf16", 379,
             pmain["cols_fwd_bf16"][0], default["pfft"]),
            ("pfft_rows_combine_bf16", wg_pfft_src, "rows_bf16", 398,
             max(pmain["rows_bf16_forward"][0],
                 pmain["rows_bf16_adjoint"][0]), default["pfft"]),
            ("pfft_cols_inv_bf16", wg_pfft_src, "cols_inv_bf16", 460,
             max(pmain["cols_inv_bf16_forward"][0],
                 pmain["cols_inv_bf16_adjoint"][0]), default["pfft"])):
        table.append((name, source, f"jolideco_tpu/ops/pallas_fft.py:{line}",
                      path, err, ptiming[key], ptiming[key + "_plain"],
                      pbound[key]))
        library[name] = {"cols_fwd": ptiming["torch_fft_cols"], "rows": None,
                         "cols_inv": ptiming["torch_ifft_cols"]}[
                             key.split("_split")[0].split("_bf16")[0]]
    print(json.dumps({"pfft": {
        "batch": "5 pairs of 1024^2, n = 1152",
        "errors_against_float64": {
            label: {name: dict(zip(("kernel", "plain_float32", "max_abs",
                                    "cufft_pair"), e))
                    for name, e in pfft[label].items()}
            for label in pfft if label not in ("timing", "bounds", "tall")},
        "tall_pass1": pfft["tall"],
        "ms": ptiming, "bounds": pbound,
        "path": {**{f"{key}_{dial}": pfft_train[dial][key]
                    for dial in ("high", "highest")
                    for key in ("steps_per_s", "peak_bytes", "flux_diff",
                                "flux_rel")},
                 "probe_seconds": pfft_probe["error_seconds"],
                 "probe_peak_bytes": pfft_probe["peak_bytes"],
                 "errors_against_fft": pfft_probe["error_rel"],
                 "fft_steps_per_s": slice_["high"]["steps_per_s"],
                 "fft_probe_seconds": errors["high"]["error_seconds"]},
    }}))
    # the marginalise kernels where the weights are mixed (phase 2):
    # errors against float64 beside the float32 plain version's, times
    # and bounds at the 1024² image and its rows under mixed_gmm()
    mixed = marg["mixed"]
    print(json.dumps({"mixed_weights": {
        "support": mixed["support"], "max_abs_dp": mixed["max_dp"],
        "median_largest_weight": mixed["median_p_max"],
        "kernels": [
            {"name": name, "max_abs_err": mixed["errors"][key][0],
             "float32_plain_err": mixed["errors"][key][1],
             "max_abs": mixed["errors"][key][2],
             "ms": mixed["timing"][step + "_ms"], **mixed["bounds"][step],
             **({"device_ms": mixed["timing"]["mix_device_ms"]}
                if step == "mix" else {})}
            for name, key, step in (
                ("gmm_fused_bwd_marg", "bwd", "bwd"),
                ("gmm_unit_marg", "unit", "unit"),
                ("gmm_hvp_marg_weights", "weights_dp", "weights"),
                ("gmm_hvp_marg_mix", "mix", "mix"),
            )
        ],
        "gmm_hvp_marg_weights_p": mixed["errors"]["weights_p"],
        "hvp_both_stages": mixed["errors"]["hvp"],
        "gmm_fused_fwd_marg": {
            "max_rel_err": mixed["errors"]["fwd"][1],
            "argmax_flips": mixed["errors"]["fwd"][2],
            "ms": mixed["timing"]["fwd_ms"], **mixed["bounds"]["fwd"]},
    }}))
    # K1 lse and K4 of "highest" on wgmma (phase 2): errors against the
    # plain versions and float64 at both images and past one tile of
    # components, times and bounds at 1024^2
    print(json.dumps({"marg_f32": {
        **{label: marg[label] for label in (MAIN, "{}x{}".format(*RAGGED))},
        "K=256 wide": marg["wide"],
        "ms": {key: mtiming[key + "_ms"] for key in ("fwd", "bwd")},
        "bound_six_ms": {key: mbounds[key + "_six"]["bound_ms"]
                         for key in ("fwd", "bwd")},
        "bound_fp32_ms": {key: mbounds[key]["bound_ms"]
                          for key in ("fwd", "bwd")},
        "mixed_ms": {key: mixed["timing"][key + "_ms"]
                     for key in ("fwd", "bwd")},
    }}))
    # the marginalised prior's kernels on the tensor cores (phase 2), the
    # two dials' marginalised training and probe (phase 5)
    print(json.dumps({"marg_split": {
        **{label: res for label, res in msplit.items()},
        "probe": marg_probe,
        "dial_flux_diff": marg_train["dial_flux_diff"],
        "dial_flips_limit": K1_SPLIT_FLIPS,
        "final_argmax_flips": marg_train["final_flips"],
        "steps_per_s": {dial: marg_train[dial]["steps_per_s"]
                        for dial in ("high", "highest")},
        "peak_bytes": {dial: marg_train[dial]["peak_bytes"]
                       for dial in ("high", "highest")},
    }}))
    # K1's "split" kernel on the tensor cores (phase 2) and the two dials'
    # training (phase 3)
    print(json.dumps({"k1_split": {
        **{label: kernels[label]["split"] for label in (MAIN, "{}x{}".format(
            *RAGGED))},
        **{"{}x{} K=256 {}".format(*RAGGED, key): kernels[key]
           for key in ("wide", "cancelled")},
        **{"{}x{} K=256 {} f32".format(*RAGGED, key): kernels[f"{key}_f32"]
           for key in ("wide", "cancelled")},
        "dial_flux_diff": slice_["dial_flux_diff"],
        "dial_flips_limit": K1_SPLIT_FLIPS,
        "final_argmax_flips": slice_["final_flips"],
        "k2_tile_components": slice_["k2_tiles"],
        "k2_many_components": kernels["k2_many"],
        # the float32 GMM kernels' work under "split" (three bf16
        # products each, at the bf16 peak): the dial's bound
        "split_bound_ms": {
            "gmm_fused_fwd_marg": mbounds["fwd_split"]["bound_ms"],
            "gmm_fused_bwd_marg": mbounds["bwd_split"]["bound_ms"],
            "gmm_score_rows": rbounds["score_split"]["bound_ms"],
            "gmm_unit_marg": mbounds["unit_split"]["bound_ms"],
            "gmm_hvp_marg_weights": mbounds["weights_split"]["bound_ms"],
        },
        "steps_per_s": {dial: slice_[dial]["steps_per_s"]
                        for dial in ("high", "highest")},
    }}))
    # K5 split and the row map (phase 2, the trained flux of phase 3) and
    # the probe under both dials (phase 4)
    ragged = "{}x{}".format(*RAGGED)
    print(json.dumps({"k5_split": {
        **{label: patch[label]["split"] for label in (MAIN, ragged)},
        **{f"{ragged} K=256 {key}": patch[key]
           for key in ("wide", "cancelled")},
        "ms": {key: rtiming[key] for key in ("split_ms", "split_lse_ms",
                                             "split_plain_ms", "score_ms")},
        "split_bound": rbounds["score_split"],
        "row_map": {MAIN: rows["row_map"],
                    ragged: patch[ragged]["row_map"],
                    "row index mod K": patch["many"],
                    "trained": slice_["row_map"]},
        "probe": {dial: {key: errors[dial][key]
                         for key in ("launches", "error_seconds",
                                     "peak_bytes")}
                  for dial in ("high", "highest")},
        "probe_dial_error_rel": errors["dial_error_rel"],
    }}))
    # the "default" setting: phase 2's bf16 kernels, phase 7's paths
    print(json.dumps({"default_dial": {
        "k1_bf16": {label: kernels[label]["bf16"]
                    for label in (MAIN, "{}x{}".format(*RAGGED))},
        **{"k1_bf16 {}x{} K=256 {}".format(*RAGGED, key): kernels[
            f"{key}_bf16"] for key in ("wide", "cancelled")},
        "k5_bf16": {label: patch[label]["bf16"]
                    for label in (MAIN, "{}x{}".format(*RAGGED))},
        **{"k5_bf16 {}x{} K=256 {}".format(*RAGGED, key): patch[
            f"{key}_bf16"] for key in ("wide", "cancelled")},
        "marg_bf16": mb,
        "k3_bf16": {name: pmain[name] for name in pmain if "bf16" in name},
        "paths": default,
        "jax_documented_flips": JAX_DEFAULT_FLIPS,
    }}))
    # no single PyTorch call computes any of the GMM kernels' functions
    # (each needs a gather of per-row components, or a max or softmax
    # over quadratic forms), so their library_ms is null. K2's, K6's,
    # K7's and K9b's calls take longer on the host than their kernels on
    # the card: their rows add device_ms, the profiler's device time of a
    # call, beside ms (CUDA events, as every row).
    # max_abs_err: K1, K2, K5-K7 against the float32 plain version, K1
    # split, K1 lse split and K5 split against the split plain version;
    # K1 logsumexp its values against it; K4, K8, K9a, K9b and K3
    # against the float64 plain version, K4 split (the pipeline from K1
    # lse split) against the float64 pipeline (phase 2)
    extra = {"gmm_fused_bwd": {"device_ms": timing["bwd_device_ms"]},
             "gmm_unit_map": {"device_ms": rows["row_map"]["unit"][
                 "device_ms"]},
             "gmm_hvp_map": {"device_ms": rows["row_map"]["hvp"][
                 "device_ms"]},
             "gmm_hvp_marg_mix": {"device_ms": mtiming["mix_device_ms"]}}
    # the instance of csrc/gmm_score_wg.cu's kernel behind each of its
    # wrappers: gmm_score_wg_kernel<image, products, epilogue> (epilogue 0
    # the maximum, 1 the logsumexp, 2 K4's mixture, 3 K8's, 4 K9a's
    # weights)
    for name, image, epi in (("gmm_fused_fwd", "true", 0),
                             ("gmm_fused_fwd_marg", "true", 1),
                             ("gmm_fused_bwd_marg", "false", 2),
                             ("gmm_score_rows_marg", "false", 1),
                             ("gmm_unit_marg", "false", 3),
                             ("gmm_hvp_marg_weights", "false", 4)):
        for suffix, prod in (("", 6), ("_tc", 3), ("_bf16", 1)):
            extra.setdefault(f"{name}{suffix}", {})["instance"] = (
                f"gmm_score_wg_kernel<{image}, {prod}, {epi}>")
    for suffix, prod in (("_tc", 3), ("_bf16", 1)):
        extra.setdefault(f"gmm_score_rows{suffix}", {})["instance"] = (
            f"gmm_score_wg_kernel<false, {prod}, 0>")
    # K3's pass 2 beside cuFFT's packed pair (the whole convolution), and
    # the float32 passes with their float32 CUDA-core bound (phase 2)
    for suffix in ("", "_tc", "_bf16"):
        extra["pfft_rows_combine" + suffix] = {
            "cufft_pair_ms": ptiming["cufft_pair"]}
    for name, key in (("pfft_cols_fwd", "cols_fwd"),
                      ("pfft_rows_combine", "rows"),
                      ("pfft_cols_inv", "cols_inv")):
        extra.setdefault(name, {})["bound_fp32_ms"] = pbound[
            key + "_fp32"]["bound_ms"]
    # every "highest" GMM kernel likewise: bound_ms is that of six bf16
    # products on the tensor cores, the least time of its logits
    # (phase 2), whether it runs there (K1, K1 lse, K4, K5 lse, K8, K9a)
    # or on the CUDA cores (K5 MAP)
    for name, key in (("gmm_fused_fwd_marg", "fwd"),
                      ("gmm_fused_bwd_marg", "bwd"),
                      ("gmm_unit_marg", "unit"),
                      ("gmm_hvp_marg_weights", "weights")):
        extra.setdefault(name, {})["bound_fp32_ms"] = mbounds[key][
            "bound_ms"]
    extra["gmm_score_rows"] = {"bound_fp32_ms": rbounds["score"][
        "bound_ms"]}
    extra["gmm_score_rows_marg"]["bound_fp32_ms"] = rbounds["score"][
        "bound_ms"]
    extra["gmm_fused_fwd"]["bound_fp32_ms"] = kernels["fwd_bound_fp32"][
        "bound_ms"]
    print(json.dumps({"default_entry": entry}))
    print(json.dumps({"upsampled": upsampled}))
    print(json.dumps({"priors": priors}))
    print(json.dumps({"forward_model": forward_model}))
    print(json.dumps({"io": io}))
    print(json.dumps({"mesh": {name: {k: v for k, v in run.items()
                                      if k != "launches"}
                               for name, run in mesh.items()}}))
    print(json.dumps({"conv_modes": {
        "card": card, **{mode: {
            "shape": run["shape"], "convolution": run["convolution"],
            "training": {k: v for k, v in run["training"].items()
                         if k != "launches"},
            "probe": run["probe"] and {k: v for k, v in run["probe"].items()
                                       if k != "launches"},
            "small": run["small"], "seconds": run["seconds"]}
            for mode, run in conv_modes.items()}}}))
    # launches_phase9: each kernel's launches in phase 9's three runs at
    # the 2048^2 flux (the joint run, the probe run, the quick start);
    # launches_phase10: in phase 10's runs; launches_phase11: in phase
    # 11's (the last of each timed reading's repeats); launches_phase12:
    # in phase 12's counted run of the command line's body
    phase9 = {run: upsampled[run]["launches"]
              for run in ("joint", "probe", "sequential")}
    phase10 = {run: priors[run]["launches"] for run in (
        "multiscale", "multiscale_probe", "jitter", "group", "example")}
    phase10.update({name: run["launches"]
                    for name, run in priors["parametric"].items()})
    phase11 = {run: forward_model[run]["launches"] for run in (
        "multiband_fft", "multiband_pfft", "multiband_probe",
        "multiband_sequential", "fallback", "sparse", "sparse_probe",
        "gmm16")}
    # launches_phase14: in the last of each mode's timed runs and in the
    # "ct" probe
    phase14 = {mode: run["training"]["launches"]
               for mode, run in conv_modes.items()}
    phase14["ct_probe"] = conv_modes["ct"]["probe"]["launches"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": path["launches"][name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
         "library_ms": library[name], **extra.get(name, {}),
         "launches_phase9": {run: n[name] for run, n in phase9.items()},
         "launches_phase10": {run: n[name] for run, n in phase10.items()},
         "launches_phase11": {run: n[name] for run, n in phase11.items()},
         "launches_phase12": io["launches"][name],
         "launches_phase14": {run: n[name] for run, n in phase14.items()},
         "launches_phase13": {run: [n[name] for n in mesh[run]["launches"]]
                              for run in P13_RUNS}}
        for name, source, replaces, path, err, ms, plain_ms, bnd in table
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
