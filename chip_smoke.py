#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sm_hpss_mtl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: the CUDA sources of ``sm_hpss_mtl_tpu_torch/csrc`` with nvcc, one
   process per source, all started together;
3. kernels: K1 and K2 (``frontend.launch``, the fused kernel at any
   length), K3 (``hpss``, ``hpss_masks``) and K4 (``hpss_mel``) against
   their plain PyTorch versions on the card, at every launch shape of the
   paths below and at edge geometries; then at every median pair of
   ``ops/hpss.py::KERNEL_MEDIANS`` (the tuner's l_harm 11-51 and l_perc
   21-51) at the edge lengths of each pair's half width and of K1's tile,
   the training and tuning launches, 20 and 60 mel bands, K1 at 128 bands
   in Whisper-MTL's slabs of a 20-minute broadcast, short and long
   clips, with times, bounds, registers, spills and blocks per SM per
   pair (``phase_pairs``); K1 and K2 in halo mode (the time-sharded front
   end's shards) at the first, an interior and the last shard's edge
   flags, at every shard shape of phase 11 and at l_harm 51's smallest
   block, with the mode's times and bounds (``phase_halo``); the modes the
   JAX kernels take beyond 'highest', power 2 and ``KERNEL_MEDIANS``
   (``phase_modes``): K1 and K2 at ``dft_precision='bf16x3'`` against
   their plain bf16x3 versions at every (21, 11) shape above, halo mode
   included, with both precisions' times in turns beside their bounds and
   the DFT as the kernels compute it on the tensor cores, bf16x3's error
   against float64 many times split TF32's, and the 10-minute broadcast's
   bf16x3 features; K1-K4 at powers 1 and 1.5 (a kernel argument) beside
   power 2, and at the pairs (3, 3), (15, 7) and (61, 61) (networks
   generated at the build) with times, registers and spills; ``cli.mtl
   --dft-precision bf16x3 --pipeline device`` for Lemaire-MTL and Jang-MTL
   (the bf16x3 counters move, the 'highest' ones do not) and one bf16x3
   audio step card vs CPU; the TCN block's kernels (``ops/tcn_block.py``,
   ``phase_tcn_block``) against their plain versions at the training
   step's 36 x 32 x 68 and the segmenter's 10000 x 32 x 68, in float32 and
   bf16 (the forwards bit for bit, the backward within a float32
   tolerance), with times beside their bytes bounds, then in Lemaire-MTL:
   an eval call and a train step against the chain, the patch step graphed
   against eager, 24 launches of each kernel a step or call; Jang's conv
   block kernel (``ops/conv_block.py``, ``phase_conv_block``) against its
   plain version at Jang-MTL's three block shapes of a 1024-window call, in
   float32 and bf16, pooling 'SAME' and 'VALID', with times beside the
   bytes bound and the eager chain's, then a Jang-MTL call (float32, bf16),
   a single-task Jang call and Jang-MTL's vmapped multi-trial evaluation
   step against the chain, three launches a call; the SSD scan kernel
   (``ops/ssd_scan.py``, ``phase_ssd_scan``) against its plain version at
   Granite-4.0-H's head shapes (64 heads of 64, states of 128) for 1-4
   slots, with and without a start state, a short last scan chunk, one
   launch a call, timed beside its bound at the stream cell's 4 x 1500;
4. Lemaire-MTL whole-signal serving: ``cli.segment.main`` on a synthetic
   60 s broadcast with full-width weights from a seeded init, and the same
   run on the CPU as its reference;
5. Lemaire-MTL slabbed serving: a 10-minute broadcast (~60k frames,
   featurized in 16384-frame slabs, 10000-window chunks);
6. Lemaire-MTL features of the 10-minute broadcast through K1 against the
   plain version on the card (max |delta| <= 0.02 dB); Whisper-MTL's
   features (128 bands) of a 20-minute broadcast the same way, in
   ``featuregram_slabbed``'s 8 slabs, one K1 launch each;
7. Jang-MTL serving (``--model Jang_et_al_MTL``, features through K2): the
   60 s and 10-minute broadcasts on the card, a 10 s broadcast on the card
   and on the CPU (tracks within 1e-3), and the 10-minute features through
   K2 against the plain version (<= 0.02 dB); Papakostas-MTL serving (K2
   at n_fft 400): the 60 s broadcast on the card, the 10 s one on the card
   and on the CPU (tracks within 1e-3); Lemaire's variants,
   ``--model Lemaire_et_al_Cascaded_MTL`` (``LogMelHarmSpec``, K1 with its
   harmonic half kept) and ``--model Lemaire_et_al_MTL_5class``, on the
   60 s broadcast on the card and on the CPU (tracks within 1e-3);
8. HPSS resynthesis: ``cli.hpss_resynth.main`` on the 60 s broadcast on
   the card (masks through K3) and on the CPU;
9. file-wise evaluation: on a MUSAN-shaped toy corpus (3-30 s files of
   music, speech and noise, and clips of 0.12-0.2 s),
   ``FileWiseTester.test_model`` and ``smr_sweep`` with Lemaire-MTL through
   ``Featurizer(bucket=False)`` (K1, and K4 for items under 20 frames) on
   the card and on the CPU (predictions within 1e-3, labels and confusion
   matrices equal but for near-ties); ``Classifier.classify_file`` on the
   60 s broadcast on both; one Jang-MTL ``test_model`` on the card (K2,
   and K3 for short items), and one Papakostas-MTL ``test_model`` (K2 at
   n_fft 400, K3 for short items); on the card and on the CPU as
   Lemaire-MTL's, a 5-class ``test_model`` (noise singles and
   speech+noise pairs, a (5, 5) confusion matrix), an intermediate-fusion
   ``test_model`` (``dual_tower``), and ``cli.fuse_late.main`` over two
   checkpoints (``LogMelHarmSpec`` and ``LogMelPercSpec`` models; the
   driver's bucketed featurizer, K1 once per item and leg);
10. training at full width on a ``make_toy_musan`` corpus (9 files of 4 s
   per class), each through ``cli.mtl.main`` or ``cli.baseline.main`` for
   fold 0: Lemaire-MTL (2 epochs of 10 train and 2 val steps) by the
   device pipeline (K1 once per train or eval step, at 48 clips x 11120
   samples) and by the host pipeline (K1 once per featurized file), and
   with ``--frame-level-scaling`` (the statistics pass: K1 once per
   training file); Jang-MTL by both pipelines (K2 at n_fft 512: 67 frames
   a clip), Papakostas-MTL (K2 at n_fft 400) and Doukhan-MTL (K1) by the
   device pipeline; the single-task Jang and Papakostas models through
   ``cli.baseline`` for one epoch (no kernel); after ``cli.make_folds
   --with-noise``, Lemaire's variants by the device pipeline:
   Cascaded-MTL through ``cli.mtl``, the 5-class model through
   ``cli.five_class`` (K1 at 80 clips x 11120 samples) and the
   intermediate-fusion model through ``cli.fuse_intermediate`` (by the
   host pipeline too, the dual batcher).  One Lemaire-MTL train step
   from the same weights on the card and on the CPU (loss, every update,
   BatchNorm statistics), and with K1 inside; the same for Jang-MTL with
   K2 inside and for Papakostas-MTL on patches, the intermediate-fusion
   model with K1 inside and the 5-class model on patches; 20 steps on one
   batch for Lemaire-MTL, Jang-MTL and the intermediate-fusion model (the
   loss falls); the device pipeline's step time (CUDA events) and the
   kernel's and the device's share of it (profiler), for Lemaire-MTL,
   Jang-MTL, the intermediate-fusion and the 5-class models; tuning on the
   same corpus through ``cli.tune.main`` with no ``--device``: the l_harm
   and l_perc grids by the device pipeline (K1 at each width's pair), the
   loss-weight grid with ``--vmap`` and two seed replicates (the
   multi-trial program, host pipeline), and a Bayesian search over the
   MTL heads, each writing the JAX CLI's ``Performance_Tuning.csv``; one
   four-trial step from the same stacked weights on the card and on the
   CPU at the patch step's bars, and the step time of four trials against
   one; ``cli.featurize`` over the corpus on the card (K1 once per bucket
   batch) and on the CPU (features within 0.02 dB); ``cli.tsne``'s
   device part (``collect_class_patches``, ``--stat Row``) on the card
   against the CPU (the GPU machine has no sklearn for its embedding);
   the float64 reading of the Papakostas-MTL and 5-class patch steps (CPU
   float32 and card float32 against CPU float64); bf16 compute: a patch
   step (on the CPU's features) and an audio step (K1 inside for
   Lemaire-MTL, K2 for Jang-MTL) in bf16 on the card, three times each,
   against the CPU's bf16 steps and the card's float32 audio step, at
   each parameter's bar from the CPU's recorded bf16-against-float32
   spread (``BF16_STEP_BARS``), both steps' times bf16 against float32 in
   turns, a full-width ``cli.mtl --bf16`` fold by the device pipeline and
   ``cli.segment --ckpt`` of its checkpoint on the 60 s broadcast, card and
   CPU; the segmenter's 'featuregram' and 'none' scopes on the 60 s
   broadcast, card and CPU; and, where libmpg123 and libmp3lame load, the
   10 s broadcast encoded to mp3, decoded and served through
   ``cli.segment``, card and CPU (else an ``{"mp3": ...}`` line says
   which library is missing);
10b. host: the native host kernels (``sm_hpss_mtl_tpu_torch/native``, built
   with g++ on this host) against their numpy twins at
   ``tests/test_native.py``'s tolerances; ``utils.time_op`` on K1 at 48
   clips x 11120 samples beside ``cuda_ms`` of the same launch (a ratio
   outside 0.5-2 fails), ``utils.device_trace``'s trace naming K1's kernel
   (in a fresh process; in this one its K1 events are a reading) and
   ``utils.stage_timer``'s sink; ``tools/scale_rehearsal_torch.py`` at
   smoke size in a child process (4 + 4 files at a tenth of their
   durations, 2 epochs, the device pipeline): per-epoch rows, the steps of
   ``with_steps_from_durations`` on its folds, its K1 launches (counted in
   the child, added to K1's) and K1 against its plain version at each of
   the child's launch shapes that phase 3 did not check; the readings on
   a ``{"host": ...}`` line;
11. parallel, on the one card as a mesh of ``cuda:0`` repeated: the
   time-sharded front end (``parallel.stft_hpss_mel_time_sharded`` at mel
   and full resolution, ``featuregram_time_sharded`` with its pad and tail
   splice) over 4 and 8 shards of the production leg of
   ``MULTICHIP_r05.json`` against one unsharded K1 or K2 launch, at every
   join; ``cli.segment``'s multi-device branch (``devices=[cuda:0] * 4``)
   on the 10-minute broadcast against the one-device run (features within
   0.02 dB, tracks within 1e-3); ``parallel.make_dp_train_step`` at world
   size 1 over NCCL on a Lemaire-MTL patch step and audio step (K1 inside)
   against ``make_train_step`` from the same weights; ``fit_multi`` of four
   trials over two shards against the unsharded run; the readings on a
   ``{"parallel": ...}`` line;
12. checks on the launch counts, and that every launch shape of phases 4-11
   (the bf16 steps' and their timings' too) was checked in phase 3 (K1
   and K2 also at 12 clips x 43760 samples, the device pipeline's launch
   on a corpus of MUSAN's size, and K1 at 20 x 43760, the 5-class model's
   there); the launches per median pair, per mask power (all at 2) and
   in halo mode.

Each path runs with the launch counts set to 0 just before it and read
just after.  Every kernel also reports its profiler device time, blocks
per SM, the ptxas registers and spills, and the comparators per output
of its median networks, counted in the ``csrc/`` it was built from; K1
and K2 their max |delta| against a float64 run of the plain version at
the timed shape, and their bound also with the medians priced at their
own networks; K3 its times on a rotation of inputs larger than L2 and at
Jang's short evaluation shape, and K4 the short-clip route (``stft_mag``
and K4) against K1 at the same length.  Every bound prices the medians
at the shared-core networks' count, the least work known.  Prints a
``{"kernels": [...]}`` line (each kernel with a record per median pair
under ``pairs`` and per other power under ``power_modes``, and K1's and
K2's halo mode and bf16x3 as records of their own), a serving-times
line, a resynthesis line, an evaluation line, a training line, a tuning
line, a parallel line, a host line, a modes line, the script's total
seconds, the card line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, and
prints no result, if any phase fails or no GPU is present.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SR = 16000
SEED = 0
#: K1 and K2 tolerance against their plain version, as the JAX package
#: holds its Pallas kernel to the jnp oracle (tests/test_frontend_pallas.py).
RTOL, ATOL = 2e-4, 2e-5
#: K3 and K4 tolerance against their plain versions, as
#: tests/test_hpss_pallas.py holds the spectral Pallas kernels.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
#: Feature fidelity bar of the serving path (BASELINE.md).
FEATURE_DB_TOL = 0.02
#: Probability tracks, GPU run against the CPU run of the same CLI; also
#: the evaluation's predictions and the Classifier's probabilities.
TRACK_TOL = 1e-3
#: A patch whose CPU top two 3C probabilities lie this close may take
#: another label on the card.
TIE_TOL = 1e-3
#: Evaluation corpus: files per class of 3-30 s, short clips per class,
#: and the sweep's SMR levels (the reference's).
EVAL_FILES, EVAL_SHORT = 6, 3
SMR_LEVELS = (-5, 0, 5, 10, 15, 20)
#: Training corpus: files per class and seconds per file.
TRAIN_FILES, TRAIN_SECONDS = 9, 4.0
#: Training run of each pipeline: epochs, train and val steps per epoch.
TRAIN_EPOCHS, TRAIN_STEPS, VAL_STEPS = 2, 10, 2
#: K1's and K2's launches in the device training pipeline, (clips,
#: samples): 16 clips per class of one 68-frame patch (the toy corpus
#: resolves ``clip_patches`` to 1), and 4 clips per class of four patches
#: (a corpus of MUSAN's size resolves it to 4).  The crop is framed for a
#: 400-sample window: at n_fft 512 it holds 67 and 271 frames.
TRAIN_SHAPES = ((48, 11120), (12, 43760))
#: K1's launches in the 5-class device pipeline: the same crops for five
#: classes.
FIVE_CLASS_SHAPES = ((80, 11120), (20, 43760))
#: The time-sharded front end's edge flags (mirror_left, mirror_right) of
#: the first, an interior and the last shard.
HALO_FLAGS = ((1, 0), (0, 0), (0, 1))
#: K1's and K2's halo-mode launches, (B, frames a shard, l_harm): the
#: production leg of MULTICHIP_r05.json (2 x 1536 frames) over 8 and 4
#: shards, the 10-minute broadcast over 4 shards (59 998 frames padded to
#: 60 000), and l_harm 51 at its smallest legal block (2 * 25 frames).
HALO_SHAPES = ((2, 192, 21), (2, 384, 21), (1, 15000, 21), (1, 50, 51))
#: Phase 11: the production leg's frames, the featuregram run's (3 short of
#: a multiple of 4 and 8: the pad and the tail splice), the shard counts on
#: the one card, the segmenter's shards, the tuner's trial shards.
SHARD_FRAMES, SHARD_FG_FRAMES, SHARD_COUNTS = 1536, 1533, (4, 8)
SEGMENT_SHARDS, TRIAL_SHARDS = 4, 2
#: The tail splice of ``featuregram_time_sharded``: 3 * (l_harm // 2)
#: frames through the dispatcher (K1 or K2).
SPLICE_FRAMES = 3 * (21 // 2)
#: Whisper-MTL's features: K1 at 128 bands (its preset) over a 20-minute
#: broadcast (119 998 frames), which ``featuregram_slabbed`` cuts into 8
#: slabs of 16384 frames plus l_harm // 2 = 10 frames of margin at each
#: interior seam: launches of 16394 frames (the two edge slabs) and 16404
#: (the six interior ones).
WHISPER, WHISPER_SECONDS, WHISPER_MELS = "Whisper_MTL", 1200.0, 128
WHISPER_SLAB_FRAMES = (16394, 16404)
#: Lemaire's variants: Cascaded-MTL, the 5-class model, intermediate fusion.
CASCADED, FIVE, IF = ("Lemaire_et_al_Cascaded_MTL",
                      "Lemaire_et_al_MTL_5class", "Lemaire_et_al_MTL_IF")
#: The five classes of the 5-class folds, in batch order.
FIVE_CLASSES = ["music", "speech", "speech+music", "noise", "speech+noise"]
#: The models phase 10 trains beside Lemaire-MTL, and their run names.
IMAGE_MTL = ("Jang_et_al_MTL", "Papakostas_et_al_MTL", "Doukhan_et_al_MTL")
BASELINES = ("Jang_et_al", "Papakostas_et_al")
#: One train step on the card against the same step on the CPU: the loss
#: (relative), each parameter's update (relative to the update's L2 norm,
#: plus a rounding floor, see ``_step_card_vs_cpu``), the BatchNorm
#: statistics (absolute, or relative above 1).
STEP_LOSS_RTOL, STEP_UPDATE_RTOL, STEP_STATS_TOL = 1e-3, 1e-2, 1e-3
#: The same step with K1 inside on the card: each update's bar.  K1 holds
#: 2e-4 of its plain version, but the crop-local row standardization
#: divides rows near the dB floor by a small std and moves them by up to
#: 0.1, which moves some updates by a few percent of their norm (3.0e-2
#: on an H100 80GB HBM3 for this corpus and seed).
STEP_AUDIO_UPDATE_RTOL = 1e-1
#: Jang-MTL's step with K2 inside: each update's bar.  Its mel-scale
#: kernels read the standardized features directly, and a 67-frame row at
#: the dB floor but for one frame standardizes to 0 where the row is
#: exactly constant (the CPU's, say) and to sqrt(66) = 8.1 at that frame
#: where it is not (the card's, 1e-6 dB off): the features differ by up
#: to 8.1 in 34 rows of 24672, which moves melCl_P's update by 17% of its
#: norm (an H100 80GB HBM3 for this corpus and seed).
STEP_JANG_AUDIO_UPDATE_RTOL = 5e-1
#: The intermediate-fusion model's step with K1 inside: each update's bar.
#: Its two towers read the same standardized features as Lemaire-MTL, near-
#: floor rows up to 0.1 apart card vs CPU, and carry them further: on an
#: H100 80GB HBM3 for this corpus and seed the largest update, a bias of
#: the percussive tower whose update is 4.5% of the lr, moves by 0.108 of
#: its norm (Lemaire-MTL's largest: 3.0e-2), while the same model's patch
#: step on the CPU's features holds the patch bars.
STEP_IF_AUDIO_UPDATE_RTOL = 3e-1
#: The biases that feed a BatchNorm have a gradient of 0 in exact
#: arithmetic; their updates, rounding noise on both sides, are held to
#: this share of the first lr per element.
ZERO_GRAD_UPDATE = 1e-2
#: The optimizer of the card-against-CPU steps of the image models: plain
#: SGD (Papakostas's), whose update is lr * g, so that the update bars hold
#: the gradients.  Jang's and Doukhan's Adam takes lr * g / (|g| + eps) at
#: its first step, which turns a gradient that is 0 in exact arithmetic (a
#: conv bias before a BatchNorm) into an update of ~lr of either sign.
STEP_SGD = "Papakostas_et_al"
#: bf16 compute (``--bf16``): the models whose bf16 train step is held on
#: the card, Lemaire-MTL (K1 inside its audio step) and Jang-MTL (K2): the
#: optimizer of their steps (None: the model's own) and the model's float32
#: audio-step bar.
#: Dropout off, one crop batch, the same float32 weights in every run.
BF16_STEP_MODELS = {"Lemaire_et_al_MTL": (None, STEP_AUDIO_UPDATE_RTOL),
                    "Jang_et_al_MTL": (STEP_SGD, STEP_JANG_AUDIO_UPDATE_RTOL)}
#: The CPU's bf16-against-float32 spread of one step at full width, per
#: model and parameter (a patch step on the CPU's features; the CPU's audio
#: step is the same computation), recorded by tools/bf16_step_bars.py on
#: the GPU machine's CPU.  Every bf16 bar below is BF16_SPREAD_FACTOR times
#: a recorded spread (a loss, a BatchNorm statistic, one parameter's update
#: difference relative to its norm), plus the rounding floor of
#: ``_hold_step`` on an update: two bf16 programs that each lie within the
#: spread of float32 lie within twice it of each other.  Held:
#: - the patch step, card bf16 against CPU bf16 on the same features, at
#:   each parameter's own bar, and not degenerate (below);
#: - the audio step, card bf16 against card float32 (the same features on
#:   both sides, since the kernels write float32 in every mode), at each
#:   parameter's own bar;
#: - the audio step, card bf16 against CPU bf16: the features differ as in
#:   the float32 audio steps, so the model's float32 audio-step bar
#:   (``STEP_*_RTOL``, ``ZERO_GRAD_UPDATE``) is added to each, and the
#:   update is not degenerate.
#: The BatchNorm-fed biases are held per lr per element (``_hold_step``),
#: at twice their recorded spread plus ZERO_GRAD_UPDATE.
BF16_STEP_BARS = os.path.join("tools", "bf16_step_bars.json")
BF16_SPREAD_FACTOR = 2.0
#: A parameter of fewer than BF16_MIN_ELEMENTS elements (an output layer's
#: bias) has no spread of its own: the difference of one to three numbers
#: is one draw, which other features redraw (heads.S_out.bias of
#: Lemaire-MTL read 3.0e-4 on the CPU's features and 6.6e-4 on the card's,
#: H100 80GB HBM3, 700.00 W); it takes the model's largest recorded spread.
#: Not degenerate: each card bf16 update of at least BF16_MIN_ELEMENTS
#: elements (a BatchNorm-fed bias aside) has a norm within 1 +-
#: BF16_NORM_RATIO_TOL of the CPU bf16 update's and a cosine with it of at
#: least BF16_MIN_COSINE.  An update within r of another's norm has a norm
#: ratio within 1 +- r and a cosine of at least sqrt(1 - r^2); the largest
#: card-against-CPU bf16 audio-step reading before these bars was r =
#: 0.184 (Jang-MTL, H100 80GB HBM3, 700.00 W), which gives 1 +- 0.184 and
#: 0.983.  A step that updates nothing (ratio 0, cosine 0) or half (ratio
#: 0.5) fails, which the run checks on the CPU's own update.
BF16_NORM_RATIO_TOL = 0.3
BF16_MIN_COSINE = 0.9
BF16_MIN_ELEMENTS = 8
#: The card's bf16 steps are taken this many times, each on a fresh copy of
#: the model after NaN has been written over a block of freed card memory
#: that the allocator hands out again, and every repeat is held.
BF16_STEP_REPEATS = 3
BF16_SCRIBBLE_BYTES = 1 << 30
#: The tensors whose card-against-CPU patch-step readings (9.86e-3 and
#: 1.64e-3 of the update's norm, H100 80GB HBM3, 700.00 W) the float64
#: reading explains.
CONDITIONING_TENSORS = {"Papakostas_et_al_MTL": "c1.bias",
                        FIVE: "tcn.stack1_dilation32.dilated_conv.weight"}
#: Clips under this many frames take the short-clip kernels (K4, K3).
SHORT_FRAMES = 2 * (21 // 2)
#: The tuning phase's runs of ``cli.tune.main`` on the training corpus:
#: name, arguments, and the rows each writes; every run takes one epoch of
#: TUNE_STEPS train steps and one val step.
TUNE_STEPS = 3
TUNE_RUNS = (
    ("tune_l_harm", ("--mode", "grid", "--param", "l_harm"), 5),
    ("tune_l_perc", ("--mode", "grid", "--param", "l_perc"), 5),
    ("tune_vmap", ("--mode", "grid", "--param", "loss_weights", "--vmap"), 4),
    ("tune_seeds", ("--mode", "seeds", "--trials", "2"), 2),
    ("tune_bayes", ("--mode", "search", "--space", "mtl-heads", "--algo",
                    "bayes", "--trials", "3"), 3))
#: The ``Performance_Tuning.csv`` header of each run, as the JAX CLI writes
#: it (``sm_hpss_mtl_tpu/cli/tune.py::main``'s rows).
TUNE_HEADERS = {
    "tune_l_harm": "fold\tl_harm\tval_loss\taccuracy",
    "tune_l_perc": "fold\tl_perc\tval_loss\taccuracy",
    "tune_vmap": "fold\ttrial\tloss_weights\tval_loss\taccuracy\tbest_epoch",
    "tune_seeds": "fold\ttrial\tseed\tval_loss\taccuracy\tbest_epoch",
    "tune_bayes": "fold\ttrial\thead_layers\thead_width\tval_loss\taccuracy"}
#: ``cli.featurize``'s default batch: items a launch.
FEATURIZE_BATCH = 16
#: ``cli.tsne``'s skewness vectors, card vs CPU: each row's skewness is
#: held to the largest change that its featuregram's difference can make
#: (``skew_bars``).  With d the row's deviations from its mean over the
#: patch, std their RMS, and the difference's deviations at most eta:
#: the perturbed std lies in std -+ eta, the third moment moves by at most
#: (std + eta)^3 - std^3, and the skewness m3 / std^3 moves by at most its
#: largest change over those corners.  eta takes TSNE_ROUNDING of the row's
#: largest magnitude besides (float32 standardization), and the bar adds
#: the float32 rounding of the moments over the patch's frames.  A row
#: whose std is not above eta is held to nothing: its skewness is not set
#: by its values to that precision (a row flat at the dB floor but for
#: one frame reads 8.1 where that frame stays above the floor and 0 where
#: it rounds onto it).  A single absolute bar (1e-3, then 1e-2 in rows
#: of at least 1 dB spread) failed on such rows or left them unheld.
TSNE_ROUNDING = 2.0 ** -20
#: Resynthesized signals, GPU run against the CPU run: max |delta| over the
#: CPU signal's peak, both weighted by min(1, overlap-added squared window)
#: (see ``resynth_delta``).  The two runs differ by float32 summation
#: order in the STFT, the iFFT and the overlap-add (~1e-6 of the peak);
#: a wrong mask, edge rule or frame offset moves the signals by 1e-2 or
#: more.
RESYNTH_TOL = 1e-4
#: Dense tensor-core FLOP/s of the DFT's operands per DFT precision: bf16
#: for 'bf16x3', TF32 for 'highest' (split TF32) (NVIDIA data sheet, SXM
#: and PCIe parts).
TENSOR_FLOPS = {"PCIe": {"bf16x3": 756e12, "highest": 378e12},
                "default": {"bf16x3": 989e12, "highest": 495e12}}
#: phase_modes: the mask powers besides 2 and the median pairs outside
#: KERNEL_MEDIANS (the narrowest, an unlisted middle one, and the widest,
#: whose K1 block keeps 64 - 60 = 4 output frames) it holds on the card.
MODE_POWERS = (1.0, 1.5)
MODE_PAIRS = ((3, 3), (15, 7), (61, 61))
#: phase_modes: K1's and K2's error against float64 at 1 x 16404 frames in
#: bf16x3 over that in split TF32 must reach this.  bf16's 8-bit halves
#: leave about 30-40 times split TF32's 11-bit error on an H100, so a
#: library that ran the split-TF32 body under the bf16x3 name reads about
#: 1 and fails: the values show which body ran, not the name.
BF16X3_ERR_FACTOR = 5.0


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synth_broadcast(seconds: float, seed: int) -> np.ndarray:
    """Alternating 5 s segments of music (chords), speech-like bursts
    (a formant-filtered pulse train with syllabic gaps) and both, with
    clicks, as 16 kHz float32 in [-1, 1]."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    seg = (t // 5.0).astype(np.int64) % 3          # 0 music, 1 speech, 2 both
    roots = rng.choice([220.0, 246.9, 293.7, 329.6], size=int(seconds) // 5 + 1)
    f0 = roots[(t // 5.0).astype(np.int64)]
    music = sum(a * np.sin(2 * np.pi * f0 * m * t)
                for m, a in ((1, 1.0), (1.5, 0.6), (2, 0.5), (3, 0.25)))
    pitch = 120 + 40 * np.sin(2 * np.pi * 2.3 * t)
    phase = np.cumsum(pitch) / SR
    glottal = np.sign(np.sin(2 * np.pi * phase)) * np.sin(2 * np.pi * phase) ** 2
    speech = glottal * np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.4, 0, None)
    for fc in (700.0, 1900.0):
        r = np.exp(-2 * np.pi * 150 / SR)
        speech = lfilter([1.0], [1.0, -2 * r * np.cos(2 * np.pi * fc / SR),
                                 r * r], speech)
    speech /= np.abs(speech).max()
    x = (0.25 * music * (seg != 1) + 0.5 * speech * (seg != 0)
         + 0.01 * rng.standard_normal(n))
    clicks = np.zeros(n)
    clicks[rng.integers(0, n - 64, int(seconds * 2))] = 1.0
    x += np.convolve(clicks, np.hanning(64), mode="same")
    return (x / np.abs(x).max() * 0.9).astype(np.float32)


def write_broadcast(tmp: str, name: str, seconds: float, seed: int
                    ) -> tuple[str, np.ndarray]:
    """The broadcast as a 16-bit wav, and the float signal a reader of
    that wav gets back."""
    from scipy.io import wavfile
    x = synth_broadcast(seconds, seed)
    path = os.path.join(tmp, name)
    wavfile.write(path, SR, (x * 32767).astype(np.int16))
    return path, (x * 32767).astype(np.int16).astype(np.float32) / 32768.0


def cuda_ms(fn, reps: int = 20, batches: int = 7
            ) -> tuple[float, float, float]:
    """ms per call of ``fn``: the median over ``batches`` batches of
    ``reps`` back-to-back calls, each timed by CUDA events, after a warm-up
    batch; also the fastest and slowest batch.  A call that takes less than
    its host-side enqueue is timed at the enqueue rate."""
    import torch
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def device_ms(fn, kernel: str, reps: int = 50) -> float | None:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` calls of ``fn``; None
    where the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0))
            count += ev.count
    return total / count / 1e3 if count else None


def median_comparators(extra_pairs=()) -> tuple[dict, dict]:
    """Comparators per output of the median networks in the checkout's
    ``csrc/``, the sources phase 2 builds, counted from their text (and
    from the networks generated for ``extra_pairs``, pairs outside
    ``median.cuh``): per width L, ``Median<L>`` (one network per window, as
    K1 and K2 run them); per (l_harm, l_perc), harmonic plus percussive,
    the shared-core networks K3 and K4 run, ``MedianCore<W, K>`` over its K
    outputs plus one ``MedianMerge<K>`` each, with K the frames (``QT``)
    and bins (``QF``) of ``hpss.cu``'s unit, or ``Median<W>`` per window
    where W is too narrow to share a core.  The shared-core count is the
    least work known for the medians; every bound prices them with it."""
    import re
    from sm_hpss_mtl_tpu_torch.ops import _nvcc
    from sm_hpss_mtl_tpu_torch.ops.hpss import KERNEL_MEDIANS
    from sm_hpss_mtl_tpu_torch.ops.median_networks import shares_core
    head = (_nvcc.CSRC / "median.cuh").read_text() + "".join(
        _nvcc.pair_networks(pair) for pair in extra_pairs)
    unit = (_nvcc.CSRC / "hpss.cu").read_text()

    def count(pattern):
        return {tuple(int(g) for g in m.groups()[:-1]):
                len(re.findall(r"CS\(\d+,\d+\)", m.groups()[-1]))
                for m in re.finditer(pattern, head, re.S)}

    single = count(r"struct Median<(\d+)>\s*\{(.*?)return")
    cores = count(r"struct MedianCore<(\d+), (\d+)>\s*\{(.*?)\n\};")
    merges = count(r"struct MedianMerge<(\d+)>\s*\{(.*?)return")
    qf, qt = (int(re.search(rf"constexpr int {q} = (\d+);", unit).group(1))
              for q in ("QF", "QT"))

    def shared(w, k):
        if not shares_core(w, k):
            return single[(w,)]
        return cores[(w, k)] / k + merges[(k,)]

    return ({w: n for (w,), n in single.items()},
            {(lh, lp): shared(lh, qt) + shared(lp, qf)
             for lh, lp in (*KERNEL_MEDIANS, *extra_pairs)})


def dft_as_computed_ms(B: int, T: int, n_fft: int, card: str,
                       dft_precision: str = "highest",
                       win_length: int = 400) -> float:
    """Least time of K1's and K2's DFT as the kernels compute it at (21, 11)
    on the tensor cores, a reading beside ``bound_ms`` and not a bound of
    the function (an FFT needs far less): each block's DFT rows (64 frame
    rows, only the m16 tiles that hold real frames: the block's 44 output
    frames and their harmonic halo) by the folded frame's k-steps
    (``frontend.dft_steps``: 8 samples a step in split TF32, 16 in bf16x3)
    by the padded bins (8 per group, cos and sin), 2 operations a product
    and 3 products a product (hi*hi, hi*lo, lo*hi), over the dense
    tensor-core peak of the operands' type (``TENSOR_FLOPS``).  ``T`` is
    the output frames of each of ``B`` items."""
    from sm_hpss_mtl_tpu_torch.ops import frontend
    ht, tile = 10, 44
    rows = sum(16 * -(-(min(T, t0 + tile + ht) - max(0, t0 - ht)) // 16)
               for t0 in range(0, T, tile))
    s_lo, s_hi = frontend.dft_steps(n_fft, win_length, dft_precision)
    samples = (16 if dft_precision == "bf16x3" else 8) * (s_hi - s_lo)
    bins = 8 * -(-(1 + n_fft // 2) // 8)
    flops = B * rows * samples * bins * 2 * 2 * 3
    peak = TENSOR_FLOPS["PCIe" if "PCIe" in card else "default"]
    return 1e3 * flops / peak[dft_precision]


def frontend_bound_ms(T: int, N: int, n_fft: int, comparators: float,
                      card: str, n_mels: int = 0, mel_nnz: int = 0,
                      B: int = 1) -> tuple[float, str, float]:
    """Least time for K1's function (``n_mels`` > 0) or K2's on this card,
    over ``B`` items of ``N`` samples and ``T`` frames each, in ms:
    ``benchmark/counts.py``'s ``frontend_bound_s``.  Also returns which of
    its bytes and its operations sets it, and the operations bound with
    the DFT and the mel projection priced as the dense products the
    kernels compute (2 n_fft 2F and 2 F n_mels per output per frame) in
    place of an FFT and the basis's nonzeros."""
    from benchmark import counts
    nbytes = counts.frontend_bytes(T, N, n_fft, n_mels, B)
    flops = counts.frontend_flops(T, n_fft, comparators, mel_nnz, B)
    by = ("bytes" if nbytes / counts.HBM_BYTES_PER_S
          > flops / counts.f32_peak(card) else "operations")
    F = 1 + n_fft // 2
    direct = (counts.frontend_flops(T, n_fft, comparators, F * n_mels, B)
              + B * T * (4 * n_fft * F - 2.5 * n_fft * np.log2(n_fft)))
    return (1e3 * counts.frontend_bound_s(T, N, n_fft, comparators, card,
                                          n_mels, mel_nnz, B), by,
            1e3 * counts.bound_s(nbytes, direct, card))


def k3_bound_ms(B: int, F: int, T: int, comparators: float,
                card: str) -> float:
    """Least time for K3's function in ms (``benchmark/counts.py``'s
    ``k3_bound_s``)."""
    from benchmark import counts
    return 1e3 * counts.k3_bound_s(B, F, T, comparators, card)


def k4_bound_ms(B: int, F: int, T: int, n_mels: int, mel_nnz: int,
                comparators: float, card: str) -> float:
    """Least time for K4's function in ms (``benchmark/counts.py``'s
    ``k4_bound_s``)."""
    from benchmark import counts
    return 1e3 * counts.k4_bound_s(B, F, T, n_mels, mel_nnz, comparators,
                                   card)


def ptxas_report(source: str, kernel: str, pair=(21, 11),
                 dft_precision: str = "highest") -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for the
    entry function of ``csrc/<source>``'s library for the median ``pair``
    and DFT precision whose mangled name contains ``kernel``."""
    from sm_hpss_mtl_tpu_torch.ops import _nvcc
    return parse_ptxas(Path(str(_nvcc.library_path(
        source, pair, dft_precision)) + ".log").read_text(), kernel)


def parse_ptxas(log: str, kernel: str) -> dict:
    """``ptxas_report`` of one ``nvcc -Xptxas -v`` log."""
    import re
    part = log.split(kernel, 1)[1].split("Compiling entry function", 1)[0]
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       part)
    return {"registers": int(re.search(r"Used (\d+) registers",
                                       part).group(1)),
            "spill_stores": int(spills.group(1)),
            "spill_loads": int(spills.group(2))}


def compare(tag: str, got, want, rtol: float, atol: float) -> float:
    """Both outputs of a kernel against its plain version; max |delta|."""
    import torch
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{tag}: shape {tuple(g.shape)} vs "
                                  f"{tuple(w.shape)}")
        d = (g - w).abs()
        ok = bool((d <= atol + rtol * w.abs()).all())
        check(ok and bool(torch.isfinite(g).all()),
              f"{tag} disagrees with plain: max |delta| {d.max().item():.3e}")
        err = max(err, d.max().item())
    return err


def phase_kernels(card: str, eval_frames: dict) -> tuple[list[dict], dict]:
    """K1, K2, K3 and K4 against their plain versions on the card, at edge
    geometries and at every launch shape of the paths: K1 at the 60 s
    Lemaire broadcast bucketed to 6024 frames, the 10-minute slabs (16394
    and 16404 frames), each evaluated file's length and the training
    launches (the 5-class model's at 80 and 20 clips among them); K2 at
    n_fft 512 at the bucketed 10 s (1081) and 60 s (6023) Jang
    broadcasts, the same slabs and each evaluated file's length, at
    n_fft 400 at Papakostas's served and evaluated lengths, and both at the
    training launches; K3 at the 60 s resynthesis (201 bins, 5998 frames)
    and at 257 and 201 bins, every T under 20 (Jang's and Papakostas's
    short items); K4 at 201 bins, every T under 20 (Lemaire's short
    items).
    K1 and K2 run through ``frontend.launch``, which launches the fused
    kernel at every length (the dispatchers send T < 20 to K4 and K3).
    ``eval_frames`` holds the evaluation's frame counts per kernel and the
    most frequent K4 length.  Returns the kernel entries (launches still
    None) and, per kernel, the launch shapes checked."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checked = {"K1": set(), "K2": set(), "K3": set(), "K4": set(),
               "tcn": set(), "conv_block": set()}

    def audio(n_fft, B, T):
        return torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                           device="cuda")

    def bank(n_fft):
        return mel_filterbank(22050, n_fft, 120, device="cuda")

    k1_cases = [(400, 21, 11, 2, T) for T in (1, 7, 19, 21, 48, 58, 98)]
    k1_cases += [(512, 11, 5, 2, 71)]
    k1_cases += [(512, 21, 11, 2, T) for T in (1, 19, 98)]
    k1_cases += [(400, 21, 11, 1, T) for T in sorted(
        {6024, 16384, 16394, 16404} | eval_frames["K1"])]
    k1_cases += [(400, 21, 11, B, n_frames(N, 400, 160))
                 for B, N in TRAIN_SHAPES + FIVE_CLASS_SHAPES]
    k1_cases += [(400, 21, 11, B, SPLICE_FRAMES) for B in (1, 2)]
    k1_err = 0.0
    for n_fft, lh, lp, B, T in k1_cases:
        y = audio(n_fft, B, T)
        M = bank(n_fft)
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        k1_err = max(k1_err, compare(
            f"K1 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.launch(y, M, **kw),
            frontend.stft_hpss_mel_plain(y, M, **kw), RTOL, ATOL))
        checked["K1"].add((n_fft, lh, lp, B, T))
    print(f"kernel K1 stft_hpss_mel: {len(k1_cases)} shapes ok, "
          f"max |delta| {k1_err:.3e}", flush=True)

    k2_cases = [(n_fft, lh, lp, 2, T) for n_fft in (400, 512)
                for lh, lp in ((21, 11), (11, 5))
                for T in (1, 7, 19, 21, 48, 98)]
    k2_cases += [(512, 21, 11, 1, T) for T in sorted(
        {1081, 6023, 16394, 16404} | eval_frames["K2"])]
    k2_cases += [(400, 21, 11, 1, T) for T in sorted(eval_frames["K2_400"])]
    k2_cases += [(n_fft, 21, 11, B, n_frames(N, n_fft, 160))
                 for n_fft in (512, 400) for B, N in TRAIN_SHAPES]
    k2_cases += [(400, 21, 11, 2, SPLICE_FRAMES)]
    k2_err = 0.0
    for n_fft, lh, lp, B, T in k2_cases:
        y = audio(n_fft, B, T)
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        k2_err = max(k2_err, compare(
            f"K2 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.launch(y, None, **kw),
            frontend.stft_hpss_plain(y, **kw),
            RTOL, ATOL))
        checked["K2"].add((n_fft, lh, lp, B, T))
    print(f"kernel K2 stft_hpss: {len(k2_cases)} shapes ok, "
          f"max |delta| {k2_err:.3e}", flush=True)

    k3_cases = [(mo, 21, 11, 2, 201, T) for mo in (False, True)
                for T in (1, 19, 364, 365)]
    k3_cases += [(mo, 21, 11, 1, 201, 5998) for mo in (False, True)]
    k3_cases += [(False, 21, 11, 1, F, T) for F in (257, 201)
                 for T in range(1, SHORT_FRAMES)]
    k3_err = 0.0
    for mo, lh, lp, B, F, T in k3_cases:
        S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
        fn, plain = ((hpss.hpss_masks, hpss.hpss_masks_plain) if mo
                     else (hpss.hpss, hpss.hpss_plain))
        k3_err = max(k3_err, compare(
            f"K3 mask_only={mo} l=({lh},{lp}) B={B} F={F} T={T}",
            fn(S, l_harm=lh, l_perc=lp), plain(S, l_harm=lh, l_perc=lp),
            K3_RTOL, K3_ATOL))
        checked["K3"].add((mo, lh, lp, B, F, T))
    print(f"kernel K3 hpss: {len(k3_cases)} shapes ok, "
          f"max |delta| {k3_err:.3e}", flush=True)

    # K4: the short-clip domain (B = 1, F = 201, every T under 20), edge
    # lengths at B = 2, the narrow medians, and F = 257.
    k4_cases = [(21, 11, 1, 201, T) for T in range(1, SHORT_FRAMES)]
    k4_cases += [(21, 11, 2, 201, T) for T in (1, 7, 19, 32, 33, 5998)]
    k4_cases += [(11, 5, 2, 201, T) for T in (1, 9, 40)]
    k4_cases += [(21, 11, 2, 257, T) for T in (1, 19, 300)]
    k4_err = 0.0
    for lh, lp, B, F, T in k4_cases:
        S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
        M = bank(2 * (F - 1))
        got = hpss.hpss_mel(S, M, l_harm=lh, l_perc=lp)
        k4_err = max(k4_err, compare(
            f"K4 l=({lh},{lp}) B={B} F={F} T={T}", got,
            hpss.hpss_mel_plain(S, M, l_harm=lh, l_perc=lp),
            K3_RTOL, K3_ATOL))
        empty = (M == 0).all(dim=1)
        check(all(bool((g[:, empty] == 0).all()) for g in got),
              f"K4 F={F} T={T}: empty mel rows are not exact zeros")
        checked["K4"].add((lh, lp, B, F, T))
    # A basis whose bands all span F = 600 bins: the span is taken in
    # several passes, so no F is refused.
    S = torch.rand((1, 600, 5), generator=gen, device="cuda")
    M = torch.rand((8, 600), generator=gen, device="cuda")
    k4_err = max(k4_err, compare(
        "K4 F=600 dense basis", hpss.hpss_mel(S, M),
        hpss.hpss_mel_plain(S, M), K3_RTOL, K3_ATOL))
    print(f"kernel K4 hpss_mel: {len(k4_cases) + 1} shapes ok (F=600 with "
          f"a dense basis among them), max |delta| {k4_err:.3e}", flush=True)

    # Times at each kernel's dominant launch on its path: an interior slab
    # of the slabbed featurizer (16384 frames plus a 10-frame margin on
    # each side) for K1 (Lemaire, n_fft 400) and K2 (Jang, n_fft 512); the
    # 60 s resynthesis for K3; the evaluation's most frequent short clip
    # for K4, and K4 at the 60 s length, where it is more than latency.
    single, shared = median_comparators()
    entries = []
    T = 16384 + 2 * 10
    for name, n_fft, err in (("stft_hpss_mel", 400, k1_err),
                             ("stft_hpss", 512, k2_err)):
        y = audio(n_fft, 1, T)
        kw = dict(n_fft=n_fft)
        if name == "stft_hpss_mel":
            M = bank(n_fft)
            run = lambda: frontend.stft_hpss_mel(y, M, **kw)  # noqa: E731
            plain = lambda: frontend.stft_hpss_mel_plain(y, M, **kw)  # noqa
            mel = dict(n_mels=120, mel_nnz=int((M != 0).sum()))
            replaces = "sm_hpss_mtl_tpu/ops/frontend_pallas.py:207"
        else:
            run = lambda: frontend.stft_hpss(y, **kw)  # noqa: E731
            plain = lambda: frontend.stft_hpss_plain(y, **kw)  # noqa: E731
            mel = {}
            replaces = "sm_hpss_mtl_tpu/ops/frontend_pallas.py:219"
        bound, by, direct = frontend_bound_ms(
            T, y.shape[-1], n_fft, shared[(21, 11)], card, **mel)
        per_window = frontend_bound_ms(T, y.shape[-1], n_fft,
                                       single[21] + single[11], card, **mel)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain, reps=5, batches=3)
        ref = (frontend.stft_hpss_mel_plain(y.double(), M.double(), **kw)
               if mel else frontend.stft_hpss_plain(y.double(), **kw))
        f64_err = [max((g.double() - w).abs().max().item()
                       for g, w in zip(fn(), ref)) for fn in (run, plain)]
        del ref
        fullres = name == "stft_hpss"
        entries.append({
            "name": name, "route": "cuda",
            "source": "sm_hpss_mtl_tpu_torch/csrc/frontend.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms[0], "plain_ms": plain_ms[0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "ms_spread": ms[1:], "plain_ms_spread": plain_ms[1:],
            "device_ms": device_ms(run, "frontend_kernel"),
            "max_err_vs_f64": f64_err[0], "plain_err_vs_f64": f64_err[1],
            "blocks_per_sm": frontend.blocks_per_sm(
                fullres=fullres, n_fft=n_fft, hop_length=160, l_harm=21,
                l_perc=11),
            **ptxas_report("frontend.cu",
                           f"frontend_kernelILi21ELi11ELb{int(fullres)}E"),
            "bound_direct_dft_ms": direct,
            "dft_as_computed_ms": dft_as_computed_ms(1, T, n_fft, card),
            "comparators_per_output": single[21] + single[11],
            "bound_comparators_per_output": shared[(21, 11)],
            "bound_ms_at_own_networks": per_window[0],
            "timed_shape": list(y.shape)})
    # K1 at the device training pipeline's batched launches, the 5-class
    # model's among them.
    M = bank(400)
    nnz = int((M != 0).sum())
    trained = {}
    for B, N in TRAIN_SHAPES + FIVE_CLASS_SHAPES:
        T = n_frames(N, 400, 160)
        y = audio(400, B, T)
        run = lambda: frontend.stft_hpss_mel(y, M)  # noqa: E731
        ms = cuda_ms(run, reps=50)
        plain_ms = cuda_ms(lambda: frontend.stft_hpss_mel_plain(y, M),
                           reps=3, batches=3)
        bound, by, _ = frontend_bound_ms(T, N, 400, shared[(21, 11)], card,
                                         n_mels=120, mel_nnz=nnz, B=B)
        trained[f"{B}x{N}"] = {
            "frames": T, "ms": ms[0], "ms_spread": ms[1:],
            "device_ms": device_ms(run, "frontend_kernel"),
            "plain_ms": plain_ms[0], "bound_ms": bound, "bound_by": by}
    entries[0]["training_shapes"] = trained
    # K2 at the same launches, for Jang-MTL (n_fft 512) and Papakostas-MTL
    # (n_fft 400).
    trained = {}
    for n_fft in (512, 400):
        for B, N in TRAIN_SHAPES:
            T = n_frames(N, n_fft, 160)
            y = torch.randn((B, N), generator=gen, device="cuda")
            run = lambda: frontend.stft_hpss(y, n_fft=n_fft)  # noqa: E731
            ms = cuda_ms(run, reps=50)
            plain_ms = cuda_ms(
                lambda: frontend.stft_hpss_plain(y, n_fft=n_fft), reps=3,
                batches=3)
            bound, by, _ = frontend_bound_ms(T, N, n_fft, shared[(21, 11)],
                                             card, B=B)
            trained[f"n_fft{n_fft}_{B}x{N}"] = {
                "frames": T, "ms": ms[0], "ms_spread": ms[1:],
                "device_ms": device_ms(run, "frontend_kernel"),
                "plain_ms": plain_ms[0], "bound_ms": bound, "bound_by": by,
                "blocks_per_sm": frontend.blocks_per_sm(
                    fullres=True, n_fft=n_fft, hop_length=160, l_harm=21,
                    l_perc=11),
                **ptxas_report("frontend.cu",
                               "frontend_kernelILi21ELi11ELb1E")}
    entries[1]["training_shapes"] = trained
    # K3: the 60 s resynthesis (mask-only), on one resident input and on
    # a rotation of 12 inputs (58 MB, over the 50 MB L2), and Jang's most
    # frequent short evaluation item (1 x 257 x T, masked components).
    k3 = {"comparators_per_output": shared[(21, 11)],
          "blocks_per_sm": hpss.blocks_per_sm(mel=False),
          **ptxas_report("hpss.cu", "hpss_kernelILi21ELi11ELb1ELb0E")}
    S = torch.rand((1, 201, 5998), generator=gen, device="cuda")
    bound = k3_bound_ms(1, 201, 5998, shared[(21, 11)], card)
    run = lambda: hpss.hpss_masks(S)  # noqa: E731
    ms = cuda_ms(run, reps=100)
    plain_ms = cuda_ms(lambda: hpss.hpss_masks_plain(S), reps=5, batches=3)
    rotation = [torch.rand((1, 201, 5998), generator=gen, device="cuda")
                for _ in range(12)]
    inputs = itertools.cycle(rotation)
    rotating = lambda: hpss.hpss_masks(next(inputs))  # noqa: E731
    cold = cuda_ms(rotating, reps=96)
    T3 = eval_frames["K3_T"]
    S3 = torch.rand((1, 257, T3), generator=gen, device="cuda") ** 3
    short_run = lambda: hpss.hpss(S3)  # noqa: E731
    short_ms = cuda_ms(short_run, reps=100)
    short_plain = cuda_ms(lambda: hpss.hpss_plain(S3), reps=5, batches=3)
    entries.append({
        "name": "hpss", "route": "cuda",
        "source": "sm_hpss_mtl_tpu_torch/csrc/hpss.cu",
        "replaces": "sm_hpss_mtl_tpu/ops/hpss_pallas.py:146",
        "launches": None, "max_abs_err": k3_err,
        "ms": ms[0], "plain_ms": plain_ms[0],
        "bound_ms": bound, "library_ms": None,
        "ms_spread": ms[1:], "plain_ms_spread": plain_ms[1:],
        "device_ms": device_ms(run, "hpss_kernel"),
        "timed_shape": list(S.shape), "timed_mode": "mask_only",
        "ms_rotating_58MB": cold[0], "ms_rotating_58MB_spread": cold[1:],
        "device_ms_rotating_58MB": device_ms(rotating, "hpss_kernel"),
        "short_shape": [1, 257, T3], "short_mode": "masked components",
        "ms_short": short_ms[0], "ms_short_spread": short_ms[1:],
        "device_ms_short": device_ms(short_run, "hpss_kernel"),
        "plain_ms_short": short_plain[0],
        "bound_ms_short": k3_bound_ms(1, 257, T3, shared[(21, 11)],
                                      card), **k3})
    del rotation
    M = bank(400)
    nnz = int((M != 0).sum())
    k4 = {}
    for T in (eval_frames["K4_T"], 5998):
        S = torch.rand((1, 201, T), generator=gen, device="cuda") ** 3
        ms = cuda_ms(lambda: hpss.hpss_mel(S, M), reps=100)
        plain_ms = cuda_ms(lambda: hpss.hpss_mel_plain(S, M), reps=5,
                           batches=3)
        k4[T] = dict(ms=ms, plain_ms=plain_ms,
                     bound=k4_bound_ms(1, 201, T, 120, nnz,
                                       shared[(21, 11)], card),
                     device_ms=device_ms(lambda: hpss.hpss_mel(S, M),
                                         "hpss_mel_kernel"))
    # The short-clip route against K1 at the same length: frontend.launch
    # runs K1 at any length; stft_hpss_mel sends a clip this short to the
    # plain stft_mag and K4.
    y = audio(400, 1, eval_frames["K4_T"])
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11)
    route = {"frames": eval_frames["K4_T"],
             "k1_ms": cuda_ms(lambda: frontend.launch(y, M, **kw),
                              reps=100)[0],
             "k1_device_ms": device_ms(lambda: frontend.launch(y, M, **kw),
                                       "frontend_kernel"),
             "stft_mag_k4_ms": cuda_ms(lambda: frontend.stft_hpss_mel(y, M),
                                       reps=100)[0]}
    short, full = k4[eval_frames["K4_T"]], k4[5998]
    entries.append({
        "name": "hpss_mel", "route": "cuda",
        "source": "sm_hpss_mtl_tpu_torch/csrc/hpss.cu",
        "replaces": "sm_hpss_mtl_tpu/ops/hpss_pallas.py:125",
        "launches": None, "max_abs_err": k4_err,
        "ms": short["ms"][0], "plain_ms": short["plain_ms"][0],
        "bound_ms": short["bound"], "library_ms": None,
        "ms_spread": short["ms"][1:], "plain_ms_spread":
        short["plain_ms"][1:], "device_ms": short["device_ms"],
        "timed_shape": [1, 201, eval_frames["K4_T"]],
        "ms_at_5998": full["ms"][0], "ms_at_5998_spread": full["ms"][1:],
        "plain_ms_at_5998": full["plain_ms"][0],
        "bound_ms_at_5998": full["bound"],
        "device_ms_at_5998": full["device_ms"],
        "comparators_per_output": shared[(21, 11)],
        "blocks_per_sm": hpss.blocks_per_sm(mel=True),
        **ptxas_report("hpss.cu", "hpss_mel_kernelILi21ELi11ELb0E"),
        "short_clip_route": route})
    return entries, checked


def phase_pairs(card: str, checked: dict, corpus: dict) -> dict:
    """K1 to K4 at every median pair of ``KERNEL_MEDIANS`` against their
    plain versions on the card (phase 3, continued): each pair at the edge
    lengths of its harmonic half width ``ht`` (T = 1, 7, 2ht - 1, 2ht, 2ht
    + 1) and of K1's tile (50, 51, 63, 64, 65 and the training 68 frames;
    the tile is 64 - 2ht output frames, 14 at l_harm 51), K1 and K2 at the
    training launches and K1 at every bucketed length of the tuning
    corpus (the tuner's test files), K3 and K4 at short and long clips and
    at F = 257, K1 and K4 also at 20 and 60 mel bands (the n_mels grid
    leaves part groups of K4's 8 bands), K1 at 128 bands at Whisper-MTL's
    slab lengths (``WHISPER_SLAB_FRAMES``); ``frontend.launch`` runs K1 and
    K2 at any length.  At (21, 11) also ``cli.featurize``'s bucket batches.
    Then per pair: times, device times, bounds (the medians priced at the
    pair's shared-core comparators, counted in the built ``median.cuh``),
    ptxas registers and spills, and blocks per SM.  Returns, per kernel, a
    record per pair (launches still None)."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    from sm_hpss_mtl_tpu_torch.ops.hpss import KERNEL_MEDIANS
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    banks = {(n_fft, m): mel_filterbank(22050, n_fft, m, device="cuda")
             for n_fft in (400, 512) for m in (120, 60, 20)}
    banks[(400, WHISPER_MELS)] = mel_filterbank(22050, 400, WHISPER_MELS,
                                                device="cuda")
    single, shared = median_comparators()
    err = Counter()
    n_cases = Counter()

    def audio(n_fft, B, T):
        return torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                           device="cuda")

    def k1(n_fft, lh, lp, B, T, n_mels=120):
        y, M = audio(n_fft, B, T), banks[(n_fft, n_mels)]
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        err[("K1", lh, lp)] = max(err[("K1", lh, lp)], compare(
            f"K1 n_fft={n_fft} l=({lh},{lp}) B={B} T={T} n_mels={n_mels}",
            frontend.launch(y, M, **kw),
            frontend.stft_hpss_mel_plain(y, M, **kw), RTOL, ATOL))
        checked["K1"].add((n_fft, lh, lp, B, T))
        n_cases["K1"] += 1

    def k2(n_fft, lh, lp, B, T):
        y = audio(n_fft, B, T)
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        err[("K2", lh, lp)] = max(err[("K2", lh, lp)], compare(
            f"K2 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.launch(y, None, **kw),
            frontend.stft_hpss_plain(y, **kw), RTOL, ATOL))
        checked["K2"].add((n_fft, lh, lp, B, T))
        n_cases["K2"] += 1

    def k3(mo, lh, lp, B, F, T):
        S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
        fn, plain = ((hpss.hpss_masks, hpss.hpss_masks_plain) if mo
                     else (hpss.hpss, hpss.hpss_plain))
        err[("K3", lh, lp)] = max(err[("K3", lh, lp)], compare(
            f"K3 mask_only={mo} l=({lh},{lp}) B={B} F={F} T={T}",
            fn(S, l_harm=lh, l_perc=lp), plain(S, l_harm=lh, l_perc=lp),
            K3_RTOL, K3_ATOL))
        checked["K3"].add((mo, lh, lp, B, F, T))
        n_cases["K3"] += 1

    def k4(lh, lp, B, F, T, n_mels=120):
        S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
        M = banks[(2 * (F - 1), n_mels)]
        got = hpss.hpss_mel(S, M, l_harm=lh, l_perc=lp)
        err[("K4", lh, lp)] = max(err[("K4", lh, lp)], compare(
            f"K4 l=({lh},{lp}) B={B} F={F} T={T} n_mels={n_mels}", got,
            hpss.hpss_mel_plain(S, M, l_harm=lh, l_perc=lp),
            K3_RTOL, K3_ATOL))
        empty = (M == 0).all(dim=1)
        check(all(bool((g[:, empty] == 0).all()) for g in got),
              f"K4 l=({lh},{lp}) T={T}: empty mel rows are not exact zeros")
        checked["K4"].add((lh, lp, B, F, T))
        n_cases["K4"] += 1

    for lh, lp in KERNEL_MEDIANS:
        ht = lh // 2
        edges = sorted({1, 7, 2 * ht - 1, 2 * ht, 2 * ht + 1,
                        50, 51, 63, 64, 65, 68})
        for T in edges:
            k1(400, lh, lp, 2, T)
            k2(512, lh, lp, 2, T)
        for T in sorted(corpus["frames"][400]):
            k1(400, lh, lp, 1, T)
        for B, N in TRAIN_SHAPES:
            k1(400, lh, lp, B, n_frames(N, 400, 160))
            for n_fft in (512, 400):
                k2(n_fft, lh, lp, B, n_frames(N, n_fft, 160))
        for n_mels in (20, 60):
            k1(400, lh, lp, 2, 68, n_mels)
            k4(lh, lp, 1, 201, 13, n_mels)
        for mo in (False, True):
            for T in sorted({1, 7, 2 * ht - 1, 2 * ht, 33, 365}):
                k3(mo, lh, lp, 2, 201, T)
        k3(True, lh, lp, 1, 201, 5998)
        for T in sorted({1, 13, 2 * ht - 1}):
            k3(False, lh, lp, 1, 257, T)
            k4(lh, lp, 1, 201, T)
            k4(lh, lp, 1, 257, T)
        for T in (32, 33, 2 * ht + 1, 5998):
            k4(lh, lp, 2, 201, T)
    for B, T in sorted(corpus["featurize_shapes"]):
        k1(400, 21, 11, B, T)
    for T in WHISPER_SLAB_FRAMES:
        k1(400, 21, 11, 1, T, WHISPER_MELS)
    print("kernels at every median pair: " + "; ".join(
        f"{k} {n_cases[k]} shapes ok, max |delta| "
        f"{max(v for key, v in err.items() if key[0] == k):.3e}"
        for k in ("K1", "K2", "K3", "K4")), flush=True)

    # Times per pair, at each kernel's launch on the tuner's path (K1 at
    # the device pipeline's 48 x 11120 samples; K2 there too at n_fft 512,
    # the launch a Jang tuning run would make) and at its long clips (K1 at
    # a 16404-frame slab, K3 and K4 at 201 x 5998); K4 also at 13 frames.
    M = banks[(400, 120)]
    nnz = int((M != 0).sum())
    out = {"K1": [], "K2": [], "K3": [], "K4": []}
    for lh, lp in KERNEL_MEDIANS:
        pair = f"{lh},{lp}"
        cmp = shared[(lh, lp)]
        kw = dict(l_harm=lh, l_perc=lp)
        rec = {"pair": [lh, lp], "launches": None,
               "comparators_per_output": cmp,
               "comparators_per_output_own_networks": single[lh]
               + single[lp]}
        y = audio(400, 48, 68)
        run = lambda: frontend.stft_hpss_mel(y, M, **kw)  # noqa: E731
        ms = cuda_ms(run, batches=5)
        dev = device_ms(run, "frontend_kernel", reps=20)
        bound, by, _ = frontend_bound_ms(68, y.shape[-1], 400, cmp, card,
                                         n_mels=120, mel_nnz=nnz, B=48)
        y1 = audio(400, 1, 16404)
        run1 = lambda: frontend.stft_hpss_mel(y1, M, **kw)  # noqa: E731
        dev1 = device_ms(run1, "frontend_kernel", reps=10)
        out["K1"].append({
            **rec, "ms": ms[0], "ms_spread": ms[1:], "device_ms": dev,
            "plain_ms": cuda_ms(lambda: frontend.stft_hpss_mel_plain(
                y, M, **kw), reps=2, batches=3)[0],
            "bound_ms": bound, "bound_by": by, "timed_shape": [48, 11120],
            "device_ms_per_output_frame": dev / (48 * 68) if dev else None,
            "device_ms_at_16404": dev1,
            "device_ms_per_output_frame_at_16404":
            dev1 / 16404 if dev1 else None,
            "bound_ms_at_16404": frontend_bound_ms(
                16404, y1.shape[-1], 400, cmp, card, n_mels=120,
                mel_nnz=nnz)[0],
            "blocks_per_sm": frontend.blocks_per_sm(
                fullres=False, n_fft=400, hop_length=160, **kw),
            **ptxas_report("frontend.cu",
                           f"frontend_kernelILi{lh}ELi{lp}ELb0E",
                           (lh, lp))})
        y = audio(512, 48, 67)
        run = lambda: frontend.stft_hpss(y, n_fft=512, **kw)  # noqa: E731
        ms = cuda_ms(run, batches=5)
        bound, by, _ = frontend_bound_ms(67, y.shape[-1], 512, cmp, card,
                                         B=48)
        out["K2"].append({
            **rec, "ms": ms[0], "ms_spread": ms[1:],
            "device_ms": device_ms(run, "frontend_kernel", reps=20),
            "plain_ms": cuda_ms(lambda: frontend.stft_hpss_plain(
                y, n_fft=512, **kw), reps=2, batches=3)[0],
            "bound_ms": bound, "bound_by": by,
            "timed_shape": [48, 11120], "n_fft": 512,
            "blocks_per_sm": frontend.blocks_per_sm(
                fullres=True, n_fft=512, hop_length=160, **kw),
            **ptxas_report("frontend.cu",
                           f"frontend_kernelILi{lh}ELi{lp}ELb1E",
                           (lh, lp))})
        S = torch.rand((1, 201, 5998), generator=gen, device="cuda")
        run = lambda: hpss.hpss_masks(S, **kw)  # noqa: E731
        ms = cuda_ms(run, reps=50, batches=5)
        bound = k3_bound_ms(1, 201, 5998, cmp, card)
        out["K3"].append({
            **rec, "ms": ms[0], "ms_spread": ms[1:],
            "device_ms": device_ms(run, "hpss_kernel", reps=20),
            "plain_ms": cuda_ms(lambda: hpss.hpss_masks_plain(S, **kw),
                                reps=2, batches=3)[0],
            "bound_ms": bound,
            "timed_shape": [1, 201, 5998], "timed_mode": "mask_only",
            "blocks_per_sm": hpss.blocks_per_sm(mel=False, **kw),
            **ptxas_report("hpss.cu", f"hpss_kernelILi{lh}ELi{lp}ELb1ELb0E",
                           (lh, lp))})
        k4_rec = {}
        for T in (13, 5998):
            S = torch.rand((1, 201, T), generator=gen, device="cuda") ** 3
            run = lambda: hpss.hpss_mel(S, M, **kw)  # noqa: E731
            ms = cuda_ms(run, reps=50, batches=5)
            k4_rec[T] = dict(
                ms=ms, device_ms=device_ms(run, "hpss_mel_kernel", reps=20),
                plain_ms=cuda_ms(lambda: hpss.hpss_mel_plain(S, M, **kw),
                                 reps=2, batches=3)[0],
                bound=k4_bound_ms(1, 201, T, 120, nnz, cmp, card))
        short, full = k4_rec[13], k4_rec[5998]
        out["K4"].append({
            **rec, "ms": short["ms"][0], "ms_spread": short["ms"][1:],
            "device_ms": short["device_ms"], "plain_ms": short["plain_ms"],
            "bound_ms": short["bound"], "timed_shape": [1, 201, 13],
            "ms_at_5998": full["ms"][0], "device_ms_at_5998":
            full["device_ms"], "plain_ms_at_5998": full["plain_ms"],
            "bound_ms_at_5998": full["bound"],
            "blocks_per_sm": hpss.blocks_per_sm(mel=True, **kw),
            **ptxas_report("hpss.cu", f"hpss_mel_kernelILi{lh}ELi{lp}ELb0E",
                           (lh, lp))})
        for k in out:
            out[k][-1]["max_abs_err"] = err[(k, lh, lp)]
        print(f"pair {pair}: K1 {out['K1'][-1]['ms']:.4f} ms at 48 x 11120 "
              f"({out['K1'][-1]['registers']} registers, "
              f"{out['K1'][-1]['spill_stores']} B spilled), K2 "
              f"{out['K2'][-1]['ms']:.4f}, K3 {out['K3'][-1]['ms']:.4f} at "
              f"201 x 5998, K4 {out['K4'][-1]['ms']:.4f} at 201 x 13",
              flush=True)
    return out


@contextlib.contextmanager
def recorded():
    """Counts every kernel launch of the code run inside, and the shape of
    each.  Every tally is taken from the launch counters
    (``utils.profiling.counters()``) on exit less their values on entry, so
    it also counts the launches a CUDA graph of the train step replays:
    the launches per kernel, per median pair (``by_pair``, keyed
    ``"l_harm,l_perc"``), per mask power (``by_power``, keyed by the float
    power), in halo mode (``halo``), and K1's and K2's per DFT precision
    (``launches_by_precision``); the TCN block's kernels' launches per
    kernel (``tcn``); Jang's conv block kernel's per pooling mode
    (``conv_block``).  The shapes are the calls' (a TCN kernel's: kernel,
    dtype, B, C, T, bias rows, and whether a dropout mask was given, None
    for forward_b, which takes none; the conv block's: dtype, B, C, H, W,
    Ho, Wo, parameter rows)."""
    from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters
    rec = {"shapes": {"K1": set(), "K2": set(), "K3": set(), "K4": set(),
                      "tcn": set(), "conv_block": set()}}
    launch = _nvcc.launch
    kernel_of = {"k1_stft_hpss_mel": "K1", "k2_stft_hpss": "K2",
                 "k3_hpss": "K3", "k4_hpss_mel": "K4",
                 "conv_block_forward": "conv_block"}

    def rec_launch(source, fn, device, *args, **kw):
        a = dict(zip((n for n, _ in _nvcc.signatures(_nvcc.CSRC / source)[
            fn][1]), args))
        k = kernel_of.get(fn, "tcn")
        if k in ("K1", "K2"):
            key = (a["n_fft"], a["l_harm"], a["l_perc"], a["B"], a["T"])
            if a["halo"]:
                # Halo mode: the frames a shard, then the shard's edge flags.
                key += ("halo", a["mirror_l"], a["mirror_r"])
            # A mode other than the default: its name (phase_modes checks).
            if kw.get("dft_precision", "highest") != "highest":
                key += (kw["dft_precision"],)
            if a["power"] != 2.0:
                key += (f"power{a['power']}",)
        elif k == "K3":
            key = (bool(a["mask_only"]), a["l_harm"], a["l_perc"], a["B"],
                   a["F"], a["T"])
        elif k == "K4":
            key = (a["l_harm"], a["l_perc"], a["B"], a["F"], a["T"])
        elif k == "conv_block":
            key = ("bfloat16" if a["bf16"] else "float32", a["B"], a["C"],
                   a["H"], a["W"], a["Ho"], a["Wo"], a["rows"])
        else:
            key = (fn[len("tcn_"):], "bfloat16" if a["bf16"] else "float32",
                   a["B"], a["C"], a["T"], a["bias_rows"],
                   a["mask"] is not None if "mask" in a else None)
        rec["shapes"][k].add(key)
        return launch(source, fn, device, *args, **kw)

    counted_as = {"K1": ("stft_hpss_mel",), "K2": ("stft_hpss",),
                  "K3": ("hpss", "hpss_masks"), "K4": ("hpss_mel",)}
    _nvcc.launch = rec_launch
    try:
        before = counters()
        yield rec
        after = counters()

        def launches(name):
            return after.get(name, 0) - before.get(name, 0)

        def tally(k, by, key=str):
            out = Counter()
            for fn in counted_as[k]:
                head = f"{fn}.launches_by_{by}."
                for name in after:
                    if name.startswith(head) and launches(name):
                        out[key(name[len(head):])] += launches(name)
            return out
        rec["launches"] = {k: sum(launches(f"{fn}.launches") for fn in fns)
                           for k, fns in counted_as.items()}
        rec["by_pair"] = {k: tally(k, "pair") for k in counted_as}
        rec["by_power"] = {k: tally(k, "power", float) for k in counted_as}
        rec["halo"] = Counter({k: launches(f"{fn}.launches_halo")
                               for k, fn in (("K1", "stft_hpss_mel"),
                                             ("K2", "stft_hpss"))})
        rec["launches_by_precision"] = {
            k: {p: tally(k, "precision")[p] for p in frontend.DFT_PRECISIONS}
            for k in ("K1", "K2")}
        rec["tcn"] = {k: launches(f"tcn_block.launches_by_kernel.{k}")
                      for k in TCN_KERNELS}
        rec["conv_block"] = {p: launches(f"conv_block.launches_by_pool.{p}")
                             for p in CONV_BLOCK_POOLS}
    finally:
        _nvcc.launch = launch


def serve(model: str, wav: str, weights: str, out: str, device: str,
          x: np.ndarray, chunk_frames: int = 10000,
          source: str = "--weights", devices=None) -> dict:
    """One ``cli.segment`` run (host clock around it) of the weights .npz,
    or with ``source="--ckpt"`` of a fold checkpoint; outputs checked.
    ``devices``: the GPUs ``cli.segment`` shards the features over (its
    function argument).  Also returns the launches and launch shapes of
    each kernel."""
    from sm_hpss_mtl_tpu_torch.cli import segment as cli

    with recorded() as rec:
        t0 = time.perf_counter()
        prob, labels = cli.main([wav, "--model", model, source, weights,
                                 "--device", device, "--chunk-frames",
                                 str(chunk_frames), "--out", out],
                                devices=devices)
        total_s = time.perf_counter() - t0

    n_fft = cli.MODEL_PRESETS[model]["n_fft"]
    T = 1 + (len(x) - n_fft) // 160
    with np.load(out) as z:
        tracks = {k: z[k] for k in z.files}
    for k in ("track_S", "track_M"):
        v = tracks[k]
        check(v.shape == (T - 67, 1), f"{k} shape {v.shape}, want {(T - 67, 1)}")
        check(bool(np.isfinite(v).all()), f"{k} not finite")
        check(bool(((v >= 0) & (v <= 1)).all()), f"{k} outside [0, 1]")
    check(prob.shape == labels.shape == (T - 67,), "smoothed track length")
    for k in ("track_R", "track_3C"):
        check(bool(np.isfinite(tracks[k]).all()), f"{k} not finite")

    return {"tracks": tracks, "launches": rec["launches"], "frames": T,
            "tcn": rec["tcn"],
            "conv_block": rec["conv_block"],
            "total_s": total_s, "shapes": rec["shapes"],
            "by_pair": rec["by_pair"],
            "by_power": rec["by_power"], "halo": rec["halo"]}


def time_legs(model: str, x: np.ndarray, wav: str, weights: str, out: str,
              first_s: float, chunk_frames: int = 10000) -> dict:
    """A served broadcast timed again, warm: the whole CLI run, then its
    featurize and model legs on their own (host clock around work that
    ends in a synchronise or a copy to the host)."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.data.audio import read_wav
    from sm_hpss_mtl_tpu_torch.eval.segment import smooth_predictions

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cli.main([wav, "--model", model, "--weights", weights,
              "--chunk-frames", str(chunk_frames), "--out", out])
    total_s = time.perf_counter() - t0
    legs = {}

    def leg(name, fn, sync=False):
        t0 = time.perf_counter()
        r = fn()
        if sync:
            torch.cuda.synchronize()
        legs[name] = 1e3 * (time.perf_counter() - t0)
        return r

    leg("read_wav_ms", lambda: read_wav(wav))
    fv = leg("featurize_ms", lambda: cli._featurize_broadcast(
        x, cli.MODEL_PRESETS[model], dev), sync=True)
    net = leg("load_model_ms", lambda: cli.load_model(weights, dev, model),
              sync=True)
    seg = cli.segmenter(model, net, chunk_frames=chunk_frames)
    # frame_probabilities ends with the tracks on the host.
    tracks = leg("model_ms", lambda: seg.frame_probabilities(fv))
    leg("smooth_ms", lambda: smooth_predictions(tracks["S"][:, 0], 501))
    return {"audio_s": len(x) / SR, **legs, "total_ms": 1e3 * total_s,
            "first_run_total_ms": 1e3 * first_s,
            "rtf": total_s / (len(x) / SR)}


def phase_features(model: str, x: np.ndarray) -> float:
    """Kernel-path features of a long broadcast against the plain path,
    both on the card; max |delta| in dB."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.ops import frontend

    preset = cli.MODEL_PRESETS[model]
    dev = torch.device("cuda")
    got = cli._featurize_broadcast(x, preset, dev)
    k1, k2 = frontend.stft_hpss_mel, frontend.stft_hpss
    frontend.stft_hpss_mel = (
        lambda y, M, dft_precision="highest", **kw:
        frontend.stft_hpss_mel_plain(y, M, **kw))
    frontend.stft_hpss = (
        lambda y, dft_precision="highest", **kw:
        frontend.stft_hpss_plain(y, **kw))
    try:
        want = cli._featurize_broadcast(x, preset, dev)
    finally:
        frontend.stft_hpss_mel, frontend.stft_hpss = k1, k2
    check(got.shape == want.shape, "feature shapes differ")
    return (got - want).abs().max().item()


def resynth(wav: str, out_dir: str, device: str) -> dict:
    """One ``cli.hpss_resynth`` run (host clock around it); its three wavs
    checked, and the harmonic and percussive signals it computed kept."""
    from sm_hpss_mtl_tpu_torch.cli import hpss_resynth as cli

    kept = {}
    resynthesize = cli.resynthesize

    def keep(x, **kw):
        kept["yh"], kept["yp"] = resynthesize(x, **kw)
        return kept["yh"], kept["yp"]

    cli.resynthesize = keep
    try:
        with recorded() as rec:
            t0 = time.perf_counter()
            paths = cli.main([wav, "--out-dir", out_dir, "--device", device])
            total_s = time.perf_counter() - t0
    finally:
        cli.resynthesize = resynthesize
    check(len(paths) == 3 and all(os.path.getsize(p) > 44 for p in paths),
          "hpss_resynth did not write its three wavs")
    for k in ("yh", "yp"):
        check(bool(np.isfinite(kept[k]).all()), f"resynthesis {k} not finite")
    return {**kept, "launches": rec["launches"], "shapes": rec["shapes"],
            "tcn": rec["tcn"],
            "conv_block": rec["conv_block"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"],
            "total_s": total_s}


def resynth_delta(got: np.ndarray, want: np.ndarray, n_fft: int = 400,
                  hop: int = 160) -> float:
    """max |got - want| / max |want|, both weighted by min(1, wsum), the
    overlap-added squared window.  The iSTFT divides by wsum, which is
    ~1e-9 at the first and last samples, so there it multiplies rounding
    by up to ~1e9 (the JAX package's iSTFT too); the weight keeps those
    samples from deciding the comparison."""
    from sm_hpss_mtl_tpu_torch.ops.stft import hann_window
    w = hann_window(n_fft, n_fft).numpy().astype(np.float64) ** 2
    T = 1 + (len(want) - n_fft) // hop
    wsum = np.zeros(len(want))
    for t in range(T):
        wsum[t * hop:t * hop + n_fft] += w
    weight = np.minimum(wsum, 1.0)
    return float(np.abs((got - want) * weight).max()
                 / np.abs(want * weight).max())


def make_eval_corpus(root: str) -> dict:
    """The evaluation corpus: ``make_toy_musan`` music, speech and noise of
    3-30 s, and ``EVAL_SHORT`` clips of 0.12-0.2 s per class of music and
    speech beside them with their annotation rows (stratum 'short', so fold
    0 holds one of each); its 3-class folds saved where ``cli.fuse_late``
    reads them.  Returns the corpus root, fold 0's test files of the
    3-class folds (``test``) and of the 5-class ones (``test5``), and each
    file's length in samples after the loader's chain (silence removal may
    shorten a file), from which every launch shape of the phase follows."""
    from sm_hpss_mtl_tpu_torch.data import audio
    from sm_hpss_mtl_tpu_torch.data.folds import (create_cv_folds,
                                                  get_train_test_files,
                                                  save_cv_folds)
    from sm_hpss_mtl_tpu_torch.ops.mixing import normalize_signal_np
    audio.make_toy_musan(root, n_per_class=EVAL_FILES,
                         duration_s=(3.0, 30.0), with_noise=True, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    for cls, synth in (("music", audio._synth_music),
                       ("speech", audio._synth_speech)):
        with open(os.path.join(root, "annotations", cls + ".csv"), "a") as f:
            for i in range(EVAL_SHORT):
                name = f"{cls}-short-{i:04d}"
                n = int(rng.uniform(0.12, 0.2) * SR)
                audio.write_wav(os.path.join(root, cls, name + ".wav"),
                                normalize_signal_np(synth(rng, n, SR)))
                f.write(f"{name},short\n")
    cv = create_cv_folds(root, seed=SEED)
    save_cv_folds(cv, os.path.join(root, "cv_info"))
    _, test = get_train_test_files(cv, 0)
    _, test5 = get_train_test_files(
        create_cv_folds(root, with_noise=True, seed=SEED), 0,
        class_names=FIVE_CLASSES)
    samples = {os.path.join(root, c, f): len(
        audio.load_and_preprocess_signal(os.path.join(root, c, f))[0])
        for c in ("music", "speech", "noise")
        for f in os.listdir(os.path.join(root, c)) if f.endswith(".wav")}
    return {"root": root, "test": test, "test5": test5, "samples": samples}


def eval_item_frames(corpus: dict, n_fft: int, sweep: bool,
                     test: str = "test", bucketed: bool = False
                     ) -> list[int]:
    """Frames of every item the tester featurizes, in order: test_model's
    single files and pairs of fold 0's ``test`` files (a mixture takes its
    speech file's length), then, with ``sweep``, the speech+music pairs
    again at each SMR level; with ``bucketed``, at the length bucket a
    bucketed featurizer launches."""
    from sm_hpss_mtl_tpu_torch.data.featurize import bucket_length
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames
    root, files, samples = corpus["root"], corpus[test], corpus["samples"]
    singles = [samples[os.path.join(root, c, f)]
               for c in ("music", "speech", "noise") for f in files.get(c, [])]
    pairs = [samples[os.path.join(root, "speech", p["speech"])]
             for k in ("speech+music", "speech+noise")
             for p in files.get(k, [])]
    swept = [samples[os.path.join(root, "speech", p["speech"])]
             for p in files["speech+music"]] * len(SMR_LEVELS)
    items = singles + pairs + (swept if sweep else [])
    return [n_frames(bucket_length(n) if bucketed else n, n_fft, 160)
            for n in items]


def evaluate(model: str, corpus: dict, weights: str, device: str,
             sweep: bool) -> dict:
    """``FileWiseTester.test_model`` (and ``smr_sweep``) of ``model`` on
    fold 0 of the corpus through ``Featurizer(bucket=False)`` on
    ``device`` (the 5-class model on the 5-class folds, the fusion model
    with ``dual_tower``); the host clock around each, the time inside the
    featurizer, and the frames of each featurized item."""
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.data.featurize import (FeatureConfig,
                                                      Featurizer)
    from sm_hpss_mtl_tpu_torch.device import resolve_device
    from sm_hpss_mtl_tpu_torch.eval.tester import FileWiseTester
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND, load_model
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames

    preset = cli.MODEL_PRESETS[model]
    cfg = FeatureConfig(feat_name=preset["feat_name"], n_fft=preset["n_fft"],
                        n_mels=preset["n_mels"])
    feat = Featurizer(cfg, bucket=False, device=device)
    seen = {"frames": [], "samples": 0, "featurize_s": 0.0}
    compute, featuregram = feat._compute, feat.featuregram

    def counted(audio):
        seen["frames"].append(n_frames(len(audio), cfg.n_fft,
                                       cfg.hop_length))
        seen["samples"] += len(audio)
        return compute(audio)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        fv = featuregram(*args, **kw)
        seen["featurize_s"] += time.perf_counter() - t0
        return fv

    feat._compute, feat.featuregram = counted, timed
    net = load_model(weights, resolve_device(device), model)
    dual = INPUT_KIND[model] == "dual"
    test, n_classes = ("test5", 5) if model == FIVE else ("test", 3)
    tester = FileWiseTester(featurizer=feat, predict_fn=net,
                            folder=corpus["root"], feat_name=cfg.feat_name,
                            input_kind="time_mel" if dual
                            else INPUT_KIND[model], dual_tower=dual)
    with recorded() as rec:
        t0 = time.perf_counter()
        res = tester.test_model(corpus[test])
        t1 = time.perf_counter()
        swept = (tester.smr_sweep(corpus[test], levels=SMR_LEVELS)
                 if sweep else {})
        t2 = time.perf_counter()
    for r in [res] + [swept[db] for db in SMR_LEVELS if db in swept]:
        p = r["Predictions"]
        check(p.ndim == 2 and p.shape[1] == n_classes and len(p) == len(
            r["PtdLabels"]) == len(r["GroundTruth"]), "prediction shapes")
        check(bool(np.isfinite(p).all()), "predictions not finite")
        check(bool((np.abs(p.sum(axis=1) - 1) < 1e-4).all()),
              "class probabilities do not sum to 1")
    check(res["ConfMat"].shape == (n_classes, n_classes),
          f"{model}: confusion matrix {res['ConfMat'].shape}")
    want = eval_item_frames(corpus, cfg.n_fft, sweep, test)
    check(sorted(seen["frames"]) == sorted(want),
          f"{model}: featurized frames {sorted(seen['frames'])}, planned "
          f"{sorted(want)}")
    return {"result": res, "sweep": swept, "launches": rec["launches"],
            "tcn": rec["tcn"], "conv_block": rec["conv_block"],
            "shapes": rec["shapes"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"],
            "test_model_s": t1 - t0,
            "sweep_s": t2 - t1, **seen}


def fuse_late(corpus: dict, ckpts: tuple, out: str, device: str) -> dict:
    """``cli.fuse_late.main`` on fold 0 of the corpus's 3-class folds over
    the harmonic-feature and percussive-feature checkpoints on ``device``
    (host clock around it); its row and results checked, K1 launched once
    per item and leg at the items' length buckets."""
    from sm_hpss_mtl_tpu_torch.cli import fuse_late as cli
    with recorded() as rec:
        t0 = time.perf_counter()
        res = cli.main(["--data", corpus["root"], "--ckpt-harm", ckpts[0],
                        "--ckpt-perc", ckpts[1], "--output", out,
                        "--device", device])
        total_s = time.perf_counter() - t0
    check(res["ConfMat"].shape == (3, 3) and bool(np.isfinite(
        res["Predictions"]).all()), f"fuse_late results {res['ConfMat']}")
    check(os.path.exists(os.path.join(out, "Late_Fusion",
                                      "Lemaire_et_al_MTL",
                                      "Performance.csv")),
          "fuse_late wrote no Performance.csv")
    return {"result": res, "launches": rec["launches"], "tcn": rec["tcn"],
            "conv_block": rec["conv_block"],
            "shapes": rec["shapes"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"],
            "total_s": total_s,
            "items": len(eval_item_frames(corpus, 400, sweep=False))}


def same_labels(tag: str, got: dict, want: dict) -> tuple[float, list]:
    """The card's results against the CPU's: predictions within
    ``TRACK_TOL``; labels equal but at near-ties (the CPU's top two 3C
    probabilities within ``TIE_TOL``), which are returned; confusion
    matrices equal where no label differs."""
    d = float(np.abs(got["Predictions"] - want["Predictions"]).max())
    check(d <= TRACK_TOL, f"{tag}: predictions GPU vs CPU max |delta| "
                          f"{d:.3e}")
    top2 = np.sort(want["Predictions"], axis=1)[:, -2:]
    differ = np.flatnonzero(got["PtdLabels"] != want["PtdLabels"])
    ties = [(tag, int(i), top2[i].tolist()) for i in differ
            if top2[i, 1] - top2[i, 0] <= TIE_TOL]
    check(len(ties) == len(differ), f"{tag}: labels differ at patches "
          f"{differ.tolist()}, not all near-ties")
    if not len(differ):
        check(np.array_equal(got["ConfMat"], want["ConfMat"]),
              f"{tag}: confusion matrices differ")
    return d, ties


def classify(wav: str, weights: str, device: str) -> dict:
    """``Classifier.classify_file`` of Lemaire-MTL on one wav (bucketed
    featurizer, as the JAX entry point)."""
    from sm_hpss_mtl_tpu_torch.infer import Classifier
    clf = Classifier.from_weights(weights, device=device)
    with recorded() as rec:
        t0 = time.perf_counter()
        out = clf.classify_file(wav)
        total_s = time.perf_counter() - t0
    check(out["probabilities"].shape == (3,)
          and bool(np.isfinite(out["probabilities"]).all()),
          "classifier probabilities")
    return {"out": out, "launches": rec["launches"], "shapes": rec["shapes"],
            "tcn": rec["tcn"],
            "conv_block": rec["conv_block"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"],
            "total_s": total_s}


def make_train_corpus(root: str) -> dict:
    """The training corpus: ``make_toy_musan`` with ``TRAIN_FILES`` files
    of ``TRAIN_SECONDS`` per class of music, speech and noise, and its
    3-class folds where ``cli.mtl`` reads them (the 5-class ones are
    ``cli.make_folds``'s, in phase 10).  Returns the root, fold 0's
    training split, and per n_fft (400, 512) the frames of every item the
    host pipeline's featurizer can compute: each music, speech and noise
    file's length bucket (a mixture takes its speech file's length),
    launched one item at a time."""
    from sm_hpss_mtl_tpu_torch.cli.experiment import (load_or_create_folds,
                                                      split_train_val)
    from sm_hpss_mtl_tpu_torch.data import audio
    from sm_hpss_mtl_tpu_torch.data.featurize import bucket_length
    from sm_hpss_mtl_tpu_torch.data.folds import get_train_test_files
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames
    from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
    audio.make_toy_musan(root, n_per_class=TRAIN_FILES,
                         duration_s=TRAIN_SECONDS, with_noise=True, seed=SEED)
    cv = load_or_create_folds(ExperimentConfig(data_root=root))
    tr, _ = split_train_val(get_train_test_files(cv, 0)[0])
    lengths = {bucket_length(len(audio.load_and_preprocess_signal(
        os.path.join(root, c, f))[0]))
        for c in ("music", "speech", "noise")
        for f in os.listdir(os.path.join(root, c)) if f.endswith(".wav")}
    # cli.featurize's launches: every item of the 3-class folds grouped by
    # length bucket, FEATURIZE_BATCH a launch (Featurizer.precompute).
    from sm_hpss_mtl_tpu_torch.cli.featurize import corpus_items
    from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig, Featurizer
    loader = Featurizer(FeatureConfig(), device="cpu")
    buckets = Counter(bucket_length(len(loader._load(*item)))
                      for item in corpus_items(root, cv, 3))
    featurize = [(min(FEATURIZE_BATCH, n - i), n_frames(b, 400, 160))
                 for b, n in sorted(buckets.items())
                 for i in range(0, n, FEATURIZE_BATCH)]
    return {"root": root, "train_files": tr,
            "frames": {n_fft: {n_frames(n, n_fft, 160) for n in lengths}
                       for n_fft in (400, 512)},
            "featurize_launches": featurize,
            "featurize_shapes": set(featurize)}


def make_five_class_folds(corpus: dict) -> None:
    """``cli.make_folds --with-noise`` into ``<root>/cv_info_5_class``,
    where ``cli.five_class`` reads them (host work only: no kernel may
    launch); adds fold 0's 5-class training split to ``corpus`` as
    ``train_files5``."""
    from sm_hpss_mtl_tpu_torch.cli import make_folds
    from sm_hpss_mtl_tpu_torch.cli.experiment import split_train_val
    from sm_hpss_mtl_tpu_torch.data.folds import (get_train_test_files,
                                                  load_cv_folds)
    out = os.path.join(corpus["root"], "cv_info_5_class")
    with recorded() as rec:
        make_folds.main(["--data", corpus["root"], "--with-noise",
                         "--output", out])
    check(not any(rec["launches"].values()),
          f"make_folds launched {rec['launches']}")
    cv5 = load_cv_folds(out)
    check(all(cv5[k]["fold0"] for k in FIVE_CLASSES),
          "the 5-class folds lack a class")
    corpus["train_files5"], _ = split_train_val(
        get_train_test_files(cv5, 0, class_names=FIVE_CLASSES)[0])


def model_kernel(model: str) -> str | None:
    """The kernel a model's features launch: K1 for the Mel-HPSS families,
    K2 for the full-resolution HPSS ones, none for the plain spectrograms
    of the single-task baselines."""
    from sm_hpss_mtl_tpu_torch.train.config import MODEL_PRESETS
    name = MODEL_PRESETS[model]["feat_name"]
    if "Harm" not in name and "Perc" not in name:
        return None
    return "K1" if "Mel" in name else "K2"


def train_cli(corpus: dict, out: str, pipeline: str,
              model: str = "Lemaire_et_al_MTL", extra: tuple = (),
              epochs: int = TRAIN_EPOCHS) -> dict:
    """One run of fold 0 on the card (host clock around it) through the
    model's driver: ``cli.five_class`` for the 5-class model,
    ``cli.fuse_intermediate`` for the fusion model, ``cli.mtl`` for the
    other MTL models and ``cli.baseline`` for a single-task one; its
    outputs checked, and the model's kernel launched once per
    device-pipeline train or eval step and once per featurized file (the
    statistics pass's too), nothing else."""
    from sm_hpss_mtl_tpu_torch.cli import (baseline, five_class,
                                           fuse_intermediate, mtl)
    from sm_hpss_mtl_tpu_torch.models.zoo import MTL
    main = {FIVE: five_class.main, IF: fuse_intermediate.main}.get(
        model, mtl.main if MTL[model] else baseline.main)
    tag = f"{model} {pipeline} {' '.join(extra)}".strip()
    with recorded() as rec:
        t0 = time.perf_counter()
        res = main(["--data", corpus["root"], "--output", out, "--model",
                    model, "--pipeline", pipeline, "--epochs", str(epochs),
                    "--tr-steps", str(TRAIN_STEPS), "--v-steps",
                    str(VAL_STEPS), "--lr-schedule-steps", "100000",
                    "--folds", "0", *extra])
        total_s = time.perf_counter() - t0
    fold = res[0]
    row, hist = fold["row"], fold["fit"].history
    check(fold["pipeline"] == pipeline, f"{tag}: ran the {fold['pipeline']} "
          f"pipeline")
    check(len(hist) == epochs, f"{tag}: {len(hist)} epochs")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"])
              for h in hist), f"{tag}: losses not finite: {hist}")
    check(np.isfinite(row["val_loss"]) and 0 <= row["accuracy"] <= 1,
          f"{tag}: fold row {row}")
    n_classes = 5 if model == FIVE else 3
    check(fold["test"]["ConfMat"].shape == (n_classes, n_classes),
          f"{tag}: confusion matrix {fold['test']['ConfMat'].shape}")
    for name in ("Performance.csv", "fold0_log.csv",
                 "fold0_ckpt/state/model.npz"):
        check(os.path.exists(os.path.join(fold["op_dir"], name)),
              f"{tag}: {name} not written")
    computes = fold["cache_stats"]["featurizer"]["computes"]
    steps = epochs * (TRAIN_STEPS + VAL_STEPS)
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    kernel = model_kernel(model)
    if kernel:
        want[kernel] = computes + (steps if pipeline == "device" else 0)
    check(rec["launches"] == want, f"{tag}: launches {rec['launches']}, "
          f"want {want} ({computes} featurized files)")
    return {"launches": rec["launches"], "shapes": rec["shapes"],
            "tcn": rec["tcn"],
            "conv_block": rec["conv_block"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"],
            "launches_by_precision": rec["launches_by_precision"],
            "total_s": total_s, "featurized_files": computes,
            "epoch_train_s": [h["epoch_train_s"] for h in hist],
            "fit_wall_s": fold["fit"].wall_time,
            "val_loss": row["val_loss"], "accuracy": row["accuracy"],
            "op_dir": fold["op_dir"], "history": hist}


def _feature_config(model: str):
    from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu_torch.train.config import (MODEL_PRESETS,
                                                    preset_n_mels)
    preset = MODEL_PRESETS[model]
    return FeatureConfig(feat_name=preset["feat_name"], n_fft=preset["n_fft"],
                         n_mels=preset_n_mels(preset))


def _train_setup(device: str, net, seed: int, audio: bool = True,
                 model: str = "Lemaire_et_al_MTL",
                 optimizer: str | None = None,
                 dft_precision: str = "highest", **step_kw):
    """A copy of ``net`` on ``device``, an optimizer (``model``'s, or that
    of the ``optimizer`` family) and a train step at full width: the device
    pipeline's (``audio``: 16 clips per class, one 68-frame patch each, the
    model's kernel inside, its DFT at ``dft_precision``) or the patch step.
    Also the first lr."""
    import copy
    import dataclasses

    import torch
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND
    from sm_hpss_mtl_tpu_torch.train.endtoend import make_audio_train_step
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState, make_train_step
    model_ = copy.deepcopy(net).to(device)
    opt, sched = for_model(optimizer or model, model_.parameters(),
                           tr_steps=100000)
    kw = dict(generator=torch.Generator(device=device).manual_seed(seed),
              l2_reg=0.01, **step_kw)
    feature_config = dataclasses.replace(_feature_config(model),
                                         dft_precision=dft_precision)
    step = (make_audio_train_step(model_, opt, feature_config,
                                  patch_size=68, patch_shift=68,
                                  n_patches_per_clip=1,
                                  input_kind=INPUT_KIND[model], **kw)
            if audio else make_train_step(model_, opt, mtl=True, **kw))
    return model_, TrainState(model_, opt), step, float(sched(0))


def _crops(corpus: dict, seed: int, model: str = "Lemaire_et_al_MTL"):
    """The device pipeline's crop batches of fold 0's training files (the
    5-class split for the 5-class model)."""
    from sm_hpss_mtl_tpu_torch.data.audiostream import (AudioCache,
                                                        AudioCropBatcher)
    files = corpus["train_files5" if model == FIVE else "train_files"]
    return AudioCropBatcher(AudioCache(), corpus["root"],
                            files, _feature_config(model),
                            clips_per_class=16, n_patches_per_clip=1,
                            patch_size=68, seed=seed)


def _bn_fed_biases(model) -> set[str]:
    """The biases of the layers that feed a BatchNorm (``X.conv``/``X.dense``
    before ``X.bn``, Jang's ``fc1`` before ``fc1_bn``): a train-mode
    BatchNorm subtracts the batch mean, so their gradient is 0 in exact
    arithmetic and what a step computes for them is rounding noise."""
    import torch
    names = set(model.state_dict())
    out = set()
    for path, mod in model.named_modules():
        if not isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            continue
        base, _, leaf = path.rpartition(".")
        feeds = ([f"{base}.conv", f"{base}.dense"] if leaf == "bn"
                 else [path[:-len("_bn")]] if path.endswith("_bn") else [])
        out |= {f"{f.lstrip('.')}.bias" for f in feeds} & names
    return out


def _step_card_vs_cpu(net, batch, labels, audio: bool, update_rtol: float,
                      model: str = "Lemaire_et_al_MTL",
                      optimizer: str | None = None,
                      dft_precision: str = "highest") -> dict:
    """One train step of ``net`` on ``batch`` on the CPU and on the card:
    the loss, the BatchNorm statistics and every parameter's update (to
    ``update_rtol`` of its norm) held to their bars; the biases that feed
    a BatchNorm, whose updates are rounding noise on both sides, to
    ``ZERO_GRAD_UPDATE`` of the first lr per element instead.  Every
    violation is reported."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    before = {k: v.clone() for k, v in net.state_dict().items()}
    noise = _bn_fed_biases(net)
    got = {}
    for dev in ("cpu", "cuda"):
        model_, state, step, lr = _train_setup(dev, net, SEED, audio=audio,
                                               model=model,
                                               optimizer=optimizer,
                                               dft_precision=dft_precision)
        d = torch.device(dev)
        loss = float(step(state, to_device(batch, d),
                          to_device(labels, d))["loss"])
        got[dev] = (loss, {k: v.detach().cpu()
                           for k, v in model_.state_dict().items()})
    (loss_cpu, cpu), (loss_gpu, gpu) = got["cpu"], got["cuda"]
    tag = f"{model} {'audio' if audio else 'patch'} step ({dft_precision})"
    return _hold_step(tag, before, cpu, gpu, loss_cpu, loss_gpu, noise, lr,
                      update_rtol)


def _hold_step(tag: str, before: dict, cpu: dict, gpu: dict,
               loss_cpu: float, loss_gpu: float, noise: set, lr: float,
               update_rtol: float) -> dict:
    """One step's state dicts, ``before`` it and after it on the CPU and on
    the card, held to the step bars (``_step_card_vs_cpu``)."""
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    bad = [] if loss_rel <= STEP_LOSS_RTOL else [
        f"loss card {loss_gpu} vs CPU {loss_cpu}"]
    rels, stats_err, noise_max = {}, 0.0, 0.0
    for k, b in before.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            err = float(((gpu[k] - cpu[k]).abs()
                         / cpu[k].abs().clamp_min(1.0)).max())
            stats_err = max(stats_err, err)
            if err > STEP_STATS_TOL:
                bad.append(f"{k} card vs CPU {err:.3e}")
            continue
        b = b.double()
        d_cpu, d_gpu = cpu[k].double() - b, gpu[k].double() - b
        if k in noise:
            bar = ZERO_GRAD_UPDATE * lr * b.numel() ** 0.5
            norm = float(max(d_cpu.norm(), d_gpu.norm()))
            noise_max = max(noise_max, norm / (lr * b.numel() ** 0.5))
            if norm > bar:
                bad.append(f"{k} (feeds a BatchNorm) update norm {norm:.3e} "
                           f"over {bar:.3e}")
            continue
        # Below the relative bar: two float32 ulps of the parameter, and
        # 1e-6 of the largest update (the first lr) per element.
        floor = 2 * 2.0 ** -23 * b.norm() + 1e-6 * lr * b.numel() ** 0.5
        tol = update_rtol * d_cpu.norm() + floor
        diff = (d_gpu - d_cpu).norm()
        if diff > tol:
            bad.append(f"{k} update card vs CPU |delta| {diff:.3e} over "
                       f"{tol:.3e} (update norm {d_cpu.norm():.3e})")
        if d_cpu.norm() > floor:
            rels[k] = float(diff / d_cpu.norm())
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    check(not bad, f"{tag}: " + "; ".join(bad))
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu,
            "loss_rel": loss_rel, "update_rel_max": top[0][1],
            "update_rel_max_at": top[0][0], "update_rel_top": dict(top),
            "stats_err_max": stats_err,
            "bn_fed_bias_update_max_per_lr": noise_max}


def _seeded(model: str, dropout: bool = True, dtype=None):
    """``model`` at full width with Keras's initialisation from SEED,
    computing in ``dtype`` (float32 parameters either way); with
    ``dropout=False`` every dropout's rate is 0."""
    import torch
    from sm_hpss_mtl_tpu_torch.models import layers
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    kw = {} if dropout or not model.startswith("Lemaire") else {
        "dropout_rate": 0.0}
    net = init_weights(get_model(model, dtype=dtype, **kw),
                       torch.Generator().manual_seed(SEED))
    if not dropout:
        for m in net.modules():
            if isinstance(m, layers.Dropout):
                m.rate = 0.0
    return net


def _patches(audio, model: str, dev: str):
    """The device pipeline's patches of ``audio`` (one 68-frame patch a
    clip) on ``dev``, the card's through the model's kernel and the CPU's
    through its plain version, on the host (a dict of two for the fusion
    model)."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND
    from sm_hpss_mtl_tpu_torch.train.endtoend import device_featurize_patches
    f = device_featurize_patches(
        to_device(audio, torch.device(dev)), _feature_config(model),
        patch_size=68, patch_shift=68, max_patches=1,
        input_kind=INPUT_KIND[model])
    return {k: v.cpu() for k, v in f.items()} if isinstance(f, dict) \
        else f.cpu()


def _features_card_vs_cpu(audio, model: str) -> tuple[dict, "object"]:
    """The device pipeline's patches of ``audio`` on the card (the model's
    kernel) and on the CPU (the plain version): the CPU's patches (a dict
    of two for the fusion model) and the difference's statistics."""
    import torch
    feats = {dev: _patches(audio, model, dev) for dev in ("cpu", "cuda")}

    def joined(f):                  # the fusion model's two inputs, as one
        return torch.cat([f["harm_input"], f["perc_input"]], dim=-1) \
            if isinstance(f, dict) else f

    fdiff = (joined(feats["cuda"]) - joined(feats["cpu"])).abs()
    rows = fdiff.amax(dim=1) if fdiff.ndim == 3 else fdiff.amax(dim=2)
    return {"features_max_abs_delta": float(fdiff.max()),
            "features_mean_abs_delta": float(fdiff.mean()),
            "features_rows_over_1e-2": int((rows > 1e-2).sum())}, feats["cpu"]


def _falls(model: str, net, audio, labels, steps: int = 20) -> list:
    """``steps`` audio steps on one batch on the card with the model's own
    optimizer; the loss stays finite and falls."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    _, state, step, _ = _train_setup("cuda", net, SEED, model=model)
    dev = torch.device("cuda")
    a, y = to_device(audio, dev), to_device(labels, dev)
    losses = torch.stack([step(state, a, y)["loss"]
                          for _ in range(steps)]).tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{model}: {steps} steps on one batch: losses {losses}")
    return losses


def train_step_checks(corpus: dict) -> dict:
    """One crop batch and one set of weights, dropout and augmentation off:
    the features on the card (K1) against the CPU's (the plain version);
    one patch step on the CPU's features on the card and on the CPU, held
    to every bar (loss, each update, BatchNorm statistics); one audio step
    (K1 inside on the card) on both, held to the same loss and statistics
    bars and to ``STEP_AUDIO_UPDATE_RTOL`` on each update.  Then 20 audio
    steps on that batch on the card: the loss stays finite and falls."""
    model = "Lemaire_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, model))
    net = _seeded(model, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, model)
    # Patch j of clip b is row j*B + b; one patch a clip, so the clips'
    # labels are the rows'.
    patch = _step_card_vs_cpu(net, patches, labels, audio=False,
                              update_rtol=STEP_UPDATE_RTOL)
    audio_step = _step_card_vs_cpu(net, audio, labels, audio=True,
                                   update_rtol=STEP_AUDIO_UPDATE_RTOL)
    return {**feat_stats, "patch_step": patch, "audio_step": audio_step,
            "fixed_batch_losses": _falls(model, net, audio, labels)}


def image_step_checks(corpus: dict) -> dict:
    """Jang-MTL: the features on the card (K2, n_fft 512) against the
    CPU's, one audio step (K2 inside on the card) on the card and on the
    CPU with plain SGD (``STEP_SGD``) at the loss and statistics bars and
    ``STEP_JANG_AUDIO_UPDATE_RTOL`` on each update, and 20
    audio steps on one batch with its own Adam (the loss falls).
    Papakostas-MTL: one patch step on the CPU's features (HarmPercSpec,
    n_fft 400) on the card and on the CPU at the patch step's bars.  One
    crop batch each, dropout and augmentation off."""
    out = {}
    jang = "Jang_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, jang))
    net = _seeded(jang, dropout=False)
    feat_stats, _ = _features_card_vs_cpu(audio, jang)
    out[jang] = {**feat_stats, "audio_step": _step_card_vs_cpu(
        net, audio, labels, audio=True,
        update_rtol=STEP_JANG_AUDIO_UPDATE_RTOL, model=jang,
        optimizer=STEP_SGD),
        "fixed_batch_losses": _falls(jang, net, audio, labels)}
    del net
    pap = "Papakostas_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, pap))
    net = _seeded(pap, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, pap)
    out[pap] = {**feat_stats, "patch_step": _step_card_vs_cpu(
        net, patches, labels, audio=False, update_rtol=STEP_UPDATE_RTOL,
        model=pap), "conditioning": conditioning_checks(net, patches, labels,
                                                        pap)}
    return out


def variant_step_checks(corpus: dict) -> dict:
    """Lemaire's variants, one crop batch each, dropout and augmentation
    off.  The intermediate-fusion model: the features on the card (K1)
    against the CPU's; one patch step on the CPU's features (a dict of the
    two towers' inputs) on the card and on the CPU at the patch step's
    bars; one audio step (K1 inside on the card) on both at the loss and
    statistics bars and ``STEP_IF_AUDIO_UPDATE_RTOL`` on each update; and
    20 audio steps on one batch (the loss falls).  The 5-class model: one
    patch step on the CPU's features on the card and on the CPU at the
    patch step's bars."""
    out = {}
    audio, labels = next(_crops(corpus, SEED, IF))
    net = _seeded(IF, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, IF)
    out[IF] = {**feat_stats, "patch_step": _step_card_vs_cpu(
        net, patches, labels, audio=False, update_rtol=STEP_UPDATE_RTOL,
        model=IF), "audio_step": _step_card_vs_cpu(
        net, audio, labels, audio=True,
        update_rtol=STEP_IF_AUDIO_UPDATE_RTOL, model=IF),
        "fixed_batch_losses": _falls(IF, net, audio, labels)}
    del net
    audio, labels = next(_crops(corpus, SEED, FIVE))
    check(audio.shape == (5 * 16, 11120), f"5-class crops {audio.shape}")
    net = _seeded(FIVE, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, FIVE)
    out[FIVE] = {**feat_stats, "patch_step": _step_card_vs_cpu(
        net, patches, labels, audio=False, update_rtol=STEP_UPDATE_RTOL,
        model=FIVE), "conditioning": conditioning_checks(net, patches,
                                                         labels, FIVE)}
    return out


def _stepped(net, batch, labels, dev: str, audio: bool, model: str,
             optimizer: str | None = None) -> tuple:
    """One train step of a copy of ``net`` on ``dev`` (``_train_setup``):
    its loss, the state dict after it on the host, and the first lr."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    model_, state, step, lr = _train_setup(dev, net, SEED, audio=audio,
                                           model=model, optimizer=optimizer)
    d = torch.device(dev)
    loss = float(step(state, to_device(batch, d),
                      to_device(labels, d))["loss"])
    return loss, {k: v.detach().cpu()
                  for k, v in model_.state_dict().items()}, lr


def _spread(before: dict, a: tuple, b: tuple, noise: set
            ) -> tuple[dict, dict]:
    """Step ``a`` against step ``b`` (``_stepped`` results) from the state
    ``before``: a summary (the relative loss difference, the largest
    relative update differences, the largest BatchNorm-statistic
    difference, the BatchNorm-fed biases' largest update per lr per
    element, the range of the update norm ratios a/b and the least
    cosine, over the updates above the floor) and, per parameter that does
    not feed a BatchNorm: the update difference ``d``, ``b``'s update norm
    ``n``, the rounding floor of ``_hold_step``, ``a``'s update norm
    ``n_a``, the cosine of the two updates and the parameter's size."""
    (la, sa, lr), (lb, sb, _) = a, b
    upd, stats, noise_max = {}, 0.0, 0.0
    for k, v in before.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            stats = max(stats, float(((sa[k] - sb[k]).abs()
                                      / sb[k].abs().clamp_min(1.0)).max()))
            continue
        v = v.double()
        da, db = sa[k].double() - v, sb[k].double() - v
        if k in noise:
            noise_max = max(noise_max, float(max(da.norm(), db.norm()))
                            / (lr * v.numel() ** 0.5))
            continue
        n_a, n_b = float(da.norm()), float(db.norm())
        upd[k] = {"d": float((da - db).norm()), "n": n_b,
                  "floor": float(2 * 2.0 ** -23 * v.norm()
                                 + 1e-6 * lr * v.numel() ** 0.5),
                  "n_a": n_a, "numel": v.numel(),
                  "cos": float((da * db).sum()) / (n_a * n_b)
                  if n_a * n_b > 0 else 0.0}
    above = {k: u for k, u in upd.items() if u["n"] > u["floor"]}
    rels = {k: u["d"] / u["n"] for k, u in above.items()}
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    ratios = [u["n_a"] / u["n"] for u in above.values()]
    return {"loss_rel": abs(la - lb) / abs(lb), "update_rel_max": top[0][1],
            "update_rel_max_at": top[0][0], "update_rel_top": dict(top),
            "update_rel": rels, "stats_err_max": stats,
            "bn_fed_bias_update_max_per_lr": noise_max,
            "norm_ratio_range": [min(ratios), max(ratios)],
            "cosine_min": min(u["cos"] for u in above.values())}, upd


def _bf16_violations(r: dict, upd: dict, spread: dict,
                     extra: dict | None = None,
                     nondegenerate: bool = False) -> tuple[list[str], float]:
    """A bf16 step against another (``_spread``'s ``r`` and ``upd``) held
    to ``BF16_SPREAD_FACTOR`` times the recorded ``spread`` of one model's
    step (``BF16_STEP_BARS``), plus ``extra`` ("loss", "update", "stats":
    the model's float32 bars where the features differ) and the rounding
    floor; with ``nondegenerate`` also each update's norm ratio and cosine
    (``BF16_NORM_RATIO_TOL``, ``BF16_MIN_COSINE``).  Every violation, and
    the largest update difference as a share of its bar."""
    k, e = BF16_SPREAD_FACTOR, extra or {}
    bad, share = [], 0.0
    for key, tol in (("loss_rel", e.get("loss", 0.0)),
                     ("stats_err_max", e.get("stats", 0.0)),
                     ("bn_fed_bias_update_max_per_lr", ZERO_GRAD_UPDATE)):
        bar = k * spread[key] + tol
        if r[key] > bar:
            bad.append(f"{key} {r[key]:.3e} over {bar:.3e}")
    widest = max(spread["update_rel"].values())
    for name, u in upd.items():
        own = (spread["update_rel"].get(name, 0.0)
               if u["numel"] >= BF16_MIN_ELEMENTS else widest)
        bar = (k * own + e.get("update", 0.0)) * u["n"] + u["floor"]
        share = max(share, u["d"] / bar)
        if u["d"] > bar:
            bad.append(f"{name} update |delta| {u['d']:.3e} over {bar:.3e} "
                       f"(update norm {u['n']:.3e})")
        if (nondegenerate and u["numel"] >= BF16_MIN_ELEMENTS
                and u["n"] > u["floor"]):
            ratio = u["n_a"] / u["n"]
            if (abs(ratio - 1) > BF16_NORM_RATIO_TOL
                    or u["cos"] < BF16_MIN_COSINE):
                bad.append(f"{name} update norm ratio {ratio:.3f}, cosine "
                           f"{u['cos']:.3f}")
    return bad, share


def _scaled(before: dict, step: tuple, scale: float) -> tuple:
    """``step`` (a ``_stepped`` result) with every parameter's update
    multiplied by ``scale``: a made-up degenerate step."""
    loss, state, lr = step
    return loss, {k: v if k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked"))
                  else before[k] + scale * (v - before[k])
                  for k, v in state.items()}, lr


def _scribble_card() -> None:
    """NaN over ``BF16_SCRIBBLE_BYTES`` of card memory, freed again into the
    allocator's cache, so that the next allocations reuse written blocks."""
    import torch
    junk = torch.full((BF16_SCRIBBLE_BYTES // 4,), float("nan"),
                      device="cuda")
    del junk


def bf16_step_bars() -> dict:
    """The recorded spreads (``BF16_STEP_BARS``) by model."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, BF16_STEP_BARS)) as f:
        return json.load(f)["models"]


def bf16_inputs(corpus: dict, model: str) -> tuple:
    """One crop batch of ``model``, its labels, and the float32 and bf16
    models, dropout off, with the same float32 weights."""
    import torch
    audio, labels = next(_crops(corpus, SEED, model))
    f32 = _seeded(model, dropout=False)
    b16 = _seeded(model, dropout=False, dtype=torch.bfloat16)
    b16.load_state_dict(f32.state_dict())
    return audio, labels, f32, b16


def bf16_step_checks(corpus: dict) -> dict:
    """``BF16_STEP_MODELS``, dropout off, one crop batch each, from the same
    weights: a patch step on the CPU's features and an audio step (the
    model's kernel inside on the card) in bf16 on the CPU, the patch step
    in float32 on the CPU (this run's spread, against the recorded one),
    the audio step in float32 on the card, and the card's bf16 steps
    ``BF16_STEP_REPEATS`` times on fresh copies after ``_scribble_card``.
    Every card bf16 step is held to the bars of ``BF16_STEP_BARS`` (every
    violation is reported), and the bars are shown to refuse the CPU's own
    bf16 patch update zeroed and halved.  Also the launches and shapes of
    the card's steps, for phase 11."""
    spreads = bf16_step_bars()
    out, bad = {}, []
    with recorded() as rec:
        for model, (optimizer, f32_bar) in BF16_STEP_MODELS.items():
            audio, labels, f32, b16 = bf16_inputs(corpus, model)
            before = {k: v.clone() for k, v in f32.state_dict().items()}
            noise = _bn_fed_biases(f32)
            feat_stats, patches = _features_card_vs_cpu(audio, model)
            spread = spreads[model]

            def step(net, dev, kind):
                return _stepped(net, patches if kind == "patch" else audio,
                                labels, dev, kind == "audio", model,
                                optimizer)

            cpu16 = {kind: step(b16, "cpu", kind) for kind in ("patch",
                                                              "audio")}
            cpu32, card32 = step(f32, "cpu", "patch"), step(f32, "cuda",
                                                            "audio")
            now, _ = _spread(before, cpu16["patch"], cpu32, noise)
            res = {**feat_stats, "cpu_bf16_vs_cpu_f32": now,
                   "spread_vs_recorded_max": max(
                       v / spread["update_rel"][k]
                       for k, v in now.pop("update_rel").items()
                       if spread["update_rel"].get(k)),
                   "loss": {"cpu_f32": cpu32[0], "card_f32_audio": card32[0],
                            **{f"cpu_bf16_{k}": v[0]
                               for k, v in cpu16.items()}}}
            for scale in (0.0, 0.5):
                r, upd = _spread(before, _scaled(before, cpu16["patch"],
                                                 scale), cpu16["patch"], noise)
                check(_bf16_violations(r, upd, spread, nondegenerate=True)[0],
                      f"{model}: the CPU's bf16 patch step with its updates "
                      f"times {scale} passes the bf16 bars")
            # tag: (kind, reference, extra bars, held not degenerate)
            held = {"patch_card_bf16_vs_cpu_bf16": ("patch", cpu16["patch"],
                                                    None, True),
                    "audio_card_bf16_vs_card_f32": ("audio", card32, None,
                                                    False),
                    "audio_card_bf16_vs_cpu_bf16": (
                        "audio", cpu16["audio"],
                        {"loss": STEP_LOSS_RTOL, "update": f32_bar,
                         "stats": STEP_STATS_TOL}, True)}
            for rep in range(BF16_STEP_REPEATS):
                _scribble_card()
                card16 = {kind: step(b16, "cuda", kind)
                          for kind in ("patch", "audio")}
                for tag, (kind, ref, extra, nondeg) in held.items():
                    r, upd = _spread(before, card16[kind], ref, noise)
                    del r["update_rel"]
                    found, r["update_bar_share_max"] = _bf16_violations(
                        r, upd, spread, extra, nondeg)
                    res.setdefault(tag, []).append(r)
                    bad += [f"{model} repeat {rep}, {tag}: {v}"
                            for v in found]
            out[model] = res
    check(not bad, "bf16 steps (features card vs CPU max |delta| " + ", ".join(
        f"{m} {r['features_max_abs_delta']:.3e}" for m, r in out.items())
        + "): " + "; ".join(bad))
    return {"models": out, "launches": rec["launches"], "tcn": rec["tcn"],
            "conv_block": rec["conv_block"],
            "shapes": rec["shapes"]}


def conditioning_checks(net, patches, labels, model: str) -> dict:
    """One patch step of ``net`` from the same weights on the same patches
    (the CPU's features, dropout off) on the CPU in float64, on the CPU in
    float32 and on the card in float32: each float32 update's distance
    from the float64 one, relative to that update's norm, at every
    parameter, and by name at ``CONDITIONING_TENSORS[model]``.  If the
    CPU's float32 step lies as far from float64 as the card's, the
    card-against-CPU reading there is the gradient's conditioning, not the
    card.  A reading: no bar."""
    import copy

    import torch
    before = {k: v.clone() for k, v in net.state_dict().items()}
    noise = _bn_fed_biases(net)
    f64 = _stepped(copy.deepcopy(net).double(), patches.double(), labels,
                   "cpu", False, model)
    name = CONDITIONING_TENSORS[model]
    out = {"tensor": name}
    for dev in ("cpu", "card"):
        r, upd = _spread(before, _stepped(net, patches, labels,
                                          "cuda" if dev == "card" else "cpu",
                                          False, model), f64, noise)
        out[f"{dev}_f32_vs_f64"] = upd[name]["d"] / upd[name]["n"]
        out[f"{dev}_f32_vs_f64_top"] = r["update_rel_top"]
        out[f"{dev}_loss_rel_vs_f64"] = r["loss_rel"]
    return out


def scope_checks(wav: str, weights: str) -> dict:
    """The segmenter's 'featuregram' and 'none' standardization scopes
    (``StreamingSegmenter.standardize``) with Lemaire-MTL on a broadcast:
    features and tracks on the card (K1) and on the CPU, the tracks held to
    ``TRACK_TOL``.  Also the launches and shapes."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.data.audio import read_audio
    from sm_hpss_mtl_tpu_torch.models.zoo import load_model
    lem = "Lemaire_et_al_MTL"
    x, _ = read_audio(wav)
    tracks = {}
    with recorded() as rec:
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            fv = cli._featurize_broadcast(x, cli.MODEL_PRESETS[lem], d)
            seg = cli.segmenter(lem, load_model(weights, d, lem))
            for scope in ("featuregram", "none"):
                seg.standardize = scope
                tracks[dev, scope] = seg.frame_probabilities(fv)
    out = {"launches": rec["launches"], "shapes": rec["shapes"],
           "tcn": rec["tcn"],
           "conv_block": rec["conv_block"], "by_pair": rec["by_pair"],
           "by_power": rec["by_power"]}
    for scope in ("featuregram", "none"):
        d = max(float(np.abs(tracks["cuda", scope][k]
                             - tracks["cpu", scope][k]).max())
                for k in ("S", "M"))
        check(d <= TRACK_TOL, f"scope {scope}: tracks card vs CPU max "
                              f"|delta| {d:.3e}")
        check(all(np.isfinite(v).all() for v in
                  tracks["cuda", scope].values()), f"scope {scope}: tracks "
              "not finite")
        out[scope] = {"track_max_abs_delta_vs_cpu": d,
                      "windows": len(tracks["cuda", scope]["S"])}
    return out


def _mp3_libraries() -> dict:
    """Whether the system's libmpg123 (decoding, ``data/codecs.py``) and
    libmp3lame (the encoder this script makes its mp3 with) load."""
    import ctypes
    import ctypes.util

    from sm_hpss_mtl_tpu_torch.data import codecs
    try:
        ctypes.CDLL(ctypes.util.find_library("mp3lame") or "libmp3lame.so.0")
        lame = True
    except OSError:
        lame = False
    return {"libmpg123": codecs.available(), "libmp3lame": lame}


def encode_mp3(path: str, x: np.ndarray, sr: int) -> None:
    """Encode mono float32 audio as a 128 kbit/s mp3 with libmp3lame."""
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("mp3lame") or
                      "libmp3lame.so.0")
    lib.lame_init.restype = ctypes.c_void_p
    gf = ctypes.c_void_p(lib.lame_init())
    lib.lame_set_in_samplerate(gf, sr)
    lib.lame_set_num_channels(gf, 1)
    lib.lame_set_mode(gf, 3)                                 # mono
    lib.lame_set_brate(gf, 128)
    check(lib.lame_init_params(gf) >= 0, "libmp3lame refused its settings")
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    buf = ctypes.create_string_buffer(len(pcm) * 2 + 7200)
    n = lib.lame_encode_buffer(
        gf, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)), None,
        len(pcm), buf, len(buf))
    check(n >= 0, f"libmp3lame encode returned {n}")
    data = buf.raw[:n]
    n = lib.lame_encode_flush(gf, buf, len(buf))
    data += buf.raw[:n]
    lib.lame_close(gf)
    Path(path).write_bytes(data)


def make_mp3(tmp: str, x: np.ndarray) -> dict:
    """The mp3 phase's input: ``x`` encoded, then decoded through
    ``data/audio.py::read_audio`` (libmpg123), whose output must hold the
    signal (correlation over 0.99 after the codec's delay) and the
    duration.  With either library missing, a record that says so."""
    from sm_hpss_mtl_tpu_torch.data.audio import duration_seconds, read_audio
    libs = _mp3_libraries()
    if not all(libs.values()):
        return {"available": False, **libs}
    path = os.path.join(tmp, "b10.mp3")
    encode_mp3(path, x, SR)
    y, sr = read_audio(path)
    check(sr == SR and y.ndim == 1 and abs(len(y) - len(x)) < SR // 4,
          f"mp3 decoded to {y.shape} at {sr} Hz for {len(x)} samples")
    c = np.correlate(y[:SR], x[:SR // 2], mode="valid")
    lag = int(np.argmax(c))
    a, b = y[lag:lag + 4 * SR], x[:4 * SR]
    corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    check(corr > 0.99, f"mp3 round trip correlation {corr:.4f}")
    dur = duration_seconds(path)
    check(abs(dur - len(x) / SR) < 0.2, f"mp3 duration {dur} s")
    return {"available": True, **libs, "path": path, "x": y,
            "samples": len(y), "lag": lag, "correlation": corr,
            "duration_s": dur}


def time_device_steps(corpus: dict, model: str = "Lemaire_et_al_MTL",
                      steps: int = 30, profiled: int = 10,
                      dtype=None) -> dict:
    """Device-pipeline train steps of ``model`` at full width on the card,
    fed by the crop batcher through the prefetcher, dropout and
    augmentation on.  Each step's period (its start to the next one's, CUDA
    events) and its own span; over a further ``profiled`` steps, the
    kernel's (K1 or K2) device time and all device time per step from
    ``torch.profiler``, against the host clock around them.  ``dtype``:
    the model's compute dtype (bf16 for ``--bf16``)."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import DevicePrefetcher
    from torch.profiler import ProfilerActivity, profile

    _, state, step, _ = _train_setup("cuda", _seeded(model, dtype=dtype),
                                     SEED, model=model, augment_noise=True)
    it = DevicePrefetcher(_crops(corpus, SEED + 100, model), "cuda")
    try:
        marks = []
        for _ in range(steps):
            audio, labels = next(it)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, audio, labels)
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
        # Steps 3 and after: the first two build the kernel plans.
        period = sorted(marks[i][0].elapsed_time(marks[i + 1][0])
                        for i in range(2, steps - 1))
        span = sorted(a.elapsed_time(b) for a, b in marks[2:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                audio, labels = next(it)
                step(state, audio, labels)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        it.close()
    device = [e for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU]
    busy = sum(e.device_time_total for e in device) / 1e3
    kern = sum(e.device_time_total for e in device
               if "frontend_kernel" in e.name) / 1e3
    k = model_kernel(model).lower()
    # Where the host's time goes: the operators with the most self CPU
    # time per step (the profiler's own cost is in them too).
    host_ops = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
    mid = len(period) // 2
    return {"steps_timed": len(period), "step_ms": period[mid],
            "step_ms_spread": [period[0], period[-1]],
            "step_span_ms": span[len(span) // 2],
            "step_span_ms_spread": [span[0], span[-1]],
            "profiled_steps": profiled,
            "profiled_wall_ms_per_step": wall_ms / profiled,
            "device_busy_ms_per_step": busy / profiled if device else None,
            "device_idle_share": 1 - busy / wall_ms if device else None,
            f"{k}_device_ms_per_step": kern / profiled if device else None,
            f"{k}_share_of_step": (kern / profiled) / period[mid]
            if device else None,
            "device_busy_share_of_step": (busy / profiled) / period[mid]
            if device else None,
            "host_top_ops_ms_per_step": {
                e.key: e.self_cpu_time_total / 1e3 / profiled
                for e in host_ops[:8]}}


def tune_cli(corpus: dict, out: str, name: str, argv: tuple,
             n_rows: int) -> dict:
    """One ``cli.tune.main`` run on fold 0 of the training corpus with no
    ``--device`` (the card), one epoch of ``TUNE_STEPS`` train steps and one
    val step per trial; its rows, the JAX CLI's ``Tuning.csv`` header and
    finite losses checked, and K1 the only kernel (the tuner's tester
    featurizes bucketed files, so no item takes K4); a grid over l_harm or
    l_perc launches K1 at each of its widths."""
    from sm_hpss_mtl_tpu_torch.cli import tune
    with recorded() as rec:
        t0 = time.perf_counter()
        rows, best = tune.main([*argv, "--data", corpus["root"], "--output",
                                out, "--epochs", "1", "--tr-steps",
                                str(TUNE_STEPS), "--v-steps", "1"])
        total_s = time.perf_counter() - t0
    check(len(rows) == n_rows and best in rows, f"{name}: {len(rows)} rows")
    check(all(np.isfinite(r["val_loss"]) for r in rows),
          f"{name}: losses not finite: {rows}")
    with open(os.path.join(out, "Performance_Tuning.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == TUNE_HEADERS[name] and len(lines) == n_rows + 1,
          f"{name}: Performance_Tuning.csv header {lines[0]!r}")
    check(rec["launches"]["K1"] > 0 and not any(
        rec["launches"][k] for k in ("K2", "K3", "K4")),
          f"{name}: launches {rec['launches']}")
    # Every trial's Lemaire model runs its blocks in the TCN kernels, the
    # vmapped trials (--vmap) through the Functions' vmap rules.
    check(all(rec["tcn"].values()), f"{name}: TCN launches {rec['tcn']}")
    from sm_hpss_mtl_tpu_torch.cli.tune import GRID_RANGES
    widths = {}
    if "l_harm" in argv or "l_perc" in argv:
        param = "l_harm" if "l_harm" in argv else "l_perc"
        pairs = [(w, 11) if param == "l_harm" else (21, w)
                 for w in GRID_RANGES[param]]
        widths = {f"{lh},{lp}": rec["by_pair"]["K1"][f"{lh},{lp}"]
                  for lh, lp in pairs}
        check(all(widths.values()), f"{name}: K1 launches per pair {widths}")
    return {"launches": rec["launches"], "shapes": rec["shapes"],
            "tcn": rec["tcn"],
            "conv_block": rec["conv_block"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"], "total_s": total_s, "rows": rows,
            "k1_launches_per_pair": widths}


def _multi_trials():
    """The card-vs-CPU multi-trial step's four trials: the loss-weight grid,
    with lr scales 1, 0.5, 1, 2."""
    from sm_hpss_mtl_tpu_torch.cli.tune import GRID_RANGES
    return [{"loss_weights": w, "lr_scale": s}
            for w, s in zip(GRID_RANGES["loss_weights"], (1, 0.5, 1, 2))]


def _multi_setup(net, n: int, device: str):
    """``n`` trials of ``net``'s weights stacked on ``device``, Lemaire's
    SGD over them (per-trial clipnorm), and the multi-trial step."""
    import copy

    from sm_hpss_mtl_tpu_torch.train import multitrial
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    state = multitrial.stacked_state(
        [copy.deepcopy(net) for _ in range(n)],
        lambda ps: for_model("Lemaire_et_al_MTL", ps, 100000,
                             trial_axis=True)[0], [SEED] * n, device)
    return state, multitrial.make_multi_train_step(net, mtl=True,
                                                   l2_reg=0.01)


def multi_step_checks(corpus: dict) -> dict:
    """One four-trial step of full-width Lemaire-MTL (dropout off) on the
    CPU's patches of one crop batch, from the same stacked weights on the
    card and on the CPU: each trial's loss, updates and BatchNorm
    statistics held to the patch step's bars (per-trial loss weights,
    clipnorm and lr scales)."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.train.multitrial import (stack_hyperparams,
                                                        unstack_trial)
    model = "Lemaire_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, model))
    net = _seeded(model, dropout=False)
    _, patches = _features_card_vs_cpu(audio, model)
    trials = _multi_trials()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    got = {}
    for dev in ("cpu", "cuda"):
        state, step = _multi_setup(net, len(trials), dev)
        d = torch.device(dev)
        m = step(state, to_device(patches, d), to_device(labels, d),
                 stack_hyperparams(trials, ("3C", "M", "R", "S"), dev))
        got[dev] = (m["loss"].cpu().tolist(),
                    [unstack_trial(state, i) for i in range(len(trials))])
    noise = _bn_fed_biases(net)
    out = []
    for i, t in enumerate(trials):
        out.append(_hold_step(
            f"multi-trial step, trial {i}", before, got["cpu"][1][i],
            got["cuda"][1][i], got["cpu"][0][i], got["cuda"][0][i], noise,
            0.002 * t["lr_scale"], STEP_UPDATE_RTOL))
    return {"trials": out, "losses_card": got["cuda"][0],
            "losses_cpu": got["cpu"][0]}


def time_multi_steps(corpus: dict, steps: int = 20) -> dict:
    """Step time (CUDA events, step start to the next step's) of the
    multi-trial step on the card at full width, dropout on, on the CPU's
    patches of one crop batch: four trials, one trial, the single-trial
    step (``train.state.make_train_step``), and four of those in a loop,
    the last in turns with the four-trial step (the mean of two medians
    each)."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.train.multitrial import stack_hyperparams
    model = "Lemaire_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, model))
    net = _seeded(model)
    _, patches = _features_card_vs_cpu(audio, model)
    dev = torch.device("cuda")
    x, y = to_device(patches, dev), to_device(labels, dev)

    def period(step):
        marks = []
        for _ in range(steps):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            step()
        torch.cuda.synchronize()
        times = sorted(marks[i].elapsed_time(marks[i + 1])
                       for i in range(2, steps - 1))
        return times[len(times) // 2], [times[0], times[-1]]

    runs = {}
    for n in (4, 1):
        hyper = stack_hyperparams(_multi_trials()[:n], ("3C", "M", "R", "S"),
                                  "cuda")
        state, step = _multi_setup(net, n, "cuda")
        runs[f"trials_{n}"] = functools.partial(step, state, x, y, hyper)
    # The four trials as four single steps (a model, optimizer and
    # generator each), timed in turns with the multi-trial step.
    singles = [_train_setup("cuda", net, SEED, audio=False,
                            loss_weights=t["loss_weights"])[1:3]
               for t in _multi_trials()]
    runs["loop_of_4_single"] = lambda: [step(state, x, y)
                                        for state, step in singles]
    runs["single"] = functools.partial(singles[0][1], singles[0][0], x, y)
    turns = {}
    for name in ("trials_4", "loop_of_4_single", "loop_of_4_single",
                 "trials_4", "trials_1", "single"):
        turns.setdefault(name, []).append(period(runs[name]))
    out = {}
    for name, got in turns.items():
        out[f"{name}_step_ms"] = sum(t[0] for t in got) / len(got)
        out[f"{name}_step_ms_spread"] = [min(t[1][0] for t in got),
                                         max(t[1][1] for t in got)]
    out["trials_4_over_1"] = out["trials_4_step_ms"] / out["trials_1_step_ms"]
    out["trials_4_over_loop_of_4_single"] = (
        out["trials_4_step_ms"] / out["loop_of_4_single_step_ms"])
    return out


def _cached_features(root: str) -> dict:
    """Every ``.npy`` featuregram under ``root``, by relative path."""
    return {str(p.relative_to(root)): np.load(p)
            for p in sorted(Path(root).rglob("*.npy"))}


def featurize_checks(corpus: dict, out: str) -> dict:
    """``cli.featurize.main`` over the training corpus on the card (K1 once
    per bucket batch of up to 16 items, at the shapes planned in
    ``make_train_corpus``) and on the CPU: every cached featuregram card vs
    CPU within ``FEATURE_DB_TOL``."""
    from sm_hpss_mtl_tpu_torch.cli import featurize
    runs = {}
    for dev in ("cuda", "cpu"):
        with recorded() as rec:
            t0 = time.perf_counter()
            done = featurize.main(["--data", corpus["root"], "--features",
                                   os.path.join(out, dev), "--device", dev])
            total_s = time.perf_counter() - t0
        runs[dev] = {"launches": rec["launches"], "shapes": rec["shapes"],
                     "tcn": rec["tcn"],
                     "conv_block": rec["conv_block"],
                     "by_pair": rec["by_pair"],
                     "by_power": rec["by_power"], "total_s": total_s,
                     "computed": done,
                     "features": _cached_features(os.path.join(out, dev))}
    card, cpu = runs["cuda"], runs["cpu"]
    planned = corpus["featurize_launches"]
    check(card["launches"] == {"K1": len(planned), "K2": 0, "K3": 0,
                               "K4": 0}
          and {s[3:] for s in card["shapes"]["K1"]} == set(planned),
          f"featurize launches {card['launches']} at "
          f"{sorted(card['shapes']['K1'])}, planned {planned}")
    check(card["computed"] == cpu["computed"] == len(cpu["features"])
          == sum(b for b, _ in planned) and set(card["features"])
          == set(cpu["features"]), "featurize: cached items differ")
    db = max(float(np.abs(card["features"][k] - v).max())
             for k, v in cpu["features"].items())
    check(db <= FEATURE_DB_TOL, f"featurize: card vs CPU {db:.4f} dB")
    for r in runs.values():
        del r["features"]
    return {"card": card, "cpu_total_s": cpu["total_s"],
            "max_abs_db_vs_cpu": db, "launch_shapes": planned}


def tsne_checks(corpus: dict) -> dict:
    """``cli.tsne``'s device part, ``collect_class_patches`` with ``--stat
    Row``'s arguments over fold 0 of the training corpus, on the card (K1
    once per item) and on the CPU: every featuregram it computes within
    ``FEATURE_DB_TOL``, and each row's skewness within the change that the
    featuregrams' difference can make (``skew_bars``).  The KMeans compression and the
    t-SNE embedding are sklearn's, which the GPU machine lacks; the CPU
    tests run them (``tests/test_torch_drivers.py``)."""
    from sm_hpss_mtl_tpu_torch.cli import tsne
    from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig, Featurizer
    from sm_hpss_mtl_tpu_torch.data.folds import load_cv_folds

    class Kept(Featurizer):
        """A featurizer that keeps every featuregram it computes."""
        def _compute(self, audio):
            fv = super()._compute(audio)
            self.kept.append(fv)
            return fv

    cv = load_cv_folds(os.path.join(corpus["root"], "cv_info"))
    files = {"music": cv["music"]["fold0"], "speech": cv["speech"]["fold0"],
             "speech_music": cv["speech+music"]["fold0"]}
    # No class has 10000 patches, so none is subsampled and the rows keep
    # the featuregrams' order.
    kw = dict(feat_name="LogMelHarmPercSpec", stat="Row",
              max_patches_per_class=10000, seed=SEED)
    fz = {dev: Kept(FeatureConfig(), device=dev) for dev in ("cuda", "cpu")}
    for f in fz.values():
        f.kept = []
    with recorded() as rec:
        t0 = time.perf_counter()
        gx, gy = tsne.collect_class_patches(fz["cuda"], corpus["root"],
                                            files, **kw)
        total_s = time.perf_counter() - t0
    check(rec["launches"]["K1"] == len(fz["cuda"].kept) and not any(
        rec["launches"][k] for k in ("K2", "K3", "K4")),
          f"tsne launches {rec['launches']}")
    cx, cy = tsne.collect_class_patches(fz["cpu"], corpus["root"], files,
                                        **kw)
    check(gx.shape == cx.shape and bool((gy == cy).all())
          and set(np.unique(gy)) == {0, 1, 2},
          f"tsne features {gx.shape} vs {cx.shape}")
    db = max(float(np.abs(g - c).max())
             for g, c in zip(fz["cuda"].kept, fz["cpu"].kept))
    check(db <= FEATURE_DB_TOL, f"tsne featuregrams card vs CPU {db:.4f} dB")
    bar = np.concatenate([skew_bars(c, g) for c, g in
                          zip(fz["cpu"].kept, fz["cuda"].kept)])
    check(bar.shape == cx.shape, f"skewness bars {bar.shape}")
    d = np.abs(gx - cx)
    ratio = float((d / bar).max())
    check(ratio <= 1.0, f"tsne skewness card vs CPU at {ratio:.3f} of its "
          f"bar (largest difference {float(d.max()):.3e})")
    # A bar under the skewness's range, 2 (n - 2) / sqrt(n - 1), holds.
    holds = bar < 2 * 66 / np.sqrt(67)
    return {"launches": rec["launches"], "shapes": rec["shapes"],
            "tcn": rec["tcn"],
            "conv_block": rec["conv_block"], "by_pair": rec["by_pair"],
            "by_power": rec["by_power"], "total_s": total_s,
            "features_shape": list(gx.shape),
            "featuregram_max_abs_db_vs_cpu": db,
            "skew_max_abs_delta_vs_cpu": float(d.max()),
            "skew_max_share_of_bar": ratio,
            "skew_rows_with_a_bar_under_the_range": float(holds.mean()),
            "skew_max_abs_delta_in_rows_without_a_bar": float(
                d[np.isinf(bar)].max(initial=0.0)),
            "skew_bar_median": float(np.median(bar)),
            "skew_entries_over_1e-3": int((d > 1e-3).sum())}


def skew_bars(cpu, card, patch: int = 68) -> np.ndarray:
    """Per patch and row of ``cli.tsne``'s ``--stat Row`` vectors of one
    item (its featuregram ``cpu`` and ``card``, (2 n_mels, T) dB): the
    largest change of the row's skewness that the card's difference can
    make (see ``TSNE_ROUNDING``), as ``collect_class_patches`` orders the
    rows (harmonic half, then percussive, per patch)."""
    from sm_hpss_mtl_tpu_torch.ops.patches import extract_patches_np

    def rows(fv):                                # (N, 2 n_mels, patch)
        half = fv.shape[0] // 2
        return np.concatenate([extract_patches_np(p, patch, patch)
                               for p in (fv[:half], fv[half:])],
                              axis=1).astype(np.float64)

    x, y = rows(cpu), rows(card)
    e = y - x
    eta = (np.abs(e - e.mean(axis=2, keepdims=True)).max(axis=2)
           + TSNE_ROUNDING * np.abs(x).max(axis=2))
    d = x - x.mean(axis=2, keepdims=True)
    std, m3 = np.sqrt((d * d).mean(axis=2)), (d ** 3).mean(axis=2)
    moved = (std + eta) ** 3 - std ** 3
    with np.errstate(divide="ignore", invalid="ignore"):
        skew = m3 / std ** 3
        corners = np.stack([(m3 + a) / (std + b) ** 3
                            for a in (-moved, moved) for b in (-eta, eta)])
        change = np.abs(corners - skew).max(axis=0)
        # float32 moments on both sides, each a sum of `patch` terms.
        rounding = 2 * patch * 2.0 ** -24 * (
            (np.abs(d) ** 3).mean(axis=2) / std ** 3 + 1.5 * np.abs(skew))
    return np.where(std > eta, change + rounding, np.inf)


def late_fusion_checkpoints(root: str) -> tuple[str, str]:
    """Fold checkpoints of two full-width Lemaire-MTL models from seeded
    inits, one on ``LogMelHarmSpec`` and one on ``LogMelPercSpec`` (120
    rows each), as ``cli.mtl --feat-name ...`` writes them; the paths that
    ``cli.fuse_late`` takes."""
    import torch
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    from sm_hpss_mtl_tpu_torch.train.checkpoint import save_checkpoint
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState
    paths = []
    for k, feat in enumerate(("LogMelHarmSpec", "LogMelPercSpec")):
        net = init_weights(get_model("Lemaire_et_al_MTL", in_dim=120),
                           torch.Generator().manual_seed(SEED + k))
        opt, _ = for_model("Lemaire_et_al_MTL", net.parameters(), tr_steps=1)
        paths.append(os.path.join(root, feat, "fold0_ckpt"))
        save_checkpoint(paths[-1], TrainState(net, opt), {"epoch": 0})
    return tuple(paths)


def phase_halo(card: str, checked: dict) -> tuple[dict, list]:
    """K1 and K2 in halo mode (``frontend.launch(halo_in_audio=True)``, the
    time-sharded front end's launch) against their plain versions on the
    card (phase 3, continued): each shard shape of ``HALO_SHAPES`` at each
    edge flag pair of ``HALO_FLAGS``, added to the checked shapes.  Then
    the kernel records of the mode: K1 at the 10-minute broadcast's shard
    (1 x 15 000 frames, an interior shard's flags) and K2 at the
    production leg's 4-shard cut (2 x 384 frames), each with its time,
    device time, plain time and bound at that shape (launches still
    None), and the device time of a launch without halo on the same audio
    (its ``T + 2*ht`` frames: the same DFTs, the halo frames output too),
    the two device times taken in turns (halo, whole, whole, halo).
    Returns the max |delta| per kernel and the two records."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    M = mel_filterbank(22050, 400, 120, device="cuda")
    err = {"K1": 0.0, "K2": 0.0}

    def inputs(B, T, lh, flags):
        y = torch.randn((B, 400 + (T + 2 * (lh // 2) - 1) * 160),
                        generator=gen, device="cuda")
        return y, dict(n_fft=400, win_length=400, hop_length=160,
                       l_harm=lh, l_perc=11, halo_in_audio=True,
                       edge_flags=flags)

    for B, T, lh in HALO_SHAPES:
        for flags in HALO_FLAGS:
            y, kw = inputs(B, T, lh, flags)
            for k, basis in (("K1", M), ("K2", None)):
                want = (frontend.stft_hpss_plain(y, **kw) if basis is None
                        else frontend.stft_hpss_mel_plain(y, basis, **kw))
                err[k] = max(err[k], compare(
                    f"{k} halo mode flags={flags} l_harm={lh} B={B} T={T}",
                    frontend.launch(y, basis, **kw), want, RTOL, ATOL))
                checked[k].add((400, lh, 11, B, T, "halo", *flags))
                del want
    print(f"kernels in halo mode: {2 * len(HALO_SHAPES) * len(HALO_FLAGS)} "
          f"shapes ok, max |delta| K1 {err['K1']:.3e}, K2 {err['K2']:.3e}",
          flush=True)

    _, shared = median_comparators()
    nnz = int((M != 0).sum())
    records = []
    for k, basis, (B, T) in (("K1", M, (1, 15000)), ("K2", None, (2, 384))):
        y, kw = inputs(B, T, 21, (0, 0))
        run = lambda: frontend.launch(y, basis, **kw)  # noqa: E731
        plain = ((lambda: frontend.stft_hpss_plain(y, **kw)) if basis is None
                 else (lambda: frontend.stft_hpss_mel_plain(y, basis, **kw)))
        ms, plain_ms = cuda_ms(run, reps=50), cuda_ms(plain, reps=3,
                                                      batches=3)
        whole = functools.partial(frontend.launch, y, basis,
                                  **{k: v for k, v in kw.items()
                                     if k not in ("halo_in_audio",
                                                  "edge_flags")})
        turns = {"halo": [], "whole": []}
        for name in ("halo", "whole", "whole", "halo"):
            turns[name].append(device_ms(run if name == "halo" else whole,
                                         "frontend_kernel"))
        dev_ms = {k: None if None in v else sum(v) / len(v)
                  for k, v in turns.items()}
        mel = dict(n_mels=120, mel_nnz=nnz) if basis is not None else {}
        bound, by, _ = frontend_bound_ms(T, y.shape[-1], 400,
                                         shared[(21, 11)], card, B=B, **mel)
        records.append({
            "name": ("stft_hpss_mel" if basis is not None else "stft_hpss")
            + " (halo mode)", "route": "cuda",
            "source": "sm_hpss_mtl_tpu_torch/csrc/frontend.cu",
            "replaces": "sm_hpss_mtl_tpu/ops/frontend_pallas.py:"
            + ("207" if basis is not None else "219"),
            "launches": None, "max_abs_err": err[k], "ms": ms[0],
            "plain_ms": plain_ms[0], "bound_ms": bound, "bound_by": by,
            "library_ms": None, "ms_spread": ms[1:],
            "device_ms": dev_ms["halo"],
            "device_ms_same_audio_without_halo": dev_ms["whole"],
            "device_ms_turns": turns,
            "timed_shape": [B, T], "timed_flags": [0, 0],
            "halo_modes_checked": [list(f) for f in HALO_FLAGS],
            "halo_of": "sm_hpss_mtl_tpu/ops/frontend_pallas.py:164 "
                       "(edge_flags, halo_in_audio :267)"})
    return err, records


def _plain_frontend(y, M, **kw):
    """K1's (``M`` given) or K2's plain version."""
    from sm_hpss_mtl_tpu_torch.ops import frontend
    return (frontend.stft_hpss_plain(y, **kw) if M is None
            else frontend.stft_hpss_mel_plain(y, M, **kw))


def _turns(fns: dict, order: tuple, kernel: str, reps: int = 20) -> dict:
    """``cuda_ms`` and ``device_ms`` of each of ``fns``, taken in the turns
    of ``order`` (each name twice, as a, b, b, a); per name the mean of its
    turns' medians and the turns themselves (a profiler turn that recorded
    no such kernel reads None and is left out of the mean)."""
    ms = {name: [] for name in fns}
    dev = {name: [] for name in fns}
    for name in order:
        ms[name].append(cuda_ms(fns[name], reps=reps, batches=5)[0])
        dev[name].append(device_ms(fns[name], kernel, reps=reps))
    seen = {name: [d for d in dev[name] if d is not None] for name in fns}
    return {name: {"ms": sum(ms[name]) / len(ms[name]),
                   "ms_turns": ms[name],
                   "device_ms": (sum(seen[name]) / len(seen[name])
                                 if seen[name] else None),
                   "device_ms_turns": dev[name]} for name in fns}


def phase_modes(card: str, checked: dict, corpus: dict, x600: np.ndarray,
                out) -> tuple[list[dict], dict, dict, dict]:
    """The front end's modes beyond 'highest', power 2 and the pairs of
    ``KERNEL_MEDIANS`` on the card (phase 3, continued):

    (a) K1 and K2 at ``dft_precision='bf16x3'`` (the JAX package's default)
        against their plain bf16x3 versions at every launch shape phase 3
        checked at (21, 11), halo mode included, at phase 3's bars (added to
        the checked shapes with the mode's name); the 10-minute broadcast's
        bf16x3 features against the plain bf16x3 ones (<= 0.02 dB) and, a
        reading with no bar, against the plain 'highest' ones; both
        precisions' times in turns (highest, bf16x3, bf16x3, highest),
        device times, bounds and the DFT as the kernels compute it at 1 x
        16404 frames and 48 x 11120 samples; at 1 x 16404 each precision's
        error against float64, bf16x3's at least ``BF16X3_ERR_FACTOR``
        times split TF32's (the values show the bf16x3 body ran);
    (b) K1-K4 at the powers ``MODE_POWERS`` against their plain versions at
        a short and a long shape each, with the long shape's times beside
        power 2's, in turns;
    (c) K1-K4 at the pairs ``MODE_PAIRS`` against their plain versions at
        the edge lengths of each pair's half width and a long shape, with
        times, bounds, registers and spills;
    (d) the main path at the JAX CLI's default precision: ``cli.mtl
        --dft-precision bf16x3 --pipeline device`` for Lemaire-MTL (K1) and
        Jang-MTL (K2), one epoch of fold 0 on the training corpus at full
        width, and one Lemaire-MTL audio step from the same weights on the
        card and on the CPU, both at bf16x3, at the audio step's bars;
    (e) during (d), the bf16x3 launch counters moved and the 'highest' ones
        did not.
    Returns K1's and K2's bf16x3 records (kernel entries of their own, the
    launches those of (d)), the power records and the pair records per
    kernel, and the readings."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    from sm_hpss_mtl_tpu_torch.ops.featuregram import featuregram_slabbed
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    banks = {n: mel_filterbank(22050, n, 120, device="cuda")
             for n in (400, 512)}
    nnz = {n: int((M != 0).sum()) for n, M in banks.items()}
    single, shared = median_comparators(MODE_PAIRS)
    geo = dict(win_length=400, hop_length=160)
    t0 = time.perf_counter()

    def audio(n_fft, B, T):
        return torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                           device="cuda")

    # (a) bf16x3 at every (21, 11) shape of phase 3.
    err = {"K1": 0.0, "K2": 0.0}
    added = []
    for k in ("K1", "K2"):
        for key in sorted(checked[k], key=str):
            if key[1:3] != (21, 11) or isinstance(key[-1], str) and (
                    key[-1] == "bf16x3" or key[-1].startswith("power")):
                continue
            n_fft, B, T = key[0], key[3], key[4]
            kw = dict(n_fft=n_fft, l_harm=21, l_perc=11,
                      dft_precision="bf16x3", **geo)
            halo = 0
            if len(key) > 5:                     # (..., T, "halo", ml, mr)
                kw.update(halo_in_audio=True, edge_flags=key[6:8])
                halo = 2 * (21 // 2)
            y = audio(n_fft, B, T + halo)
            M = banks[n_fft] if k == "K1" else None
            err[k] = max(err[k], compare(
                f"{k} bf16x3 {key}", frontend.launch(y, M, **kw),
                _plain_frontend(y, M, **kw), RTOL, ATOL))
            added.append((k, key + ("bf16x3",)))
    for k, key in added:
        checked[k].add(key)
    print(f"modes: K1/K2 in bf16x3 at {len(added)} shapes of phase 3 ok, "
          f"max |delta| K1 {err['K1']:.3e}, K2 {err['K2']:.3e}", flush=True)

    x = torch.as_tensor(x600, device="cuda")
    fkw = dict(feat_name="LogMelHarmPercSpec", n_fft=400, n_mels=120)
    got = featuregram_slabbed(x, dft_precision="bf16x3", **fkw)
    k1 = frontend.stft_hpss_mel
    plain = {}
    for prec in ("bf16x3", "highest"):
        frontend.stft_hpss_mel = (
            lambda y, M, dft_precision="highest", prec=prec, **kw:
            frontend.stft_hpss_mel_plain(y, M, dft_precision=prec, **kw))
        try:
            plain[prec] = featuregram_slabbed(x, dft_precision=prec, **fkw)
        finally:
            frontend.stft_hpss_mel = k1
    db = {prec: (got - want).abs().max().item()
          for prec, want in plain.items()}
    del got, plain
    check(db["bf16x3"] <= FEATURE_DB_TOL,
          f"bf16x3 features of the 10-minute broadcast differ from the "
          f"plain bf16x3 ones by {db['bf16x3']:.4f} dB")

    records = []
    for k, n_fft, name in (("K1", 400, "stft_hpss_mel"),
                           ("K2", 512, "stft_hpss")):
        M = banks[n_fft] if k == "K1" else None
        mel = dict(n_mels=120, mel_nnz=nnz[n_fft]) if M is not None else {}
        lib = {prec: {**ptxas_report(
            "frontend.cu", f"frontend_kernelILi21ELi11ELb{int(M is None)}E",
            dft_precision=prec), "blocks_per_sm": frontend.blocks_per_sm(
                fullres=M is None, n_fft=n_fft, hop_length=160, l_harm=21,
                l_perc=11, dft_precision=prec)}
            for prec in ("highest", "bf16x3")}
        shapes = {}
        for B, N in ((1, n_fft + 16403 * 160), (48, 11120)):
            T = n_frames(N, n_fft, 160)
            y = torch.randn((B, N), generator=gen, device="cuda")
            kw = dict(n_fft=n_fft, l_harm=21, l_perc=11, **geo)
            fns = {prec: functools.partial(frontend.launch, y, M,
                                           dft_precision=prec, **kw)
                   for prec in ("highest", "bf16x3")}
            turns = _turns(fns, ("highest", "bf16x3", "bf16x3", "highest"),
                           "frontend_kernel")
            for prec in turns:
                turns[prec]["bound_ms"], turns[prec]["bound_by"], _ = \
                    frontend_bound_ms(T, N, n_fft, shared[(21, 11)], card,
                                      B=B, **mel)
                turns[prec]["dft_as_computed_ms"] = dft_as_computed_ms(
                    B, T, n_fft, card, prec)
            turns["bf16x3"]["plain_ms"] = cuda_ms(functools.partial(
                _plain_frontend, y, M, dft_precision="bf16x3", **kw),
                reps=3, batches=3)[0]
            if B == 1:
                ref = _plain_frontend(y.double(), None if M is None
                                      else M.double(), **kw)
                for prec in turns:
                    turns[prec]["max_err_vs_f64"] = max(
                        (g.double() - w).abs().max().item()
                        for g, w in zip(fns[prec](), ref))
                del ref
                ratio = (turns["bf16x3"]["max_err_vs_f64"]
                         / turns["highest"]["max_err_vs_f64"])
                check(ratio >= BF16X3_ERR_FACTOR,
                      f"{k} at 1 x {T}: bf16x3's error against float64 is "
                      f"{ratio:.2f}x split TF32's, under "
                      f"{BF16X3_ERR_FACTOR}x: the bf16x3 body did not run")
                turns["bf16x3"]["err_vs_f64_over_highest"] = ratio
            shapes[f"{B}x{N}"] = {"frames": T, **turns}
        long = shapes[f"1x{n_fft + 16403 * 160}"]
        records.append({
            "name": f"{name} (bf16x3)", "route": "cuda",
            "source": "sm_hpss_mtl_tpu_torch/csrc/frontend.cu",
            "replaces": "sm_hpss_mtl_tpu/ops/frontend_pallas.py:"
            + ("207" if M is not None else "219"),
            "launches": None, "max_abs_err": err[k],
            "ms": long["bf16x3"]["ms"], "plain_ms": long["bf16x3"]["plain_ms"],
            "bound_ms": long["bf16x3"]["bound_ms"],
            "bound_by": long["bf16x3"]["bound_by"], "library_ms": None,
            "device_ms": long["bf16x3"]["device_ms"],
            "dft_precision": "bf16x3",
            "bf16x3_body": "sm_hpss_mtl_tpu/ops/frontend_pallas.py:130",
            "timed_shape": [1, n_fft + 16403 * 160], "n_fft": n_fft,
            "precisions_in_turns": shapes, "ptxas": lib,
            **({"features_600s_max_abs_db_vs_plain_bf16x3": db["bf16x3"],
                "features_600s_max_abs_db_vs_plain_highest": db["highest"]}
               if M is not None else {})})
        print(f"modes: {k} at 1 x 16404 frames device ms highest "
              f"{long['highest']['device_ms']} bf16x3 "
              f"{long['bf16x3']['device_ms']} (DFT as computed "
              f"{long['highest']['dft_as_computed_ms']:.5f} / "
              f"{long['bf16x3']['dft_as_computed_ms']:.5f} ms)", flush=True)

    # (b) K1-K4 at the other powers.
    powers = {"K1": [], "K2": [], "K3": [], "K4": []}
    M = banks[400]
    for p in MODE_POWERS:
        kwp = dict(l_harm=21, l_perc=11, power=p)
        e = Counter()
        for k, n_fft in (("K1", 400), ("K2", 512)):
            Mk = M if k == "K1" else None
            for B, T in ((2, 7), (1, 16404)):
                y = audio(n_fft, B, T)
                kw = dict(n_fft=n_fft, **geo, **kwp)
                e[k] = max(e[k], compare(
                    f"{k} power {p} B={B} T={T}",
                    frontend.launch(y, Mk, **kw),
                    _plain_frontend(y, Mk, **kw), RTOL, ATOL))
            kw = dict(n_fft=n_fft, l_harm=21, l_perc=11, **geo)
            fns = {f"power {p}": functools.partial(frontend.launch, y, Mk,
                                                   power=p, **kw),
                   "power 2": functools.partial(frontend.launch, y, Mk, **kw)}
            turns = _turns(fns, (f"power {p}", "power 2", "power 2",
                                 f"power {p}"), "frontend_kernel")
            bound, by, _ = frontend_bound_ms(
                16404, y.shape[-1], n_fft, shared[(21, 11)], card,
                **(dict(n_mels=120, mel_nnz=nnz[400]) if Mk is not None
                   else {}))
            powers[k].append({
                "power": p, "launches": None, "max_abs_err": e[k],
                "timed_shape": [1, y.shape[-1]], **turns[f"power {p}"],
                "power_2": turns["power 2"],
                "plain_ms": cuda_ms(functools.partial(
                    _plain_frontend, y, Mk, power=p, **kw), reps=2,
                    batches=3)[0],
                "bound_ms": bound, "bound_by": by})
        for F, T in ((201, 13), (201, 5998)):
            B = 2 if T == 13 else 1
            S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
            for mo in (False, True):
                fn, plain = ((hpss.hpss_masks, hpss.hpss_masks_plain) if mo
                             else (hpss.hpss, hpss.hpss_plain))
                e["K3"] = max(e["K3"], compare(
                    f"K3 power {p} mask_only={mo} T={T}", fn(S, **kwp),
                    plain(S, **kwp), K3_RTOL, K3_ATOL))
            e["K4"] = max(e["K4"], compare(
                f"K4 power {p} T={T}", hpss.hpss_mel(S, M, **kwp),
                hpss.hpss_mel_plain(S, M, **kwp), K3_RTOL, K3_ATOL))
        S = torch.rand((1, 201, 5998), generator=gen, device="cuda") ** 3
        # K3's and K4's powf twins (POW true) and their ptxas reports.
        for k, kernel, fn, plain, mangled in (
                ("K3", "hpss_kernel", hpss.hpss_masks, hpss.hpss_masks_plain,
                 "hpss_kernelILi21ELi11ELb1ELb1E"),
                ("K4", "hpss_mel_kernel",
                 functools.partial(hpss.hpss_mel, mel_basis=M),
                 functools.partial(hpss.hpss_mel_plain, mel_basis=M),
                 "hpss_mel_kernelILi21ELi11ELb1E")):
            fns = {f"power {p}": functools.partial(fn, S, power=p),
                   "power 2": functools.partial(fn, S)}
            turns = _turns(fns, (f"power {p}", "power 2", "power 2",
                                 f"power {p}"), kernel, reps=50)
            bound = (k3_bound_ms(1, 201, 5998, shared[(21, 11)], card)
                     if k == "K3" else
                     k4_bound_ms(1, 201, 5998, 120, nnz[400],
                                 shared[(21, 11)], card))
            powers[k].append({
                "power": p, "launches": None, "max_abs_err": e[k],
                "timed_shape": [1, 201, 5998], **turns[f"power {p}"],
                "power_2": turns["power 2"],
                "plain_ms": cuda_ms(functools.partial(plain, S, power=p),
                                    reps=2, batches=3)[0],
                "bound_ms": bound, **ptxas_report("hpss.cu", mangled)})
    print("modes: powers " + "; ".join(
        f"{k} " + ", ".join(f"p={r['power']}: {r['device_ms']} ms "
                            f"(power 2 {r['power_2']['device_ms']}), "
                            f"|delta| {r['max_abs_err']:.2e}" for r in v)
        for k, v in powers.items()), flush=True)

    # (c) the pairs outside KERNEL_MEDIANS.
    pairs = {"K1": [], "K2": [], "K3": [], "K4": []}
    for lh, lp in MODE_PAIRS:
        ht = lh // 2
        kwl = dict(l_harm=lh, l_perc=lp)
        e = Counter()
        for T in sorted({1, 7, max(1, 2 * ht - 1), 2 * ht, 2 * ht + 1, 68}):
            for k, n_fft in (("K1", 400), ("K2", 512)):
                Mk = M if k == "K1" else None
                y = audio(n_fft, 2, T)
                kw = dict(n_fft=n_fft, **geo, **kwl)
                e[k] = max(e[k], compare(
                    f"{k} l=({lh},{lp}) T={T}", frontend.launch(y, Mk, **kw),
                    _plain_frontend(y, Mk, **kw), RTOL, ATOL))
            S = torch.rand((2, 201, T), generator=gen, device="cuda") ** 3
            for mo in (False, True):
                fn, plain = ((hpss.hpss_masks, hpss.hpss_masks_plain) if mo
                             else (hpss.hpss, hpss.hpss_plain))
                e["K3"] = max(e["K3"], compare(
                    f"K3 l=({lh},{lp}) mask_only={mo} T={T}", fn(S, **kwl),
                    plain(S, **kwl), K3_RTOL, K3_ATOL))
            e["K4"] = max(e["K4"], compare(
                f"K4 l=({lh},{lp}) T={T}", hpss.hpss_mel(S, M, **kwl),
                hpss.hpss_mel_plain(S, M, **kwl), K3_RTOL, K3_ATOL))
        cmp = shared[(lh, lp)]
        rec = {"pair": [lh, lp], "launches": None,
               "comparators_per_output": cmp,
               "comparators_per_output_own_networks": single[lh]
               + single[lp], "networks": "generated"}
        for k, n_fft in (("K1", 400), ("K2", 512)):
            Mk = M if k == "K1" else None
            y = audio(n_fft, 1, 16404)
            kw = dict(n_fft=n_fft, **geo, **kwl)
            run = functools.partial(frontend.launch, y, Mk, **kw)
            ms = cuda_ms(run, reps=10, batches=5)
            bound, by, _ = frontend_bound_ms(
                16404, y.shape[-1], n_fft, cmp, card,
                **(dict(n_mels=120, mel_nnz=nnz[400]) if Mk is not None
                   else {}))
            pairs[k].append({
                **rec, "max_abs_err": e[k], "ms": ms[0], "ms_spread": ms[1:],
                "device_ms": device_ms(run, "frontend_kernel", reps=10),
                "plain_ms": cuda_ms(functools.partial(_plain_frontend, y, Mk,
                                                      **kw),
                                    reps=1, batches=3)[0],
                "bound_ms": bound, "bound_by": by,
                "timed_shape": [1, y.shape[-1]], "n_fft": n_fft,
                "blocks_per_sm": frontend.blocks_per_sm(
                    fullres=Mk is None, n_fft=n_fft, hop_length=160, **kwl),
                **ptxas_report("frontend.cu", f"frontend_kernelILi{lh}ELi"
                               f"{lp}ELb{int(Mk is None)}E", (lh, lp))})
        S = torch.rand((1, 201, 5998), generator=gen, device="cuda") ** 3
        for k, kernel, fn, plain, mangled, bound in (
                ("K3", "hpss_kernel", hpss.hpss_masks, hpss.hpss_masks_plain,
                 f"hpss_kernelILi{lh}ELi{lp}ELb1ELb0E",
                 k3_bound_ms(1, 201, 5998, cmp, card)),
                ("K4", "hpss_mel_kernel",
                 functools.partial(hpss.hpss_mel, mel_basis=M),
                 functools.partial(hpss.hpss_mel_plain, mel_basis=M),
                 f"hpss_mel_kernelILi{lh}ELi{lp}ELb0E",
                 k4_bound_ms(1, 201, 5998, 120, nnz[400], cmp, card))):
            e[k] = max(e[k], compare(f"{k} l=({lh},{lp}) T=5998",
                                     fn(S, **kwl), plain(S, **kwl),
                                     K3_RTOL, K3_ATOL))
            run = functools.partial(fn, S, **kwl)
            ms = cuda_ms(run, reps=20, batches=5)
            pairs[k].append({
                **rec, "max_abs_err": e[k], "ms": ms[0], "ms_spread": ms[1:],
                "device_ms": device_ms(run, kernel, reps=20),
                "plain_ms": cuda_ms(functools.partial(plain, S, **kwl),
                                    reps=1, batches=3)[0],
                "bound_ms": bound, "timed_shape": [1, 201, 5998],
                "timed_mode": "mask_only" if k == "K3" else None,
                "blocks_per_sm": hpss.blocks_per_sm(mel=k == "K4", **kwl),
                **ptxas_report("hpss.cu", mangled, (lh, lp))})
        print(f"modes: pair ({lh},{lp}) " + "; ".join(
            f"{k} {pairs[k][-1]['device_ms']} ms "
            f"({pairs[k][-1]['registers']} registers, "
            f"{pairs[k][-1]['spill_stores']} B spilled), |delta| "
            f"{pairs[k][-1]['max_abs_err']:.2e}" for k in pairs), flush=True)

    # (d) the main path at the JAX CLI's default precision, and (e).
    runs = {}
    for model, k in (("Lemaire_et_al_MTL", "K1"), ("Jang_et_al_MTL", "K2")):
        r = train_cli(corpus, out(f"modes_{model}"), "device", model=model,
                      extra=("--dft-precision", "bf16x3"), epochs=1)
        by = r["launches_by_precision"][k]
        check(by["bf16x3"] == r["launches"][k] > 0 and by["highest"] == 0,
              f"{model} --dft-precision bf16x3: launches per precision {by}")
        _shapes_checked(f"{model} at bf16x3", r["shapes"], checked)
        runs[model] = r
    audio_, labels = next(_crops(corpus, SEED))
    step = _step_card_vs_cpu(_seeded("Lemaire_et_al_MTL", dropout=False),
                             audio_, labels, audio=True,
                             update_rtol=STEP_AUDIO_UPDATE_RTOL,
                             dft_precision="bf16x3")
    for rec, r, k in zip(records, runs.values(), ("K1", "K2")):
        rec["launches"] = r["launches_by_precision"][k]["bf16x3"]
    readings = {
        "card": card, "s": time.perf_counter() - t0,
        "bf16x3_shapes_checked": len(added),
        "features_600s_max_abs_db": db,
        "audio_step_bf16x3_card_vs_cpu": step,
        "main_path": {m: {"launches": r["launches"],
                          "launches_by_precision": r["launches_by_precision"],
                          "total_s": r["total_s"], "val_loss": r["val_loss"],
                          "accuracy": r["accuracy"]}
                      for m, r in runs.items()}}
    return records, powers, pairs, readings


#: phase_tcn_block: the TCN block's shapes on the main paths, (items, C, T):
#: a training step's 36 patches and the segmenter's 10000-window chunk.
TCN_SHAPES = {"train": (36, 32, 68), "eval": (10000, 32, 68)}
#: The TCN block's kernels (``ops/tcn_block.py``), as their counters name
#: them.
TCN_KERNELS = ("forward_a", "forward_b", "backward_a")
#: The spatial dropout's keep probability in the Lemaire models.
TCN_KEEP = 1.0 - 0.275
#: backward_a against the closed form on the card, per element, relative to
#: the largest |gradient|: the same float32 formula, its channel sum taken
#: in another order (1.6e-7 at most on the host build, 8 shapes); in bf16
#: both round once, at the output (one bf16 step).
TCN_BACKWARD_RTOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
#: The same against autograd of the plain chain on the card: float32
#: round-off, and in bf16 the chain's rounding of every step of its backward.
TCN_AUTOGRAD_RTOL = {"float32": 5e-6, "bfloat16": 2.0 ** -5}
#: The vmapped multi-trial step's losses on the fused blocks against the
#: chain on the card: the forward's bits are the chain's, but vmap batches
#: each trial's convolutions and their bias adds another way on each route.
TCN_MULTI_LOSS_RTOL = 1e-6
#: A fused train step's parameter gradients against the chain's on the card
#: (float32; the backward's sums in another order), relative to each
#: parameter's largest.
TCN_STEP_GRAD_RTOL = 1e-4


def _tcn_inputs(B: int, C: int, T: int, dtype, gen, train: bool,
                rows: int = 1) -> dict:
    """A dilated conv's product and bias (``rows`` rows, as a vmapped
    block's trials folded into the items have, else ``(C,)``), a block
    input, an output gradient and (train) a dropout mask on the card, with
    an all-zero column after the ReLU and a tie at the channel max."""
    import torch
    dev = gen.device
    conv = torch.randn((B, C, T), generator=gen, device=dev) * 3
    conv[0, :, 0] = -1.0
    conv[0, :2, min(1, T - 1)] = 50.0
    bias = torch.randn((rows, C) if rows > 1 else (C,), generator=gen,
                       device=dev) * 0.1
    bias[..., 1] = bias[..., 0]
    mask = (torch.empty((B, C, 1), device=dev).bernoulli_(TCN_KEEP,
                                                          generator=gen)
            if train else None)
    x = torch.randn((B, C, T), generator=gen, device=dev)
    grad = torch.randn((B, C, T), generator=gen, device=dev)
    return {"conv": conv.to(dtype), "bias": bias.to(dtype),
            "mask": None if mask is None else mask.to(dtype),
            "x": x.to(dtype), "grad": grad.to(dtype)}


def _same_bits(tag: str, got, want) -> None:
    import torch
    torch.cuda.synchronize()
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    check(got.shape == want.shape and got.dtype == want.dtype
          and torch.equal(got.view(view), want.view(view)),
          f"{tag}: not bit-identical to the plain version "
          f"({int((got.float() != want.float()).sum())} values differ)")


def _rel_err(got, want) -> float:
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / scale


def _tcn_registers() -> dict:
    """Per kernel of ``csrc/tcn_block.cu``, the most registers and spill
    bytes over its instances (the ptxas report)."""
    import re
    from sm_hpss_mtl_tpu_torch.ops import _nvcc
    log = Path(str(_nvcc.library_path("tcn_block.cu")) + ".log").read_text()
    out = {}
    for part in log.split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        kernel = next(k for k in TCN_KERNELS if k in name)
        regs = int(re.search(r"Used (\d+) registers", part).group(1))
        spill = sum(map(int, re.search(r"(\d+) bytes spill stores, (\d+) "
                                       r"bytes spill loads", part).groups()))
        rec = out.setdefault(kernel, {"registers": 0, "spill_bytes": 0,
                                      "instances": 0})
        rec["registers"] = max(rec["registers"], regs)
        rec["spill_bytes"] = max(rec["spill_bytes"], spill)
        rec["instances"] += 1
    return out


def _tcn_counts(before: dict) -> dict:
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters
    now = counters()
    return {k: now.get(f"tcn_block.launches_by_kernel.{k}", 0)
            - before.get(f"tcn_block.launches_by_kernel.{k}", 0)
            for k in TCN_KERNELS}


@contextlib.contextmanager
def _chain():
    """The model's blocks on the chain (the plain version) inside."""
    from sm_hpss_mtl_tpu_torch.models.tcn import TCNResidualBlock
    forward = TCNResidualBlock.forward
    TCNResidualBlock.forward = TCNResidualBlock.chain
    try:
        yield
    finally:
        TCNResidualBlock.forward = forward


def _tcn_keys(B: int, C: int, T: int, dtype: str, rows: int,
              masked: bool) -> set:
    """The launch shapes (``recorded``'s ``shapes["tcn"]`` keys) that one
    ``_tcn_hold`` covers."""
    return {("forward_a", dtype, B, C, T, rows, masked),
            ("forward_b", dtype, B, C, T, rows, None),
            ("backward_a", dtype, B, C, T, rows, masked)}


def _tcn_hold(B: int, C: int, T: int, dtype, gen, masked: bool,
              rows: int = 1) -> dict:
    """Each kernel against its plain version at one shape: the forwards bit
    for bit (forward_b with and without the skip branch), the backward
    within ``TCN_BACKWARD_RTOL`` of the closed form and
    ``TCN_AUTOGRAD_RTOL`` of autograd of the chain.  Returns the readings
    and the inputs."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import tcn_block as tb
    name = str(dtype).split(".")[1]
    v = _tcn_inputs(B, C, T, dtype, gen, train=masked, rows=rows)
    conv, bias, mask, x, grad = (v[k] for k in ("conv", "bias", "mask", "x",
                                                 "grad"))
    key = f"{name} {B}x{C}x{T}" + (f" bias rows {rows}" if rows > 1 else "")
    _same_bits(f"forward_a {key}", tb._launch_a(conv, bias, mask, TCN_KEEP),
               tb.forward_a_plain(conv, bias, mask, TCN_KEEP))
    want_out, want_t = tb.forward_b_plain(x, conv, bias)
    for skip in (False, True):
        got_out, got_t = tb._launch_b(x, conv, bias, skip)
        _same_bits(f"forward_b {key}", got_out, want_out)
        check((got_t is None) != skip, "forward_b: t where not asked")
        if skip:
            _same_bits(f"forward_b t {key}", got_t, want_t)
    got = tb._launch_backward_a(grad, conv, bias, mask, TCN_KEEP, None)
    closed = tb.backward_a_plain(grad, conv, bias, mask, TCN_KEEP)
    c = conv.clone().requires_grad_()
    tb.forward_a_plain(c, bias, mask, TCN_KEEP).backward(grad)
    rec = {"closed_form_rel_err": _rel_err(got, closed),
           "autograd_rel_err": _rel_err(got, c.grad),
           "relu_zeros_equal": bool(torch.equal(got == 0, c.grad == 0))}
    check(rec["closed_form_rel_err"] <= TCN_BACKWARD_RTOL[name],
          f"backward_a {key}: {rec['closed_form_rel_err']:.3e} of the "
          "closed form's largest")
    check(rec["autograd_rel_err"] <= TCN_AUTOGRAD_RTOL[name],
          f"backward_a {key}: {rec['autograd_rel_err']:.3e} of autograd's "
          "largest")
    return rec, v


def _hold_tcn_shapes(keys: set, checked: dict) -> list:
    """``_tcn_hold`` at each launch shape of ``keys`` (``recorded``'s
    ``shapes["tcn"]``) that ``checked["tcn"]`` lacks, each then added to
    it; the shapes held here, as [dtype, B, C, T, bias rows, masked]."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    groups = {}
    for _, dtype, B, C, T, rows, masked in keys - checked["tcn"]:
        groups.setdefault((dtype, B, C, T, rows), set()).add(masked)
    held = []
    for (dtype, B, C, T, rows), seen in sorted(groups.items(), key=str):
        # forward_b's keys carry no mask (None): the unmasked hold covers
        # them where no forward_a of that shape says otherwise.
        for masked in sorted({m for m in seen if m is not None} or {False}):
            _tcn_hold(B, C, T, getattr(torch, dtype), gen, masked, rows)
            checked["tcn"] |= _tcn_keys(B, C, T, dtype, rows, masked)
            held.append([dtype, B, C, T, rows, masked])
    return held


def _tcn_kernel_checks(checked: dict) -> dict:
    """Each kernel against its plain version at the main paths' shapes
    (``TCN_SHAPES``; the training step's with its dropout mask) in float32
    and bf16 (``_tcn_hold``), each shape added to ``checked["tcn"]``; in
    float32 the times of kernel and chain (CUDA events, and the profiler's
    device time) beside the bytes bound."""
    import torch
    from benchmark import counts
    from sm_hpss_mtl_tpu_torch.ops import tcn_block as tb
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for tag, (B, C, T) in TCN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            rec, v = _tcn_hold(B, C, T, dtype, gen, masked=tag == "train")
            checked["tcn"] |= _tcn_keys(B, C, T, name, 1, tag == "train")
            conv, bias, mask, x, grad = (v[k] for k in (
                "conv", "bias", "mask", "x", "grad"))
            key = f"{tag} {name} {B}x{C}x{T}"
            if dtype == torch.float32:
                n = B * C * T * 4
                a = (tb._launch_a, (conv, bias, mask, TCN_KEEP),
                     tb.forward_a_plain, 2 * n)
                b = (lambda *a: tb._launch_b(*a, False), (x, conv, bias),
                     tb.forward_b_plain, 3 * n)
                bw = (lambda *a: tb._launch_backward_a(*a, None),
                      (grad, conv, bias, mask, TCN_KEEP),
                      None, 3 * n)
                # The chain's backward alone: autograd over one recorded
                # forward.
                cc = conv.clone().requires_grad_()
                recorded = tb.forward_a_plain(cc, bias, mask, TCN_KEEP)
                for kern, (fn, args, plain, nbytes) in (
                        ("forward_a", a), ("forward_b", b),
                        ("backward_a", bw)):
                    if plain is None:
                        def plain_fn(g=grad):
                            torch.autograd.grad(recorded, cc, g,
                                                retain_graph=True)
                    else:
                        def plain_fn(p=plain, a=args):
                            p(*a)
                    ms, lo, hi = cuda_ms(lambda f=fn, a=args: f(*a))
                    plain_ms = cuda_ms(plain_fn)[0]
                    bound = 1e3 * nbytes / counts.HBM_BYTES_PER_S
                    rec[kern] = {
                        "ms": ms, "ms_spread": [lo, hi],
                        "device_ms": device_ms(lambda f=fn, a=args: f(*a),
                                               kern),
                        "bound_ms": bound, "roofline": bound / ms,
                        "plain_ms": plain_ms}
            out[key] = rec
    return out


def _tcn_model_checks() -> dict:
    """Lemaire-MTL at full width on the card, the fused blocks against the
    chain: a 10000-window eval call bit for bit (and its time either way),
    24 launches of each forward kernel a call; a train step's loss bit for
    bit and its gradients within ``TCN_STEP_GRAD_RTOL``, 24 launches of
    each kernel; the patch step graphed against eager for 5 steps under
    cuDNN's deterministic algorithms, bit for bit, every replay counting
    24 of each."""
    import copy
    import torch
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState, make_train_step
    lem = "Lemaire_et_al_MTL"
    net = _seeded(lem).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, C, T = TCN_SHAPES["eval"]
    windows = torch.randn((B, T, 240), generator=gen, device="cuda")
    net.eval()
    with torch.inference_mode():
        before = counters()
        fused = net(windows)
        counts = _tcn_counts(before)
        with _chain():
            chain = net(windows)
        for k in chain:
            _same_bits(f"Lemaire-MTL eval call, head {k}", fused[k], chain[k])
        check(counts == {"forward_a": 24, "forward_b": 24, "backward_a": 0},
              f"eval call launches {counts}")
        call_ms = cuda_ms(lambda: net(windows), reps=5, batches=5)[0]
        with _chain():
            chain_ms = cuda_ms(lambda: net(windows), reps=5, batches=5)[0]
    res = {"eval_call": {"launches": counts, "fused_ms": call_ms,
                         "chain_ms": chain_ms}}

    # One eager train step on 36 patches, fused against the chain.
    Bt = TCN_SHAPES["train"][0]
    patches = torch.randn((Bt, T, 240), generator=gen, device="cuda")
    cls = torch.arange(Bt, device="cuda") % 3
    labels = {"S": (cls == 1).float(), "M": (cls == 0).float(),
              "R": torch.stack([(cls != 1).float(), (cls != 0).float()], -1),
              "3C": torch.nn.functional.one_hot(cls, 3).float()}

    def run(graphed: bool, steps: int, chain: bool = False):
        model_ = copy.deepcopy(net).train()
        opt, _ = for_model(lem, model_.parameters(), tr_steps=100000)
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        step = make_train_step(model_, opt, mtl=True, generator=g,
                               l2_reg=0.01, before_update=None if graphed
                               else (lambda: None))
        state = TrainState(model_, opt)
        losses, per_step = [], []
        with _chain() if chain else contextlib.nullcontext():
            for _ in range(steps):
                before = counters()
                losses.append(float(step(state, patches, labels)["loss"]))
                per_step.append(_tcn_counts(before))
        grads = [p.grad.detach().clone() for p in model_.parameters()]
        params = [p.detach().clone() for p in model_.parameters()]
        return losses, per_step, grads, params, g.get_state()

    # cuDNN's deterministic algorithms throughout: its default weight
    # gradients sum in no fixed order.  The biases that feed a BatchNorm
    # have round-off for gradients and are left out of the comparison.
    noise = _bn_fed_biases(net)
    names = [k for k, _ in net.named_parameters()]
    before_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        l_f, c_f, g_f, _, s_f = run(False, 1)
        l_c, _, g_c, _, s_c = run(False, 1, chain=True)
        lg, cg, _, pg, sg = run(True, 5)
        le, ce, _, pe, se = run(False, 5)
    finally:
        torch.backends.cudnn.deterministic = before_det
    check(l_f == l_c, f"train step loss {l_f} against the chain's {l_c}")
    check(torch.equal(s_f, s_c), "train step: the generator's state differs")
    grad_err = {k: _rel_err(a, b) for k, a, b in zip(names, g_f, g_c)
                if k not in noise and b.abs().max() > 0}
    worst = max(grad_err, key=grad_err.get)
    check(grad_err[worst] <= TCN_STEP_GRAD_RTOL,
          f"train step gradient of {worst} {grad_err[worst]:.3e} from the "
          "chain's")
    check(c_f == [{"forward_a": 24, "forward_b": 24, "backward_a": 24}],
          f"train step launches {c_f}")
    check(lg == le and all(torch.equal(a, b) for a, b in zip(pg, pe))
          and torch.equal(sg, se),
          "graphed patch steps differ from the eager ones")
    each = {"forward_a": 24, "forward_b": 24, "backward_a": 24}
    check(cg == [each] * 5 and ce == [each] * 5,
          f"graphed steps' launches {cg}, eager {ce}")
    res["train_step"] = {"loss": l_f[0],
                         "grad_rel_err_vs_chain": [worst, grad_err[worst]],
                         "launches": c_f[0],
                         "graphed_vs_eager_bitwise": True,
                         "graphed_launches_per_step": cg}
    res["multi_trial_step"] = _tcn_multi_checks(net, patches, labels, noise)
    return res


def _tcn_multi_checks(net, patches, labels, noise: set) -> dict:
    """The vmapped multi-trial step (``_multi_setup``'s four trials, dropout
    on, fed per trial) on the fused blocks against the chain, from the same
    stacked weights and generators: each kernel launched once a block, over
    the four trials' items folded together with a bias row each; the
    losses within ``TCN_MULTI_LOSS_RTOL`` of the chain's and each trial's
    step held to the chain's at the patch step's bars (``_hold_step``,
    ``STEP_UPDATE_RTOL``: the closed-form backward sums in another order,
    and the per-trial clipnorm and loss weights carry that on)."""
    import torch
    from sm_hpss_mtl_tpu_torch.train.multitrial import (stack_hyperparams,
                                                        unstack_trial)
    trials = _multi_trials()
    hyper = stack_hyperparams(trials, ("3C", "M", "R", "S"), "cuda")
    before = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    got = {}
    for chain in (False, True):
        state, step = _multi_setup(net, len(trials), "cuda")
        with _chain() if chain else contextlib.nullcontext():
            with recorded() as rec:
                loss = step(state, patches, labels, hyper)["loss"]
        got[chain] = (loss, rec["tcn"], rec["shapes"]["tcn"],
                      [{k: v.cpu() for k, v in unstack_trial(state, i).items()}
                       for i in range(len(trials))])
    (loss_f, tcn_f, shapes_f, after_f), (loss_c, tcn_c, _, after_c) = (
        got[False], got[True])
    B, C, T = TCN_SHAPES["train"]
    n = len(trials)
    check(tcn_f == {"forward_a": 24, "forward_b": 24, "backward_a": 24}
          and not any(tcn_c.values()),
          f"multi-trial step launches {tcn_f}, on the chain {tcn_c}")
    check({k[2:6] for k in shapes_f} == {(n * B, C, T, n)},
          f"multi-trial step launch shapes {sorted(shapes_f, key=str)}")
    loss_err = _rel_err(loss_f, loss_c)
    check(loss_err <= TCN_MULTI_LOSS_RTOL,
          f"multi-trial losses {loss_f.tolist()} against the chain's "
          f"{loss_c.tolist()}")
    held = [_hold_step(f"multi-trial step, trial {i}, fused vs the chain",
                       before, after_c[i], after_f[i], float(loss_c[i]),
                       float(loss_f[i]), noise, 0.002 * t["lr_scale"],
                       STEP_UPDATE_RTOL)
            for i, t in enumerate(trials)]
    return {"launches": tcn_f, "shapes": sorted(shapes_f, key=str),
            "losses": loss_f.tolist(), "loss_rel_err_vs_chain": loss_err,
            "losses_bitwise": bool(torch.equal(loss_f, loss_c)),
            "update_rel_max_vs_chain": [
                (h["update_rel_max_at"], h["update_rel_max"]) for h in held]}


def phase_tcn_block(card: str, checked: dict) -> dict:
    """The TCN block's kernels (``ops/tcn_block.py``): each against its
    plain version at the main paths' shapes (which go into
    ``checked["tcn"]``), then in Lemaire-MTL (``_tcn_kernel_checks``,
    ``_tcn_model_checks``); registers and spills from the ptxas report."""
    from sm_hpss_mtl_tpu_torch.ops import tcn_block
    t0 = time.perf_counter()
    tcn_block.build()
    return {"card": card, "registers": _tcn_registers(),
            "kernels": _tcn_kernel_checks(checked),
            "model": _tcn_model_checks(),
            "s": time.perf_counter() - t0}


#: phase_conv_block: Jang-MTL's three conv blocks at a segmenter's model
#: call (1024 windows of two towers of 120 mel rows by 68 frames), each
#: product's (items, C, H, W).
CONV_BLOCK_SHAPES = {"b1": (1024, 32, 240, 68), "b2": (1024, 64, 120, 34),
                     "b3": (1024, 128, 60, 17)}
#: The pooling modes as the counters name them: Jang-MTL pools 'SAME', the
#: single-task Jang 'VALID'.
CONV_BLOCK_POOLS = ("same", "valid")
#: The kernel against the eager chain on the card, relative to the largest
#: output (the chain's own float operations, so bit for bit where they are
#: the same; this bar is what a different rounding of BatchNorm may cost).
CONV_BLOCK_RTOL = 1e-6
#: Jang's paths in phase 12 that run a model call in eval mode with no
#: gradient on the card (serving and evaluation: each launches the kernel;
#: the training runs' validation may).
CONV_BLOCK_SERVING = ("jang_60", "jang_600", "jang_10", "eval_jang")
CONV_BLOCK_PATHS = CONV_BLOCK_SERVING + ("train_jang_device",
                                         "train_jang_host",
                                         "train_Jang_et_al")


def _conv_block_inputs(B: int, C: int, H: int, W: int, dtype, gen,
                       rows: int = 1) -> tuple:
    """A conv product and its bias in ``dtype``, and BatchNorm's running
    mean and variance, weight and shift in the seeded weights' ranges (one
    channel's weight negative, one's variance near 0), ``(C,)`` or
    ``(rows, C)``, on the card."""
    import torch
    dev = gen.device
    shape = (rows, C) if rows > 1 else (C,)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    conv = torch.randn((B, C, H, W), generator=gen, device=dev) * 2
    weight = u(0.9, 1.1)
    weight[..., 1] *= -1
    var = u(0.9, 1.1)
    var[..., 2] = 1e-4
    params = {"running_mean": u(-0.05, 0.05), "running_var": var,
              "weight": weight, "bias": u(-0.05, 0.05)}
    return conv.to(dtype), u(-0.05, 0.05).to(dtype), params


def _conv_block_plain_rows(conv, bias, params: dict, padding: str):
    """``conv_block_plain`` for each row of ``(rows, C)`` parameters over its
    share of the items (one call for ``(C,)`` ones)."""
    import types

    import torch
    from sm_hpss_mtl_tpu_torch.models.heads import BN_KW
    from sm_hpss_mtl_tpu_torch.ops.conv_block import conv_block_plain
    if bias.ndim == 1:
        return conv_block_plain(conv, bias, types.SimpleNamespace(
            **params, eps=BN_KW["eps"]), padding)
    rows = len(bias)
    return torch.cat([conv_block_plain(
        part, bias[g], types.SimpleNamespace(
            **{k: v[g] for k, v in params.items()}, eps=BN_KW["eps"]),
        padding) for g, part in enumerate(conv.chunk(rows))])


def _gap(got, want) -> dict:
    """The kernel's output against the chain's: bit for bit or not, the
    values that differ, the largest gap relative to the largest output."""
    import torch
    torch.cuda.synchronize()
    same_shape = got.shape == want.shape and got.dtype == want.dtype
    return {"bitwise": bool(same_shape and torch.equal(
                got.view(torch.int32), want.view(torch.int32))),
            "values_differing": int((got != want).sum()) if same_shape
            else -1,
            "rel_gap": _rel_err(got, want) if same_shape else float("inf")}


def _conv_block_key(B: int, C: int, H: int, W: int, dtype: str,
                    padding: str, rows: int = 1) -> tuple:
    """A launch shape as ``recorded`` keys it."""
    from sm_hpss_mtl_tpu_torch.ops.conv_block import pooled_size
    return (dtype, B, C, H, W, pooled_size(H, padding),
            pooled_size(W, padding), rows)


def _conv_block_hold(B: int, C: int, H: int, W: int, dtype, padding: str,
                     gen, rows: int = 1) -> tuple[dict, tuple]:
    """The kernel against the plain version at one shape, within
    ``CONV_BLOCK_RTOL`` of the largest output; its readings, and the
    kernel's arguments and the plain call for timing."""
    from sm_hpss_mtl_tpu_torch.models.heads import BN_KW
    from sm_hpss_mtl_tpu_torch.ops import conv_block as cb
    conv, bias, params = _conv_block_inputs(B, C, H, W, dtype, gen, rows)
    args = (conv, bias, params["running_mean"], params["running_var"],
            params["weight"], params["bias"], BN_KW["eps"], padding)
    rec = _gap(cb._launch(*args),
               _conv_block_plain_rows(conv, bias, params, padding))
    check(rec["rel_gap"] <= CONV_BLOCK_RTOL,
          f"conv_block {dtype} {padding} {(B, C, H, W)} rows {rows}: "
          f"{rec['values_differing']} values differ, the largest by "
          f"{rec['rel_gap']:.3e} of the largest output")
    return rec, (args, functools.partial(_conv_block_plain_rows, conv, bias,
                                         params, padding))


def _hold_conv_block_shapes(keys: set, checked: dict) -> list:
    """``_conv_block_hold`` at each launch shape of ``keys`` (``recorded``'s
    ``shapes["conv_block"]``) that ``checked["conv_block"]`` lacks, each
    then added to it; the shapes held here."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    held = []
    for key in sorted(keys - checked["conv_block"], key=str):
        dtype, B, C, H, W, Ho, Wo, rows = key
        padding = "SAME" if (Ho, Wo) == (-(-H // 2), -(-W // 2)) else "VALID"
        _conv_block_hold(B, C, H, W, getattr(torch, dtype), padding, gen,
                         rows)
        checked["conv_block"].add(key)
        held.append(list(key))
    return held


def _conv_block_registers() -> dict:
    """Per instance of ``csrc/conv_block.cu``'s kernel (its storage type
    and columns a thread), registers and spill bytes (the ptxas report)."""
    import re
    from sm_hpss_mtl_tpu_torch.ops import _nvcc
    log = Path(str(_nvcc.library_path("conv_block.cu")) + ".log").read_text()
    out = {}
    for part in log.split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        kind = "bf16" if "BF16" in name else "f32"
        vec = re.search(r"Li(\d+)E", name)
        spill = sum(map(int, re.search(r"(\d+) bytes spill stores, (\d+) "
                                       r"bytes spill loads", part).groups()))
        out[f"{kind} vec {vec.group(1) if vec else name}"] = {
            "registers": int(re.search(r"Used (\d+) registers",
                                       part).group(1)),
            "spill_bytes": spill}
    return out


def _conv_block_counts(before: dict) -> dict:
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters
    now = counters()
    return {p: now.get(f"conv_block.launches_by_pool.{p}", 0)
            - before.get(f"conv_block.launches_by_pool.{p}", 0)
            for p in CONV_BLOCK_POOLS}


@contextlib.contextmanager
def _conv_chain():
    """Jang's conv blocks on the chain (the plain version) inside."""
    from sm_hpss_mtl_tpu_torch.models.jang import _ConvBlock
    forward = _ConvBlock.forward
    _ConvBlock.forward = _ConvBlock.chain
    try:
        yield
    finally:
        _ConvBlock.forward = forward


def _conv_block_kernel_checks(checked: dict) -> dict:
    """The kernel against its plain version at Jang-MTL's three block shapes
    (``CONV_BLOCK_SHAPES``), in float32 and bf16, pooling 'SAME' and
    'VALID', each shape added to ``checked["conv_block"]``; the times of
    kernel (CUDA events, and the profiler's device time) and eager chain
    beside the bytes bound (the product read once, the pooled float32
    result written once)."""
    import torch
    from benchmark import counts
    from sm_hpss_mtl_tpu_torch.ops import conv_block as cb
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    out = {}
    for blk, (B, C, H, W) in CONV_BLOCK_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            for padding in ("SAME", "VALID"):
                rec, (args, plain) = _conv_block_hold(B, C, H, W, dtype,
                                                      padding, gen)
                checked["conv_block"].add(
                    _conv_block_key(B, C, H, W, name, padding))
                Ho, Wo = cb.pooled_size(H, padding), cb.pooled_size(W,
                                                                    padding)
                nbytes = B * C * (H * W * args[0].element_size()
                                  + Ho * Wo * 4)
                ms, lo, hi = cuda_ms(lambda a=args: cb._launch(*a), reps=10,
                                     batches=5)
                dev_ms = device_ms(lambda a=args: cb._launch(*a),
                                   "conv_block", reps=20)
                bound = 1e3 * nbytes / counts.HBM_BYTES_PER_S
                rec.update({"ms": ms, "ms_spread": [lo, hi],
                            "device_ms": dev_ms, "bound_ms": bound,
                            "roofline": bound / (dev_ms or ms),
                            "library_ms": cuda_ms(plain, reps=5,
                                                  batches=3)[0]})
                out[f"{blk} {name} {padding} {B}x{C}x{H}x{W}"] = rec
                del args, plain
    return out


def _conv_block_model_checks() -> dict:
    """Jang-MTL (pooling 'SAME'; float32 and bf16 compute) and the
    single-task Jang ('VALID') at full width on the card, a segmenter's
    model call of 1024 windows, fused against the chain: every output
    within ``CONV_BLOCK_RTOL`` of the chain's largest (bit for bit where
    the kernel is), three launches a call in the model's mode, and the
    call's time either way; then Jang-MTL's vmapped multi-trial evaluation
    step (``_multi_trials``' four trials) fused against the chain, the
    kernel launched once a block over the four trials' items with a
    parameter row each."""
    import torch
    from sm_hpss_mtl_tpu_torch.train import multitrial
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    B = CONV_BLOCK_SHAPES["b1"][0]
    x = torch.randn((B, 514, 68, 1), generator=gen, device="cuda")
    res = {}
    for model, dtype, pool in (("Jang_et_al_MTL", None, "same"),
                               ("Jang_et_al_MTL", torch.bfloat16, "same"),
                               ("Jang_et_al", None, "valid")):
        net = _seeded(model, dtype=dtype).cuda().eval()
        xin = x if model.endswith("MTL") else x[:, :257]
        with torch.inference_mode():
            before = counters()
            fused = net(xin)
            counts = _conv_block_counts(before)
            with _conv_chain():
                chain = net(xin)
            if not isinstance(fused, dict):
                fused, chain = {"out": fused}, {"out": chain}
            gaps = {k: _gap(fused[k], chain[k]) for k in chain}
            fused_ms = cuda_ms(lambda: net(xin), reps=3, batches=5)[0]
            with _conv_chain():
                chain_ms = cuda_ms(lambda: net(xin), reps=3, batches=5)[0]
        tag = f"{model} {'bf16' if dtype else 'float32'}"
        worst = max(g["rel_gap"] for g in gaps.values())
        check(worst <= CONV_BLOCK_RTOL,
              f"{tag} eval call: outputs {worst:.3e} from the chain's")
        check(counts == {p: 3 if p == pool else 0 for p in CONV_BLOCK_POOLS},
              f"{tag} eval call launches {counts}")
        res[tag] = {"launches": counts, "gaps": gaps, "fused_ms": fused_ms,
                    "chain_ms": chain_ms}
        del net

    net = _seeded("Jang_et_al_MTL")
    trials = _multi_trials()
    hyper = multitrial.stack_hyperparams(trials, ("3C", "M", "R", "S"),
                                         "cuda")
    step = multitrial.make_multi_eval_step(net, mtl=True)
    Bt = 36
    patches = torch.randn((Bt, 514, 68, 1), generator=gen, device="cuda")
    cls = torch.arange(Bt, device="cuda") % 3
    labels = {"S": (cls == 1).float(), "M": (cls == 0).float(),
              "R": torch.stack([(cls != 1).float(), (cls != 0).float()], -1),
              "3C": torch.nn.functional.one_hot(cls, 3).float()}
    got = {}
    for chain in (False, True):
        state, _ = _multi_setup(net, len(trials), "cuda")
        with _conv_chain() if chain else contextlib.nullcontext():
            with recorded() as rec:
                metrics = step(state, patches, labels, hyper)
        got[chain] = (metrics["loss"], rec["conv_block"],
                      rec["shapes"]["conv_block"])
    (loss_f, n_f, shapes_f), (loss_c, n_c, _) = got[False], got[True]
    n = len(trials)
    check(n_f == {"same": 3, "valid": 0} and not any(n_c.values()),
          f"multi-trial evaluation launches {n_f}, on the chain {n_c}")
    want = {_conv_block_key(n * Bt, C, H, W, "float32", "SAME", n)
            for _, C, H, W in CONV_BLOCK_SHAPES.values()}
    check(shapes_f == want, f"multi-trial evaluation launch shapes "
          f"{sorted(shapes_f)}")
    loss_gap = _rel_err(loss_f, loss_c)
    check(loss_gap <= CONV_BLOCK_RTOL,
          f"multi-trial evaluation losses {loss_f.tolist()} against the "
          f"chain's {loss_c.tolist()}")
    res["multi_trial_eval"] = {
        "launches": n_f, "shapes": sorted(shapes_f),
        "losses": loss_f.tolist(), "loss_rel_gap_vs_chain": loss_gap,
        "losses_bitwise": bool(torch.equal(loss_f, loss_c))}
    return res


def phase_conv_block(card: str, checked: dict) -> dict:
    """Jang's conv block kernel (``ops/conv_block.py``): against its plain
    version at the main path's shapes (which go into
    ``checked["conv_block"]``), then in the Jang models
    (``_conv_block_kernel_checks``, ``_conv_block_model_checks``);
    registers and spills from the ptxas report."""
    from sm_hpss_mtl_tpu_torch.ops import conv_block
    t0 = time.perf_counter()
    conv_block.build()
    return {"card": card, "registers": _conv_block_registers(),
            "kernels": _conv_block_kernel_checks(checked),
            "model": _conv_block_model_checks(),
            "s": time.perf_counter() - t0}


#: phase_ssd_scan: (slots, positions, start state) against the plain
#: version: the stream cell's call (4 x 1500: chunks 5 x 256 + 220), 1-3
#: slots, a whole chunk, a chunk and a bit, and a call shorter than a chunk.
SSD_SHAPES = ((4, 1500, True), (1, 1500, False), (2, 256, True),
              (3, 257, False), (4, 37, True))


def _ssd_inputs(slots: int, L: int, seed: int):
    """The mixer's operands at Granite-4.0-H's widths: x, B and C as rows of
    the conv output (4352 floats), dt in Mamba-2's range, A in [-16, -1],
    D, and a start state."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import ssd_scan
    H, P, N = 64, ssd_scan.HEAD_DIM, ssd_scan.STATE_DIM
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = 0.5 * torch.randn(slots, L, H * P + 2 * N, generator=g,
                             device="cuda")
    x = rows[..., :H * P].view(slots, L, H, P)
    B, C = rows[..., H * P:H * P + N], rows[..., H * P + N:]
    dt = torch.exp(np.log(1e-3) + np.log(100.0) * torch.rand(
        slots, L, H, generator=g, device="cuda"))
    A = -(1 + 15 * torch.rand(H, generator=g, device="cuda"))
    D = 0.5 + torch.rand(H, generator=g, device="cuda")
    state = 0.3 * torch.randn(slots, H, P, N, generator=g, device="cuda")
    return x, dt, A, B, C, D, state


def phase_ssd_scan(card: str, checked: dict) -> dict:
    """The SSD scan kernel (``ops/ssd_scan.py``) against its plain version
    (the recurrence, in float64) at :data:`SSD_SHAPES`, a launch counted at
    each call; then timed at the stream cell's call (CUDA events, profiler
    device time of its two kernels) beside its bound (``benchmark/flops/
    granite_hybrid_mtl.py``'s operations and bytes at the float32 peak and
    HBM) and the plain version's time; registers and spills from the ptxas
    report."""
    import torch
    from benchmark import counts, harness
    from benchmark.flops import granite_hybrid_mtl as gflops
    from sm_hpss_mtl_tpu_torch.ops import ssd_scan
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters
    t0 = time.perf_counter()
    ssd_scan.build()
    out = {"card": card, "shapes": {}}
    for i, (slots, L, start) in enumerate(SSD_SHAPES):
        x, dt, A, B, C, D, state = _ssd_inputs(slots, L, 100 + i)
        state = state if start else None
        before = counters().get("ssd_scan.launches", 0)
        y, s = ssd_scan.ssd_scan(x, dt, A, B, C, D, state)
        torch.cuda.synchronize()
        launches = counters()["ssd_scan.launches"] - before
        want_y, want_s = ssd_scan.ssd_scan_plain(
            *(t.double() for t in (x, dt, A, B, C, D)),
            None if state is None else state.double())
        gap_y = float((y.double() - want_y).abs().max()
                      / want_y.abs().max())
        gap_s = float((s.double() - want_s).abs().max()
                      / want_s.abs().max())
        key = f"{slots}x{L}" + (" from a state" if start else "")
        out["shapes"][key] = {"y_gap_of_max": gap_y, "state_gap_of_max":
                              gap_s, "launches": launches}
        # float32 decays from differences of a cumulative sum over a chunk
        # (down to ~-400): ~3e-5 of the largest output at most.
        check(gap_y < 1e-4 and gap_s < 1e-4 and launches == 1,
              f"ssd_scan {key}: y {gap_y:.2e}, state {gap_s:.2e} of the "
              f"largest, {launches} launches")
        checked.setdefault("ssd_scan", set()).add(key)
    x, dt, A, B, C, D, state = _ssd_inputs(4, 1500, 7)
    fn = lambda: ssd_scan.ssd_scan(x, dt, A, B, C, D, state)  # noqa: E731
    ms, lo, hi = cuda_ms(fn)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    dev = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
              if "ssd_scan" in e.key) / 20 / 1e3
    cfg = harness.read_json(harness.BENCH_DIR / "configs"
                            / "granite_hybrid_mtl.json")
    bound = 1e3 * 4 * counts.bound_s(gflops.scan_bytes(cfg, 1500),
                                     gflops.scan_flops(cfg, 1500), card)
    plain_ms = _host_ms(lambda: ssd_scan.ssd_scan_plain(
        x, dt, A, B, C, D, state), reps=1)
    out["4x1500"] = {"ms": ms, "spread": [lo, hi], "device_ms": dev,
                     "bound_ms": bound, "roofline_pct": 100 * bound / dev
                     if dev else None, "plain_ms": plain_ms}
    log = ssd_scan._nvcc.library_path("ssd_scan.cu")
    out["registers"] = {k: parse_ptxas(Path(str(log) + ".log").read_text(), k)
                        for k in ("ssd_scan_cb", "ssd_scan_chunks")}
    out["s"] = time.perf_counter() - t0
    return out


def _run_of(rec: dict) -> dict:
    """A ``recorded`` block's launches, shapes, per-pair, per-power and halo
    counts, as the phase-12 checks read a path's run."""
    return {k: rec[k] for k in ("launches", "shapes", "by_pair", "by_power",
                                "halo", "tcn", "conv_block")}


def _period_ms(fn, steps: int = 20) -> tuple[float, list]:
    """Median step period of ``fn`` on the card (CUDA events, a call's
    start to the next one's, the first two left out) and its spread."""
    import torch
    marks = []
    for _ in range(steps):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        fn()
    torch.cuda.synchronize()
    times = sorted(marks[i].elapsed_time(marks[i + 1])
                   for i in range(2, steps - 1))
    return times[len(times) // 2], [times[0], times[-1]]


def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronise, warm."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def sharded_frontend_checks(card: str) -> tuple[dict, dict]:
    """``stft_hpss_mel_time_sharded`` (mel and full resolution) over 4 and
    8 shards of the one card on the production leg's audio (2 x 1536
    frames), and ``featuregram_time_sharded`` (``LogMelHarmPercSpec``,
    ``LogHarmPercSpec``) on 2 x 1533 frames (the pad and the tail splice),
    recorded as one path; then each against one unsharded K1 or K2 launch
    on the same audio, outside the record: K1's bar everywhere and 0.02 dB
    on the features, and the max |delta| at every join, frames
    ``[j*T_local - ht, j*T_local + ht)``."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.ops.featuregram import featuregram
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.parallel import (featuregram_time_sharded,
                                                make_mesh,
                                                stft_hpss_mel_time_sharded)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    y = torch.randn((2, 400 + (SHARD_FRAMES - 1) * 160), generator=gen,
                    device="cuda")
    yf = y[:, :400 + (SHARD_FG_FRAMES - 1) * 160]
    M = mel_filterbank(22050, 400, 120, device="cuda")
    feats = ("LogMelHarmPercSpec", "LogHarmPercSpec")
    got = {}
    with recorded() as rec:
        for n in SHARD_COUNTS:
            mesh = make_mesh(n_data=1, n_time=n, devices=[dev] * n)
            for name, basis in (("mel", M), ("fullres", None)):
                got[(n, name)] = stft_hpss_mel_time_sharded(y, basis, mesh)
            for fname in feats:
                got[(n, fname)] = featuregram_time_sharded(
                    yf, mesh, feat_name=fname)
    want_halo = 2 * sum(SHARD_COUNTS)
    check(rec["halo"] == Counter({"K1": want_halo, "K2": want_halo})
          and rec["launches"] == {"K1": want_halo + len(SHARD_COUNTS),
                                  "K2": want_halo + len(SHARD_COUNTS),
                                  "K3": 0, "K4": 0},
          f"sharded front end: launches {rec['launches']}, halo mode "
          f"{dict(rec['halo'])}")
    ht = 21 // 2
    out = {}

    def joins(g, w, n, T):
        Tl = -(-T // n)
        return [max(float((a - b)[..., j * Tl - ht:j * Tl + ht].abs().max())
                    for a, b in zip(g, w)) for j in range(1, n)]

    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11)
    for name, basis in (("mel", M), ("fullres", None)):
        want = frontend.launch(y, basis, **kw)
        for n in SHARD_COUNTS:
            g = got[(n, name)]
            err = compare(f"sharded {name} front end, {n} shards", g, want,
                          RTOL, ATOL)
            out[f"{name}_{n}_shards"] = {
                "max_abs_delta": err,
                "per_join_max_abs_delta": joins(g, want, n, SHARD_FRAMES)}
    for fname in feats:
        want = featuregram(yf, feat_name=fname)
        for n in SHARD_COUNTS:
            g = got[(n, fname)]
            check(g.shape == want.shape, f"{fname} {n} shards: shape")
            db = float((g - want).abs().max())
            check(db <= FEATURE_DB_TOL and bool(torch.isfinite(g).all()),
                  f"{fname} over {n} shards vs unsharded {db:.4f} dB")
            out[f"{fname}_{n}_shards"] = {
                "max_abs_db": db,
                "per_join_max_abs_db": joins((g,), (want,), n,
                                             SHARD_FG_FRAMES)}
    return _run_of(rec), out


def dp_step_checks(corpus: dict, rendezvous: str) -> tuple[dict, dict]:
    """Data parallelism at world size 1 over NCCL (a file rendezvous):
    ``make_dp_train_step`` on a full-width Lemaire-MTL patch step (the
    CPU's patches of one crop batch) and audio step (K1 inside, 48 x 11120
    samples, recorded as a path), each against ``make_train_step`` from
    the same weights on the card, dropout off, held to the patch step's
    bars; then the two steps' periods in turns.  The group is destroyed
    at the end: later phases run single-process."""
    import copy

    import torch
    import torch.distributed as dist
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND
    from sm_hpss_mtl_tpu_torch.parallel import make_dp_train_step
    from sm_hpss_mtl_tpu_torch.train.endtoend import audio_featurizer
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState
    model = "Lemaire_et_al_MTL"
    d = torch.device("cuda", 0)
    audio, labels = next(_crops(corpus, SEED, model))
    net = _seeded(model, dropout=False)
    _, patches = _features_card_vs_cpu(audio, model)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    noise = _bn_fed_biases(net)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}",
                            rank=0, world_size=1)
    out, run = {}, None
    try:
        for kind, batch in (("patch_step", patches), ("audio_step", audio)):
            is_audio = kind == "audio_step"
            a, y = to_device(batch, d), to_device(labels, d)
            single, s_state, s_step, lr = _train_setup("cuda", net, SEED,
                                                       audio=is_audio)
            loss_s = float(s_step(s_state, a, y)["loss"])
            model_ = copy.deepcopy(net).to(d)
            opt, _ = for_model(model, model_.parameters(), tr_steps=100000)
            featurize = (audio_featurizer(
                _feature_config(model), patch_size=68, patch_shift=68,
                max_patches=1, input_kind=INPUT_KIND[model])
                if is_audio else None)
            dp_step = make_dp_train_step(
                model_, opt, mtl=True, l2_reg=0.01, featurize=featurize,
                generator=torch.Generator(device=d).manual_seed(SEED))
            state = TrainState(model_, opt)
            with recorded() as rec:
                loss_d = float(dp_step(state, a, y)["loss"])
            if is_audio:
                check(rec["launches"]["K1"] == 1,
                      f"DP audio step launches {rec['launches']}")
                run = _run_of(rec)
            out[kind] = _hold_step(
                f"DP {kind} at world size 1", before,
                {k: v.detach().cpu() for k, v in single.state_dict().items()},
                {k: v.detach().cpu() for k, v in model_.state_dict().items()},
                loss_s, loss_d, noise, lr, STEP_UPDATE_RTOL)
            turns = {"dp": [], "single": []}
            for name in ("single", "dp", "dp", "single"):
                turns[name].append(_period_ms(
                    (lambda: dp_step(state, a, y)) if name == "dp"
                    else (lambda: s_step(s_state, a, y))))
            out[kind].update({
                "dp_step_ms": sum(t[0] for t in turns["dp"]) / 2,
                "single_step_ms": sum(t[0] for t in turns["single"]) / 2,
                "dp_step_ms_spread": [min(t[1][0] for t in turns["dp"]),
                                      max(t[1][1] for t in turns["dp"])]})
    finally:
        dist.destroy_process_group()
    return run, out


def trial_sharding_checks(corpus: dict) -> dict:
    """``fit_multi`` of four trials (``_multi_trials``: loss weights and lr
    scales, dropout on) on the CPU's patches of one crop batch, over a mesh
    of the card twice (``TRIAL_SHARDS`` shards of two trials) and unsharded:
    each trial's weights and val loss held to the multi-trial step's bars
    against the unsharded run's (one epoch, so each trial's best is its
    last)."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.parallel import make_mesh
    from sm_hpss_mtl_tpu_torch.train.multitrial import (fit_multi,
                                                        init_trials,
                                                        unstack_trial)
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    model = "Lemaire_et_al_MTL"
    d = torch.device("cuda", 0)
    audio, labels = next(_crops(corpus, SEED, model))
    _, patches = _features_card_vs_cpu(audio, model)
    net = _seeded(model)
    trials = _multi_trials()
    x, y = to_device(patches, d), to_device(labels, d)

    def stream():
        while True:
            yield x, y

    def make_opt(ps):
        return for_model(model, ps, 100000, trial_axis=True)[0]

    kw = dict(mtl=True, trials=trials, heads=("3C", "M", "R", "S"),
              epochs=1, steps_per_epoch=4, val_steps=1, l2_reg=0.01,
              base_seed=SEED, verbose=False)
    mesh = make_mesh(devices=[d] * TRIAL_SHARDS)
    t0 = time.perf_counter()
    sharded = fit_multi(net, make_opt, stream(), stream(), mesh=mesh, **kw)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = fit_multi(net, make_opt, stream(), stream(), device=d, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(len(sharded.shards) == TRIAL_SHARDS and all(
        next(iter(st.params.values())).shape[0] == len(trials)
        // TRIAL_SHARDS for st in sharded.shards),
          "trial sharding: the trials were not cut over the mesh")
    before = unstack_trial(init_trials(net, [SEED], make_opt, "cpu"), 0)
    noise = _bn_fed_biases(net)
    held = [_hold_step(
        f"trial sharding, trial {i}", before, unstack_trial(plain.state, i),
        unstack_trial(sharded.state, i), float(plain.best_val_loss[i]),
        float(sharded.best_val_loss[i]), noise, 0.002 * t["lr_scale"],
        STEP_UPDATE_RTOL) for i, t in enumerate(trials)]
    return {"trials": held, "shards": TRIAL_SHARDS,
            "sharded_total_s": sharded_s, "unsharded_total_s": plain_s}


def phase_parallel(card: str, corpus: dict, x600: np.ndarray, wav600: str,
                   weights: str, out, slabbed: dict) -> tuple[dict, dict]:
    """Phase 11: the port's multi-device paths on the one card (a mesh of
    ``cuda:0`` repeated).  Returns the runs of the paths that launch
    kernels and the readings."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    runs, read = {}, {}
    runs["sharded_frontend"], read["sharded_frontend"] = \
        sharded_frontend_checks(card)

    lem = "Lemaire_et_al_MTL"
    dev = torch.device("cuda", 0)
    devs = [dev] * SEGMENT_SHARDS
    runs["segment_sharded"] = seg = serve(lem, wav600, weights,
                                          out("s600.npz"), "cuda", x600,
                                          devices=devs)
    check(seg["halo"] == Counter({"K1": SEGMENT_SHARDS})
          and seg["launches"]["K1"] == SEGMENT_SHARDS + 1,
          f"sharded segmenter launches {seg['launches']}, halo mode "
          f"{dict(seg['halo'])}")
    track = max(float(np.abs(seg["tracks"][k] - slabbed["tracks"][k]).max())
                for k in ("track_S", "track_M"))
    check(track <= TRACK_TOL, f"sharded segmenter tracks vs one device "
                              f"{track:.3e}")
    preset = cli.MODEL_PRESETS[lem]
    sharded = cli._featurize_broadcast(x600, preset, dev, devs)
    single = cli._featurize_broadcast(x600, preset, dev)
    db = float((sharded - single).abs().max())
    check(sharded.shape == single.shape and db <= FEATURE_DB_TOL,
          f"sharded segmenter features vs one device {db:.4f} dB")
    del sharded, single
    read["segment"] = {
        "shards": SEGMENT_SHARDS, "frames": seg["frames"],
        "features_max_abs_db_vs_one_device": db,
        "tracks_max_abs_delta_vs_one_device": track,
        "first_run_total_ms": 1e3 * seg["total_s"],
        "featurize_sharded_ms": _host_ms(
            lambda: cli._featurize_broadcast(x600, preset, dev, devs)),
        "featurize_one_device_ms": _host_ms(
            lambda: cli._featurize_broadcast(x600, preset, dev))}

    runs["dp_audio"], read["dp_world_1"] = dp_step_checks(
        corpus, out("nccl_rendezvous"))
    read["trial_sharding"] = trial_sharding_checks(corpus)
    return runs, read


#: The fold-at-scale tool's smoke run (phase 10b): the corpus and budget.
SCALE_SMOKE = ("--n-music", "4", "--n-speech", "4", "--dur-scale", "0.1",
               "--epochs", "2", "--pipelines", "device")
#: time_op on K1 against cuda_ms of the same launch: a reading outside
#: this ratio would be a gross fault of the timer.
TIME_OP_RATIO = (0.5, 2.0)
#: K1 launches inside the device_trace check and reading.
TRACE_LAUNCHES = 20


def native_checks() -> dict:
    """The native host kernels (``sm_hpss_mtl_tpu_torch/native``) built on
    this host and held to their numpy twins at ``tests/test_native.py``'s
    tolerances (phase 10b)."""
    import scipy.stats
    import torch
    from sm_hpss_mtl_tpu_torch import native
    from sm_hpss_mtl_tpu_torch.data.batcher import scale_frames
    from sm_hpss_mtl_tpu_torch.ops import reference as ref
    from sm_hpss_mtl_tpu_torch.ops import silence
    from sm_hpss_mtl_tpu_torch.ops.patches import (extract_patches_np,
                                                   standardize_rows)
    t0 = time.perf_counter()
    check(native.available(),
          f"the native host kernels did not build:\n{native.build_error()}")
    rng = np.random.default_rng(SEED)
    for T, W, shift in ((500, 68, 68), (40, 68, 68), (300, 249, 24)):
        fv = rng.standard_normal((12, T)).astype(np.float32)
        check(np.array_equal(native.extract_patches(fv, W, shift),
                             extract_patches_np(fv, W, shift)),
              f"native extract_patches T={T} W={W} shift={shift}")
    fv = rng.standard_normal((8, 123)).astype(np.float32)
    fv[3] = 2.5
    d_std = float(np.abs(native.standardize_rows(fv) - standardize_rows(
        torch.from_numpy(fv.astype(np.float64))).numpy()).max())
    check(d_std <= 1e-5, f"native standardize_rows: {d_std:.3e}")
    fv = rng.standard_normal((6, 50)).astype(np.float32)
    mean = rng.standard_normal(6).astype(np.float32)
    stdev = np.abs(rng.standard_normal(6)).astype(np.float32)
    want = scale_frames(fv, mean, stdev)
    d_scale = float(np.abs(native.scale_frames(fv, mean, stdev) - want).max())
    check(np.allclose(native.scale_frames(fv, mean, stdev), want, rtol=1e-5,
                      atol=1e-6), f"native scale_frames: {d_scale:.3e}")
    x = 0.5 * rng.standard_normal(3 * SR).astype(np.float32)
    x[SR // 2:SR] = 1e-5
    x[2 * SR:2 * SR + SR // 2] = 1e-5
    e = ref.rms_energy(x, 400, 160)
    got, want = native.remove_silence(x, e, SR), silence.remove_silence(
        x, e, SR)
    check(all(np.array_equal(got[i], want[i]) for i in range(3))
          and abs(got[3] - want[3]) < 1e-9 and len(got[0]) < len(x),
          "native remove_silence")
    fv = rng.standard_normal((4, 10, 20))
    fns = {"mean": np.mean, "variance": np.var, "skew": scipy.stats.skew,
           "kurtosis": scipy.stats.kurtosis}
    for stat, axis in (("mean", 0), ("variance", 1), ("skew", 0),
                       ("kurtosis", 1)):
        want = np.stack([fns[stat](fv[i], axis=axis) for i in range(4)])
        check(np.allclose(native.patch_statistics(fv, stat, axis), want,
                          rtol=1e-8, atol=1e-10),
              f"native patch_statistics {stat} axis {axis}")
    z = np.zeros((48, 68, 240), np.float32)
    native.add_gaussian_noise(z, 1.0, seed=42)
    moments = {"mean": float(z.mean()), "var": float(z.var()),
               "tail_3_sigma": float((np.abs(z) > 3).mean())}
    check(abs(moments["mean"]) < 5e-3 and abs(moments["var"] - 1) < 5e-3
          and abs(moments["tail_3_sigma"] - 0.0027) < 5e-4,
          f"native add_gaussian_noise moments {moments}")
    return {"library": str(native.LIB_PATH), "standardize_max_abs": d_std,
            "scale_frames_max_abs": d_scale, "noise_moments": moments,
            "s": time.perf_counter() - t0}


def timer_checks(tmp: str) -> dict:
    """``utils.time_op`` on K1 at the training launch beside ``cuda_ms`` of
    the same launch, ``device_trace`` naming K1's kernel, ``stage_timer``'s
    sink (phase 10b)."""
    import glob
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.utils import device_trace, stage_timer, time_op
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, N = TRAIN_SHAPES[0]
    y = torch.randn((B, N), generator=gen, device="cuda")
    M = mel_filterbank(22050, 400, 120, device="cuda")
    sink = {}
    with stage_timer("time_op", sink, verbose=False):
        # The carry takes one element of each launch's output, so every
        # application depends on the one before it.
        op_s = time_op(lambda c: (c[0], c[1] + frontend.stft_hpss_mel(
            c[0], M)[0][0, 0, 0]), (y, torch.zeros((), device="cuda")))
    ev_ms = cuda_ms(lambda: frontend.stft_hpss_mel(y, M), reps=20)
    ratio = 1e3 * op_s / ev_ms[0]
    check(op_s > 0 and TIME_OP_RATIO[0] <= ratio <= TIME_OP_RATIO[1],
          f"time_op on K1 {1e3 * op_s:.4f} ms against cuda_ms "
          f"{ev_ms[0]:.4f} ms")
    rec = sink.get("time_op", {})
    check(set(rec) == {"wall_s", "process_s"} and rec["wall_s"] > 0,
          f"stage_timer's sink: {sink}")
    # device_trace in this process is a reading: here, after the earlier
    # phases' profiler sessions, its trace held no CUDA kernel in four of
    # five runs (PERF.md §7).  The check runs it in a fresh process.
    with device_trace(os.path.join(tmp, "trace_here")) as prof:
        for _ in range(TRACE_LAUNCHES):
            frontend.stft_hpss_mel(y, M)
        torch.cuda.synchronize()
    here_events = sum(ev.count for ev in prof.key_averages()
                      if "frontend_kernel" in ev.key)
    log_dir = os.path.join(tmp, "trace")
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
        "from sm_hpss_mtl_tpu_torch.ops import frontend\n"
        "from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank\n"
        "from sm_hpss_mtl_tpu_torch.utils import device_trace\n"
        f"y = torch.randn({B}, {N}, device='cuda')\n"
        "M = mel_filterbank(22050, 400, 120, device='cuda')\n"
        "frontend.stft_hpss_mel(y, M)\n"
        "torch.cuda.synchronize()\n"
        f"with device_trace({log_dir!r}):\n"
        f"    for _ in range({TRACE_LAUNCHES}):\n"
        "        frontend.stft_hpss_mel(y, M)\n"
        "    torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, "the device_trace process failed:\n"
          + proc.stderr[-3000:])
    files = glob.glob(os.path.join(log_dir, "trace.*.json"))
    check(len(files) == 1, f"device_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    traced = [e["name"] for e in events if e.get("cat") == "kernel"
              and "frontend_kernel" in str(e.get("name", ""))]
    kernels = sorted(set(traced))
    check(bool(kernels), "device_trace's trace names no K1 kernel; event "
          f"categories {dict(Counter(e.get('cat') for e in events))}")
    return {"shape": [B, N], "time_op_ms": 1e3 * op_s, "cuda_ms": ev_ms[0],
            "cuda_ms_spread": ev_ms[1:], "ratio": ratio,
            "stage_timer": rec, "trace_kernels": kernels,
            "trace_k1_launches": TRACE_LAUNCHES,
            "trace_k1_events": len(traced),
            "trace_k1_events_in_this_process": here_events}


def scale_tool_check(card: str, tmp: str, checked: dict) -> dict:
    """``tools/scale_rehearsal_torch.py`` end to end on the card at smoke
    size in a child process: per-epoch rows, the steps of
    ``with_steps_from_durations`` on its folds, K1 launched; K1 then held
    against its plain version at each launch shape of the child that
    phase 3 did not check (phase 10b)."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.folds import load_cv_folds
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
    here = os.path.dirname(os.path.abspath(__file__))
    root, out = os.path.join(tmp, "scale_corpus"), os.path.join(tmp,
                                                                "scale.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "tools",
                                      "scale_rehearsal_torch.py"),
         *SCALE_SMOKE, "--root", root, "--out", out, "--poll-s", "1"],
        cwd=here, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "the scale tool failed:\n"
          + (proc.stdout + proc.stderr)[-4000:])
    with open(out) as f:
        row = json.load(f)["pipelines"]["device"]
    check(row["status"] == "finished" and row["epochs_run"] == 2
          and len(row["epochs"]) == 2
          and [r["epoch"] for r in row["epochs"]] == [0.0, 1.0],
          f"the scale tool's epochs: {row.get('epochs')}")
    cv = load_cv_folds(os.path.join(root, "cv_info"))
    want = ExperimentConfig(batch_size=16, patch_size=68, patch_shift=68
                            ).with_steps_from_durations(
        {k: v for k, v in cv["total_duration"].items()
         if k in ("music", "speech", "speech+music")})
    got = (row["tr_steps"], row["v_steps"], row["ts_steps"])
    check(got == (want.tr_steps, want.v_steps, want.ts_steps),
          f"the scale tool's steps {got}")
    check(row["k1_launches"] > 0, "the scale tool launched no K1")
    check(row["device"] == card, f"the scale tool's card {row['device']}")
    check(set(row["stages"]) == {"corpus", "folds", "fit", "test"},
          f"the scale tool's stages {row['stages']}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {tuple(s) for s in row["k1_shapes"]}
    new = sorted(shapes - checked["K1"])
    err = 0.0
    for n_fft, lh, lp, B, T in new:
        y = torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                        device="cuda")
        M = mel_filterbank(22050, n_fft, 120, device="cuda")
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        err = max(err, compare(
            f"K1 (scale tool) n_fft={n_fft} B={B} T={T}",
            frontend.launch(y, M, **kw),
            frontend.stft_hpss_mel_plain(y, M, **kw), RTOL, ATOL))
        checked["K1"].add((n_fft, lh, lp, B, T))
    return {"argv": list(SCALE_SMOKE), "wall_s": wall,
            "k1_launches": row["k1_launches"],
            "k1_shapes": row["k1_shapes"], "k1_shapes_checked_here": new,
            "k1_max_abs_delta_here": err,
            **{k: row[k] for k in ("tr_steps", "v_steps", "ts_steps",
                                   "epochs_run", "warm_step_ms", "accuracy",
                                   "stages")}}


def build_all() -> tuple[float, list[str]]:
    """Compile every CUDA source for every median pair at once, one nvcc
    process each (``ops/_nvcc.py``: one library per source, pair and DFT
    precision), with phase_modes' libraries; load the libraries.  Returns
    the wall time and the ptxas reports."""
    from sm_hpss_mtl_tpu_torch.ops import (_nvcc, conv_block, frontend, hpss,
                                           tcn_block)
    from sm_hpss_mtl_tpu_torch.ops.hpss import KERNEL_MEDIANS
    jobs = [(src, pair) for src in ("frontend.cu", "hpss.cu")
            for pair in KERNEL_MEDIANS]
    jobs += [("tcn_block.cu",), ("conv_block.cu",)]
    # phase_modes' libraries: K1/K2 in bf16x3 and the pairs outside
    # KERNEL_MEDIANS, built with the rest (the powers are arguments).
    jobs += [("frontend.cu", (21, 11), "bf16x3")]
    jobs += [(src, pair) for pair in MODE_PAIRS
             for src in ("frontend.cu", "hpss.cu")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda job: _nvcc.build(*job), jobs))
    frontend.build()
    hpss.build()
    tcn_block.build()
    conv_block.build()
    logs = [f"{lib.name}:\n" + lib.with_suffix(".so.log").read_text().strip()
            for lib in libs if lib.with_suffix(".so.log").exists()]
    return time.perf_counter() - t0, logs


def _shapes_checked(tag: str, shapes: dict, checked: dict) -> None:
    """Fail unless every kernel launch shape in ``shapes`` was checked
    against its plain version in phase 3; a TCN block kernel's shape that
    phase 3 did not check is held to its plain version here
    (``_hold_tcn_shapes``)."""
    _hold_tcn_shapes(shapes.get("tcn", set()), checked)
    _hold_conv_block_shapes(shapes.get("conv_block", set()), checked)
    unchecked = {k: sorted(v - checked[k]) for k, v in shapes.items()
                 if v - checked[k]}
    check(not unchecked, f"{tag}: launch shapes phase 3 did not check: "
                         f"{unchecked}")


def run() -> None:
    import torch
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1 card] {card}", flush=True)

    build_s, logs = build_all()
    print(f"[2 build] {build_s:.2f} s", flush=True)
    for log in logs:
        print(log, flush=True)

    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.data.audio import load_and_preprocess_signal
    from sm_hpss_mtl_tpu_torch.data.featurize import bucket_length
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return os.path.join(tmp, name)

        # The evaluation's inputs come first: phase 3 checks each kernel at
        # the shapes they give it.
        wav60, x60 = write_broadcast(tmp, "b60.wav", 60.0, SEED)
        wav600, x600 = write_broadcast(tmp, "b600.wav", 600.0, SEED + 1)
        wav10, x10 = write_broadcast(tmp, "b10.wav", 10.0, SEED + 2)
        corpus = make_eval_corpus(out("corpus"))
        train_corpus = make_train_corpus(out("train_corpus"))
        lem_frames = eval_item_frames(corpus, 400, sweep=True)
        jang_frames = eval_item_frames(corpus, 512, sweep=False)
        pap_frames = eval_item_frames(corpus, 400, sweep=False)
        five_frames = eval_item_frames(corpus, 400, sweep=False,
                                       test="test5")
        late_frames = eval_item_frames(corpus, 400, sweep=False,
                                       bucketed=True)
        n60 = len(load_and_preprocess_signal(wav60)[0])
        mp3 = make_mp3(tmp, x10)
        if not mp3["available"]:
            print(json.dumps({"mp3": mp3}), flush=True)
        short = Counter(T for T in lem_frames if T < SHORT_FRAMES)
        check(short and any(T < SHORT_FRAMES for T in jang_frames),
              "the evaluation corpus has no short item")
        served_400 = {n_frames(bucket_length(len(x)), 400, 160)
                      for x in (x60, x10)}
        eval_frames = {
            "K1": {T for T in lem_frames + five_frames if T >= SHORT_FRAMES}
            | {n_frames(bucket_length(n60), 400, 160)}
            | set(late_frames) | train_corpus["frames"][400],
            "K2": {T for T in jang_frames if T >= SHORT_FRAMES}
            | train_corpus["frames"][512],
            "K2_400": {T for T in pap_frames if T >= SHORT_FRAMES}
            | served_400 | train_corpus["frames"][400],
            "K4_T": short.most_common(1)[0][0],
            "K3_T": Counter(T for T in jang_frames
                            if T < SHORT_FRAMES).most_common(1)[0][0]}
        if mp3["available"]:            # the mp3 phase serves the decoded
            eval_frames["K1"].add(n_frames(bucket_length(mp3["samples"]),
                                           400, 160))

        entries, checked = phase_kernels(card, eval_frames)
        print("[3 kernels] ok; " + "; ".join(
            f"{e['name']} {e['ms']:.4f} ms [{e['ms_spread'][0]:.4f}, "
            f"{e['ms_spread'][1]:.4f}] at {e['timed_shape']}"
            for e in entries), flush=True)
        _, halo_records = phase_halo(card, checked)
        print("[3 halo] ok; " + "; ".join(
            f"{e['name']} {e['ms']:.4f} ms, device {e['device_ms']} ms at "
            f"{e['timed_shape']} (without halo on the same audio "
            f"{e['device_ms_same_audio_without_halo']} ms)"
            for e in halo_records), flush=True)
        t_pairs = time.perf_counter()
        pair_entries = phase_pairs(card, checked, train_corpus)
        print(f"[3 pairs] ok, {time.perf_counter() - t_pairs:.1f} s",
              flush=True)
        mode_records, power_records, mode_pairs, modes = phase_modes(
            card, checked, train_corpus, x600, out)
        for k, recs in mode_pairs.items():
            pair_entries[k].extend(recs)
        print(f"[3 modes] ok, {modes['s']:.1f} s; bf16x3 main path "
              + ", ".join(f"{m} {v['launches_by_precision']}"
                          for m, v in modes["main_path"].items())
              + "; audio step card vs CPU at bf16x3: update "
              f"{modes['audio_step_bf16x3_card_vs_cpu']['update_rel_max']:.2e}"
              f" of its norm; 10-minute features at bf16x3 vs plain "
              f"'highest' {modes['features_600s_max_abs_db']['highest']:.4f}"
              " dB", flush=True)

        tcn = phase_tcn_block(card, checked)
        print("[3 tcn_block] ok, {:.1f} s; ".format(tcn["s"]) + "; ".join(
            f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, chain "
            f"{v['plain_ms']:.4f})" for k, v in
            tcn["kernels"]["eval float32 10000x32x68"].items()
            if isinstance(v, dict)), flush=True)
        print(json.dumps({"tcn_block": tcn}, default=str), flush=True)

        cb = phase_conv_block(card, checked)
        print("[3 conv_block] ok, {:.1f} s; ".format(cb["s"]) + "; ".join(
            f"{k} {v['device_ms']} ms device (bound {v['bound_ms']:.4f}, "
            f"chain {v['library_ms']:.4f}, bit for bit {v['bitwise']})"
            for k, v in cb["kernels"].items() if "float32 SAME" in k)
            + "; " + "; ".join(f"{k} call {v['fused_ms']:.2f} ms (chain "
                               f"{v['chain_ms']:.2f})"
                               for k, v in cb["model"].items()
                               if "fused_ms" in v), flush=True)
        print(json.dumps({"conv_block": cb}, default=str), flush=True)

        ssd = phase_ssd_scan(card, checked)
        print("[3 ssd_scan] ok, {:.1f} s; 4x1500 {:.3f} ms, device {:.3f} "
              "(bound {:.3f}); ".format(ssd["s"], ssd["4x1500"]["ms"],
                                        ssd["4x1500"]["device_ms"],
                                        ssd["4x1500"]["bound_ms"])
              + ", ".join(f"{k} {v['y_gap_of_max']:.1e}"
                          for k, v in ssd["shapes"].items()), flush=True)
        print(json.dumps({"ssd_scan": ssd}, default=str), flush=True)

        wpath = {}
        for model in ("Lemaire_et_al_MTL", "Jang_et_al_MTL",
                      "Papakostas_et_al_MTL", CASCADED, FIVE, IF):
            wpath[model] = out(f"{model}.npz")
            net = init_weights(get_model(model),
                               torch.Generator().manual_seed(SEED))
            weights.save_npz(wpath[model], weights.to_flax(net.state_dict()))
            del net
        late_ckpts = late_fusion_checkpoints(out("late"))

        lem = "Lemaire_et_al_MTL"
        runs["lemaire_60"] = whole = serve(lem, wav60, wpath[lem],
                                           out("g60.npz"), "cuda", x60)
        check(whole["launches"]["K1"] > 0, "whole-signal run launched no K1")
        ref = serve(lem, wav60, wpath[lem], out("c60.npz"), "cpu", x60)
        for k in ("track_S", "track_M"):
            d = np.abs(whole["tracks"][k] - ref["tracks"][k]).max()
            check(d <= TRACK_TOL, f"{k}: GPU vs CPU max |delta| {d:.3e}")
        print(f"[4 whole] {whole['frames']} frames, "
              f"{whole['launches']['K1']} K1 launches, tracks match the CPU "
              "run", flush=True)

        runs["lemaire_600"] = slabbed = serve(lem, wav600, wpath[lem],
                                              out("g600.npz"), "cuda", x600)
        check(slabbed["launches"]["K1"] > 0, "slabbed run launched no K1")
        print(f"[5 slabbed] {slabbed['frames']} frames, "
              f"{slabbed['launches']['K1']} K1 launches", flush=True)

        db = phase_features(lem, x600)
        check(db <= FEATURE_DB_TOL, f"features differ by {db:.4f} dB")
        print(f"[6 features] kernel vs plain max |delta| {db:.5f} dB",
              flush=True)

        # Whisper-MTL's front end: K1 at 128 bands in the slabs of a
        # 20-minute broadcast, its launches tallied from the counters.
        x1200 = synth_broadcast(WHISPER_SECONDS, SEED + 3)
        with recorded() as wrec:
            wdb = phase_features(WHISPER, x1200)
        runs["whisper_1200"] = wrec
        T1200 = n_frames(len(x1200), 400, 160)
        slabs = -(-T1200 // 16384)
        check(wdb <= FEATURE_DB_TOL,
              f"Whisper-MTL features differ by {wdb:.4f} dB")
        check(wrec["launches"] == {"K1": slabs, "K2": 0, "K3": 0, "K4": 0},
              f"Whisper-MTL features: launches {wrec['launches']}, want "
              f"{slabs} of K1")
        check({key[-1] for key in wrec["shapes"]["K1"]}
              == set(WHISPER_SLAB_FRAMES),
              f"Whisper-MTL slabs {sorted(wrec['shapes']['K1'])}")
        check(wrec["by_pair"]["K1"] == {"21,11": slabs}
              and wrec["by_power"]["K1"] == {2.0: slabs},
              "Whisper-MTL's K1 launches per pair or power")
        print(f"[6 whisper features] {T1200} frames at {WHISPER_MELS} "
              f"bands, {slabs} K1 launches at "
              f"{sorted(wrec['shapes']['K1'])}, kernel vs plain max "
              f"|delta| {wdb:.5f} dB", flush=True)

        jang = "Jang_et_al_MTL"
        jw = wpath[jang]
        runs["jang_60"] = j60 = serve(jang, wav60, jw, out("j60.npz"), "cuda",
                                      x60)
        runs["jang_600"] = j600 = serve(jang, wav600, jw, out("j600.npz"),
                                        "cuda", x600)
        runs["jang_10"] = j10 = serve(jang, wav10, jw, out("j10.npz"), "cuda",
                                      x10)
        j10_cpu = serve(jang, wav10, jw, out("c10.npz"), "cpu", x10)
        for r in (j60, j600, j10):
            check(r["launches"]["K2"] > 0, "a Jang run launched no K2")
        jang_track = max(
            float(np.abs(j10["tracks"][k] - j10_cpu["tracks"][k]).max())
            for k in ("track_S", "track_M"))
        check(jang_track <= TRACK_TOL,
              f"Jang tracks: GPU vs CPU max |delta| {jang_track:.3e}")
        jang_db = phase_features(jang, x600)
        check(jang_db <= FEATURE_DB_TOL,
              f"Jang features differ by {jang_db:.4f} dB")
        print(f"[7 jang] {j60['frames']} + {j600['frames']} + "
              f"{j10['frames']} frames, K2 launches "
              f"{j60['launches']['K2']} + {j600['launches']['K2']} + "
              f"{j10['launches']['K2']}; 10 s tracks vs CPU max |delta| "
              f"{jang_track:.3e} (CPU run {j10_cpu['total_s']:.1f} s); "
              f"10 min features vs plain {jang_db:.5f} dB", flush=True)
        pap = "Papakostas_et_al_MTL"
        pw = wpath[pap]
        runs["pap_60"] = p60 = serve(pap, wav60, pw, out("p60.npz"), "cuda",
                                     x60)
        runs["pap_10"] = p10 = serve(pap, wav10, pw, out("p10.npz"), "cuda",
                                     x10)
        p10_cpu = serve(pap, wav10, pw, out("q10.npz"), "cpu", x10)
        for r in (p60, p10):
            check(r["launches"]["K2"] == 1,
                  f"a Papakostas run launched K2 {r['launches']['K2']} times")
        pap_track = max(
            float(np.abs(p10["tracks"][k] - p10_cpu["tracks"][k]).max())
            for k in ("track_S", "track_M"))
        check(pap_track <= TRACK_TOL,
              f"Papakostas tracks: GPU vs CPU max |delta| {pap_track:.3e}")
        p60_warm = serve(pap, wav60, pw, out("p60w.npz"), "cuda", x60)
        print(f"[7 papakostas] {p60['frames']} + {p10['frames']} frames, one "
              f"K2 launch each; 10 s tracks vs CPU max |delta| "
              f"{pap_track:.3e} (CPU run {p10_cpu['total_s']:.1f} s); 60 s "
              f"warm {p60_warm['total_s']:.3f} s", flush=True)
        variants_serving = {}
        for model, tag in ((CASCADED, "cascaded"), (FIVE, "five")):
            runs[f"{tag}_60"] = g = serve(model, wav60, wpath[model],
                                          out(f"{tag}_g60.npz"), "cuda", x60)
            c = serve(model, wav60, wpath[model], out(f"{tag}_c60.npz"),
                      "cpu", x60)
            check(g["launches"]["K1"] > 0 and not any(
                g["launches"][k] for k in ("K2", "K3", "K4")),
                  f"{model} serving launches {g['launches']}")
            d = max(float(np.abs(g["tracks"][k] - c["tracks"][k]).max())
                    for k in ("track_S", "track_M"))
            check(d <= TRACK_TOL, f"{model} tracks: GPU vs CPU max |delta| "
                                  f"{d:.3e}")
            if model == FIVE:
                check(g["tracks"]["track_N"].shape[1] == 1
                      and g["tracks"]["track_3C"].shape[1] == 5,
                      "5-class tracks")
            variants_serving[model] = {
                "first_run_60s_total_ms": 1e3 * g["total_s"],
                "cpu_60s_total_ms": 1e3 * c["total_s"],
                "launches": g["launches"],
                "track_max_abs_delta_vs_cpu": d}
        print("[7 variants] 60 s, " + "; ".join(
            f"{m}: launches {v['launches']}, tracks vs CPU max |delta| "
            f"{v['track_max_abs_delta_vs_cpu']:.3e}"
            for m, v in variants_serving.items()), flush=True)

        runs["resynth_60"] = rs = resynth(wav60, out("rg"), "cuda")
        check(rs["launches"]["K3"] > 0, "resynthesis launched no K3")
        rs_cpu = resynth(wav60, out("rc"), "cpu")
        rs_delta = max(resynth_delta(rs[k], rs_cpu[k]) for k in ("yh", "yp"))
        check(rs_delta <= RESYNTH_TOL,
              f"resynthesis GPU vs CPU {rs_delta:.3e} of the peak")
        rs_warm = resynth(wav60, out("rw"), "cuda")
        print(f"[8 resynth] {rs['launches']['K3']} K3 launches, GPU vs CPU "
              f"{rs_delta:.3e} of the peak", flush=True)

        lem_eval = evaluate(lem, corpus, wpath[lem], "cuda", sweep=True)
        runs["eval_lemaire"] = lem_eval
        lem_eval_cpu = evaluate(lem, corpus, wpath[lem], "cpu", sweep=True)
        n_short = sum(T < SHORT_FRAMES for T in lem_eval["frames"])
        check(lem_eval["launches"]["K4"] == n_short,
              f"K4 launched {lem_eval['launches']['K4']} times for "
              f"{n_short} items under {SHORT_FRAMES} frames")
        check(lem_eval["launches"]["K1"]
              == len(lem_eval["frames"]) - n_short,
              "K1 did not launch once per item of 20 frames or more")
        eval_delta, ties = same_labels("test_model", lem_eval["result"],
                                       lem_eval_cpu["result"])
        for level in SMR_LEVELS:
            d, t = same_labels(f"sweep {level} dB", lem_eval["sweep"][level],
                               lem_eval_cpu["sweep"][level])
            eval_delta, ties = max(eval_delta, d), ties + t
        for tie in ties:
            print(f"near-tie, label differs: {tie}", flush=True)
        runs["classify_60"] = clf = classify(wav60, wpath[lem], "cuda")
        clf_cpu = classify(wav60, wpath[lem], "cpu")
        clf_delta = float(np.abs(clf["out"]["probabilities"]
                                 - clf_cpu["out"]["probabilities"]).max())
        check(clf_delta <= TRACK_TOL,
              f"Classifier GPU vs CPU max |delta| {clf_delta:.3e}")
        runs["eval_jang"] = jang_eval = evaluate(jang, corpus, jw, "cuda",
                                                 sweep=False)
        j_short = sum(T < SHORT_FRAMES for T in jang_eval["frames"])
        check(jang_eval["launches"]["K3"] == j_short
              and jang_eval["launches"]["K2"] == len(jang_eval["frames"])
              - j_short, f"Jang evaluation launches {jang_eval['launches']}"
                         f" for {j_short} short of "
                         f"{len(jang_eval['frames'])} items")
        runs["eval_papakostas"] = pap_eval = evaluate(pap, corpus, pw,
                                                      "cuda", sweep=False)
        p_short = sum(T < SHORT_FRAMES for T in pap_eval["frames"])
        check(pap_eval["launches"] == {
            "K1": 0, "K2": len(pap_eval["frames"]) - p_short, "K3": p_short,
            "K4": 0}, f"Papakostas evaluation launches "
                      f"{pap_eval['launches']} for {p_short} short of "
                      f"{len(pap_eval['frames'])} items")
        variants_eval, variant_ties = {}, []
        for model, tag in ((FIVE, "eval_five"), (IF, "eval_if")):
            runs[tag] = r = evaluate(model, corpus, wpath[model], "cuda",
                                     sweep=False)
            c = evaluate(model, corpus, wpath[model], "cpu", sweep=False)
            short_n = sum(T < SHORT_FRAMES for T in r["frames"])
            check(r["launches"] == {"K1": len(r["frames"]) - short_n,
                                    "K2": 0, "K3": 0, "K4": short_n},
                  f"{model} evaluation launches {r['launches']} for "
                  f"{short_n} short of {len(r['frames'])} items")
            d, t = same_labels(f"{model} test_model", r["result"],
                               c["result"])
            variant_ties += t
            variants_eval[model] = {
                "items": len(r["frames"]), "short_items": short_n,
                "audio_s": r["samples"] / SR,
                "test_model_ms": 1e3 * r["test_model_s"],
                "cpu_test_model_ms": 1e3 * c["test_model_s"],
                "featurize_ms": 1e3 * r["featurize_s"],
                "launches": r["launches"],
                "conf_mat_shape": list(r["result"]["ConfMat"].shape),
                "predictions_max_abs_delta_vs_cpu": d}
        runs["fuse_late"] = fl = fuse_late(corpus, late_ckpts, out("fl_g"),
                                           "cuda")
        fl_cpu = fuse_late(corpus, late_ckpts, out("fl_c"), "cpu")
        check(fl["launches"] == {"K1": 2 * fl["items"], "K2": 0, "K3": 0,
                                 "K4": 0},
              f"fuse_late launches {fl['launches']} for {fl['items']} "
              "items in two legs")
        d, t = same_labels("fuse_late", fl["result"], fl_cpu["result"])
        variant_ties += t
        variants_eval["late_fusion"] = {
            "items": fl["items"], "total_ms": 1e3 * fl["total_s"],
            "cpu_total_ms": 1e3 * fl_cpu["total_s"],
            "launches": fl["launches"],
            "predictions_max_abs_delta_vs_cpu": d}
        for tie in variant_ties:
            print(f"near-tie, label differs: {tie}", flush=True)
        print("[9 variants] " + "; ".join(
            f"{m}: launches {v['launches']}, predictions vs CPU max |delta| "
            f"{v['predictions_max_abs_delta_vs_cpu']:.3e}"
            for m, v in variants_eval.items())
            + f"; {len(variant_ties)} near-ties", flush=True)
        print(f"[9 evaluation] Lemaire {len(lem_eval['frames'])} items "
              f"({n_short} under {SHORT_FRAMES} frames), launches "
              f"{lem_eval['launches']}; predictions GPU vs CPU max |delta| "
              f"{eval_delta:.3e}, {len(ties)} near-ties; classifier 60 s "
              f"{clf_delta:.3e}; Jang {len(jang_eval['frames'])} items, "
              f"launches {jang_eval['launches']}; Papakostas "
              f"{len(pap_eval['frames'])} items, launches "
              f"{pap_eval['launches']}", flush=True)

        runs["train_device"] = tdev = train_cli(train_corpus, out("td"),
                                                "device")
        runs["train_host"] = thost = train_cli(train_corpus, out("th"),
                                               "host")
        runs["train_lemaire_fls"] = tfls = train_cli(
            train_corpus, out("tf"), "device",
            extra=("--frame-level-scaling",))
        step_checks = train_step_checks(train_corpus)
        step_times = time_device_steps(train_corpus)
        image = {}
        for model in IMAGE_MTL:
            image[model] = {"device_pipeline": train_cli(
                train_corpus, out(f"t_{model}_d"), "device", model=model)}
        runs["train_jang_device"] = image["Jang_et_al_MTL"]["device_pipeline"]
        runs["train_jang_host"] = image["Jang_et_al_MTL"]["host_pipeline"] = \
            train_cli(train_corpus, out("t_jang_h"), "host",
                      model="Jang_et_al_MTL")
        runs["train_papakostas"] = image[pap]["device_pipeline"]
        runs["train_doukhan"] = image["Doukhan_et_al_MTL"]["device_pipeline"]
        for model in BASELINES:
            runs[f"train_{model}"] = train_cli(
                train_corpus, out(f"t_{model}"), "device", model=model,
                epochs=1)
            image[model] = {"device_pipeline": runs[f"train_{model}"]}
        image_checks = image_step_checks(train_corpus)
        jang_times = time_device_steps(train_corpus, "Jang_et_al_MTL")
        make_five_class_folds(train_corpus)
        variants = {model: {"device_pipeline": train_cli(
            train_corpus, out(f"t_{model}_d"), "device", model=model)}
            for model in (CASCADED, FIVE, IF)}
        variants[IF]["host_pipeline"] = train_cli(
            train_corpus, out("t_if_h"), "host", model=IF)
        runs["train_cascaded"] = variants[CASCADED]["device_pipeline"]
        runs["train_five"] = variants[FIVE]["device_pipeline"]
        runs["train_if_device"] = variants[IF]["device_pipeline"]
        runs["train_if_host"] = variants[IF]["host_pipeline"]
        variant_checks = variant_step_checks(train_corpus)
        for model in (IF, FIVE):
            variants[model]["device_steps"] = time_device_steps(train_corpus,
                                                                model)
        if_step = variant_checks[IF]["audio_step"]
        five_step = variant_checks[FIVE]["patch_step"]
        print("[10 variants] " + "; ".join(
            f"{m}: " + ", ".join(f"{p} {r['launches']} val loss "
                                 f"{r['val_loss']}" for p, r in v.items()
                                 if p != "device_steps")
            for m, v in variants.items())
            + f"; fusion one step card vs CPU on the same patches: updates "
              f"{variant_checks[IF]['patch_step']['update_rel_max']:.2e};"
              f" with K1 inside: loss "
              f"{if_step['loss_rel']:.2e}, updates "
              f"{if_step['update_rel_max']:.2e}, statistics "
              f"{if_step['stats_err_max']:.2e}; 20 steps "
              f"{variant_checks[IF]['fixed_batch_losses'][0]:.4f} -> "
              f"{variant_checks[IF]['fixed_batch_losses'][-1]:.4f}; 5-class "
              f"patch step loss {five_step['loss_rel']:.2e}, updates "
              f"{five_step['update_rel_max']:.2e}; steps "
              f"{variants[IF]['device_steps']['step_ms']:.3f} ms (fusion), "
              f"{variants[FIVE]['device_steps']['step_ms']:.3f} ms "
              "(5-class)", flush=True)
        jang_step = image_checks["Jang_et_al_MTL"]["audio_step"]
        pap_step = image_checks[pap]["patch_step"]
        print("[10 image training] " + "; ".join(
            f"{m}: " + ", ".join(f"{p} {r['launches']} val loss "
                                 f"{r['val_loss']}" for p, r in v.items())
            for m, v in image.items())
            + f"; Jang one step card vs CPU (K2 inside): loss "
              f"{jang_step['loss_rel']:.2e}, updates "
              f"{jang_step['update_rel_max']:.2e}; Papakostas patch step "
              f"updates {pap_step['update_rel_max']:.2e}; Jang step "
              f"{jang_times['step_ms']:.3f} ms", flush=True)
        print(f"[10 training] device pipeline {tdev['launches']['K1']} K1 "
              f"launches, epochs {tdev['epoch_train_s']} s; host pipeline "
              f"{thost['launches']['K1']} K1 launches, epochs "
              f"{thost['epoch_train_s']} s; one step card vs CPU, on the "
              f"same patches: loss "
              f"{step_checks['patch_step']['loss_rel']:.2e}, updates "
              f"{step_checks['patch_step']['update_rel_max']:.2e}, "
              f"statistics {step_checks['patch_step']['stats_err_max']:.2e};"
              f" with K1 inside: loss "
              f"{step_checks['audio_step']['loss_rel']:.2e}, updates "
              f"{step_checks['audio_step']['update_rel_max']:.2e} (features "
              f"{step_checks['features_max_abs_delta']:.2e}); 20 steps "
              f"{step_checks['fixed_batch_losses'][0]:.4f} -> "
              f"{step_checks['fixed_batch_losses'][-1]:.4f}; step "
              f"{step_times['step_ms']:.3f} ms", flush=True)

        bf16 = bf16_step_checks(train_corpus)
        _shapes_checked("bf16 steps", bf16["shapes"], checked)
        bf16_times = {}
        with recorded() as rec:
            for model in BF16_STEP_MODELS:
                times = bf16_times[model] = {"f32": [], "bf16": []}
                for tag in ("f32", "bf16", "bf16", "f32"):
                    times[tag].append(time_device_steps(
                        train_corpus, model,
                        dtype=torch.bfloat16 if tag == "bf16" else None))
        _shapes_checked("bf16 step times", rec["shapes"], checked)
        runs["train_bf16"] = tb16 = train_cli(train_corpus, out("t_bf16"),
                                              "device", extra=("--bf16",))
        ckpt = os.path.join(tb16["op_dir"], "fold0_ckpt")
        runs["lemaire_60_ckpt"] = g = serve(lem, wav60, ckpt,
                                            out("k60.npz"), "cuda", x60,
                                            source="--ckpt")
        c = serve(lem, wav60, ckpt, out("k60c.npz"), "cpu", x60,
                  source="--ckpt")
        ckpt_delta = max(float(np.abs(g["tracks"][k] - c["tracks"][k]).max())
                         for k in ("track_S", "track_M"))
        check(g["launches"]["K1"] == 1 and ckpt_delta <= TRACK_TOL,
              f"--ckpt serving: launches {g['launches']}, tracks vs CPU "
              f"{ckpt_delta:.3e}")
        ckpt_serving = {"first_run_60s_total_ms": 1e3 * g["total_s"],
                        "cpu_60s_total_ms": 1e3 * c["total_s"],
                        "track_max_abs_delta_vs_cpu": ckpt_delta}
        def bf16_brief(m: str, r: dict) -> str:
            def worst(tag, key, pick=max):
                return pick(x[key] for x in r[tag])

            patch = "patch_card_bf16_vs_cpu_bf16"
            share = max(worst(t, "update_bar_share_max") for t in r
                        if t.startswith(("patch_", "audio_")))
            return (
                f"{m}: patch step card vs CPU bf16 loss "
                f"{worst(patch, 'loss_rel'):.2e}, updates "
                f"{worst(patch, 'update_rel_max'):.2e}, cosine >= "
                f"{worst(patch, 'cosine_min', min):.4f}"
                f"; audio step card bf16 vs f32 updates "
                f"{worst('audio_card_bf16_vs_card_f32', 'update_rel_max'):.2e}"
                f", vs CPU bf16 "
                f"{worst('audio_card_bf16_vs_cpu_bf16', 'update_rel_max'):.2e}"
                f" ({BF16_STEP_REPEATS} repeats, every update at most "
                f"{share:.2f} of its bar); CPU bf16 vs f32 "
                f"{r['cpu_bf16_vs_cpu_f32']['update_rel_max']:.2e}; step "
                f"f32 {[round(t['step_ms'], 3) for t in bf16_times[m]['f32']]}"
                f" ms, bf16 "
                f"{[round(t['step_ms'], 3) for t in bf16_times[m]['bf16']]}")

        print("[10 bf16] " + "; ".join(
            bf16_brief(m, r) for m, r in bf16["models"].items())
            + f"; --bf16 fold K1 {tb16['launches']['K1']}, val loss "
              f"{tb16['val_loss']}; --ckpt 60 s tracks vs CPU "
              f"{ckpt_delta:.3e}", flush=True)
        runs["scopes_60"] = scopes = scope_checks(wav60, wpath[lem])
        print("[10 scopes] " + "; ".join(
            f"{k}: tracks vs CPU {scopes[k]['track_max_abs_delta_vs_cpu']:.3e}"
            for k in ("featuregram", "none")), flush=True)
        if mp3["available"]:
            runs["mp3_10"] = m3 = serve(lem, mp3["path"], wpath[lem],
                                        out("m10.npz"), "cuda", mp3["x"])
            m3c = serve(lem, mp3["path"], wpath[lem], out("m10c.npz"), "cpu",
                        mp3["x"])
            mp3["track_max_abs_delta_vs_cpu"] = d = max(
                float(np.abs(m3["tracks"][k] - m3c["tracks"][k]).max())
                for k in ("track_S", "track_M"))
            check(m3["launches"]["K1"] == 1 and d <= TRACK_TOL,
                  f"mp3 serving: launches {m3['launches']}, tracks vs CPU "
                  f"{d:.3e}")
            mp3["total_ms"] = 1e3 * m3["total_s"]
            print(f"[10 mp3] decoded {mp3['samples']} samples (correlation "
                  f"{mp3['correlation']:.4f}), served, tracks vs CPU "
                  f"{d:.3e}", flush=True)
        for key in ("x", "path"):
            mp3.pop(key, None)

        tuning = {}
        for name, argv, n_rows in TUNE_RUNS:
            runs[name] = tuning[name] = tune_cli(train_corpus, out(name),
                                                 name, argv, n_rows)
        multi = multi_step_checks(train_corpus)
        multi_times = time_multi_steps(train_corpus)
        feat = featurize_checks(train_corpus, out("featurize"))
        runs["featurize"] = feat["card"]
        runs["tsne"] = tsne_run = tsne_checks(train_corpus)
        print("[10 tuning] " + "; ".join(
            f"{n}: {len(tuning[n]['rows'])} rows, K1 "
            f"{tuning[n]['launches']['K1']}, {tuning[n]['total_s']:.1f} s"
            for n, _, _ in TUNE_RUNS)
            + "; K1 per pair " + ", ".join(
                f"({k}) {v}" for n in ("tune_l_harm", "tune_l_perc")
                for k, v in tuning[n]["k1_launches_per_pair"].items())
            + f"; 4-trial step card vs CPU: losses "
              f"{max(t['loss_rel'] for t in multi['trials']):.2e}, updates "
              f"{max(t['update_rel_max'] for t in multi['trials']):.2e}; "
              f"step 4 trials {multi_times['trials_4_step_ms']:.3f} ms, 1 "
              f"trial {multi_times['trials_1_step_ms']:.3f}, single step "
              f"{multi_times['single_step_ms']:.3f}, 4 single steps "
              f"{multi_times['loop_of_4_single_step_ms']:.3f}; featurize K1 "
              f"{feat['card']['launches']['K1']} launches, card vs CPU "
              f"{feat['max_abs_db_vs_cpu']:.5f} dB; tsne featuregrams card "
              f"vs CPU {tsne_run['featuregram_max_abs_db_vs_cpu']:.5f} dB, "
              f"skewness {tsne_run['skew_max_abs_delta_vs_cpu']:.3e}, at "
              f"most {tsne_run['skew_max_share_of_bar']:.3f} of its bar",
            flush=True)

        lem_t = {"whole_60s": time_legs(lem, x60, wav60, wpath[lem],
                                        out("t60.npz"), whole["total_s"]),
                 "slabbed_600s": time_legs(lem, x600, wav600, wpath[lem],
                                           out("t600.npz"),
                                           slabbed["total_s"])}
        jang_t = {"whole_60s": time_legs(jang, x60, wav60, jw,
                                         out("u60.npz"), j60["total_s"]),
                  "slabbed_600s": time_legs(jang, x600, wav600, jw,
                                            out("u600.npz"),
                                            j600["total_s"])}


        # Phase 10b: the native host kernels, the timers, and the
        # fold-at-scale tool at smoke size in a child process.
        t_host = time.perf_counter()
        host = {"native": native_checks(), "timers": timer_checks(tmp),
                "scale_tool": scale_tool_check(card, tmp, checked)}
        print(f"[10b host] native kernels ok ({host['native']['s']:.1f} s); "
              f"time_op on K1 {host['timers']['time_op_ms']:.4f} ms vs "
              f"cuda_ms {host['timers']['cuda_ms']:.4f} ms; trace "
              f"{host['timers']['trace_k1_events']} of {TRACE_LAUNCHES} K1 "
              f"launches (in this process "
              f"{host['timers']['trace_k1_events_in_this_process']}); "
              f"scale tool "
              f"{host['scale_tool']['epochs_run']} epochs of "
              f"{host['scale_tool']['tr_steps']} steps, K1 launches "
              f"{host['scale_tool']['k1_launches']}, "
              f"{host['scale_tool']['wall_s']:.1f} s; "
              f"{time.perf_counter() - t_host:.1f} s", flush=True)

        t_par = time.perf_counter()
        par_runs, parallel = phase_parallel(card, train_corpus, x600, wav600,
                                            wpath[lem], out, slabbed)
        runs.update(par_runs)
        fe, seg_read = parallel["sharded_frontend"], parallel["segment"]
        dp_read = parallel["dp_world_1"]
        print(f"[11 parallel] sharded front end vs one launch, max |delta| "
              f"at the joins: " + ", ".join(
                  f"{k} {max(v.get('per_join_max_abs_delta', v.get('per_join_max_abs_db'))):.2e}"
                  for k, v in fe.items())
              + f"; segmenter over {SEGMENT_SHARDS} shards: features "
              f"{seg_read['features_max_abs_db_vs_one_device']:.5f} dB, "
              f"tracks {seg_read['tracks_max_abs_delta_vs_one_device']:.2e}, "
              f"featurize {seg_read['featurize_sharded_ms']:.1f} ms vs "
              f"{seg_read['featurize_one_device_ms']:.1f} ms on one device; "
              f"DP world 1 patch step loss "
              f"{dp_read['patch_step']['loss_rel']:.2e}, updates "
              f"{dp_read['patch_step']['update_rel_max']:.2e}, audio step "
              f"loss {dp_read['audio_step']['loss_rel']:.2e}, updates "
              f"{dp_read['audio_step']['update_rel_max']:.2e}, step "
              f"{dp_read['audio_step']['dp_step_ms']:.3f} ms vs "
              f"{dp_read['audio_step']['single_step_ms']:.3f} ms; trial "
              f"sharding updates "
              f"{max(t['update_rel_max'] for t in parallel['trial_sharding']['trials']):.2e}"
              f"; {time.perf_counter() - t_par:.1f} s", flush=True)

    paths = {"K1": ("lemaire_60", "lemaire_600", "whisper_1200",
                    "eval_lemaire",
                    "classify_60", "train_device", "train_host",
                    "train_lemaire_fls", "train_doukhan", "cascaded_60",
                    "five_60", "eval_five", "eval_if", "fuse_late",
                    "train_cascaded", "train_five", "train_if_device",
                    "train_if_host", *(n for n, _, _ in TUNE_RUNS),
                    "featurize", "tsne", "train_bf16", "lemaire_60_ckpt",
                    "scopes_60", *(["mp3_10"] if "mp3_10" in runs else []),
                    "sharded_frontend", "segment_sharded", "dp_audio"),
             "K2": ("jang_60", "jang_600", "jang_10", "eval_jang", "pap_60",
                    "pap_10", "eval_papakostas", "train_jang_device",
                    "train_jang_host", "train_papakostas",
                    "sharded_frontend"),
             "K3": ("resynth_60", "eval_jang", "eval_papakostas"),
             "K4": ("eval_lemaire", "eval_five", "eval_if")}
    for entry, (kernel, names) in zip(entries, paths.items()):
        entry["launches"] = sum(runs[n]["launches"][kernel] for n in names)
        check(entry["launches"] > 0, f"{kernel} never launched on its path")
        shapes = set().union(*(runs[n]["shapes"][kernel] for n in names))
        unchecked = shapes - checked[kernel]
        check(not unchecked, f"{kernel} launched at shapes phase 3 did not "
              f"check: {sorted(unchecked)}")
        others = [n for n in runs if n not in names
                  and runs[n]["launches"][kernel]]
        check(not others, f"{kernel} launched on another path: {others}")
        for rec in pair_entries[kernel]:
            rec["launches"] = sum(runs[n]["by_pair"][kernel][
                "{},{}".format(*rec["pair"])] for n in names)
        check(sum(r["launches"] for r in pair_entries[kernel])
              == entry["launches"], f"{kernel}: launches per pair do not "
              "add up")
        entry["pairs"] = pair_entries[kernel]
        # The main path's launches per power: all at power 2, none at the
        # powers phase_modes holds.
        powers = Counter()
        for n in names:
            powers.update(runs[n]["by_power"][kernel])
        check(powers[2.0] == entry["launches"], f"{kernel}: launches at "
              f"power 2 {powers[2.0]} of {entry['launches']}")
        for rec in power_records[kernel]:
            rec["launches"] = powers[rec["power"]]
        entry["power_modes"] = power_records[kernel]
    # The halo-mode records: the launches of that mode among each kernel's.
    for rec, kernel in zip(halo_records, ("K1", "K2")):
        rec["launches"] = sum(runs[n].get("halo", {}).get(kernel, 0)
                              for n in paths[kernel])
        check(rec["launches"] > 0, f"{kernel} never ran in halo mode")
        entries.append(rec)
    # K1 and K2 in bf16x3: their launches are phase_modes' main path's.
    for rec in mode_records:
        check(rec["launches"] > 0, f"{rec['name']} never launched")
        entries.append(rec)
    # The TCN block's kernels on the Lemaire models' paths (every model
    # built on the TCN, on the card): each launched there and nowhere else,
    # every launch shape held to the plain version (phase 3's main shapes,
    # the rest here), the readings phase 3 took at the segmenter's eval
    # shape.  The scale tool's process (phase 10b) is not counted.
    tcn_paths = ("lemaire_60", "lemaire_600", "eval_lemaire", "classify_60",
                 "train_device", "train_host", "train_lemaire_fls",
                 "cascaded_60", "five_60", "eval_five", "eval_if",
                 "fuse_late", "train_cascaded", "train_five",
                 "train_if_device", "train_if_host",
                 *(n for n, _, _ in TUNE_RUNS), "train_bf16",
                 "lemaire_60_ckpt", "scopes_60",
                 *(["mp3_10"] if "mp3_10" in runs else []),
                 "segment_sharded", "dp_audio")
    tcn_shapes = set().union(*(runs[n]["shapes"]["tcn"] for n in tcn_paths))
    tcn_held = _hold_tcn_shapes(tcn_shapes, checked)
    eval_reading = tcn["kernels"]["eval float32 {}x{}x{}".format(
        *TCN_SHAPES["eval"])]
    for kernel in TCN_KERNELS:
        by_path = {n: runs[n]["tcn"][kernel] for n in tcn_paths}
        # The backward runs on the training paths alone.
        wrong = [n for n, v in by_path.items() if bool(v) != (
            kernel != "backward_a" or n.startswith(("train", "tune", "dp")))]
        check(not wrong, f"tcn_block {kernel}: launches on {wrong}: "
              f"{by_path}")
        others = [n for n in runs if n not in tcn_paths
                  and runs[n]["tcn"][kernel]]
        check(not others, f"tcn_block {kernel} launched on another path: "
              f"{others}")
        shapes = sorted(k[1:] for k in tcn_shapes if k[0] == kernel)
        entries.append({
            "name": f"tcn_block.{kernel}",
            "launches": sum(by_path.values()),
            "launches_by_path": {n: v for n, v in by_path.items() if v},
            "shapes": shapes,
            "shapes_held_in_phase_12": [h for h in tcn_held
                                        if tuple(h[:5]) in {
                                            s[:5] for s in shapes}],
            **{k: eval_reading[kernel][k] for k in (
                "ms", "ms_spread", "device_ms", "bound_ms", "roofline",
                "plain_ms")},
            "timed_shape": list(TCN_SHAPES["eval"]),
            **tcn["registers"][kernel]})
    check(tcn_shapes <= checked["tcn"], "TCN launch shapes left unheld: "
          f"{sorted(tcn_shapes - checked['tcn'], key=str)}")
    # Jang's conv block kernel on the Jang models' paths: on each serving and
    # evaluation path (a model call in eval mode with no gradient on the
    # card), three launches a call, 'SAME' for Jang-MTL and 'VALID' for the
    # single-task model; every launch shape held to the plain version; no
    # launch on another path.
    cb_shapes = set().union(*(runs[n]["shapes"]["conv_block"]
                              for n in CONV_BLOCK_PATHS))
    cb_held = _hold_conv_block_shapes(cb_shapes, checked)
    cb_by_path = {n: runs[n]["conv_block"] for n in CONV_BLOCK_PATHS}
    for n, by in cb_by_path.items():
        pool = "valid" if n == "train_Jang_et_al" else "same"
        check(sum(by.values()) % 3 == 0 and not any(
            v for p, v in by.items() if p != pool)
            and (by[pool] > 0 or n not in CONV_BLOCK_SERVING),
            f"conv_block launches on {n}: {by}")
    others = [n for n in runs if n not in CONV_BLOCK_PATHS
              and any(runs[n]["conv_block"].values())]
    check(not others, f"conv_block launched on another path: {others}")
    cb_reading = cb["kernels"]["b1 float32 SAME {}x{}x{}x{}".format(
        *CONV_BLOCK_SHAPES["b1"])]
    entries.append({
        "name": "conv_block",
        "launches": sum(sum(v.values()) for v in cb_by_path.values()),
        "launches_by_pool": {p: sum(v[p] for v in cb_by_path.values())
                             for p in CONV_BLOCK_POOLS},
        "launches_by_path": {n: v for n, v in cb_by_path.items()
                             if any(v.values())},
        "shapes": sorted(cb_shapes), "shapes_held_in_phase_12": cb_held,
        **{k: cb_reading[k] for k in ("ms", "ms_spread", "device_ms",
                                      "bound_ms", "roofline", "library_ms",
                                      "bitwise", "rel_gap")},
        "timed_shape": list(CONV_BLOCK_SHAPES["b1"]),
        "registers": cb["registers"]})
    check(cb_shapes <= checked["conv_block"], "conv block launch shapes "
          f"left unheld: {sorted(cb_shapes - checked['conv_block'])}")
    print(f"[12 conv_block] {len(cb_shapes)} launch shapes on "
          f"{len(CONV_BLOCK_PATHS)} paths, {len(cb_held)} held here; "
          f"launches {entries[-1]['launches_by_path']}", flush=True)
    print(f"[12 tcn_block] {len(tcn_shapes)} launch shapes on "
          f"{len(tcn_paths)} paths, {len(tcn_held)} held here; launches "
          + ", ".join(f"{e['name']} {e['launches']}" for e in entries
                      if e["name"].startswith("tcn_block.")), flush=True)
    # The scale tool's path (phase 10b) ran in its own process, which
    # counted its K1 launches (all at (21, 11)).
    entries[0]["launches"] += host["scale_tool"]["k1_launches"]
    for rec in pair_entries["K1"]:
        if tuple(rec["pair"]) == (21, 11):
            rec["launches"] += host["scale_tool"]["k1_launches"]
    print("[12 checks] ok", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"serving": {
        "card": card, "lemaire_mtl": lem_t, "jang_mtl": jang_t,
        "feature_max_abs_db": {"lemaire_mtl": db, "jang_mtl": jang_db},
        "jang_track_max_abs_delta_vs_cpu": jang_track,
        "jang_cpu_10s_total_ms": 1e3 * j10_cpu["total_s"],
        "papakostas_mtl": {
            "first_run_60s_total_ms": 1e3 * p60["total_s"],
            "warm_60s_total_ms": 1e3 * p60_warm["total_s"],
            "10s_total_ms": 1e3 * p10["total_s"],
            "cpu_10s_total_ms": 1e3 * p10_cpu["total_s"],
            "track_max_abs_delta_vs_cpu": pap_track},
        "variants": variants_serving,
        "ckpt_of_bf16_fold_60s": ckpt_serving,
        "segmenter_scopes": {k: v for k, v in scopes.items()
                             if k not in ("shapes", "by_pair", "by_power")},
        "mp3": mp3,
        "build_s": build_s}}))
    print(json.dumps({"resynthesis": {
        "card": card, "audio_s": len(x60) / SR,
        "first_run_total_ms": 1e3 * rs["total_s"],
        "total_ms": 1e3 * rs_warm["total_s"],
        "cpu_total_ms": 1e3 * rs_cpu["total_s"],
        "gpu_vs_cpu_peak_rel": rs_delta}}))
    print(json.dumps({"evaluation": {
        "card": card, "model": lem, "items": len(lem_eval["frames"]),
        "short_items": n_short, "audio_s": lem_eval["samples"] / SR,
        "test_model_ms": 1e3 * lem_eval["test_model_s"],
        "sweep_ms": 1e3 * lem_eval["sweep_s"],
        "featurize_ms": 1e3 * lem_eval["featurize_s"],
        "featurize_share": lem_eval["featurize_s"]
        / (lem_eval["test_model_s"] + lem_eval["sweep_s"]),
        "launches": lem_eval["launches"],
        "cpu_test_model_ms": 1e3 * lem_eval_cpu["test_model_s"],
        "cpu_sweep_ms": 1e3 * lem_eval_cpu["sweep_s"],
        "predictions_max_abs_delta_vs_cpu": eval_delta,
        "near_ties": len(ties),
        "classify_60s": {"total_ms": 1e3 * clf["total_s"],
                         "cpu_total_ms": 1e3 * clf_cpu["total_s"],
                         "launches": clf["launches"],
                         "probabilities_max_abs_delta_vs_cpu": clf_delta},
        "jang_mtl": {"items": len(jang_eval["frames"]), "short_items":
                     j_short, "audio_s": jang_eval["samples"] / SR,
                     "test_model_ms": 1e3 * jang_eval["test_model_s"],
                     "featurize_ms": 1e3 * jang_eval["featurize_s"],
                     "launches": jang_eval["launches"]},
        "papakostas_mtl": {"items": len(pap_eval["frames"]), "short_items":
                           p_short, "audio_s": pap_eval["samples"] / SR,
                           "test_model_ms": 1e3 * pap_eval["test_model_s"],
                           "featurize_ms": 1e3 * pap_eval["featurize_s"],
                           "launches": pap_eval["launches"]},
        "variants": variants_eval}}))
    k1_train = entries[0]["training_shapes"]

    def brief(run):
        return {k: v for k, v in run.items() if k not in ("shapes",
                                                          "history")}
    print(json.dumps({"training": {
        "card": card, "model": lem, "width": "32 filters, 3 stacks, Nd 8, "
        "D 240, patch 68, head width 16, 16 clips per class",
        "corpus": {"files_per_class": TRAIN_FILES,
                   "seconds_per_file": TRAIN_SECONDS},
        "epochs": TRAIN_EPOCHS, "train_steps": TRAIN_STEPS,
        "val_steps": VAL_STEPS,
        "device_pipeline": {**{k: v for k, v in tdev.items()
                               if k not in ("shapes", "history")},
                            **step_times},
        "host_pipeline": {k: v for k, v in thost.items()
                          if k not in ("shapes", "history")},
        "k1_at_48x11120": k1_train["48x11120"],
        "k1_at_12x43760": k1_train["12x43760"],
        "one_step_card_vs_cpu": {k: v for k, v in step_checks.items()
                                 if k != "fixed_batch_losses"},
        "fixed_batch_losses": step_checks["fixed_batch_losses"],
        "frame_level_scaling": brief(tfls),
        **{model: {**{p: brief(r) for p, r in image[model].items()},
                   **image_checks.get(model, {}),
                   **({"device_steps": jang_times}
                      if model == "Jang_et_al_MTL" else {})}
           for model in IMAGE_MTL + BASELINES},
        "variants": {model: {
            **{p: (brief(r) if p != "device_steps" else r)
               for p, r in v.items()},
            **variant_checks.get(model, {})}
            for model, v in variants.items()},
        "bf16": {"step_checks": bf16["models"], "step_times": bf16_times,
                 "fold": brief(tb16)},
        "k1_at_80x11120": k1_train["80x11120"],
        "k1_at_20x43760": k1_train["20x43760"],
        "k2_training_shapes": entries[1]["training_shapes"]}}))
    print(json.dumps({"tuning": {
        "card": card, "model": lem, "width": "32 filters, 3 stacks, Nd 8, "
        "D 240, patch 68, 16 clips per class", "epochs": 1,
        "train_steps": TUNE_STEPS, "val_steps": 1,
        **{n: {k: v for k, v in tuning[n].items()
               if k not in ("shapes", "by_pair", "by_power")}
           for n, _, _ in TUNE_RUNS},
        "multi_step_card_vs_cpu": multi, "multi_step_times": multi_times,
        "featurize": {**{k: v for k, v in feat["card"].items()
                         if k not in ("shapes", "by_pair", "by_power")},
                      "cpu_total_s": feat["cpu_total_s"],
                      "max_abs_db_vs_cpu": feat["max_abs_db_vs_cpu"],
                      "launch_shapes": feat["launch_shapes"]},
        "tsne": {k: v for k, v in tsne_run.items()
                 if k not in ("shapes", "by_pair", "by_power")}}},
        default=str))
    print(json.dumps({"parallel": {
        "card": card, **parallel,
        "readings": {
            "k1_halo_device_ms_1x15000": halo_records[0]["device_ms"],
            "k1_whole_device_ms_1x16404": entries[0]["device_ms"],
            "featurize_600s_sharded_ms": seg_read["featurize_sharded_ms"],
            "featurize_600s_one_device_ms":
            seg_read["featurize_one_device_ms"],
            "featurize_600s_slabbed_ms_time_legs":
            lem_t["slabbed_600s"]["featurize_ms"],
            "dp_world_1_audio_step_ms": dp_read["audio_step"]["dp_step_ms"],
            "single_audio_step_ms": dp_read["audio_step"]["single_step_ms"],
            "dp_world_1_patch_step_ms": dp_read["patch_step"]["dp_step_ms"],
            "single_patch_step_ms": dp_read["patch_step"]["single_step_ms"]}
    }}, default=str))
    print(json.dumps({"host": {"card": card, **host}}, default=str))
    print(json.dumps({"modes": modes}, default=str))
    print(f"[13 total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import sm_hpss_mtl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
