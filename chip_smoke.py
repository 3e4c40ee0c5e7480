#!/usr/bin/env python3
"""Smoke run of metrics_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compiled-only   # build, then the compiled phase alone
    python3 chip_smoke.py --resilience-only   # build, then the resilience phase alone
    python3 chip_smoke.py --analysis-only   # build, then the metricslint phase alone
    python3 chip_smoke.py --examples-only   # build, then the examples phase alone

Every phase prints its collections' ``compile_stats()``: after 16 eager
steps the compiled hot path (``core/compiled.py``) replays a metric's
``update``/``forward`` as a CUDA graph, so a phase with more steps runs
compiled after its warm-up, and the line says which path ran and what fell
back.

1. checks for a card and prints its name and power limit;
2. builds the CUDA kernels from ``metrics_tpu_torch/csrc``;
3. holds every kernel against its plain PyTorch version on the card (bit for
   bit): the binned-counts kernel in both its designs, the shared-memory
   histogram and the compare kernel; times both designs, the wrapper and the
   plain versions at the main path's shapes, and counts the device
   operations of one wrapper call with ``torch.profiler``; then the
   confusion-count kernel at the main path's three shapes (Cityscapes scores
   [1, 19, 1024, 2048] and labels [1, 1024, 2048] over 19 classes, an
   ImageNet-1k batch [2000, 1000]) against its plain form and the one-hot
   composition it replaced, with its time, the composition's, and its bytes
   bound;
4. drives the flagship collection, ``Accuracy`` + macro ``StatScores`` over
   10 classes, for 16 ``forward`` steps of [2048, 10] probabilities, then
   ``compute()``, and holds it against the same run on the CPU;
5. drives the binned collection, ``BinnedAveragePrecision`` +
   ``BinnedRecallAtFixedPrecision`` (10 classes, 100 thresholds), the same
   way, and checks that every update went through the CUDA kernel;
6. drives the report collection at ImageNet-1k eval width (macro
   Precision/Recall/F1/Specificity, ConfusionMatrix, MatthewsCorrcoef,
   CohenKappa over 1000 classes, HammingDistance) for 16 ``forward`` steps of
   [2048, 1000] probabilities, with its compute groups (the default: the four
   stat-score members share one update) and without, and a
   ``CompositionalMetric`` ``2 * (p * r) / (p + r)``; the grouped run is held
   bit for bit against the ungrouped one, and both against the CPU run; each
   of ConfusionMatrix, MatthewsCorrcoef and CohenKappa launches the
   confusion-count kernel once a step;
7. drives the segmentation collection at Cityscapes val resolution (IoU and
   ConfusionMatrix over 19 classes, plus ``dice_score`` per step) for 4 steps
   of [1, 19, 1024, 2048] probabilities, held against the CPU run; each of
   the two launches the confusion-count kernel once a step;
8. drives the curves collection at ImageNet-1k eval width: ``AUROC`` and
   ``AveragePrecision`` (macro, 1000 classes) with ``with_capacity(49152)``
   and ``CalibrationError(n_bins=15)``, 24 ``update`` steps of [2048, 1000]
   softmax probabilities, then ``compute()``; times the steps and the
   compute, profiles both (device busy share, kernels per step, host reads
   inside ``compute()``, peak memory), runs the same collection with list
   states, and a binary run (AUROC, AveragePrecision, ROC and
   PrecisionRecallCurve on 2^20 scores with large tie groups) in both modes;
   every state is held against the CPU run, and the two modes against each
   other; then ``CalibrationError`` with a NaN, a +inf and a -inf confidence
   planted in one batch, multiclass and binary, finite and held to the CPU;
9. drives the regression collection at NYU Depth v2 test size (MSE, RMSE,
   MAE, MSLE, MAPE, SMAPE, R2Score, ExplainedVariance, PearsonCorrcoef,
   TweedieDevianceScore(power=2)) for 16 ``forward`` steps of 2,457,600
   flattened depths, held against the CPU run within bounds derived from
   this run's data (``_regression_bounds``), counts exact;
10. drives SpearmanCorrcoef and CosineSimilarity(mean) at sentence-embedding
   eval size (24 ``update`` steps of 2048 pairs of 768-wide embeddings, and
   their cosines against STS-B-style gold scores) in list mode and with
   ``with_capacity(49152)``: the two modes equal bit for bit, both against
   the CPU run; times ``compute()``, counts its host reads, its peak memory;
11. drives the retrieval collection at MS MARCO passage dev size (MRR, MAP,
   nDCG@10, P@10, R@100, FallOut@100 and MAP skipping empty queries over one
   grouping sort; 6,980 queries x 1,000 candidates in 70 ``update`` steps)
   in list mode and with ``num_queries`` + ``with_capacity``: the two modes
   equal bit for bit, the collection equal to its seven members run alone,
   both modes against the CPU run within ``RETRIEVAL_ATOL``; times and
   profiles ``compute()`` of the collection (one sort) and of the members
   (seven): device operations, host reads, peak memory, the top device
   operations by time;
12. snapshots the curves collection (capacity mode) and the retrieval
   collection (capacity mode) with ``save_checkpoint``, loads them into fresh
   metrics on the card (states bit-equal, ``compute()`` equal), times save
   (device-to-host copy, CRC, write + fsync) and load, and holds a file with
   one flipped payload byte to ``CheckpointCorruptError`` with the target's
   states unchanged; ``telemetry()['checkpoint']`` counts the saves and the
   verified load;
   telemetry: the flagship collection with the journal off and on (the step's
   time, its ``cudaStreamSynchronize`` count, equal both ways, and its
   events), a journaled save/prune/load, the journal exported as a Chrome
   trace and read back, ``telemetry()``'s JSON-lines and Prometheus
   encodings against the JAX package's schema, the host cost of a record;
13. image-fid: FID (buffered and ``streaming=True``), KID (100 subsets of
   1,000) and IS (10 splits) through the fidelity Inception-v3 (random
   weights) at CIFAR-10 FID-10k size, 40 steps of 250 uint8 32x32 images
   a side; the features of 16 images against the port on the CPU with
   PyTorch's default TF32 flags and with them off (and, to show the bound
   tells them apart, without the float32 guard); images/s in float32 and
   bfloat16; an update step profiled; each ``compute()`` timed, profiled and
   held against the same ``compute()`` on the CPU and against the same
   states' float64 FID;
14. image-lpips: LPIPS with AlexNet and VGG16 towers on 10,000 pairs of
   64x64 patches, pairs/s, 32 pairs against the CPU; image-ssim: PSNR and
   streaming SSIM on 100 DIV2K-size [3, 1356, 2040] images, the window
   convolution timed, the first 2 steps against the CPU and the float32
   counts against the JAX package's rounding, ``image_gradients`` once;
15. text: WER at LibriSpeech test-clean size (2,620 utterances), BLEU at
   WMT newstest size (3,000 segments) and ROUGE (rouge1/2/L/Lsum, stemmed:
   the built-in Porter where nltk is absent) on 1,000 CNN/DailyMail-size
   summaries, from a seeded 5,000-word vocabulary, on the card and on the
   CPU: states equal (ROUGE's per sentence), WER's value equal, BLEU's and
   ROUGE's means within their bounds; host ms per update and of compute();
16. bertscore: BERTScore through a bert-base-width ``BertEncoder`` (12
   layers, hidden 768, random weights from a seeded ``torch.Generator``
   loaded through ``load_torch_bert_weights``) over 3,000 newstest-size pairs
   in 30 update steps (``max_length=128``, ``batch_size=64``); the encoder's
   sentences/s; ``compute()`` timed and profiled; the first 64 pairs against
   the port on the CPU, with TF32 switched on outside the float32 guard and,
   to show the bound tells them apart, without the guard; identical pairs
   score F1 = 1 and swapped sides swap P and R; then the default encoder
   (``bert_init`` weights) with ``idf=True``;
17. audio: PIT(si_sdr) and SI-SDR, SI-SNR and SNR on PIT's order at
   WSJ0-2mix and wsj0-3mix test size (3,000 mixtures of 32,000 samples, 30
   steps of 100) and one batch of 8 speakers (the host Hungarian solve),
   against the CPU run (permutations equal wherever the best one leads by
   more than the values' bound); step ms and idle share; then ``si_snr`` and
   ``SI_SNR`` against one step's sources as int64 PCM, held to the CPU;
   compiled: the flagship, the grouped report, the regression, the binned
   collection (B1 inside the graphs) and the 2-speaker audio step, 48 steps
   with ``compiled_update=False`` and 48 with the default (16 eager, then
   replays): step ms (median of the last 24), kernels and
   ``cudaGraphLaunch`` a step, ``cudaStreamSynchronize`` a step and the
   idle share (``torch.profiler``), traces, dispatches and fallbacks; the
   states equal leaf for leaf between the two runs, every member the JAX
   package compiles replayed and fell back nowhere, the members it refuses
   carry its fallback kinds, B1's launches counted through the replays and
   its states equal to the CPU run's (the plain twin);
   wrappers: a bootstrapped confidence interval of ImageNet-1k val top-1
   (``BootStrapper(Accuracy(num_classes=1000), num_bootstraps=100)``, 50,000
   seeded [., 1000] scores in 25 updates of 2,000; Poisson and multinomial),
   its first 5 updates against the CPU (keys, draws, every copy's states,
   mean/std/quantile/raw), update ms and host reads; a ``MetricTracker`` over
   10 epochs of 10,000 rows (best value and epoch equal to the CPU's);
   ``embedding_similarity`` on a SimCLR batch (4,096 x 128, cosine, zero
   diagonal, ``none`` and ``mean``) against the CPU, timed, peak memory;
18. syncs on two ranks that share the card (``torch.multiprocessing`` spawn,
   gloo, every state on ``cuda:0``): each rank takes a contiguous half of the
   report batches, of the curves batches (AUROC + AveragePrecision with
   ``with_capacity``), of the regression batches (PearsonCorrcoef's
   ``dist_reduce_fx=None`` states gather to ``[2]`` and fold) and of the
   retrieval queries, a streaming FID of half the feature batches, the text
   metrics (WER, BLEU, ROUGE) as one collection and the default BERTScore
   over 256 pairs, half of each;
   the collections sync through one health header and one bucketed plan, and the synced values on both ranks are held against one
   process on the card over all batches; counts the collectives of the fused
   sync against the per-leaf sync and times both; then drives three
   divergence cases on the two ranks (``num_classes`` 1000 against 1001, the
   same with ``on_error="local"``/``"warn"``, one NaN under
   ``enable_check_finite()``), which must raise, degrade and raise on both;
   each rank saves its shard (``world=2``) of the report, ranking and
   retrieval collections, and the main process folds the two into one
   (``world=1``), held against the one-process runs: an elastic resume;
   the journal is on in both ranks: equal ``(kind, label)`` sequences, one
   ``sync.gather`` a sync round, the guarded collectives' time, the schema
   divergence once in ``health`` and as ``health.failure`` on each rank,
   both journals as one Chrome trace;
19. resilience and tiers: four gloo ranks share the card (one
   ``torch.multiprocessing`` spawn, every state on ``cuda:0``, a c10d store
   hosted by this process; ``--resilience-only`` runs the build and this
   alone). The phase builds its own quorum and tier transport
   (``_StoreTransport``: gloo groups, liveness from store heartbeats; the
   package ships none). (a) tiers: at ``METRICS_TPU_TIER_SIZE=2`` the report
   collection and a 2048-dim streaming FID sync flat, tiered at full
   precision (equal to flat, ``torch.equal``), bf16 and int8 (bit-stable,
   integer states untouched, the FID bucket within the bound derived from
   the codec and this run's data); ms a sync, the tier byte counters, the
   codec's device ms. (c) probation: a straggler past the others' watchdog;
   they degrade, cool down, and the next sync readmits them as the probe
   round. (b) quorum: rank 3 leaves with ``os._exit`` before a
   ``sync_on_missing="quorum"`` sync; the survivors agree on epoch 1 and
   live (0, 1, 2) with tiers {0, 1} and {2}, retry once, and equal one
   process over their batches;
20. profiles a step of each collection (the report collection with and
   without compute groups), then prints one JSON line describing the kernels,
   then, as the last line, ``{"ok": true, "device": {...}}``.

After the compiled phase comes the analysis phase (``--analysis-only`` runs
the build and it alone): metricslint over the package, the compiled
configurations with static pre-classification on and off (probes, the first
compiled step, the steady steps, states ``torch.equal``, B1's launches), a
class refuted from this file before any capture, a host read the analysis
cannot see that the CUDA graph capture refuses, and the host-sync list under
``torch.cuda.set_sync_debug_mode("error")`` and capture.

After the resilience phase comes the examples phase (``--examples-only``
runs the build and it alone): the three ``examples/torch_*.py`` through
their own entry points, imported by file path. The train loop at the JAX
example's size on the CPU, on the card op by op and on the card as one CUDA
graph a step (forward, loss, backward, ``Adam(capturable=True)`` and both
``pure_update`` calls), per-epoch values held against the CPU run, step ms,
kernels and ``cudaGraphLaunch`` a step; the sharded eval over a one-rank
NCCL group against one collection within 1e-6; own-model BERTScore against
the CPU; ``inception_v3_init``/``lpips_init`` drawn on the card against the
CPU draw (4 ulps), and the JAX suite's golden FID, KID and LPIPS cases on
the card.

Any failed check raises, and the script then exits non-zero without the last
line. Without CUDA it exits with code 2 and prints no result.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

BATCH, NUM_CLASSES, STEPS, THRESHOLDS = 2048, 10, 16, 100
# bound_ms: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the five shapes of tests/ops/test_pallas_binned.py, then the main path's
# binned update, the JAX package's binned benchmark shape and an ImageNet-1k
# eval batch with the default 100 thresholds
TEST_SHAPES = [(37, 3, 100), (256, 10, 5), (5, 1, 1), (1000, 17, 130), (64, 130, 20)]
SLICE_SHAPES = [(BATCH, NUM_CLASSES, THRESHOLDS), (65536, 8, 128), (2048, 1000, 100)]
VALUE_ATOL = 1e-6  # float32 values reduced in another order on the card
# report and segmentation phases: ImageNet-1k eval width, Cityscapes val at
# full resolution with its 19 evaluation classes
REPORT_CLASSES, SEG_CLASSES, SEG_STEPS, SEG_HW = 1000, 19, 4, (1024, 2048)
# the confusion-count kernel at the main path's shapes (the benchmark's
# Cityscapes scores and labels, its ImageNet-1k batch of 2000): preds shape,
# classes, scores or labels
CONFUSION_SHAPES = {
    "seg-scores": ((1, SEG_CLASSES, *SEG_HW), SEG_CLASSES, "scores"),
    "seg-labels": ((1, SEG_CLASSES, *SEG_HW), SEG_CLASSES, "labels"),
    "report-rows": ((2000, REPORT_CLASSES), REPORT_CLASSES, "scores"),
}
L2_BYTES = 50 << 20  # H100 SXM
# kappa = 1 - a / b, with a and b float32 sums over the 1e6 cells of the
# [1000, 1000] matrix, summed in another order on the card: each sum may move
# by ~log2(1e6) * 2**-24 = 1.2e-6 of itself, so a / b (about 1) by twice that
VALUE_ATOL_BY_METRIC = {"kappa": 1e-5}
# curves phase: ImageNet-1k eval width; 24 steps of 2048 = 49,152 of the
# 50,000 validation images (cut to whole batches)
CURVE_CLASSES, CURVE_STEPS, CURVE_CAPACITY = 1000, 24, 24 * BATCH
BINARY_ROWS, BINARY_STEPS = 2 ** 20, 8
# capacity mode, card vs CPU: per-class AUROC comes from exact integer rank
# sums and per-class AP from float64 sums, so they agree to a float32 ulp;
# the macro mean is a float32 sum over 1000 classes in another order, off by
# at most log2(1000) * 2**-24 = 6e-7
RANKING_ATOL = 1e-6
# list mode against capacity mode (and list mode card vs CPU): the curve
# path integrates in float32, one sum of up to 49,152 terms per class, off
# by about log2(49152) * 2**-24 = 1e-6 of the value, plus the rounding of
# the curve points; two such values differ by up to about 2e-6
CURVE_ATOL = 3e-6
# CalibrationError card vs CPU: per-bin float32 sums of ~3,300 confidences
# in another order (12 roundings of 2**-24 each), for conf and acc both,
# weighted by bin shares that sum to 1
CE_ATOL = 2e-6
# sync phase: two ranks on the one card, each with half of the batches
SYNC_WORLD = 2
# regression phase: NYU Depth v2's labelled test split (654 images of
# 480x640) cut to 128 images, 16 forward steps of 8 flattened depth maps
DEPTH_HW, DEPTH_BATCH, REG_STEPS = (480, 640), 8, 16
DEPTH_PIXELS = DEPTH_BATCH * DEPTH_HW[0] * DEPTH_HW[1]  # 2,457,600 a step
# float32 sums, card vs CPU: a step sums 2,457,600 terms (in a tree on both
# sides: log2(2,457,600) = 21.2 roundings of 2**-24, of the sum of the terms'
# magnitudes), then 16 steps add up in the state (16 more roundings); the two
# sides may err in opposite directions: twice that, 4.4e-6 of the sum
REG_SUM_RTOL = 2 * (float(np.log2(DEPTH_PIXELS)) + REG_STEPS) * 2.0 ** -24
# regression-cat phase: sentence-embedding evaluation at BERT-base width,
# 24 update steps of 2048 pairs (49,152 pairs; STS-B-style gold scores)
EMBED_DIM, CAT_STEPS, CAT_CAPACITY = 768, 24, 24 * BATCH
# cosine mean, card vs CPU: each row's dot product and norms are float32 sums
# of 768 terms (log2(768) = 9.6 roundings each side; the dot's terms are of
# mixed sign, Σ|xy| / |Σxy| about 2 at a cosine of 0.6), then a mean over
# 49,152 rows (15.6 roundings): 2 * (2 * 9.6 + 9.6 + 15.6) * 2**-24 = 5.3e-6
COSINE_ATOL = 2 * (2 * 9.6 + 9.6 + 15.6) * 2.0 ** -24
# Spearman, card vs CPU: the ranks are exact on both sides (one stable sort of
# the same data); the moments of the ranks are float32 means over 49,152 rows
# (15.6 roundings), the covariance's terms of mixed sign (Σ|ab| / |Σab| below
# 3 at rho of 0.5), and rho = cov / (sd * sd): 2 * (3 + 1) * 15.6 * 2**-24
SPEARMAN_ATOL = 2 * (3 + 1) * 15.6 * 2.0 ** -24
# retrieval phase: MS MARCO passage ranking, dev ("small") set, re-ranking
# the official BM25 top-1000: 6,980 queries x 1,000 candidates, 70 update
# steps of 100 queries (the last of 80); query ids drawn from the range of
# MS MARCO qids
MSMARCO_QUERIES, MSMARCO_DEPTH, MSMARCO_STEP_QUERIES = 6980, 1000, 100
MSMARCO_ROWS = MSMARCO_QUERIES * MSMARCO_DEPTH  # 6,980,000
MSMARCO_STEPS = -(-MSMARCO_QUERIES // MSMARCO_STEP_QUERIES)  # 70
MSMARCO_QID_RANGE = 1_102_432
# retrieval values, card vs CPU. Per query, a score is a quotient of float32
# sums whose nonzero terms are few (at most 2 relevant rows, the rest add
# exact zeros or 0/1 counts), so it rounds at most ~3 times (one more for a
# log2 discount, which may differ by an ulp); then a float32 mean over 6,980
# queries (log2(6980) = 12.8 roundings of values in [0, 1]). The two sides
# may err in opposite directions: 2 * (12.8 + 3) * 2**-24 = 1.9e-6
RETRIEVAL_ATOL = 2 * (float(np.log2(MSMARCO_QUERIES)) + 3) * 2.0 ** -24

# sync phase's streaming FID: 8 steps of [256, 2048] features a side, half
# on each rank. Kahan-corrected sums are within a few ulps of the exact sum
# whatever the order, so two ranks' against one process within 1e-6 of the
# largest (non-negative features: no cancellation)
FID_SYNC_STEPS, FID_SYNC_BATCH, FID_SYNC_DIM, FID_SYNC_RTOL = 8, 256, 2048, 1e-6
# image-fid phase: a CIFAR-10 GAN's evaluation against CIFAR-10's test
# split, torch-fidelity's FID-10k: 10,000 real and 10,000 generated uint8
# [3, 32, 32] images in 40 update steps of 250 a side, resized to 299 inside
# the extractor; KID with torch-fidelity's 100 subsets of 1,000, IS with 10
# splits on the generated images
CIFAR_IMAGES, CIFAR_STEP = 10_000, 250
CIFAR_STEPS = CIFAR_IMAGES // CIFAR_STEP  # 40
KID_SUBSETS, KID_SUBSET_SIZE, IS_SPLITS = 100, 1000, 10
FEATURE_CHECK_IMAGES = 16
# Inception features, card vs the port on the CPU: ~95 float32 convolutions
# deep, each a sum of up to 4,032 products (log2 = 12 roundings of 2**-24)
# that cuDNN and oneDNN order differently, some by transforms (Winograd,
# FFT) of their own: 1e-4 of the tap's largest value, ten times the bound
# the port's CPU forward holds against the JAX package
# (tests/test_torch_inception.py). A TF32 forward (10-bit mantissas, 2**-11
# a product) misses it by far.
FEATURE_RTOL = 1e-4
# FID = |mu1 - mu2|^2 + tr S1 + tr S2 - 2 tr sqrt(S1 S2): each float32 path
# (card or CPU; buffered or Kahan-streamed moments; eigh or Newton-Schulz)
# is held against the same states' float64 value with the JAX package's bar
# for its float32 trace term (rtol 2e-3, atol 1e-3 of tr sqrt(S1 S2),
# tests/image/test_fid_precision.py), which enters FID twice; two float32
# paths against each other within twice that
FID_SQRT_RTOL, FID_SQRT_ATOL = 2e-3, 1e-3
# KID, card vs CPU: every kernel value is (gamma <f, g> + 1)^3, a dot of 2048
# float32 terms (11 roundings) cubed (33), averaged over 10^6 entries (20
# more); KID is a difference of three such means: 3 * 64 * 2**-24 of the
# kernels' size, 1.2e-5
KID_KERNEL_RTOL = 3 * 64 * 2.0 ** -24
# IS, card vs CPU: softmax, log and means over 1,000 rows of 1008 logits
# in float32, exp of a mean KL of size ~1: 1e-5
IS_ATOL = 1e-5
# image-lpips phase: BAPPS (the LPIPS paper's data) patch size, 64x64 in
# [-1, 1]; 10,000 pairs in 40 steps of 250; the CPU check on the first 32
# pairs of the first step (VGG16 on the host takes ~6 s for a whole step)
BAPPS_PAIRS, BAPPS_STEP, BAPPS_HW, LPIPS_CHECK_PAIRS = 10_000, 250, 64, 32
# distances of size ~0.1-1: sums over 5 taps of spatial means of
# unit-normalised squared differences of convolution outputs, 5 (AlexNet)
# or 13 (VGG16) float32 layers deep in another order on each side
LPIPS_RTOL = 1e-4
# image-ssim phase: DIV2K's validation split at its full 2K resolution, 100
# images cut to [3, 1356, 2040] (the smallest crop every image admits), 25
# steps of 4, uint8 high-resolution images and a reconstruction 8 levels off
DIV2K_IMAGES, DIV2K_STEP, DIV2K_HW = 100, 4, (1356, 2040)
DIV2K_STEPS = DIV2K_IMAGES // DIV2K_STEP  # 25
SSIM_CHECK_STEPS = 2
# SSIM and PSNR card vs CPU over 2 steps. Each window sum of 121 products
# rounds ~log2(121) = 7 times on either side (cuDNN and oneDNN order them
# differently); sigma = E[x^2] - mu^2 cancels, (1/3 + 1/4) / (1/12) = 7 times
# for these uniform pixels, so sigma and sigma_xy carry 49 roundings,
# mu^2 and mu_x mu_y 14; the index (luminance factor ~2 * 14, structure
# factor ~2 * 49), systematic at worst, then a sum of 65,585,120 values
# (26 roundings) and the division: 2 * (28 + 98 + 26 + 4) * 2**-24 = 1.9e-5.
# PSNR is 10 log10 of a float32 ratio (4.3 dB per unit of relative error)
# whose squared-error sum rounds 26 + 2 times each side
SSIM_ATOL = 2 * (28 + 98 + 26 + 4) * 2.0 ** -24
PSNR_ATOL = 4.35 * 2 * (25 + 2) * 2.0 ** -24

# text phase: a seeded vocabulary of 5,000 words; WER at LibriSpeech
# test-clean size (2,620 utterances), BLEU at WMT newstest size (3,000
# segments, one reference each), ROUGE (stemmed) on 1,000 CNN/DailyMail-size
# summaries (3-4 highlight sentences of ~56 words together; the test split
# holds 11,490, cut to 1,000 for the script's time)
TEXT_VOCAB, LIBRISPEECH_UTTERANCES, NEWSTEST_SEGMENTS, CNNDM_SUMMARIES = 5000, 2620, 3000, 1000
TEXT_STEPS = {"wer": 262, "bleu": 100, "rouge": 100}
ROUGE_KEYS = ("rouge1", "rouge2", "rougeL", "rougeLsum")
# BLEU's value: four float32 logs and an exp, which the card's and the
# host's math libraries may each round an ulp apart: 4 * 2**-24 relative
BLEU_RTOL = 4 * 2.0 ** -24
# ROUGE means of 1,000 float32 per-sentence values summed in another order
# on each side: 2 * log2(1000) * 2**-24 relative
ROUGE_MEAN_RTOL = 2 * float(np.log2(CNNDM_SUMMARIES)) * 2.0 ** -24
# bertscore phase: bert-base-uncased width, 3,000 newstest pairs in 30
# update steps, padded to 128 tokens, embedded 64 sentences at a time
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512)
BERT_STEPS, BERT_MAX_LEN, BERT_BATCH, BERT_CHECK_PAIRS, ENCODER_REPS = 30, 128, 64, 64, 10
# P, R, F1 card vs CPU: each layer's outputs are float32 sums of up to 3,072
# products (log2 = 11.6 roundings), ordered differently by cuBLAS and the
# host, through 12 layers (layer norm keeps each at its scale): a hidden
# entry moves by up to 12 * 11.6 * 2**-24 = 8.3e-6 of its size; a cosine of
# unit vectors by twice that, and P, R, F1 are weighted means of cosines
BERT_ATOL = 2 * 12 * float(np.log2(3072)) * 2.0 ** -24
# audio phase: WSJ0-2mix's and wsj0-3mix's test ("tt") sets, 3,000 mixtures
# each at 8 kHz, cut to 32,000 samples (4 s; the sets' lengths vary), in 30
# steps of 100; one batch of 20 mixtures of 8 speakers takes the Hungarian path
WSJ_MIXTURES, WSJ_SAMPLES, WSJ_STEP = 3000, 32000, 100
HUNGARIAN_SPK, HUNGARIAN_MIXTURES = 8, 20
# a dB value, card vs CPU: 10 log10 of a ratio of float32 sums over 32,000
# samples (log2 = 15 roundings each; 4 sums with SI-SDR's alpha), the two
# sides erring in opposite directions, plus the cancellation in the noise
# (scaled target minus estimate, ~0.36 of the signal: 3 roundings' worth):
# 10 / ln(10) * 2 * (4 * 15 + 3) * 2**-24 = 3.3e-5 dB
AUDIO_DB_ATOL = 10 / float(np.log(10)) * 2 * (4 * float(np.log2(WSJ_SAMPLES)) + 3) * 2.0 ** -24
# sync phase's text metrics: WER over the first 524 utterances, BLEU over 600
# segments, ROUGE over 200 summaries, and the default BERTScore (idf) over
# 256 pairs, half of each on each rank
SYNC_TEXT = {"wer": 524, "bleu": 600, "rouge": 200}  # in _text_data's argument order
SYNC_BERT_PAIRS = 256


_START = time.perf_counter()


def _phase(name: str) -> None:
    print(f"== [{time.perf_counter() - _START:.1f} s] {name}", flush=True)


def _binned_inputs(n, c, t, seed, device, unsorted=False, target_dtype=np.float32, nan_thresholds=False,
                   inf_preds=False):
    """Preds with exact-threshold ties and NaNs planted, {0,1} targets;
    optionally unsorted thresholds with duplicates, NaN thresholds, and
    +inf / -inf preds."""
    from metrics_tpu_torch.utils.data import _linspace_like_reference

    rng = np.random.RandomState(seed)
    thresholds = _linspace_like_reference(t).numpy()
    preds = rng.rand(n, c).astype(np.float32)
    if n > 4:
        k = min(n // 4, t)
        preds[:k] = thresholds[rng.randint(0, t, (k, c))]
        preds[k, 0] = np.nan
    if inf_preds:
        preds[rng.rand(n, c) < 0.05] = np.inf
        preds[rng.rand(n, c) < 0.05] = -np.inf
    if unsorted:
        thresholds = np.concatenate([rng.permutation(thresholds), thresholds[:3]])
    if nan_thresholds:
        thresholds = rng.permutation(np.concatenate([thresholds, [np.nan, np.nan]]).astype(np.float32))
    target = (rng.rand(n, c) > 0.5).astype(target_dtype)
    return (torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device),
            torch.from_numpy(thresholds).to(device))


def _time_ms(fn, reps: int = 15, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _launch_only(preds, target, thr, design=None):
    """The bare C entry (its scratch memset and its kernel) on preallocated
    scratch and output, without the wrapper's checks and allocations, to
    separate the kernel's time from its wrapper's. ``design`` forces the
    histogram or the compare kernel."""
    from metrics_tpu_torch.ops import _build, binned_stats

    lib = _build.load_library()
    n, c = preds.shape
    t = thr.numel()
    chosen, tile, rows = binned_stats._plan(
        n, c, t, binned_stats._SMEM_OPTIN, binned_stats._sm_count(preds.device.index), design=design)
    nbytes = binned_stats._scratch_bytes(chosen, n, c, t, tile, rows)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=preds.device)
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)
    args = (preds.data_ptr(), target.data_ptr(), binned_stats._TARGET_KINDS[target.dtype], thr.data_ptr(),
            n, c, t, binned_stats._DESIGNS[chosen], tile, rows, scratch.data_ptr(), nbytes, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.binned_stats_launch(*args)
        assert err == 0, f"CUDA error {err}"

    return launch


def _device_profile(fn, calls: int = 20):
    """What one call of ``fn`` puts on the card, by ``torch.profiler``: the
    number of device operations (kernels, memsets, copies), their device time
    in ms, and their names; (None, None, []) when it traced none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return None, None, []
    device_ms = sum(e.time_range.elapsed_us() for e in ops) / calls / 1e3
    return len(ops) / calls, device_ms, sorted({e.name[:60] for e in ops})


def _bound(n: int, c: int, t: int):
    """Least time for the binned counts: each input read once (float32 preds
    and targets, thresholds), each output written once (three float32 [C, T]),
    against the compares the histogram needs: one bucket search of
    log2(T+1) float32 compares per element."""
    nbytes = 4 * (2 * n * c + t + 3 * c * t)
    ops = n * c * float(np.log2(t + 1))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _confusion_inputs(shape, classes, form, seed):
    """(preds, target) pairs made on the card, in copies that together exceed
    twice the L2, to be used in turn: softmax of standard normal logits with
    the true class's raised by 3, or their argmax as labels."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    positions = int(np.prod(shape)) // shape[1]
    one = 8 * positions + (4 * shape[1] * positions if form == "scores" else 8 * positions)
    out = []
    for _ in range(max(2, -(-2 * L2_BYTES // one))):
        target = torch.randint(0, classes, shape[:1] + shape[2:], generator=g, device="cuda")
        logits = torch.randn(shape, generator=g, device="cuda")
        logits.scatter_add_(1, target.unsqueeze(1), torch.full_like(target.unsqueeze(1), 3.0, dtype=logits.dtype))
        probs = torch.softmax(logits, dim=1)
        del logits
        out.append((probs if form == "scores" else probs.argmax(1), target))
    return out


def _cycle(fn, batches):
    """``fn`` as a call without arguments that takes the next batch each time."""
    state = {"i": 0}

    def call():
        p, t = batches[state["i"] % len(batches)]
        state["i"] += 1
        return fn(p, t)

    return call


def _confusion_bound(preds, target, classes):
    """Least time for the confusion counts: preds and targets read once, and
    the int64 cells a batch can touch, ``min(s, C*C)``, read and written once."""
    nbytes = (preds.numel() * preds.element_size() + target.numel() * target.element_size()
              + 16 * min(target.numel(), classes**2))
    return nbytes / HBM_BYTES_PER_S * 1e3


def _confusion_rows():
    """The confusion-count kernel at ``CONFUSION_SHAPES``, held bit for bit
    against its plain form and against the one-hot composition it replaced
    (run as a compiled replay runs it, value checks off), then timed with
    both: one dict a shape, and the largest count difference."""
    import importlib

    from metrics_tpu_torch.core.compiled import program_mode
    from metrics_tpu_torch.ops import confusion_counts

    cm = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")
    rows, max_err = {}, 0
    for seed, (name, (shape, classes, form)) in enumerate(CONFUSION_SHAPES.items()):
        batches = _confusion_inputs(shape, classes, form, seed)
        p0, t0 = batches[0]

        def kernel(p, t, classes=classes):
            return confusion_counts._confusion_counts_kernel(p, t, classes, classes)

        def composed(p, t, classes=classes):
            with program_mode():
                return cm._confusion_matrix_update_plain(p, t, classes)

        for p, t in batches[:2]:
            got, want = kernel(p, t), confusion_counts._confusion_counts_plain(p, t, classes, classes)
            max_err = max(max_err, int((got - want).abs().max()))
            assert torch.equal(got, want), f"confusion counts at {name} differ from the plain form"
            assert torch.equal(got, composed(p, t)), f"confusion counts at {name} differ from the composition"
            assert int(got.sum()) == t.numel(), f"confusion counts at {name} lost positions"
        ms, plain_ms = _time_ms(_cycle(kernel, batches)), _time_ms(_cycle(composed, batches))
        ops, device_ms, op_names = _device_profile(_cycle(kernel, batches))
        plain_ops, plain_device_ms, _ = _device_profile(_cycle(composed, batches))
        assert ops is None or ops <= 2, f"a kernel call put {ops} operations on the card: {op_names}"
        plan = confusion_counts._plan(not p0.is_floating_point(), p0.shape[0], 1 if form == "labels" else shape[1],
                                      t0.numel() // p0.shape[0], classes, confusion_counts._sm_count(0))
        bound_ms = _confusion_bound(p0, t0, classes)
        rows[name] = dict(
            shape=list(p0.shape), target=list(t0.shape), classes=classes, plan=list(plan), copies=len(batches),
            ms=ms, device_ms=device_ms, device_ops_per_call=ops, plain_ms=plain_ms, plain_device_ms=plain_device_ms,
            plain_device_ops_per_call=plain_ops, bound_ms=bound_ms,
        )
        share = "not measured" if device_ms is None else f"{100 * bound_ms / device_ms:.2f}% of it"
        print(f"confusion_counts {name} preds {tuple(p0.shape)} {p0.dtype} target {tuple(t0.shape)} {t0.dtype}, "
              f"{classes} classes, plan {plan}: kernel {ms:.5f} ms (CUDA events), device {device_ms} ms in {ops} "
              f"ops {op_names}; composition {plain_ms:.5f} ms, device {plain_device_ms} ms in {plain_ops} ops; "
              f"bound {bound_ms:.6f} ms (bytes), {share}; equal to the plain form and the composition")
        del batches
        torch.cuda.empty_cache()
    return rows, max_err


def _run_collection(make, batches, device, per_step=None):
    """One forward call per batch (and ``per_step(preds, target)`` in the
    same step, when given), then ``compute()``; returns the collection, its
    values, the host-clock ms of each step and of the compute, and what
    ``per_step`` returned at each step."""
    mc = make(device)
    preds, target = batches
    preds, target = preds.to(device), target.to(device)
    torch.cuda.synchronize()
    step_ms, extra = [], []
    for i in range(len(preds)):
        t0 = time.perf_counter()
        mc(preds[i], target[i])
        if per_step is not None:
            extra.append(per_step(preds[i], target[i]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    values = mc.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    _print_compile(f"{len(preds)} steps on {device}", mc)
    return mc, values, step_ms, compute_ms, extra


def _profile(make, batches, device, step_ms, steps=4, per_step=None):
    """Where a steady-state step's time goes: the device time of the kernels
    a step launches, against the unprofiled host-clock step ``step_ms``, and
    the host calls that take longest (these are inflated by the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mc = make(device)
    preds, target = batches[0].to(device), batches[1].to(device)
    mc(preds[0], target[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(1, steps + 1):
            mc(preds[i], target[i])
            if per_step is not None:
                per_step(preds[i], target[i])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    syncs = len(_sync_events(prof)) / steps
    if not kernels:
        print("profile: the profiler recorded no device activity (device busy share not measured)")
        return {"kernels_per_step": None, "busy_us": None, "syncs_per_step": syncs}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / steps
    print(f"device busy {busy_us:.2f} us/step in {len(kernels) / steps:.1f} kernels/step, {syncs:.1f} "
          f"cudaStreamSynchronize/step; the unprofiled step takes {step_ms * 1e3:.2f} us, so the device is idle "
          f"{100 * (1 - busy_us / (step_ms * 1e3)):.2f}% of it")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"  device {t / steps:8.2f} us/step {n / steps:5.1f}/step  {name[:90]}")
    rows = [r for r in prof.key_averages() if r.key != "Activity Buffer Request"]
    for r in sorted(rows, key=lambda r: -r.self_cpu_time_total)[:6]:
        print(f"  host   {r.self_cpu_time_total / steps:8.2f} us/step {r.count / steps:5.1f}/step  {r.key[:90]}")
    return {"kernels_per_step": len(kernels) / steps, "busy_us": busy_us, "syncs_per_step": syncs}


def _step_peak_mib(make, batch, device, per_step=None):
    """Device memory one step allocates at its peak above what was allocated
    before it (inputs on the card, a fresh collection), in MiB."""
    mc = make(device)
    preds, target = batch[0].to(device), batch[1].to(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mc(preds, target)
    if per_step is not None:
        per_step(preds, target)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _to_cpu(v):
    if isinstance(v, (list, tuple)):
        return [_to_cpu(x) for x in v]
    return v.detach().cpu()


def _check_values(name, got, want, atol=VALUE_ATOL):
    """Same shape, finite, equal (integers) or within ``atol`` (floats);
    returns the largest float difference."""
    got, want = _to_cpu(got), _to_cpu(want)
    if isinstance(want, list):
        assert len(got) == len(want), name
        return max([_check_values(name, g, w, atol) for g, w in zip(got, want)], default=0.0)
    assert got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}"
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite values {got}"
    if got.is_floating_point():
        err = float((got - want).abs().max()) if got.numel() else 0.0
        assert err <= atol, f"{name}: max abs err {err} > {atol}"
        return err
    assert torch.equal(got, want), f"{name}: {got} vs {want}"
    return 0.0


def _check_states(mc_gpu, mc_cpu):
    for (key, m_gpu), (_, m_cpu) in zip(mc_gpu.items(), mc_cpu.items()):
        for name, v in m_gpu._state.items():
            w = m_cpu._state[name]
            assert torch.equal(v.cpu(), w), f"state {key}.{name} differs between the card and the CPU"


def _run_updates(mc, batches, device):
    """``update`` per batch, host clock per step ending in a synchronize;
    returns the step times in ms."""
    preds, target = batches
    step_ms = []
    for i in range(len(preds)):
        t0 = time.perf_counter()
        mc.update(preds[i], target[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return step_ms


def _fresh_compute(mc):
    """``compute()`` again, not from the compute cache."""
    for m in mc.values():
        m._computed = None
    return mc.compute()


def _sync_events(prof):
    from torch.autograd import DeviceType

    # (the profiled code's own torch.cuda.synchronize() is a
    # cudaDeviceSynchronize, not counted)
    return [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name == "cudaStreamSynchronize"]


def _host_reads(prof):
    """``cudaStreamSynchronize`` calls and device-to-host copies a profile
    recorded."""
    from torch.autograd import DeviceType

    d2h = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "DtoH" in e.name)
    return len(_sync_events(prof)), d2h


def _sync_sources(prof, top=4):
    """The outermost operators that the synchronizations of a profile ran
    under, most frequent first."""
    counts = {}
    for e in _sync_events(prof):
        outer = e
        while getattr(outer, "cpu_parent", None) is not None:
            outer = outer.cpu_parent
        counts[outer.name] = counts.get(outer.name, 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]


def _profile_compute(mc):
    """Host clock of a first and a second uncached ``compute()`` (the first
    also grows the caching allocator), the host reads and device time of a
    third, and the peak device memory above what was allocated before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        values = _fresh_compute(mc)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fresh_compute(mc)
        torch.cuda.synchronize()
    syncs, d2h = _host_reads(prof)
    if syncs:
        print(f"  synchronizations inside compute() ran under {_sync_sources(prof)}")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return values, ms, peak_mib, syncs, d2h, device_ms, len(kernels)


def _profile_updates(make, batches, device, step_ms, steps=4):
    """Device busy share and kernels per ``update`` step, over ``steps``
    steps after a first one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mc = make(device)
    preds, target = batches
    mc.update(preds[0], target[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(1, steps + 1):
            mc.update(preds[i], target[i])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    syncs, d2h = _host_reads(prof)
    if not kernels:
        return "the profiler recorded no device activity (busy share not measured)"
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / steps
    return (f"device busy {busy_us:.2f} us/step in {len(kernels) / steps:.1f} kernels/step, "
            f"{syncs / steps:.1f} cudaStreamSynchronize and {d2h / steps:.1f} DtoH copies/step; the unprofiled "
            f"step takes {step_ms * 1e3:.2f} us, so the device is idle {100 * (1 - busy_us / (step_ms * 1e3)):.2f}%")


def _state_rows(v):
    """A cat state's rows: a CatBuffer's valid rows, a list's concatenation."""
    from metrics_tpu_torch.utils.data import dim_zero_cat

    return dim_zero_cat(v).cpu()


def _check_cat_states(mc_a, mc_b, what):
    for (key, m_a), (_, m_b) in zip(mc_a.items(), mc_b.items()):
        for name, v in m_a._state.items():
            w = m_b._state[name]
            if isinstance(v, torch.Tensor):
                assert torch.equal(v.cpu(), w.cpu()), f"state {key}.{name} differs ({what})"
            else:
                assert torch.equal(_state_rows(v), _state_rows(w)), f"state {key}.{name} differs ({what})"


def _report_data():
    """The report phase's 16 batches of [2048, 1000] probabilities and labels."""
    rng = np.random.RandomState(1)
    probs = torch.from_numpy(rng.rand(STEPS, BATCH, REPORT_CLASSES).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, REPORT_CLASSES, (STEPS, BATCH)))
    return probs, labels


def _report_collection(dev, compute_groups=True):
    from metrics_tpu_torch import (
        F1,
        CohenKappa,
        ConfusionMatrix,
        HammingDistance,
        MatthewsCorrcoef,
        MetricCollection,
        Precision,
        Recall,
        Specificity,
    )

    k = dict(num_classes=REPORT_CLASSES, device=dev)
    return MetricCollection({
        "prec": Precision(average="macro", **k),
        "rec": Recall(average="macro", **k),
        "f1": F1(average="macro", **k),
        "spec": Specificity(average="macro", **k),
        "confmat": ConfusionMatrix(REPORT_CLASSES, normalize="true", device=dev),
        "mcc": MatthewsCorrcoef(REPORT_CLASSES, device=dev),
        "kappa": CohenKappa(REPORT_CLASSES, device=dev),
        "hamming": HammingDistance(device=dev),
    }, compute_groups=compute_groups)


def _curve_data():
    """The curves phase's 24 batches of [2048, 1000] softmax probabilities of
    an informative model (the true class's logit raised by 3), and labels."""
    rng = np.random.RandomState(3)
    labels = rng.randint(0, CURVE_CLASSES, (CURVE_STEPS, BATCH))
    logits = rng.randn(CURVE_STEPS, BATCH, CURVE_CLASSES).astype(np.float32)
    np.put_along_axis(logits, labels[..., None], np.take_along_axis(logits, labels[..., None], -1) + 3, -1)
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    return probs, torch.from_numpy(labels)


def _ranking_collection(dev, capacity):
    """AUROC + AveragePrecision (macro, 1000 classes) with ``with_capacity``."""
    from metrics_tpu_torch import AUROC, AveragePrecision, MetricCollection

    k = dict(num_classes=CURVE_CLASSES, average="macro", device=dev)
    return MetricCollection({"auroc": AUROC(**k).with_capacity(capacity),
                             "ap": AveragePrecision(**k).with_capacity(capacity)})


def _curves_collection(dev, capacity=True):
    """AUROC + AveragePrecision (macro, 1000 classes; ``with_capacity`` in
    capacity mode) + CalibrationError(n_bins=15)."""
    from metrics_tpu_torch import AUROC, AveragePrecision, CalibrationError, MetricCollection

    k = dict(num_classes=CURVE_CLASSES, average="macro", device=dev)
    auroc, ap = AUROC(**k), AveragePrecision(**k)
    if capacity:
        auroc.with_capacity(CURVE_CAPACITY)
        ap.with_capacity(CURVE_CAPACITY)
    return MetricCollection({"auroc": auroc, "ap": ap, "ce": CalibrationError(n_bins=15, device=dev)})


def _curves_phase(smi, device):
    """The curves collection at ImageNet-1k width in capacity and list mode,
    and the binary curve metrics on 2^20 tied scores in both modes."""
    from metrics_tpu_torch import AUROC, ROC, AveragePrecision, CatBuffer, MetricCollection, PrecisionRecallCurve

    probs, labels = _curve_data()
    curves = _curves_collection

    print(f"{smi}; {CURVE_STEPS} update steps of [{BATCH}, {CURVE_CLASSES}] float32 softmax probabilities "
          f"(RandomState(3)), capacity {CURVE_CAPACITY}: 49,152 of the 50,000 ILSVRC-2012 validation images")
    batches = (probs.to(device), labels.to(device))
    torch.cuda.synchronize()
    results = {}
    for mode in ("capacity", "list"):
        make = (lambda dev: curves(dev)) if mode == "capacity" else (lambda dev: curves(dev, capacity=False))
        warm = make(device)  # warm-up: the first updates load the CUDA modules
        _run_updates(warm, (batches[0][:2], batches[1][:2]), device)
        if mode == "capacity":
            # (two batches leave classes without a positive, where a list-mode
            # curve raises; its compute is timed cold)
            warm.compute()
        del warm
        mc = make(device)
        step_ms = _run_updates(mc, batches, device)
        values, (cold_ms, compute_ms), peak_mib, syncs, d2h, device_ms, n_kernels = _profile_compute(mc)
        if mode == "capacity":
            assert all(isinstance(m.preds, CatBuffer) for m in (mc["auroc"], mc["ap"]))
        step = float(np.median(step_ms))
        print(f"{mode} mode: update step median {step:.4f} ms (max {max(step_ms):.4f}); compute first "
              f"{cold_ms:.4f} ms, again {compute_ms:.4f} ms "
              f"with {syncs} cudaStreamSynchronize and {d2h} DtoH copies, {n_kernels} device operations for "
              f"{device_ms:.4f} ms of device time; peak device memory of compute {peak_mib:.1f} MiB above its "
              f"inputs; values " + ", ".join(f"{k} {float(v):.7f}" for k, v in values.items()))
        print(f"  update steps: {_profile_updates(make, batches, device, step)}")
        _print_compile(f"curves, {mode} mode", mc)
        mc_cpu = make("cpu")
        for i in range(CURVE_STEPS):
            mc_cpu.update(probs[i], labels[i])
        t0 = time.perf_counter()
        values_cpu = mc_cpu.compute()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        _check_cat_states(mc, mc_cpu, f"{mode} mode, card vs CPU")
        atol = {"capacity": RANKING_ATOL, "list": CURVE_ATOL}[mode]
        errs = {k: _check_values(k, values[k], values_cpu[k], CE_ATOL if k == "ce" else atol) for k in values}
        print(f"  states equal to the CPU run; max abs err against it {errs} (CPU compute {cpu_ms:.1f} ms)")
        results[mode] = dict(values=values, step_ms=step, compute_ms=compute_ms, cold_ms=cold_ms, syncs=syncs,
                             d2h=d2h, peak_mib=peak_mib, device_ms=device_ms,
                             collection=mc if mode == "capacity" else None)  # the checkpoint phase's
        del mc, mc_cpu
    errs = {k: _check_values(k, results["capacity"]["values"][k], results["list"]["values"][k],
                             0.0 if k == "ce" else CURVE_ATOL) for k in results["list"]["values"]}
    print(f"capacity mode vs list mode on the card: max abs err {errs}; compute "
          f"{results['capacity']['compute_ms']:.4f} vs {results['list']['compute_ms']:.4f} ms, host reads "
          f"(syncs, DtoH) {results['capacity']['syncs']}, {results['capacity']['d2h']} vs "
          f"{results['list']['syncs']}, {results['list']['d2h']}")
    _nonfinite_calibration(device, probs[0], labels[0])
    del batches, probs, labels

    rng = np.random.RandomState(4)
    scores = np.round(rng.rand(BINARY_STEPS, BINARY_ROWS // BINARY_STEPS), 3).astype(np.float32)
    hits = (rng.rand(*scores.shape) < scores).astype(np.int64)
    scores, hits = torch.from_numpy(scores), torch.from_numpy(hits)

    def binary(dev, capacity=True):
        mc = MetricCollection({"auroc": AUROC(device=dev), "ap": AveragePrecision(device=dev),
                               "roc": ROC(pos_label=1, device=dev), "pr": PrecisionRecallCurve(pos_label=1, device=dev)})
        if capacity:
            for m in mc.values():
                m.with_capacity(BINARY_ROWS)
        return mc

    print(f"binary: {BINARY_ROWS} scores rounded to 1e-3 (1001 tie groups of ~1000), labels P(1) = score, "
          f"{BINARY_STEPS} updates")
    binary_values = {}
    for mode in ("capacity", "list"):
        mc = binary(device, capacity=mode == "capacity")
        _run_updates(mc, (scores.to(device), hits.to(device)), device)
        values, (cold_ms, compute_ms), peak_mib, syncs, d2h, device_ms, n_kernels = _profile_compute(mc)
        mc_cpu = binary("cpu", capacity=mode == "capacity")
        for i in range(BINARY_STEPS):
            mc_cpu.update(scores[i], hits[i])
        values_cpu = mc_cpu.compute()
        _check_cat_states(mc, mc_cpu, f"binary {mode} mode, card vs CPU")
        errs = {k: _check_values(k, values[k], values_cpu[k], RANKING_ATOL if k in ("auroc", "ap") else 0.0)
                for k in values}
        print(f"{mode} mode: compute first {cold_ms:.4f} ms, again {compute_ms:.4f} ms, {syncs} "
              f"cudaStreamSynchronize, {d2h} DtoH, "
              f"{n_kernels} device operations for {device_ms:.4f} ms, peak {peak_mib:.1f} MiB; auroc "
              f"{float(values['auroc']):.7f}, ap {float(values['ap']):.7f}, {len(values['roc'][0])} ROC points; "
              f"states equal to the CPU run, max abs err {errs} (curves exact)")
        binary_values[mode] = values
    errs = {k: _check_values(k, binary_values["capacity"][k], binary_values["list"][k],
                             CURVE_ATOL if k in ("auroc", "ap") else 0.0) for k in binary_values["list"]}
    print(f"binary capacity mode vs list mode: max abs err {errs}")
    return results


def _nonfinite_calibration(device, probs, labels):
    """CalibrationError with a NaN, a +inf and a -inf confidence planted:
    one [2048, 1000] batch with them in column 0 of rows 2, 5 and 7, and as
    binary scores its top-label confidences (the same three planted in rows
    2, 5 and 7) against the top label's correctness. Each lies in no bin and
    still counts in N, as in the JAX package (ROADMAP C.27), so every norm
    is finite; the card against the CPU run within CE_ATOL."""
    from metrics_tpu_torch import CalibrationError

    nonfinite = torch.tensor([float("nan"), float("inf"), float("-inf")])
    scores, correct = probs.amax(1), (probs.argmax(1) == labels).to(torch.int64)
    scores[[2, 5, 7]] = nonfinite
    probs = probs.clone()
    probs[[2, 5, 7], 0] = nonfinite
    forms = {"multiclass": (probs, labels), "binary": (scores, correct)}
    errs, values = {}, {}
    for form, (p, t) in forms.items():
        for norm in ("l1", "l2", "max"):
            card, cpu = CalibrationError(norm=norm, device=device), CalibrationError(norm=norm, device="cpu")
            card.update(p.to(device), t.to(device))
            cpu.update(p, t)
            got = card.compute()
            errs[f"{form} {norm}"] = _check_values(f"calibration {form} {norm}", got, cpu.compute(), CE_ATOL)
            values[f"{form} {norm}"] = float(got)
    print("calibration with NaN, +inf and -inf confidences planted: "
          + ", ".join(f"{k} {v:.7f}" for k, v in values.items())
          + f"; finite, card vs CPU max abs err {max(errs.values()):.3g} (bound {CE_ATOL})")


def _depth_data():
    """The regression phase's 16 batches of flattened depth maps: targets
    in 0.5-10 m, preds the targets times exp(N(0, 0.1)), both strictly
    positive (for the log error and the Gamma deviance)."""
    rng = np.random.RandomState(4)
    target = rng.uniform(0.5, 10.0, (REG_STEPS, DEPTH_PIXELS)).astype(np.float32)
    preds = (target * np.exp(rng.normal(0.0, 0.1, (REG_STEPS, DEPTH_PIXELS)))).astype(np.float32)
    return torch.from_numpy(preds), torch.from_numpy(target)


def _regression_collection(dev):
    from metrics_tpu_torch import (
        ExplainedVariance,
        MeanAbsoluteError,
        MeanAbsolutePercentageError,
        MeanSquaredError,
        MeanSquaredLogError,
        MetricCollection,
        PearsonCorrcoef,
        R2Score,
        SymmetricMeanAbsolutePercentageError,
        TweedieDevianceScore,
    )

    return MetricCollection({
        "mse": MeanSquaredError(device=dev),
        "rmse": MeanSquaredError(squared=False, device=dev),
        "mae": MeanAbsoluteError(device=dev),
        "msle": MeanSquaredLogError(device=dev),
        "mape": MeanAbsolutePercentageError(device=dev),
        "smape": SymmetricMeanAbsolutePercentageError(device=dev),
        "r2": R2Score(device=dev),
        "ev": ExplainedVariance(device=dev),
        "pearson": PearsonCorrcoef(device=dev),
        "tweedie": TweedieDevianceScore(power=2.0, device=dev),
    })


# the count states of the regression collection: equal, not close
REG_COUNTS = ("total", "num_observations", "n_obs", "n_total")


def _regression_bounds(preds, target):
    """Relative bounds of each float state and each value of the regression
    collection, card vs CPU, from REG_SUM_RTOL and float64 moments of this
    run's data (one step at a time on the host).

    - MSE, RMSE, MAE, MAPE, SMAPE and R2's sums: their elementwise ops are
      correctly rounded float32 on both sides, so only the sums differ.
    - ExplainedVariance's Σ(y - p) has terms of both signs: REG_SUM_RTOL
      times Σ|y - p| / |Σ(y - p)|.
    - MSLE: each log1p is within 1 ulp of exact on either side (values up
      to log1p(10) = 2.4, ulp 2**-22), so d = log1p(p) - log1p(y) moves by
      up to 4 * 2**-22 and d² by 2|d| times that: relative to mean d²,
      8 * 2**-22 * mean|d| / mean d².
    - Gamma deviance 2 (log(p/y) + y/p - 1): the log moves by up to 2 ulps
      of |log(p/y)| (2**-22 of it), doubled: 2**-21 * mean|log(p/y)| /
      mean deviance, plus an ulp of the result (2**-23).
    - R² and explained variance are 1 - a/b, b a difference of Σy² and
      (Σy)²/N, kappa = mean y² / var y times smaller than either: the value
      moves by |1 - v| * (1 + kappa) * REG_SUM_RTOL.
    - Pearson r = c / sqrt(vx vy), c, vx, vy streamed sums of products of
      one dominant sign: 3 * REG_SUM_RTOL of r."""
    acc = dict(abs_e=0.0, e=0.0, abs_d=0.0, d2=0.0, abs_log=0.0, dev=0.0, y=0.0, y2=0.0)
    for p, y in zip(preds.numpy(), target.numpy()):
        p, y = p.astype(np.float64), y.astype(np.float64)
        e, d, lr = y - p, np.log1p(p) - np.log1p(y), np.log(p / y)
        acc["abs_e"] += np.abs(e).sum()
        acc["e"] += e.sum()
        acc["abs_d"] += np.abs(d).sum()
        acc["d2"] += (d * d).sum()
        acc["abs_log"] += np.abs(lr).sum()
        acc["dev"] += (2 * (lr + y / p - 1)).sum()
        acc["y"] += y.sum()
        acc["y2"] += (y * y).sum()
    n = preds.numel()
    kappa = (acc["y2"] / n) / (acc["y2"] / n - (acc["y"] / n) ** 2)
    state = {name: REG_SUM_RTOL for name in (
        "mse.sum_squared_error", "rmse.sum_squared_error", "mae.sum_abs_error", "mape.sum_abs_per_error",
        "smape.sum_abs_per_error", "r2.sum_squared_error", "r2.sum_error", "r2.residual", "ev.sum_squared_error",
        "ev.sum_target", "ev.sum_squared_target", "pearson.mean_x", "pearson.mean_y")}
    state.update({f"pearson.{k}": 2 * REG_SUM_RTOL for k in ("var_x", "var_y", "corr_xy")})
    state["ev.sum_error"] = REG_SUM_RTOL * acc["abs_e"] / abs(acc["e"])
    state["msle.sum_squared_log_error"] = REG_SUM_RTOL + 8 * 2.0 ** -22 * acc["abs_d"] / acc["d2"]
    state["tweedie.sum_deviance_score"] = REG_SUM_RTOL + 2.0 ** -21 * acc["abs_log"] / acc["dev"] + 2.0 ** -23
    values = {k: state[f"{k}.{s}"] for k, s in (
        ("mse", "sum_squared_error"), ("rmse", "sum_squared_error"), ("mae", "sum_abs_error"),
        ("msle", "sum_squared_log_error"), ("mape", "sum_abs_per_error"), ("smape", "sum_abs_per_error"),
        ("tweedie", "sum_deviance_score"))}
    return state, values, kappa


def _check_regression(name, got, want, value_rtol, kappa):
    """One regression value against another within its bound (see
    ``_regression_bounds``); returns the absolute difference."""
    got, want = float(got), float(want)
    assert np.isfinite(got), f"{name}: {got}"
    if name in ("r2", "ev"):
        bound = abs(1 - want) * (1 + kappa) * REG_SUM_RTOL + 2.0 ** -23
    elif name == "pearson":
        bound = 3 * REG_SUM_RTOL * abs(want) + 2.0 ** -23
    else:
        bound = value_rtol[name] * abs(want) + 2.0 ** -23 * abs(want)
    err = abs(got - want)
    assert err <= bound, f"{name}: {got} vs {want}, |diff| {err} > bound {bound}"
    return err


def _check_regression_states(mc_a, mc_b, state_rtol, what):
    """Counts equal; every float state within its relative bound."""
    for key, m in mc_a.items():
        for name, v in m._state.items():
            w = mc_b[key]._state[name]
            v, w = v.cpu(), w.cpu()
            if name in REG_COUNTS:
                assert torch.equal(v.double(), w.double()), f"{key}.{name}: {v} vs {w} ({what})"
            else:
                rtol = state_rtol[f"{key}.{name}"]
                err = float((v.double() - w.double()).abs().max() / w.double().abs().max())
                assert err <= rtol, f"{key}.{name}: relative diff {err} > {rtol} ({what})"


def _regression_phase(device):
    """The regression collection at NYU Depth v2 test size, against the same
    run on the CPU; returns its data, the collection run on the card, its
    values, the bounds and the median step time."""
    from metrics_tpu_torch.ops import binned_stats

    preds, target = _depth_data()
    print(f"{REG_STEPS} forward steps of [{DEPTH_PIXELS}] float32 depths ({DEPTH_BATCH} maps of "
          f"{DEPTH_HW[0]}x{DEPTH_HW[1]}; RandomState(4), targets 0.5-10 m, preds x exp(N(0, 0.1))): 128 of the "
          f"654 NYU Depth v2 test images, {preds.numel():,} values")
    _run_collection(_regression_collection, (preds[:2], target[:2]), device)  # warm-up
    binned_stats.KERNEL_LAUNCHES = 0
    mc_gpu, v_gpu, step_ms, compute_ms, _ = _run_collection(_regression_collection, (preds, target), device)
    assert binned_stats.KERNEL_LAUNCHES == 0  # no hand kernel lies on this path
    t0 = time.perf_counter()
    mc_cpu, v_cpu, _, _, _ = _run_collection(_regression_collection, (preds, target), "cpu")
    cpu_s = time.perf_counter() - t0
    assert mc_gpu.compute_group_keys == []  # regression declares no update_identity
    state_rtol, value_rtol, kappa = _regression_bounds(preds, target)
    _check_regression_states(mc_gpu, mc_cpu, state_rtol, "card vs CPU")
    assert int(mc_gpu["mse"].total) == REG_STEPS * DEPTH_PIXELS
    errs = {k: _check_regression(k, v_gpu[k], v_cpu[k], value_rtol, kappa) for k in v_cpu}
    step = float(np.median(step_ms))
    print(f"forward step on the card (host clock, after a warm-up run): median {step:.4f} ms, max "
          f"{max(step_ms):.4f} ms; compute {compute_ms:.4f} ms; states equal to the CPU run (counts exact, float "
          f"states within their bounds); max abs err of values against it {errs} (CPU run {cpu_s:.1f} s); "
          f"values " + ", ".join(f"{k} {float(v):.7f}" for k, v in v_gpu.items()))
    print(f"peak device memory of a step above its inputs: "
          f"{_step_peak_mib(_regression_collection, (preds[0], target[0]), device):.1f} MiB")
    return (preds, target), mc_gpu, v_gpu, (state_rtol, value_rtol, kappa), step


def _sts_data():
    """The regression-cat phase's 24 batches: [2048, 768] embedding pairs
    with a cosine of about 0.6, and per pair its cosine (computed once, on the
    host) and an STS-B-style gold score on 0-5 in steps of 0.2."""
    rng = np.random.RandomState(5)
    a = rng.normal(0.0, 1.0, (CAT_STEPS, BATCH, EMBED_DIM)).astype(np.float32)
    b = (0.75 * a + rng.normal(0.0, 1.0, a.shape)).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    cos = ((a64 * b64).sum(-1) / np.sqrt((a64 * a64).sum(-1) * (b64 * b64).sum(-1))).astype(np.float32)
    del a64, b64
    z = (cos - cos.mean()) / cos.std()
    gold = np.clip(np.round((2.5 + 1.2 * z + rng.normal(0.0, 0.8, z.shape)) / 0.2) * 0.2, 0.0, 5.0)
    gold = gold.astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(cos), torch.from_numpy(gold)


def _regression_cat_phase(device):
    """SpearmanCorrcoef and CosineSimilarity(mean), in list mode and with
    ``with_capacity(49152)``, 24 ``update`` steps each, against the CPU."""
    from metrics_tpu_torch import CatBuffer, CosineSimilarity, MetricCollection, SpearmanCorrcoef

    a, b, cos, gold = _sts_data()
    ties = len(torch.unique(gold))
    print(f"{CAT_STEPS} update steps of {BATCH} pairs: CosineSimilarity(mean) on [{BATCH}, {EMBED_DIM}] float32 "
          f"embedding pairs (BERT-base width; RandomState(5)), {2 * a.numel() * 4 / 1e6:.0f} MB of cat state at "
          f"{CAT_CAPACITY} rows; SpearmanCorrcoef of the pairs' cosines against gold scores in steps of 0.2 on "
          f"0-5 ({ties} distinct gold values over {gold.numel()} pairs)")

    def spearman(dev, capacity=True):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the memory-footprint warning
            m = SpearmanCorrcoef(device=dev)
        return MetricCollection({"spearman": m.with_capacity(CAT_CAPACITY) if capacity else m})

    def cosine(dev, capacity=True):
        m = CosineSimilarity(reduction="mean", device=dev)
        return MetricCollection({"cosine": m.with_capacity(CAT_CAPACITY) if capacity else m})

    for name, make, data, atol in (("cosine", cosine, (a, b), COSINE_ATOL),
                                   ("spearman", spearman, (cos, gold), SPEARMAN_ATOL)):
        batches = (data[0].to(device), data[1].to(device))
        torch.cuda.synchronize()
        values = {}
        for mode in ("capacity", "list"):
            mk = (lambda dev, m=make: m(dev)) if mode == "capacity" else (lambda dev, m=make: m(dev, capacity=False))
            warm = mk(device)  # warm-up: the first updates load the CUDA modules
            _run_updates(warm, (batches[0][:2], batches[1][:2]), device)
            warm.compute()
            del warm
            mc = mk(device)
            step_ms = _run_updates(mc, batches, device)
            value, (cold_ms, compute_ms), peak_mib, syncs, d2h, device_ms, n_kernels = _profile_compute(mc)
            # the profiler may record none of a compute's kernels: CUDA events
            # around back-to-back computes give its time on the card too
            event_ms = _time_ms(lambda: _fresh_compute(mc), reps=5, inner=5)
            if mode == "capacity":
                assert isinstance(mc[name].preds, CatBuffer) and len(mc[name].preds) == CAT_CAPACITY
            mc_cpu = mk("cpu")
            for i in range(CAT_STEPS):
                mc_cpu.update(data[0][i], data[1][i])
            t0 = time.perf_counter()
            value_cpu = mc_cpu.compute()
            cpu_ms = (time.perf_counter() - t0) * 1e3
            _check_cat_states(mc, mc_cpu, f"{name} {mode} mode, card vs CPU")
            err = _check_values(name, value[name], value_cpu[name], atol)
            step = float(np.median(step_ms))
            _print_compile(f"{name}, {mode} mode", mc)
            print(f"{name}, {mode} mode: update step median {step:.4f} ms (max {max(step_ms):.4f}); compute first "
                  f"{cold_ms:.4f} ms, again {compute_ms:.4f} ms with {syncs} cudaStreamSynchronize and {d2h} DtoH "
                  f"copies, {n_kernels} device operations for {device_ms:.4f} ms of device time (torch.profiler), "
                  f"{event_ms:.4f} ms a compute by CUDA events over 5 back-to-back; peak device memory "
                  f"of compute {peak_mib:.1f} MiB above its inputs; value {float(value[name]):.7f}; states equal to "
                  f"the CPU run, max abs err against it {err} (bound {atol:.2e}; CPU compute {cpu_ms:.1f} ms)")
            print(f"  update steps: {_profile_updates(mk, batches, device, step)}")
            values[mode] = value[name]
            del mc, mc_cpu
        assert torch.equal(values["capacity"], values["list"]), f"{name}: capacity mode differs from list mode"
        print(f"{name}: capacity mode equal to list mode on the card, bit for bit")
        del batches


def _msmarco_data():
    """The retrieval phase's 70 update batches (scores, relevance labels,
    query ids): 100 queries of 1,000 candidates each, the last batch 80. Query ids are drawn without replacement from [0, 1,102,432); 14% of
    the queries have no relevant candidate, 80% one and 6% two (BM25's top
    1000 misses about 14% of the dev queries); scores are N(0, 1), plus 1.5
    on relevant rows, rounded to 1/256 so that ties (and -0.0) are common."""
    rng = np.random.RandomState(6)
    qids = rng.choice(MSMARCO_QID_RANGE, MSMARCO_QUERIES, replace=False)
    n_rel = rng.choice(3, MSMARCO_QUERIES, p=[0.14, 0.80, 0.06])
    first = rng.randint(0, MSMARCO_DEPTH, MSMARCO_QUERIES)
    second = (first + 1 + rng.randint(0, MSMARCO_DEPTH - 1, MSMARCO_QUERIES)) % MSMARCO_DEPTH
    target = np.zeros((MSMARCO_QUERIES, MSMARCO_DEPTH), np.int64)
    rows = np.arange(MSMARCO_QUERIES)
    target[rows[n_rel >= 1], first[n_rel >= 1]] = 1
    target[rows[n_rel == 2], second[n_rel == 2]] = 1
    scores = rng.standard_normal((MSMARCO_QUERIES, MSMARCO_DEPTH)).astype(np.float32) + np.float32(1.5) * target
    scores = (np.round(scores * 256) / 256).astype(np.float32)
    indexes = np.repeat(qids, MSMARCO_DEPTH)
    flat = [torch.from_numpy(x.reshape(-1)) for x in (scores, target, indexes)]
    step = MSMARCO_STEP_QUERIES * MSMARCO_DEPTH
    return [tuple(x[i * step:(i + 1) * step] for x in flat) for i in range(MSMARCO_STEPS)]


def _retrieval_members(dev, capacity=None):
    """The seven re-ranking metrics: MRR, MAP, nDCG@10, P@10, R@100,
    fall-out@100 and MAP skipping queries with no relevant candidate; with
    ``capacity``, each with ``num_queries`` and CatBuffer states of its own."""
    from metrics_tpu_torch import (
        RetrievalFallOut,
        RetrievalMAP,
        RetrievalMRR,
        RetrievalNormalizedDCG,
        RetrievalPrecision,
        RetrievalRecall,
    )

    k = dict(device=dev, num_queries=MSMARCO_QUERIES if capacity else None)
    members = {"mrr": RetrievalMRR(**k), "map": RetrievalMAP(**k), "ndcg10": RetrievalNormalizedDCG(k=10, **k),
               "p10": RetrievalPrecision(k=10, **k), "r100": RetrievalRecall(k=100, **k),
               "fallout100": RetrievalFallOut(k=100, **k), "map_skip": RetrievalMAP(empty_target_action="skip", **k)}
    if capacity:
        for m in members.values():
            m.with_capacity(capacity)
    return members


def _retrieval_collection(dev, capacity=None):
    """The seven metrics over one grouping: list mode, or ``num_queries`` and
    ``with_capacity(capacity)``."""
    from metrics_tpu_torch import RetrievalCollection

    rc = RetrievalCollection(_retrieval_members(dev), num_queries=MSMARCO_QUERIES if capacity else None, device=dev)
    return rc.with_capacity(capacity) if capacity else rc


def _profile_call(fn, reps=5, top=8):
    """One call of ``fn`` (a ``compute()``): its time by CUDA events (median
    of ``reps`` after a warm-up), its peak device memory above what was
    allocated before, and, by ``torch.profiler``, its device operations,
    their device time, its host reads and the device operations that take
    the most time, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    values = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        values = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    syncs, d2h = _host_reads(prof)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in ops:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return values, dict(event_ms=float(np.median(times)), event_ms_all=times, peak_mib=peak_mib, syncs=syncs,
                        d2h=d2h, ops=len(ops), device_ms=sum(e.time_range.elapsed_us() for e in ops) / 1e3,
                        top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top])


def _print_profile(what, p):
    device = "not measured (the profiler recorded no device operation)" if not p["ops"] else (
        f"{p['ops']} device operations for {p['device_ms']:.4f} ms of device time")
    print(f"  {what}: compute() {p['event_ms']:.4f} ms by CUDA events (median of "
          f"{[round(t, 4) for t in p['event_ms_all']]}); {device}; {p['syncs']} cudaStreamSynchronize and "
          f"{p['d2h']} DtoH copies; peak device memory {p['peak_mib']:.1f} MiB above its inputs")
    for name, (ms, n) in p["top"]:
        print(f"    device {ms:9.4f} ms in {n:4d} op(s)  {name[:100]}")


def _fresh(metric):
    """``compute()`` again, not from the compute cache."""
    metric._computed = None
    return metric.compute()


def _retrieval_phase(smi, device):
    """The retrieval collection at MS MARCO passage dev size in list mode and
    in capacity mode, against the CPU run, the two modes against each other
    and the collection against its seven members alone; times and profiles
    ``compute()``: one grouping sort for seven metrics against seven.
    Returns the capacity-mode collection and its values."""
    data = _msmarco_data()
    n_rel = sum(int(t.sum()) for _, t, _ in data)
    print(f"{smi}; {MSMARCO_STEPS} update steps of {MSMARCO_STEP_QUERIES} queries x {MSMARCO_DEPTH} candidates "
          f"(the last {len(data[-1][0]) // MSMARCO_DEPTH} queries; RandomState(6)): {MSMARCO_ROWS} rows, {n_rel} "
          f"relevant; query ids from [0, {MSMARCO_QID_RANGE})")
    batches = [tuple(x.to(device) for x in step) for step in data]
    torch.cuda.synchronize()

    def run_updates(metrics):
        step_ms = []
        for preds, target, indexes in batches:
            t0 = time.perf_counter()
            for m in metrics:
                m.update(preds, target, indexes=indexes)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return step_ms

    warm = _retrieval_collection(device)  # warm-up: the first calls load the CUDA modules
    warm.update(*batches[0][:2], indexes=batches[0][2])
    warm.compute()
    del warm
    runs = {}
    for mode, capacity in (("list", None), ("capacity", MSMARCO_ROWS)):
        rc = _retrieval_collection(device, capacity)
        step_ms = run_updates([rc])
        values, prof = _profile_call(lambda: _fresh(rc))
        runs[mode] = dict(collection=rc, values=values, prof=prof, step_ms=float(np.median(step_ms)))
        print(f"{mode} mode: update step median {np.median(step_ms):.4f} ms (max {max(step_ms):.4f}); values "
              + ", ".join(f"{k} {float(v):.7f}" for k, v in values.items()))
        _print_compile(f"retrieval, {mode} mode", rc)
        _print_profile("the collection (one grouping sort)", prof)
    for k in runs["list"]["values"]:
        assert torch.equal(runs["list"]["values"][k], runs["capacity"]["values"][k]), \
            f"{k}: capacity mode differs from list mode on the card"
    print("capacity mode equal to list mode on the card, bit for bit")
    del runs["list"]["collection"]

    members = _retrieval_members(device, MSMARCO_ROWS)
    member_step_ms = run_updates(list(members.values()))
    alone, prof = _profile_call(lambda: {k: _fresh(m) for k, m in members.items()})
    for k, v in alone.items():
        assert torch.equal(v, runs["capacity"]["values"][k]), f"{k}: the collection differs from its member alone"
    print(f"the seven members alone (capacity mode, seven grouping sorts): update step of all seven median "
          f"{np.median(member_step_ms):.4f} ms; values equal to the collection's bit for bit")
    _print_profile("seven members alone", prof)
    runs["members"] = dict(prof=prof, step_ms=float(np.median(member_step_ms)))
    del members, alone

    rc_cpu = _retrieval_collection("cpu")
    for preds, target, indexes in data:
        rc_cpu.update(preds, target, indexes=indexes)
    t0 = time.perf_counter()
    values_cpu = rc_cpu.compute()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for name in ("indexes", "preds", "target"):
        assert torch.equal(_state_rows(getattr(runs["capacity"]["collection"], name)),
                           _state_rows(getattr(rc_cpu, name))), f"retrieval state {name} differs from the CPU run"
    for mode in ("list", "capacity"):
        errs = {k: _check_values(k, runs[mode]["values"][k], v, RETRIEVAL_ATOL) for k, v in values_cpu.items()}
        print(f"{mode} mode against the CPU run (compute {cpu_ms:.1f} ms there): states equal, max abs err {errs} "
              f"(bound {RETRIEVAL_ATOL:.3g})")
    del rc_cpu, batches
    return runs


def _state_leaves(metric):
    """``{name: state}`` of a metric, or of every member of a collection."""
    from metrics_tpu_torch import MetricCollection

    pairs = metric.items() if isinstance(metric, MetricCollection) else [("", metric)]
    return {f"{k}.{n}": v for k, m in pairs for n, v in m._state.items()}


def _assert_states_equal(a, b, what):
    from metrics_tpu_torch import CatBuffer

    sa, sb = _state_leaves(a), _state_leaves(b)
    assert sorted(sa) == sorted(sb), what
    for k, v in sa.items():
        w = sb[k]
        if isinstance(v, CatBuffer):
            assert isinstance(w, CatBuffer) and (v.capacity, v.count, v.overflowed) == (w.capacity, w.count, w.overflowed)
            v, w = v.values(), w.values()
        elif isinstance(v, list):
            assert len(v) == len(w), f"{what}: {k}"
            v, w = torch.cat([x.reshape(-1) for x in v]), torch.cat([x.reshape(-1) for x in w])
        assert v.dtype == w.dtype and v.device == w.device and torch.equal(v, w), f"{what}: state {k} differs"


@contextlib.contextmanager
def _call_spans(**targets):
    """Wraps each ``module.function`` of ``targets`` ({label: (module,
    name)}) for the block's duration: every call appends its (start, end) on
    ``time.perf_counter`` to ``spans[label]``."""
    spans = {label: [] for label in targets}
    saved = []
    for label, (module, name) in targets.items():
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _out=spans[label], **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                _out.append((t0, time.perf_counter()))

        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield spans
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _span_s(spans):
    return sum(b - a for a, b in spans)


def _checkpoint_phase(device, curves_mc, retrieval_rc):
    """Snapshots of the curves collection (capacity mode, one [49152, 1000]
    state per compute group) and of the retrieval collection (capacity mode,
    6.98M rows), loaded into fresh metrics on the card: states bit-equal,
    ``compute()`` equal. Times the public ``save_checkpoint`` and
    ``load_checkpoint``; the split of a save comes from timing every
    ``zlib.crc32`` and ``os.fsync`` call they make: the leaves' CRCs, then
    the header's CRC just before the file is written, so the time up to the
    last CRC less the CRCs is the copy to the host (with the manifest), and
    the time after it the write, its fsyncs and the rename. Holds a
    corrupted file to ``CheckpointCorruptError`` before any state changes."""
    import shutil
    import zlib

    from metrics_tpu_torch import load_checkpoint, save_checkpoint
    from metrics_tpu_torch.utils.exceptions import CheckpointCorruptError

    def fresh_curves():
        mc = _curves_collection(device)
        # AUROC latches its input mode at the first update
        mc.update(curves_mc["auroc"].preds.values()[:BATCH], curves_mc["auroc"].target.values()[:BATCH])
        mc.reset()
        return mc

    timed = dict(crc=(zlib, "crc32"), fsync=(os, "fsync"))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        paths = {}
        for name, metric, make in (("curves", curves_mc, fresh_curves),
                                   ("retrieval", retrieval_rc, lambda: _retrieval_collection(device, MSMARCO_ROWS))):
            directory = os.path.join(root, name)
            torch.cuda.synchronize()
            with _call_spans(**timed) as spans:
                t0 = time.perf_counter()
                path = save_checkpoint(metric, directory, step=0, rank=0, world=1)
                t1 = time.perf_counter()
            save_ms = (t1 - t0) * 1e3
            crc_s, fsync_s = _span_s(spans["crc"]), _span_s(spans["fsync"])
            packed = spans["crc"][-1][1]  # the header's CRC: the bytes are ready
            copy_ms = ((packed - t0) - crc_s) * 1e3
            write_ms = (t1 - packed) * 1e3
            nbytes = os.path.getsize(path)
            target = make()
            torch.cuda.synchronize()
            with _call_spans(**timed) as spans:
                t0 = time.perf_counter()
                load_checkpoint(target, directory, step=0, rank=0, world=1)
                torch.cuda.synchronize()
                load_ms = (time.perf_counter() - t0) * 1e3
            load_crc_ms = _span_s(spans["crc"]) * 1e3
            _assert_states_equal(metric, target, f"{name} checkpoint round trip")
            want, got = (_fresh_compute(metric), _fresh_compute(target)) if name == "curves" else (
                _fresh(metric), _fresh(target))
            for k, v in want.items():
                assert torch.equal(got[k], v), f"{name}: {k} after the round trip differs"
            mb = nbytes / 1e6
            print(f"{name}: {nbytes} bytes; save {save_ms:.2f} ms ({mb / save_ms * 1e3:.1f} MB/s): copy to the host "
                  f"and manifest {copy_ms:.2f} ms ({mb / copy_ms * 1e3:.1f} MB/s), CRC {crc_s * 1e3:.2f} ms "
                  f"({mb / crc_s:.1f} MB/s), write + fsync + rename {write_ms:.2f} ms "
                  f"({mb / write_ms * 1e3:.1f} MB/s; fsyncs {fsync_s * 1e3:.2f} ms); load {load_ms:.2f} ms "
                  f"({mb / load_ms * 1e3:.1f} MB/s): CRC {load_crc_ms:.2f} ms, read + decode + copy to the card "
                  f"{load_ms - load_crc_ms:.2f} ms; loaded on "
                  f"{target.device if name == 'retrieval' else target['auroc'].device}: states bit-equal, "
                  "compute() equal")
            paths[name] = (directory, path, target)
        directory, path, target = paths["retrieval"]
        corrupt = os.path.join(root, "corrupt")
        shutil.copytree(directory, corrupt)
        corrupt_path = os.path.join(corrupt, os.path.relpath(path, directory))
        blob = bytearray(open(corrupt_path, "rb").read())
        blob[len(blob) // 2] ^= 0x10  # one payload byte
        with open(corrupt_path, "wb") as f:
            f.write(blob)
        before = _retrieval_collection(device, MSMARCO_ROWS)
        before.merge_state(target)
        try:
            load_checkpoint(target, corrupt, rank=0, world=1)
            raise AssertionError("a flipped payload byte loaded without an error")
        except CheckpointCorruptError as err:
            raised = f"{type(err).__name__}: {str(err).split(': ', 1)[-1]}"
        _assert_states_equal(before, target, "the target of the corrupted load")
        print(f"one payload byte flipped: raised {raised}; the target's states unchanged")
        counts = {}
        for name, metric in (("curves", curves_mc), ("retrieval", retrieval_rc)):
            snap = metric.telemetry()
            saved = snap.get("collection", snap)["checkpoint"]
            snap = paths[name][2].telemetry()
            loaded = snap.get("collection", snap)["checkpoint"]
            assert (saved["saves"], saved["loads"]) == (1, 0), (name, saved)
            assert (loaded["saves"], loaded["loads"]) == (0, 1), (name, loaded)  # the corrupted load counts none
            counts[name] = {"saved": saved["saves"], "loaded": loaded["loads"]}
        print(f"telemetry()['checkpoint'] counts each save and each verified load: {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _synced_rows(mc):
    """Every state of a collection on the host: a tensor as it is, a cat
    state's rows."""
    return {f"{k}.{n}": v.cpu() if isinstance(v, torch.Tensor) else _state_rows(v)
            for k, m in mc.items() for n, v in m._state.items()}


def _fid_sync_data():
    """Inception-like features (non-negative, as after a relu and an average
    pool) for the sync phase's streaming FID, from RandomState(10)."""
    rng = np.random.RandomState(10)
    shape = (FID_SYNC_STEPS, FID_SYNC_BATCH, FID_SYNC_DIM)
    real = np.abs(rng.standard_normal(shape)).astype(np.float32)
    fake = (np.abs(rng.standard_normal(shape)) * 1.1 + 0.05).astype(np.float32)
    return torch.from_numpy(real), torch.from_numpy(fake)


def _fid_corrected(fid):
    """A streaming FID's Kahan-corrected sums (``total - comp``) on the host."""
    return {f"{side}_{base}": (getattr(fid, f"{side}_{base}") - getattr(fid, f"{side}_{base}_comp")).cpu()
            for side in ("real", "fake") for base in ("sum", "outer")}


OVERLAP_STEPS, OVERLAP_EVERY = 32, 8


def _overlap_rank(rank, world, device, out_dir):
    """The report collection on this rank's half of the report batches
    (cycled), ``OVERLAP_STEPS`` steps with a ``compute()`` every
    ``OVERLAP_EVERY``, under ``sync_mode="blocking"`` and ``"overlap"``:
    per-step and per-compute ms, the values served, the ``sync`` ledger; then
    a checkpoint snapshot with a round in flight, which must be refused."""
    import torch.distributed as dist

    from metrics_tpu_torch import save_checkpoint
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    probs, labels = _report_data()
    share = slice(rank * STEPS // world, (rank + 1) * STEPS // world)
    probs, labels = probs[share].to(device), labels[share].to(device)
    out = {}
    for mode in ("blocking", "overlap", "overlap", "blocking"):  # in turns; the second of each is kept
        mc = _report_collection(device)
        mc.sync_mode = mode
        values, step_ms, compute_ms = [], [], []
        dist.barrier()
        torch.cuda.synchronize()
        for i in range(OVERLAP_STEPS):
            t0 = time.perf_counter()
            mc.update(probs[i % len(probs)], labels[i % len(probs)])
            due = (i + 1) % OVERLAP_EVERY == 0
            if due:
                values.append({k: v.clone() for k, v in mc.compute().items()})
            torch.cuda.synchronize()
            (compute_ms if due else step_ms).append((time.perf_counter() - t0) * 1e3)
        record = {"values": [{k: v.cpu() for k, v in vals.items()} for vals in values],
                  "step_ms": float(np.median(step_ms)), "compute_step_ms": compute_ms}
        if mode == "overlap":
            # the last compute() launched the next round: a snapshot while it
            # holds the accumulation is refused
            assert mc.__dict__["_inflight_round"] is not None
            try:
                save_checkpoint(mc, os.path.join(out_dir, "ckpt", f"overlap{rank}"), step=0)
                record["snapshot"] = "no error"
            except MetricsTPUUserError as err:
                record["snapshot"] = f"refused: {str(err)[:80]}"
            mc.unsync()  # cancel: drain and fold back
            record["stats"] = mc.sync_stats()["collection"]
        out[mode] = record
        del mc
    return out


def _sync_rank(rank, world, port_no, out_dir, device):
    """One rank of the sync phase, a process of its own, with its states on
    ``device`` (``cuda:0`` for every rank)."""
    import torch.distributed as dist

    from metrics_tpu_torch import Precision, save_checkpoint
    from metrics_tpu_torch.parallel import sync as sync_mod
    from metrics_tpu_torch.utils.exceptions import StateDivergenceError

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port_no}", world_size=world, rank=rank)
    try:
        from metrics_tpu_torch import observability as obs

        obs.enable()  # the journal of the whole phase, rank from the process group
        out = {"backend": dist.get_backend()}
        rounds = []
        raw_sync = sync_mod.host_sync_state

        def counting_sync(*args, **kwargs):
            rounds.append(kwargs.get("metric_name"))
            return raw_sync(*args, **kwargs)

        sync_mod.host_sync_state = counting_sync
        gathers = []
        raw = sync_mod._all_gather

        def counting(x, group):
            gathers.append(x.numel() * x.element_size())
            return raw(x, group)

        sync_mod._all_gather = counting

        def timed_sync(mc, fused):
            """Collectives, bytes put in, host ms and synced states of one
            collection sync, fused or per leaf."""
            os.environ["METRICS_TPU_FUSED_SYNC"] = "1" if fused else "0"
            dist.barrier()
            torch.cuda.synchronize()
            gathers.clear()
            t0 = time.perf_counter()
            mc.sync()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            assert all(m._is_synced for m in mc.values())
            states = _synced_rows(mc)
            mc.unsync()
            os.environ.pop("METRICS_TPU_FUSED_SYNC")
            return {"collectives": len(gathers), "bytes": sum(gathers), "ms": ms}, states

        for name, (data, make, steps) in {
            "report": (_report_data, lambda: _report_collection(device), STEPS),
            "ranking": (_curve_data, lambda: _ranking_collection(device, CURVE_CAPACITY // world), CURVE_STEPS),
            "regression": (_depth_data, lambda: _regression_collection(device), REG_STEPS),
        }.items():
            probs, labels = data()
            share = slice(rank * steps // world, (rank + 1) * steps // world)
            probs, labels = probs[share].to(device), labels[share].to(device)
            mc = make()
            for i in range(len(probs)):
                mc.update(probs[i], labels[i]) if name == "ranking" else mc(probs[i], labels[i])
            del probs, labels
            runs = {}
            for fused in (True, False, False, True):  # in turns; the second of each is kept
                runs[fused] = timed_sync(mc, fused)
            assert all(torch.equal(runs[True][1][k], runs[False][1][k]) for k in runs[True][1]), \
                f"{name}: the fused sync's states differ from the per-leaf sync's"
            gathers.clear()
            values = mc.compute()  # syncs once, through the fused path
            out[name] = {"groups": mc.compute_group_keys, "fused": runs[True][0], "per_leaf": runs[False][0],
                         "compute_collectives": len(gathers), "states": runs[True][1],
                         "values": {k: v.cpu() for k, v in values.items()}, "sync_stats": mc.sync_stats(),
                         "compile": _compile_summary(mc)}
            if name != "regression":
                # this rank's shard (rank and world from the process group)
                save_checkpoint(mc, os.path.join(out_dir, "ckpt", name), step=0)
            del mc

        # the overlap part runs with the journal off: its background lane's
        # events interleave with the step's own in a per-rank order
        obs.disable()
        n_rounds = len(rounds)
        out["overlap"] = _overlap_rank(rank, world, device, out_dir)
        out["overlap"]["rounds"] = len(rounds) - n_rounds
        del rounds[n_rounds:]
        obs.enable()

        # retrieval: half of the queries on each rank, capacity mode
        data = _msmarco_data()
        share = data[rank * MSMARCO_STEPS // world:(rank + 1) * MSMARCO_STEPS // world]
        # one capacity on every rank (a sync merges into world x capacity rows)
        rc = _retrieval_collection(device, -(-MSMARCO_STEPS // world) * MSMARCO_STEP_QUERIES * MSMARCO_DEPTH)
        for preds, target, indexes in share:
            rc.update(preds.to(device), target.to(device), indexes=indexes.to(device))
        del data, share
        dist.barrier()
        torch.cuda.synchronize()
        gathers.clear()
        t0 = time.perf_counter()
        values = rc.compute()  # syncs the 3 cat states through the header and the bucketed plan
        torch.cuda.synchronize()
        out["retrieval"] = {"ms": (time.perf_counter() - t0) * 1e3, "collectives": len(gathers),
                            "bytes": sum(gathers), "values": {k: v.cpu() for k, v in values.items()}}
        save_checkpoint(rc, os.path.join(out_dir, "ckpt", "retrieval"), step=0)
        del rc

        # streaming FID (a callable extractor): half of the feature batches
        from metrics_tpu_torch import FID

        real, fake = _fid_sync_data()
        share = slice(rank * FID_SYNC_STEPS // world, (rank + 1) * FID_SYNC_STEPS // world)
        fid = FID(lambda x: x, feature_dim=FID_SYNC_DIM, streaming=True, device=device)
        for r, f in zip(real[share].to(device), fake[share].to(device)):
            fid.update(r, real=True)
            fid.update(f, real=False)
        fid.sync()
        out["fid"] = {"corrected": _fid_corrected(fid), "n": [float(fid.real_n), float(fid.fake_n)]}
        fid.unsync()
        gathers.clear()
        out["fid"]["value"] = float(fid.compute())
        out["fid"]["collectives"] = len(gathers)
        del fid, real, fake

        # the text metrics as one collection, each member fed its first
        # SYNC_TEXT items, half on each rank; the default BERTScore (idf)
        # over SYNC_BERT_PAIRS pairs, half on each rank
        from metrics_tpu_torch import BERTScore, MetricCollection

        data = _text_data(*SYNC_TEXT.values())
        text = MetricCollection(_text_metrics(device))
        for name, n in SYNC_TEXT.items():
            a, b = data[name]
            text[name].update(*(x[rank * n // world:(rank + 1) * n // world] for x in (a, b)))
        gathers.clear()
        values = text.compute()
        out["text"] = {"collectives": len(gathers), "values": {
            k: {kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu() for k, v in values.items()}}
        hyps, refs = data["bert"]
        share = slice(rank * SYNC_BERT_PAIRS // world, (rank + 1) * SYNC_BERT_PAIRS // world)
        bert = BERTScore(max_length=BERT_MAX_LEN, batch_size=BERT_BATCH, idf=True, device=device)
        bert.update(hyps[share], refs[share])
        assert all(s.device == device for s in bert.preds_input_ids)
        gathers.clear()
        out["bertscore"] = {"values": _quiet(bert.compute), "collectives": len(gathers)}
        del text, bert, data

        # three divergence cases, every one decided by the health header
        gen = torch.Generator().manual_seed(10 + rank)

        def divergent(c, check_finite=False, nan=False):
            m = Precision(num_classes=c, average="macro", device=device)
            if check_finite:
                m.enable_check_finite()
            preds = torch.rand(256, c, generator=gen)
            if nan:
                preds[7, 3] = float("nan")
            m.update(preds.to(device), torch.randint(0, c, (256,), generator=gen).to(device))
            return m

        cases = {}
        m = divergent(REPORT_CLASSES + rank)
        try:
            m.compute()
            cases["num_classes"] = "no error"
        except StateDivergenceError as err:
            cases["num_classes"] = type(err).__name__
        cases["num_classes_health"] = m.telemetry()["health"]
        for mode in ("local", "warn"):
            m = divergent(REPORT_CLASSES + rank)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                m.sync(on_error=mode)
            degraded = m._sync_degraded and not m._is_synced
            m.unsync()  # a no-op after a degraded sync
            m._to_sync = False  # the local value, with no sync
            local = m.compute()
            m._to_sync, m._computed = True, None
            m.sync_on_error = mode
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                served = m.compute()  # degrades inside compute() too
            cases[mode] = {"degraded": degraded and m._sync_degraded,
                           "warnings": sum(issubclass(w.category, RuntimeWarning) for w in caught),
                           "serves_local": bool(torch.equal(served, local))}
        poisoned = divergent(REPORT_CLASSES, check_finite=True, nan=rank == 1)
        try:
            poisoned.compute()
            cases["nonfinite"] = "no error"
        except Exception as err:  # noqa: BLE001 - the class is the result
            cases["nonfinite"] = type(err).__name__
        out["cases"] = cases
        sync_mod._all_gather = raw
        sync_mod.host_sync_state = raw_sync
        out["rounds"] = len(rounds)
        out["journal"] = [e.as_dict() for e in obs.events()]
        out["process"] = obs.registry.process_snapshot()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _check_overlap(ranks):
    """The two ranks' overlap runs (``_overlap_rank``): every resolve equal to
    the blocking value at its cut, the ledger's counts, the refused snapshot."""
    computes = OVERLAP_STEPS // OVERLAP_EVERY
    for rank, result in enumerate(ranks):
        ov = result["overlap"]
        blocking, overlap = ov["blocking"], ov["overlap"]
        assert len(blocking["values"]) == len(overlap["values"]) == computes
        # under "snapshot" each resolve serves the world state at the previous
        # compute()'s cut: the blocking run's value there, bit for bit
        for k in range(1, computes):
            for key, v in blocking["values"][k - 1].items():
                assert torch.equal(overlap["values"][k][key], v), f"overlap rank {rank}: {key} at compute {k}"
        st = overlap["stats"]
        assert (st["launched"], st["resolved"], st["stale_resolves"], st["served_local"], st["cancelled"]) == (
            computes, computes - 1, computes - 1, 1, 1), st
        assert overlap["snapshot"].startswith("refused"), overlap["snapshot"]
        print(f"overlap, rank {rank}: report collection, {OVERLAP_STEPS} steps, compute() every {OVERLAP_EVERY}: "
              f"update step {blocking['step_ms']:.4f} ms blocking / {overlap['step_ms']:.4f} ms overlap (median); "
              f"compute steps blocking {[round(x, 3) for x in blocking['compute_step_ms']]} ms, overlap "
              f"{[round(x, 3) for x in overlap['compute_step_ms']]} ms; launched {st['launched']}, resolved "
              f"{st['resolved']}, stale {st['stale_resolves']}, served_local {st['served_local']}, cancelled "
              f"{st['cancelled']}, gather_s {st['gather_s']:.6f}, resolve_wait_s {st['resolve_wait_s']:.6f}, "
              f"overlap_saved_s {st['overlap_saved_s']:.6f}; {ov['rounds']} host sync rounds; each resolve equal to "
              f"the blocking value at its cut bit for bit; a snapshot with a round in flight {overlap['snapshot']}")


def _overlap_only_rank(rank, world, port_no, out_dir, device):
    """A rank of the overlap part alone (``--fused-only``)."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port_no}", world_size=world, rank=rank)
    try:
        out = {"overlap": _overlap_rank(rank, world, device, out_dir)}
        out["overlap"]["rounds"] = -1
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _overlap_only_phase(device):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_overlap_")
    mp.start_processes(_overlap_only_rank, args=(SYNC_WORLD, port_no, out_dir, str(device)), nprocs=SYNC_WORLD,
                       join=True, start_method="spawn")
    _check_overlap([torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(SYNC_WORLD)])


# resilience phase: four gloo ranks share the card, tier size 2 (two tiers of
# two, as one 8-card node is one tier at METRICS_TPU_TIER_SIZE=8)
RESILIENCE_WORLD, RESILIENCE_TIER = 4, 2
RESILIENCE_STEPS = STEPS // RESILIENCE_WORLD  # report batches a rank
RESILIENCE_TIMEOUT_S = 5.0  # the quorum part's watchdog bound
STRAGGLER_TIMEOUT_S, STRAGGLER_DELAY_S, PROBATION_COOLDOWN_S = 2.0, 3.0, 1.0
RESILIENCE_DEADLINE_S = 300.0
HEARTBEAT_S, PROBE_WAIT_S = 0.05, 0.3
# a float32 add rounds by at most 2^-24 of its result: the flat sync adds 3
# times, the tiered one 2 times in the tiers, once in the Kahan combine and
# once in the decode's product; 8 such roundings of the sum of magnitudes
RESILIENCE_SLACK = 8 * 2.0 ** -24


def _cuda_sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StoreTransport:
    """The quorum and tier transport of the resilience phase: a deployment's
    side channel, built here from torch.distributed alone (the package ships
    none). Tier and leader groups are gloo groups made up front on every
    rank with ``new_group``; any other set (the survivors after a death) gets
    a gloo group its members alone build over the c10d store
    (``ProcessGroupGloo`` on a prefix of the store: ``new_group(ranks,
    use_local_synchronization=True)`` of gloo did not return in torch 2.13,
    every member waiting in it). A gather
    copies the wire to the host (gloo) and returns the stacked rows there.
    Liveness is a heartbeat counter per rank in the store: ``probe()`` reads
    the counters twice, ``PROBE_WAIT_S`` apart, and a rank whose counter did
    not move is gone."""

    def __init__(self, rank, world, port_no, tier_size):
        import threading

        import torch.distributed as dist

        self.rank, self.world, self._port = rank, world, port_no
        self._store = dist.TCPStore("localhost", port_no, world, is_master=False)  # the heartbeats' client
        self._lock = threading.Lock()
        self._groups = {}
        tiers = [tuple(range(t, min(t + tier_size, world))) for t in range(0, world, tier_size)]
        for ranks in tiers + [tuple(t[0] for t in tiers)]:
            self._groups[ranks] = dist.new_group(list(ranks))
        threading.Thread(target=self._beat, name="chip-smoke-heartbeat", daemon=True).start()

    def _beat(self):
        while True:
            with self._lock:
                self._store.add(f"hb/{self.rank}", 1)
            time.sleep(HEARTBEAT_S)

    def _counts(self):
        with self._lock:
            return [self._store.add(f"hb/{r}", 0) for r in range(self.world)]

    def probe(self):
        first = self._counts()
        time.sleep(PROBE_WAIT_S)
        second = self._counts()
        return tuple(r for r in range(self.world) if r == self.rank or second[r] > first[r])

    def subset_allgather(self, x, ranks):
        import torch.distributed as dist

        from metrics_tpu_torch.utils.exceptions import SyncTimeoutError

        ranks = tuple(sorted(int(r) for r in ranks))
        host = torch.as_tensor(x).detach().cpu().contiguous()
        if len(ranks) == 1:
            return host.unsqueeze(0)
        out = [torch.empty_like(host) for _ in ranks]
        try:
            group = self._groups.get(ranks)
            if group is None:
                from datetime import timedelta

                store = dist.PrefixStore("subset/" + "_".join(map(str, ranks)) + "/",
                                         dist.TCPStore("localhost", self._port, self.world, is_master=False))
                group = self._groups[ranks] = dist.ProcessGroupGloo(store, ranks.index(self.rank), len(ranks),
                                                                    timedelta(seconds=120))
            if isinstance(group, dist.ProcessGroupGloo):
                group.allgather([out], [host]).wait()
            else:
                dist.all_gather(out, host, group=group)
        except RuntimeError as err:
            raise SyncTimeoutError(f"subset gather over {ranks} failed: {err}") from err
        return torch.stack(out)

    def negotiate_allgather(self, vec, live):
        return self.subset_allgather(torch.from_numpy(np.asarray(vec)), live).numpy()


def _resilience_fid(rank, device):
    """Rank ``rank``'s streaming FID (identity features) over its share of
    the sync phase's feature batches."""
    from metrics_tpu_torch import FID

    real, fake = _fid_sync_data()
    share = slice(rank * FID_SYNC_STEPS // RESILIENCE_WORLD, (rank + 1) * FID_SYNC_STEPS // RESILIENCE_WORLD)
    fid = FID(lambda x: x, feature_dim=FID_SYNC_DIM, streaming=True, device=device)
    for r, f in zip(real[share], fake[share]):
        fid.update(r.to(device), real=True)
        fid.update(f.to(device), real=False)
    return fid


def _report_share(rank, device, steps):
    probs, labels = _report_data()
    mc = _report_collection(device)
    for i in steps:
        mc.update(probs[i].to(device), labels[i].to(device))
    return mc


def _member_states(mc):
    return {f"{k}.{n}": v for k, m in mc.items() for n, v in m._state.items()}


def _float_buckets(rank, device):
    """Rank ``rank``'s float32 payloads in (a) as the bucketed sync lays them
    out: the streaming FID's one bucket, and the report collection's one
    float state (``mcc.confmat``, float32 as in the JAX package)."""
    from metrics_tpu_torch.parallel.bucketing import build_sync_plan

    fid = _resilience_fid(rank, device)
    (specs,) = build_sync_plan(fid._state, fid._reductions).reduce_buckets.values()
    mc = _report_share(rank, device, range(rank * RESILIENCE_STEPS, (rank + 1) * RESILIENCE_STEPS))
    return {"fid": torch.cat([fid._state[s.name].reshape(-1) for s in specs]),
            "report": mc["mcc"].confmat.reshape(-1)}


def _codec_bounds(flats):
    """Per element of a float bucket (``flats``: every rank's, ``[world,
    n]``), the bound each codec keeps a tiered sync within of the flat one,
    from this run's data: the tier partials ``P_t`` (rank-order sums of the
    tier's rows) give int8 ``sum_t half-step_t`` (``maxabs / 127 / 2`` of the
    element's 256-block) and bf16 ``2^-8 sum_t |P_t|``, each plus
    ``RESILIENCE_SLACK`` times the sum of the ranks' magnitudes."""
    from metrics_tpu_torch.parallel import quantize
    from metrics_tpu_torch.parallel.sync import _rank_order_total

    n = flats.shape[1]
    nb = -(-n // quantize.BLOCK)
    half_steps, magnitudes = [], []
    for t in range(0, RESILIENCE_WORLD, RESILIENCE_TIER):
        partial = _rank_order_total(flats[t:t + RESILIENCE_TIER])
        blocks = torch.nn.functional.pad(partial.abs(), (0, nb * quantize.BLOCK - n)).reshape(nb, -1)
        half_steps.append((blocks.amax(dim=1) / 127 / 2).repeat_interleave(quantize.BLOCK)[:n])
        magnitudes.append(partial.abs())
    slack = RESILIENCE_SLACK * flats.abs().sum(dim=0)
    return {"int8": torch.stack(half_steps).sum(dim=0) + slack,
            "bf16": 2.0 ** -8 * torch.stack(magnitudes).sum(dim=0) + slack}


def _codec_ms(flat):
    """Device ms (CUDA events) of the int8 and bf16 encode and decode of one
    rank's FID bucket."""
    from metrics_tpu_torch.parallel import quantize

    out = {}
    for precision in ("int8", "bf16"):
        wire = quantize.encode(flat, precision)
        out[f"{precision} encode"] = _time_ms(lambda: quantize.encode(flat, precision), reps=5, inner=5)
        out[f"{precision} decode"] = _time_ms(lambda: quantize.decode(wire, flat.numel(), flat.dtype, precision),
                                              reps=5, inner=5)
    return out


def _resilience_rank(rank, world, port_no, out_dir, device):
    """One rank of the resilience phase, a process of its own with its
    states on ``device``: (a) tiers, (c) probation, then (b) quorum, in which
    rank 3 leaves abruptly. Every rank ends with ``os._exit``: a survivor's
    default group holds a dead peer, which its teardown would wait on."""
    import torch.distributed as dist

    from metrics_tpu_torch.core.metric import Metric
    from metrics_tpu_torch.observability.registry import process_snapshot
    from metrics_tpu_torch.parallel import resilience, tiering
    from metrics_tpu_torch.parallel import sync as sync_mod
    from metrics_tpu_torch.parallel.health import build_health_word

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore("localhost", port_no, world, is_master=False)
    dist.init_process_group("gloo", store=dist.PrefixStore("pg", store), world_size=world, rank=rank)
    transport = _StoreTransport(rank, world, port_no, RESILIENCE_TIER)
    resilience.set_quorum_transport(transport)
    out = {"rank": rank}
    steps = range(rank * RESILIENCE_STEPS, (rank + 1) * RESILIENCE_STEPS)

    # (a) tiers: the report collection (integer states, unencoded) and the
    # streaming FID (float sums and compensations) synced flat, tiered at
    # full precision, bf16 and int8, each twice, in turns
    mc = _report_share(rank, device, steps)
    fid = _resilience_fid(rank, device)
    runs, ms, stats = {}, {}, {}
    for mode in ("flat", "full", "bf16", "int8", "int8", "bf16", "full", "flat"):
        if mode == "flat":
            os.environ.pop(tiering.TIER_SIZE_ENV, None)
        else:
            os.environ[tiering.TIER_SIZE_ENV] = str(RESILIENCE_TIER)
        mc.sync_precision = fid.sync_precision = mode if mode in ("bf16", "int8") else None
        before = (dict(mc.sync_stats()["collection"]), dict(fid.sync_stats()))
        dist.barrier()
        _cuda_sync(device)
        t0 = time.perf_counter()
        mc.sync()
        fid.sync()
        _cuda_sync(device)
        ms.setdefault(mode, []).append((time.perf_counter() - t0) * 1e3)
        synced = {**{f"report.{k}": v.clone() for k, v in _member_states(mc).items()},
                  **{f"fid.{k}": v.clone() for k, v in fid._state.items()}}
        if mode in runs:
            assert all(torch.equal(v, runs[mode][k]) for k, v in synced.items()), f"rank {rank}: {mode} not bit-stable"
        else:
            runs[mode] = synced
            after = (mc.sync_stats()["collection"], fid.sync_stats())
            stats[mode] = {key: sum(a.get(key, 0) - b.get(key, 0) for a, b in zip(after, before))
                           for key in ("intra_tier_bytes", "inter_tier_bytes", "inter_tier_bytes_saved")}
        mc.unsync()
        fid.unsync()
    os.environ.pop(tiering.TIER_SIZE_ENV, None)
    flat = runs["flat"]
    for key, v in runs["full"].items():
        assert torch.equal(v, flat[key]), f"rank {rank}: tiered full precision {key} differs from the flat sync"
    for mode in ("bf16", "int8"):
        for key, v in runs[mode].items():
            if not v.is_floating_point():
                assert torch.equal(v, flat[key]), f"rank {rank}: {mode} changed the integer state {key}"
    from metrics_tpu_torch.parallel.bucketing import build_sync_plan

    (specs,) = build_sync_plan(fid._state, fid._reductions).reduce_buckets.values()
    layout = {"fid": [f"fid.{s.name}" for s in specs], "report": ["report.mcc.confmat"]}
    synced = {m: {b: torch.cat([runs[m][k].reshape(-1) for k in keys]).cpu() for b, keys in layout.items()}
              for m in ("flat", "bf16", "int8")}
    out["tiers"] = {"ms": ms, "stats": stats, "flat_crc": zlib.crc32(synced["flat"]["fid"].numpy().tobytes())}
    if rank == 0:
        flats = [_float_buckets(r, device) for r in range(RESILIENCE_WORLD)]
        out["tiers"].update(synced=synced, bounds={
            b: {k: v.cpu() for k, v in _codec_bounds(torch.stack([f[b] for f in flats])).items()} for b in layout})
        out["tiers"]["codec_ms"] = _codec_ms(flats[0]["fid"]) if device.type == "cuda" else {}
        del flats
    del mc, fid, runs, flat, synced

    # (c) probation: rank 3 straggles into the payload gather past the
    # others' watchdog (its own waits longer); they degrade, their channel
    # cools down, and the next sync, admitted as the probe round, readmits it
    class _Total(Metric):
        def __init__(self):
            super().__init__(device=device, sync_on_error="local",
                             sync_timeout=STRAGGLER_TIMEOUT_S if rank != 3 else 10 * STRAGGLER_DELAY_S)
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum()

        def compute(self):
            return self.total

    resilience.configure_probation(base_cooldown_s=PROBATION_COOLDOWN_S)
    plain = sync_mod._all_gather
    armed = {"delay": rank == 3}

    def straggling(x, group):
        if armed["delay"] and x.dtype == torch.float32:  # the payload, after the header
            armed["delay"] = False
            time.sleep(STRAGGLER_DELAY_S)
        return plain(x, group)

    sync_mod._all_gather = straggling
    m = _Total()
    m.update(torch.tensor([float(rank + 1)], device=device))
    before = process_snapshot()
    dist.barrier()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.sync()
    first = {"degraded": m._sync_degraded, "suspect": resilience.channel_is_suspect(),
             "value": float(m.total), "gate": resilience.channel_gate()}
    m.unsync()
    time.sleep(PROBATION_COOLDOWN_S + 0.5)
    m.sync()
    second = {"synced": m._is_synced, "value": float(m.total), "suspect": resilience.channel_is_suspect()}
    m.unsync()
    sync_mod._all_gather = plain
    after = process_snapshot()
    out["probation"] = {"first": first, "second": second, "counters": {
        k: after[k] - before[k] for k in ("watchdog_fired", "channel_suspect_latched", "channel_readmits",
                                          "channel_resets")}}

    # (b) quorum: the report collection under on_missing="quorum"; rank 3
    # leaves abruptly before the sync
    os.environ["METRICS_TPU_SYNC_TIMEOUT_S"] = str(RESILIENCE_TIMEOUT_S)
    os.environ[tiering.TIER_SIZE_ENV] = str(RESILIENCE_TIER)
    mc = _report_share(rank, device, steps)
    for member in mc.values():
        member.sync_on_missing = "quorum"
    dist.barrier()
    if rank == 3:
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        os._exit(0)
    headers, failures = [], []
    plain_word, plain_negotiate = sync_mod.build_health_word, resilience.negotiate_quorum

    def counted_word(*args, **kwargs):
        headers.append(time.perf_counter())
        return plain_word(*args, **kwargs)

    def timed_negotiate(err, **kwargs):
        failures.append((time.perf_counter(), type(err).__name__))  # the first attempt just failed
        return plain_negotiate(err, **kwargs)

    sync_mod.build_health_word, resilience.negotiate_quorum = counted_word, timed_negotiate
    before = process_snapshot()
    mc.sync()
    _cuda_sync(device)
    done = time.perf_counter()
    sync_mod.build_health_word, resilience.negotiate_quorum = plain_word, plain_negotiate
    after = process_snapshot()
    topo = tiering.active_topology()
    word = build_health_word({"x": torch.zeros(())}, {"x": "sum"})
    ref = _report_share(rank, device, range(3 * RESILIENCE_STEPS))  # one process, the survivors' batches
    want = _member_states(ref)
    got = _member_states(mc)
    out["quorum"] = {
        "epoch": resilience.membership_epoch(), "live": resilience.live_ranks(),
        "tiers": None if topo is None else dict(topo.tiers), "attempts": len(headers),
        "failure_to_done_ms": (done - failures[0][0]) * 1e3 if failures else None,
        "failure": failures[0][1] if failures else None,
        "equal": sorted(k for k in want if torch.equal(got[k], want[k])), "states": sorted(want),
        "header": [int(word[7]), int(word[8]), int(word[9])],
        "counters": {k: after[k] - before[k] for k in ("quorum_shrinks", "membership_transitions", "watchdog_fired",
                                                          "channel_suspect_latched")},
    }
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    sys.stdout.flush()
    os._exit(0)


def _resilience_phase(device):
    """Four gloo ranks on the card (one ``torch.multiprocessing`` spawn, a
    c10d store hosted here): tiers, probation and quorum; every check
    fails the script."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    store = dist.TCPStore("localhost", 0, RESILIENCE_WORLD + 1, is_master=True, wait_for_workers=False)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_resilience_rank, args=(RESILIENCE_WORLD, store.port, out_dir, str(device)),
                             nprocs=RESILIENCE_WORLD, join=False, start_method="spawn")
    while not ctx.join(timeout=1.0):
        if time.perf_counter() - t0 > RESILIENCE_DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the resilience ranks did not finish within {RESILIENCE_DEADLINE_S:g} s")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(RESILIENCE_WORLD)]

    # (a) tiers
    tiers = ranks[0]["tiers"]
    errs = {}
    for bucket, bounds in tiers["bounds"].items():
        flat = tiers["synced"]["flat"][bucket]
        for mode in ("bf16", "int8"):
            err = (tiers["synced"][mode][bucket] - flat).abs()
            assert bool((err <= bounds[mode]).all()), (
                f"{mode}: {int((err > bounds[mode]).sum())} of {bucket}'s float elements past the codec's bound")
            errs[f"{bucket} {mode}"] = (float(err.max()), float((err / bounds[mode].clamp_min(1e-30)).max()))
    for r, result in enumerate(ranks):
        assert result["tiers"]["flat_crc"] == tiers["flat_crc"], f"rank {r}'s flat FID sync differs from rank 0's"
        st = result["tiers"]["stats"]
        assert st["flat"] == {"intra_tier_bytes": 0, "inter_tier_bytes": 0, "inter_tier_bytes_saved": 0}, st
        assert all(st[m]["intra_tier_bytes"] > 0 for m in ("full", "bf16", "int8")), st
    leader = ranks[0]["tiers"]["stats"]
    ratio = {m: leader[m]["inter_tier_bytes"] / leader["full"]["inter_tier_bytes"] for m in ("bf16", "int8")}
    print(f"tiers (METRICS_TPU_TIER_SIZE={RESILIENCE_TIER}: tiers {{0, 1}} and {{2, 3}}, leaders 0 and 2): the "
          f"report collection (integer states, unencoded) and a streaming FID of {FID_SYNC_DIM}-dim identity "
          f"features ({tiers['synced']['flat']['fid'].numel()} float32 elements in its one bucket), each rank a "
          "quarter of the batches; tiered full precision equal to the flat sync on every rank (torch.equal), bf16 "
          "and int8 bit-stable run to run, integer states unchanged by either codec, the float buckets (the FID's, "
          "the report's mcc.confmat) within the codec's bound on rank 0: max abs err / max err-to-bound "
          + ", ".join(f"{m} {e[0]:.4g} / {e[1]:.4f}" for m, e in errs.items()))
    for r, result in enumerate(ranks):
        ms = result["tiers"]["ms"]
        print(f"tiers rank {r}: ms a sync (report + FID, host clock, two runs in turns) "
              + ", ".join(f"{m} {[round(x, 2) for x in v]}" for m, v in ms.items())
              + "; bytes " + ", ".join(f"{m} {v}" for m, v in result["tiers"]["stats"].items() if m != "flat"))
    print(f"tiers: leader 0's slow-hop bytes against full precision: bf16 {ratio['bf16']:.4f}x, int8 "
          f"{ratio['int8']:.4f}x; device ms of rank 0's FID bucket (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tiers["codec_ms"].items()))

    # (c) probation
    for r, result in enumerate(ranks):
        p = result["probation"]
        if r == 3:  # the straggler: its sync completed with the others' abandoned gathers
            assert p["first"]["degraded"] is False and not p["first"]["suspect"], p
            assert p["counters"]["watchdog_fired"] == 0, p
        else:
            assert p["first"]["degraded"] and p["first"]["suspect"] and p["first"]["gate"] == "refuse", p
            assert p["counters"] == {"watchdog_fired": 1, "channel_suspect_latched": 1, "channel_readmits": 1,
                                     "channel_resets": 0}, p
        assert p["second"]["synced"] and not p["second"]["suspect"] and p["second"]["value"] == 10.0, p
    print(f"probation: rank 3 straggled {STRAGGLER_DELAY_S:g} s into the payload gather; the watchdog "
          f"({STRAGGLER_TIMEOUT_S:g} s) fired on ranks 0-2, which degraded to local values "
          f"{[ranks[r]['probation']['first']['value'] for r in range(3)]} with the channel in probation "
          f"(gate 'refuse'); after the {PROBATION_COOLDOWN_S:g} s cooldown the next sync went through as the probe "
          "round and readmitted the channel on each, no reset_channel_health(): counters "
          f"{ranks[0]['probation']['counters']}; every rank then synced 10.0")

    # (b) quorum
    survivors = [ranks[r]["quorum"] for r in range(3)]
    for r, q in enumerate(survivors):
        assert (q["epoch"], tuple(q["live"])) == (1, (0, 1, 2)), (r, q["epoch"], q["live"])
        assert q["tiers"] == {0: (0, 1), 1: (2,)}, (r, q["tiers"])
        assert q["attempts"] == 2, (r, q["attempts"])  # the failed attempt, one retry
        assert q["equal"] == q["states"], (r, sorted(set(q["states"]) - set(q["equal"])))
        assert q["header"] == [1, 3, r // RESILIENCE_TIER], (r, q["header"])
        assert q["counters"]["quorum_shrinks"] == 1 and q["counters"]["membership_transitions"] == 1, q["counters"]
        assert q["failure_to_done_ms"] is not None, r
    how = ["watchdog fired" if q["counters"]["watchdog_fired"] else "gloo reported the closed connection"
           for q in survivors]
    assert all(q["failure"] == "SyncTimeoutError" for q in survivors), [q["failure"] for q in survivors]
    print(f"quorum: rank 3 left (os._exit) before the sync; each survivor's first attempt failed with "
          f"SyncTimeoutError: {how} (METRICS_TPU_SYNC_TIMEOUT_S={RESILIENCE_TIMEOUT_S:g}); they agreed on epoch 1, live (0, 1, 2), tiers "
          f"{{0: (0, 1), 1: (2,)}} in that epoch, retried once, and their synced states equal one process over the "
          f"survivors' {3 * RESILIENCE_STEPS} batches (torch.equal, {len(survivors[0]['states'])} states); header "
          f"member_epoch 1, live_count 3; quorum_shrinks 1; ms from the first failed gather to the finished sync "
          f"{[round(q['failure_to_done_ms'], 1) for q in survivors]}")
    print(f"resilience: {RESILIENCE_WORLD} processes spawned, ran and exited in {spawn_s:.1f} s")


def _sync_journal_check(ranks):
    """The two ranks' journals of the sync phase: equal ``(kind, label)``
    sequences (lockstep); one ``sync.gather`` a round, the rounds each rank
    ran; the guarded collectives' time from ``health.margin``; the blocking
    rounds counted as the JAX package counts them (the ``sync`` domain's
    round ledger is the overlapped path's, untouched by a blocking sync); the
    schema divergence once in ``health`` and once as ``health.failure``;
    both journals as one Chrome trace, one pid per rank."""
    from metrics_tpu_torch.observability import Event, export_chrome_trace, registry

    seqs = [[(e["kind"], e["label"]) for e in r["journal"]] for r in ranks]
    assert seqs[0] == seqs[1], "the two ranks journaled different sequences"
    idle = registry.DOMAIN_DEFAULTS["sync"]
    report = []
    for rank, r in enumerate(ranks):
        journal = r["journal"]
        gathers = sum(e["kind"] == "sync.gather" for e in journal)
        assert gathers == r["rounds"] > 0, (rank, gathers, r["rounds"])
        margins = [e for e in journal if e["kind"] == "health.margin"]
        gather_s = sum(e["elapsed_s"] for e in margins)
        assert gather_s > 0 and r["process"]["watchdog_margin_s"] > 0 and r["process"]["watchdog_fired"] == 0
        for name in ("report", "ranking", "regression"):
            stats = r[name]["sync_stats"]
            assert stats["collection"] == idle and all(s == idle for s in stats["members"].values()), (name, stats)
        failures = [e for e in journal if e["kind"] == "health.failure" and e["on_error"] == "raise"
                    and e["error"] == "StateDivergenceError"]
        assert len(failures) == 1, failures
        assert r["cases"]["num_classes_health"]["errors"] == {"StateDivergenceError": 1}, r["cases"]
        kinds = {}
        for k, _ in seqs[rank]:
            kinds[k] = kinds.get(k, 0) + 1
        report.append(f"rank {rank}: {len(journal)} events {kinds}, {r['rounds']} sync rounds = {gathers} "
                      f"sync.gather, {len(margins)} guarded collectives {gather_s * 1e3:.2f} ms on the host's clock")
    base = {"ts", "rank", "step", "kind", "label"}
    events = [Event(e["ts"], e["rank"], e["step"], e["kind"], e["label"], {k: v for k, v in e.items() if k not in base})
              for r in ranks for e in r["journal"]]
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_trace_"), "sync_trace.json")
    export_chrome_trace(path, events)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    assert {t["pid"] for t in trace} == set(range(SYNC_WORLD)) and all(t["ts"] >= 0 for t in trace if t["ph"] != "M")
    os.remove(path)
    print("journal on both ranks, equal (kind, label) sequences; " + "; ".join(report)
          + f"; sync_stats() as the JAX package's blocking path (no overlapped round); the schema divergence once in "
          f"health.errors and once as health.failure on each rank; Chrome trace of both ranks: {len(trace)} events, "
          f"pids {sorted({t['pid'] for t in trace})}, no negative ts")


def _sync_phase(device, report_gpu, report_values, regression, retrieval_values):
    """Two ranks on the card, each with half of the batches, against one
    process on the card over all of them (``report_gpu``, the report
    phase's grouped run, a ranking collection built here, the regression
    phase's collection, values and bounds in ``regression``, and the
    retrieval phase's capacity-mode values); then the shards the two ranks
    saved, folded into one process (an elastic resume from 2 ranks to 1),
    against the same one-process runs."""
    import shutil

    import torch.multiprocessing as mp

    from metrics_tpu_torch import MetricCollection, load_checkpoint

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    t0 = time.perf_counter()
    mp.start_processes(_sync_rank, args=(SYNC_WORLD, port_no, out_dir, str(device)), nprocs=SYNC_WORLD, join=True,
                       start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(SYNC_WORLD)]
    for r, result in enumerate(ranks):
        for name in ("report", "ranking", "regression"):
            print(f"compile_stats rank {r} {name} (traces/dispatches, fallback kinds): {result[name]['compile']}")
    print(f"backend {ranks[0]['backend']} (NCCL refuses two ranks on one device: not measured on one card); "
          f"{SYNC_WORLD} processes spawned, ran and joined in {spawn_s:.1f} s")

    probs, labels = _curve_data()
    ranking = _ranking_collection(device, CURVE_CAPACITY)
    for i in range(CURVE_STEPS):
        ranking.update(probs[i].to(device), labels[i].to(device))
    del probs, labels
    want = {"report": (_synced_rows(report_gpu), report_values), "ranking": (_synced_rows(ranking), ranking.compute())}
    atol = {"report": lambda k: VALUE_ATOL_BY_METRIC.get(k, VALUE_ATOL), "ranking": lambda k: RANKING_ATOL}
    for name, (want_states, want_values) in want.items():
        for rank, result in enumerate(ranks):
            got = result[name]
            assert sorted(got["states"]) == sorted(want_states)
            for k, v in want_states.items():
                assert torch.equal(got["states"][k], v), f"{name} rank {rank}: synced {k} differs from one process"
            errs = {k: _check_values(k, got["values"][k], v, atol[name](k)) for k, v in want_values.items()}
            assert got["compute_collectives"] == got["fused"]["collectives"]
            print(f"{name}, rank {rank}: compute groups {got['groups']}; fused sync {got['fused']['collectives']} "
                  f"collectives ({got['fused']['bytes']} bytes in) in {got['fused']['ms']:.4f} ms, per-leaf "
                  f"{got['per_leaf']['collectives']} collectives ({got['per_leaf']['bytes']} bytes in) in "
                  f"{got['per_leaf']['ms']:.4f} ms; compute() syncs once ({got['compute_collectives']} collectives); "
                  f"synced states equal to one process over all batches; max abs err of values {errs}")
    _check_overlap(ranks)
    reg_gpu, reg_values, (state_rtol, value_rtol, kappa) = regression
    want_states = _synced_rows(reg_gpu)
    for rank, result in enumerate(ranks):
        got = result["regression"]
        assert sorted(got["states"]) == sorted(want_states)
        for k, v in want_states.items():
            g, (metric, name) = got["states"][k].double(), k.split(".")
            if metric == "pearson":
                # gathered, not reduced: one entry per rank, folded by compute()
                assert g.shape == (SYNC_WORLD,), f"{k}: synced shape {tuple(g.shape)}"
                if name == "n_total":
                    assert float(g.sum()) == float(v), f"{k}: {g} vs {v}"
            elif name in REG_COUNTS:
                assert torch.equal(g, v.double()), f"regression rank {rank}: synced {k} {g} vs {v}"
            else:
                err = float((g - v.double()).abs().max() / v.double().abs().max())
                assert err <= state_rtol[k], f"regression rank {rank}: synced {k} relative diff {err}"
        errs = {k: _check_regression(k, got["values"][k], v, value_rtol, kappa) for k, v in reg_values.items()}
        assert got["compute_collectives"] == got["fused"]["collectives"]
        print(f"regression, rank {rank}: fused sync {got['fused']['collectives']} collectives "
              f"({got['fused']['bytes']} bytes in) in {got['fused']['ms']:.4f} ms, per-leaf "
              f"{got['per_leaf']['collectives']} collectives ({got['per_leaf']['bytes']} bytes in) in "
              f"{got['per_leaf']['ms']:.4f} ms; Pearson's states gathered to [{SYNC_WORLD}] and folded; counts equal "
              f"to one process over all batches, float states and values within their bounds; max abs err of values "
              f"{errs}")
    for rank, result in enumerate(ranks):
        got = result["retrieval"]
        for k, v in retrieval_values.items():
            assert torch.equal(got["values"][k], v.cpu()), f"retrieval rank {rank}: synced {k} differs from one process"
        print(f"retrieval, rank {rank}: compute() synced {got['collectives']} collectives ({got['bytes']} bytes in) "
              f"in {got['ms']:.4f} ms; values equal to one process over all {MSMARCO_QUERIES} queries, bit for bit")

    from metrics_tpu_torch import FID

    real, fake = _fid_sync_data()
    one = FID(lambda x: x, feature_dim=FID_SYNC_DIM, streaming=True, device=device)
    for r, f in zip(real.to(device), fake.to(device)):
        one.update(r, real=True)
        one.update(f, real=False)
    want_corrected, want_value, parts = _fid_corrected(one), float(one.compute()), _fid_parts(one)
    for rank, result in enumerate(ranks):
        got = result["fid"]
        assert got["n"] == [float(one.real_n), float(one.fake_n)], got["n"]
        errs = {}
        for k, v in want_corrected.items():
            errs[k] = float((got["corrected"][k] - v).abs().max() / v.abs().max())
            assert errs[k] <= FID_SYNC_RTOL, f"fid rank {rank}: synced {k} relative diff {errs[k]}"
        assert abs(got["value"] - want_value) <= 2 * parts["bar"], (got["value"], want_value, parts)
        print(f"streaming FID, rank {rank}: {FID_SYNC_STEPS // SYNC_WORLD} of {FID_SYNC_STEPS} steps of "
              f"[{FID_SYNC_BATCH}, {FID_SYNC_DIM}] features a side; synced Kahan-corrected moments within "
              f"{max(errs.values()):.3e} of one process (bound {FID_SYNC_RTOL:g}), counts equal; FID "
              f"{got['value']:.6f} vs {want_value:.6f} ({got['collectives']} collectives in compute())")
    del one, real, fake

    from metrics_tpu_torch import BERTScore

    text_data = _text_data(*SYNC_TEXT.values())
    text = MetricCollection(_text_metrics(device))
    for name, n in SYNC_TEXT.items():
        a, b = text_data[name]
        text[name].update(a[:n], b[:n])
    want_text = text.compute()
    hyps, refs = text_data["bert"]
    bert = BERTScore(max_length=BERT_MAX_LEN, batch_size=BERT_BATCH, idf=True, device=device)
    bert.update(hyps[:SYNC_BERT_PAIRS], refs[:SYNC_BERT_PAIRS])
    want_bert = _quiet(bert.compute)
    for rank, result in enumerate(ranks):
        got = result["text"]["values"]
        assert torch.equal(got["wer"], want_text["wer"].cpu()) and torch.equal(got["bleu"], want_text["bleu"].cpu()), rank
        assert all(torch.equal(got["rouge"][k], v.cpu()) for k, v in want_text["rouge"].items()), rank
        errs = _bert_errs(result["bertscore"]["values"], want_bert)
        assert max(errs.values()) <= BERT_ATOL, f"BERTScore rank {rank}: synced vs one process {errs}"
        print(f"text, rank {rank}: WER, BLEU and ROUGE ({SYNC_TEXT}) synced in one compute() "
              f"({result['text']['collectives']} collectives), values equal to one process bit for bit; BERTScore "
              f"over {SYNC_BERT_PAIRS} pairs ({result['bertscore']['collectives']} collectives) "
              + ("bit-equal to one process" if result["bertscore"]["values"] == want_bert else f"within {errs}"))
    del text, bert, text_data, want_text, want_bert

    # elastic resume: the two ranks' shards (world=2) folded into one process
    def warm_ranking():
        mc = _ranking_collection(device, CURVE_CAPACITY)
        mc.update(ranking["auroc"].preds.values()[:BATCH], ranking["auroc"].target.values()[:BATCH])
        mc.reset()  # AUROC latches its input mode at the first update
        return mc

    for name, make, want_states, want_values in (
        ("report", lambda: _report_collection(device), report_gpu, report_values),
        ("ranking", warm_ranking, ranking, want["ranking"][1]),
        ("retrieval", lambda: _retrieval_collection(device, MSMARCO_ROWS), None, retrieval_values),
    ):
        target = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(target, os.path.join(out_dir, "ckpt", name), rank=0, world=1)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        values = target.compute()
        if want_states is not None:
            _assert_states_equal(target, want_states, f"{name} folded from 2 shards")
        if name == "retrieval":
            errs = {}
            for k, v in want_values.items():
                assert torch.equal(values[k], v), f"retrieval folded from 2 shards: {k} differs from one process"
        else:
            errs = {k: _check_values(k, values[k], v, atol[name](k)) for k, v in want_values.items()}
        print(f"{name}: 2 shards (world=2) folded into world=1 in {load_ms:.2f} ms; "
              + ("states equal to one process; " if want_states is not None else "")
              + f"compute() equal to one process (max abs err {errs or 0.0})")
        del target
    shutil.rmtree(out_dir)

    cases = [r["cases"] for r in ranks]
    assert [c["num_classes"] for c in cases] == ["StateDivergenceError"] * SYNC_WORLD, cases
    assert [c["nonfinite"] for c in cases] == ["NonFiniteStateError"] * SYNC_WORLD, cases
    for mode in ("local", "warn"):
        assert all(c[mode]["degraded"] and c[mode]["serves_local"] for c in cases), cases
    assert [c["local"]["warnings"] for c in cases] == [1, 0], cases  # rank-zero warning
    assert [c["warn"]["warnings"] for c in cases] == [1, 1], cases
    print(f"divergence on both ranks: num_classes {REPORT_CLASSES} vs {REPORT_CLASSES + 1} -> "
          f"{[c['num_classes'] for c in cases]}; on_error='local' -> degraded to local values on both, warnings "
          f"{[c['local']['warnings'] for c in cases]} (rank zero); on_error='warn' -> degraded on both, warnings "
          f"{[c['warn']['warnings'] for c in cases]}; one NaN on rank 1 under enable_check_finite() -> "
          f"{[c['nonfinite'] for c in cases]}")
    _sync_journal_check(ranks)


def _cifar_data():
    """10,000 "real" uint8 [3, 32, 32] images (uniform noise) and 10,000
    "generated" ones (8x8 noise blown up 4x: blocky), from RandomState(7),
    as [40, 250, 3, 32, 32] each."""
    rng = np.random.RandomState(7)
    real = rng.randint(0, 256, (CIFAR_IMAGES, 3, 32, 32), dtype=np.uint8)
    fake = rng.randint(0, 256, (CIFAR_IMAGES, 3, 8, 8), dtype=np.uint8).repeat(4, axis=2).repeat(4, axis=3)
    shape = (CIFAR_STEPS, CIFAR_STEP, 3, 32, 32)
    return torch.from_numpy(real.reshape(shape)), torch.from_numpy(np.ascontiguousarray(fake).reshape(shape))


def _quiet(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make()


def _fid_parts(m):
    """|mu1 - mu2|^2, tr S1 + tr S2, tr sqrt(S1 S2) and FID in float64 on
    the host, from a FID's states, and the bar a float32 FID is held to
    against that FID."""
    from metrics_tpu_torch.image.fid import _mean_cov, _stats_to_mean_cov
    from metrics_tpu_torch.ops.linalg import trace_sqrtm_product_eigh
    from metrics_tpu_torch.utils.data import dim_zero_cat

    def moments(side):
        if m.streaming:
            return _stats_to_mean_cov(*(getattr(m, f"{side}_{k}").cpu().double()
                                        for k in ("sum", "sum_comp", "outer", "outer_comp", "n")))
        return _mean_cov(dim_zero_cat(getattr(m, f"{side}_features")).cpu().double())

    (mu1, s1), (mu2, s2) = moments("real"), moments("fake")
    d2, traces = float((mu1 - mu2) @ (mu1 - mu2)), float(torch.trace(s1) + torch.trace(s2))
    tr_sqrt = float(trace_sqrtm_product_eigh(s1, s2))
    return dict(d2=d2, traces=traces, tr_sqrt=tr_sqrt, fid=d2 + traces - 2 * tr_sqrt,
                bar=2 * (FID_SQRT_RTOL * tr_sqrt + FID_SQRT_ATOL))


def _states_to(m, make, device):
    """A fresh metric from ``make(device)`` holding ``m``'s states, moved."""
    target = _quiet(lambda: make(device))
    m.persistent(True)
    target.load_state_dict(m.state_dict())
    m.persistent(False)
    return target


def _step_profile(fn, step_ms, top=6, warm=True):
    """Device busy share of one call of ``fn`` (an update step) against its
    unprofiled host-clock ``step_ms``, and its top device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        print("  profile: the profiler recorded no device activity (device busy share not measured)")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    syncs, d2h = _host_reads(prof)
    print(f"  one update step: {len(ops)} device operations for {busy_ms:.4f} ms of device time against "
          f"{step_ms:.4f} ms unprofiled: device busy {100 * busy_ms / step_ms:.2f}%, idle "
          f"{100 * (1 - busy_ms / step_ms):.2f}%; {syncs} cudaStreamSynchronize, {d2h} DtoH copies")
    by_name = {}
    for e in ops:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    device {ms:9.4f} ms ({100 * ms / busy_ms:5.1f}%) in {n:4d} op(s)  {name[:90]}")


def _feature_check(card):
    """The 2048 features of 16 images from the extractor ``card`` (random
    weights of seed 0), against the port on the CPU: with PyTorch's default
    TF32 flags (cuDNN TF32 on) and with them off; then, to show the bound
    tells them apart, a forward with the float32 guard taken away and TF32
    on."""
    import metrics_tpu_torch.models.inception as inc
    from metrics_tpu_torch.models.inception import InceptionFeatureExtractor
    from metrics_tpu_torch.utils.device import full_float32

    device = card.device
    imgs = torch.from_numpy(np.random.RandomState(17).randint(0, 256, (FEATURE_CHECK_IMAGES, 3, 32, 32),
                                                             dtype=np.uint8))
    cpu = _quiet(lambda: InceptionFeatureExtractor(2048, device="cpu"))
    want = cpu(imgs)
    bound = FEATURE_RTOL * float(want.abs().max())
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    got = {}
    try:
        for name, flags in (("PyTorch defaults (matmul False, cuDNN True)", (False, True)),
                            ("off", (False, False))):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            got[name] = card(imgs.to(device)).cpu()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        guard, inc.full_float32 = inc.full_float32, contextlib.nullcontext
        try:
            tf32 = card(imgs.to(device)).cpu()
        finally:
            inc.full_float32 = guard
        assert inc.full_float32 is full_float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    errs = {}
    for name, g in got.items():
        errs[name] = float((g - want).abs().max())
        assert errs[name] <= bound, f"features with TF32 flags {name}: max abs err {errs[name]} > {bound}"
    tf32_err = float((tf32 - want).abs().max())
    same = torch.equal(*got.values())
    print(f"features of {FEATURE_CHECK_IMAGES} images, card vs the port on the CPU (max |feature| "
          f"{float(want.abs().max()):.4f}, bound {bound:.3e}): max abs err {errs}; the two flag settings "
          f"{'bit-equal' if same else 'differ'}; without the float32 guard, TF32 on: {tf32_err:.3e} "
          f"({tf32_err / bound:.1f}x the bound)")


def _image_fid_phase(device):
    """FID (buffered and streaming), KID and IS at CIFAR-10 FID-10k size
    through the fidelity Inception with random weights; images/s in float32
    and bfloat16; each compute() timed and profiled on the card and held
    against the same compute() on the card's states moved to the CPU."""
    from metrics_tpu_torch import FID, IS, KID
    from metrics_tpu_torch.models.inception import InceptionFeatureExtractor

    metrics = {
        "fid": _quiet(lambda: FID(2048, device=device)),
        "fid_streaming": _quiet(lambda: FID(2048, streaming=True, device=device)),
        "kid": _quiet(lambda: KID(2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, device=device)),
        "is": _quiet(lambda: IS(splits=IS_SPLITS, device=device)),
    }
    _feature_check(metrics["fid"].inception)

    t0 = time.perf_counter()
    real, fake = _cifar_data()
    real, fake = real.to(device), fake.to(device)
    torch.cuda.synchronize()
    print(f"data: {2 * CIFAR_IMAGES} uint8 images made and moved to the card in {time.perf_counter() - t0:.2f} s")

    bf16 = _quiet(lambda: InceptionFeatureExtractor(2048, dtype=torch.bfloat16, device=device))
    for dtype, ext in ((torch.float32, metrics["fid"].inception), (torch.bfloat16, bf16)):
        ms = _time_ms(lambda: ext(real[0]), reps=5, inner=2)
        print(f"Inception-v3 (fidelity, 2048 tap) forward of {CIFAR_STEP} images of 32x32 resized to 299, "
              f"{str(dtype).replace('torch.', '')}: {ms:.3f} ms by CUDA events, {CIFAR_STEP / ms * 1e3:.1f} images/s")
    del bf16

    def step(i):
        for name, m in metrics.items():
            if name == "is":
                m.update(fake[i])
            else:
                m.update(real[i], real=True)
                m.update(fake[i], real=False)

    step_ms = []
    for i in range(CIFAR_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    per_step = 2 * 3 * CIFAR_STEP + CIFAR_STEP
    print(f"{CIFAR_STEPS} update steps (FID, streaming FID and KID on {CIFAR_STEP} real + {CIFAR_STEP} generated "
          f"images, IS on the {CIFAR_STEP} generated: {per_step} Inception images a step), the first "
          f"{CIFAR_STEPS - 1} timed: median "
          f"{np.median(step_ms):.3f} ms, first {step_ms[0]:.3f} ms, total {sum(step_ms) / 1e3:.2f} s, "
          f"{per_step / np.median(step_ms) * 1e3:.1f} images/s; the last under the profiler:")
    _step_profile(lambda: step(CIFAR_STEPS - 1), float(np.median(step_ms)), warm=False)
    _print_compile("image-fid", metrics)

    def fid_ns():
        m = metrics["fid_streaming"]
        m.sqrtm_method, m._computed = "ns", None
        try:
            return m.compute()
        finally:
            m.sqrtm_method, m._computed = "auto", None

    computes = {
        "fid (buffered, eigh)": (metrics["fid"], lambda: _fresh(metrics["fid"]),
                                 lambda d: FID(lambda x: x, device=d)),
        "fid (streaming, eigh)": (metrics["fid_streaming"], lambda: _fresh(metrics["fid_streaming"]),
                                  lambda d: FID(lambda x: x, feature_dim=2048, streaming=True, device=d)),
        "fid (streaming, ns)": (metrics["fid_streaming"], fid_ns,
                                lambda d: FID(lambda x: x, feature_dim=2048, streaming=True, sqrtm_method="ns",
                                              device=d)),
        "kid": (metrics["kid"], lambda: _fresh(metrics["kid"]),
                lambda d: KID(lambda x: x, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, device=d)),
        "is": (metrics["is"], lambda: _fresh(metrics["is"]), lambda d: IS(lambda x: x, splits=IS_SPLITS, device=d)),
    }
    values = {}
    for name, (m, fn, make) in computes.items():
        value, p = _profile_call(fn, reps=3 if name != "fid (streaming, ns)" else 1)
        _print_profile(name, p)
        t0 = time.perf_counter()
        on_cpu = _states_to(m, make, "cpu")
        want = on_cpu.compute()
        cpu_s = time.perf_counter() - t0
        if name.startswith("fid"):
            parts = _fid_parts(on_cpu)
            errs = {"card": abs(float(value) - parts["fid"]), "cpu": abs(float(want) - parts["fid"])}
            assert max(errs.values()) <= parts["bar"], f"{name}: card {float(value)}, CPU {float(want)}, {parts}"
            print(f"    {name}: {float(value):.6f} on the card, {float(want):.6f} on the CPU ({cpu_s:.1f} s), "
                  f"{parts['fid']:.6f} in float64 (|mu1-mu2|^2 {parts['d2']:.6f}, tr S1 + tr S2 "
                  f"{parts['traces']:.6f}, tr sqrt(S1 S2) {parts['tr_sqrt']:.6f}): |diff| to float64 card "
                  f"{errs['card']:.3e}, CPU {errs['cpu']:.3e} (bar {parts['bar']:.3e}); card vs CPU "
                  f"{abs(float(value) - float(want)):.3e}")
            values[name + " parts"] = parts
        elif name == "kid":
            feats = on_cpu.real_features[0]
            kscale = float((feats.pow(2).sum(1).mean() / feats.shape[1] + 1) ** 3)
            errs = [abs(float(g) - float(w)) for g, w in zip(value, want)]
            assert max(errs) <= KID_KERNEL_RTOL * kscale, f"kid: card {value} vs CPU {want}"
            print(f"    kid: mean {float(value[0]):.6e} std {float(value[1]):.6e} on the card; |diff| to the CPU "
                  f"({cpu_s:.1f} s) {errs}, bound {KID_KERNEL_RTOL * kscale:.3e} (kernel size {kscale:.4f})")
        else:
            errs = [abs(float(g) - float(w)) for g, w in zip(value, want)]
            assert max(errs) <= IS_ATOL, f"is: card {value} vs CPU {want}"
            print(f"    is: mean {float(value[0]):.6f} std {float(value[1]):.6f} on the card; |diff| to the CPU "
                  f"({cpu_s:.1f} s) {errs} (bound {IS_ATOL:g})")
        values[name] = value
        del on_cpu
    buffered, streaming = float(values["fid (buffered, eigh)"]), float(values["fid (streaming, eigh)"])
    bar = values["fid (buffered, eigh) parts"]["bar"]
    assert abs(buffered - streaming) <= 2 * bar, f"buffered FID {buffered} vs streaming {streaming}"
    print(f"buffered FID {buffered:.6f} vs streaming {streaming:.6f}: |diff| {abs(buffered - streaming):.3e} "
          f"(bound {2 * bar:.3e}); ns {float(values['fid (streaming, ns)']):.6f}; counts real "
          f"{float(metrics['fid_streaming'].real_n):.0f}, fake {float(metrics['fid_streaming'].fake_n):.0f}")
    assert float(metrics["fid_streaming"].real_n) == float(metrics["fid_streaming"].fake_n) == CIFAR_IMAGES
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for k, vs in values.items() if "parts" not in k
               for v in (vs if isinstance(vs, tuple) else (vs,)))
    del metrics, real, fake


def _bapps_data(device):
    """10,000 pairs of [3, 64, 64] patches in [-1, 1] from RandomState(8):
    8-bit references and a distortion of each (every value off by up to 24
    levels, clipped), drawn as bytes and scaled on the card, as
    [40, 250, 3, 64, 64] float32 each."""
    rng = np.random.RandomState(8)
    shape = (BAPPS_PAIRS // BAPPS_STEP, BAPPS_STEP, 3, BAPPS_HW, BAPPS_HW)
    ref = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(device).to(torch.int16)
    noise = torch.from_numpy(rng.randint(-24, 25, shape, dtype=np.int8)).to(device)
    dist = torch.clamp(ref + noise, 0, 255)
    return ref.to(torch.float32) / 127.5 - 1, dist.to(torch.float32) / 127.5 - 1


def _image_lpips_phase(device):
    """LPIPS with the AlexNet and VGG16 towers over 10,000 BAPPS-size pairs;
    pairs/s; one batch against the port on the CPU."""
    from metrics_tpu_torch import LPIPS

    t0 = time.perf_counter()
    ref, dist = _bapps_data(device)
    torch.cuda.synchronize()
    print(f"data: {BAPPS_PAIRS} pairs of [3, {BAPPS_HW}, {BAPPS_HW}] made and moved in "
          f"{time.perf_counter() - t0:.2f} s")
    for net in ("alex", "vgg"):
        m = _quiet(lambda: LPIPS(net_type=net, device=device))
        m(ref[0], dist[0])  # warm-up: cuDNN picks its algorithms
        m.reset()
        step_ms = []
        for i in range(len(ref)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m(ref[i], dist[i])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        value = m.compute()
        assert float(m.total) == BAPPS_PAIRS and bool(torch.isfinite(value))
        cpu_net = _quiet(lambda: LPIPS(net_type=net, device="cpu")).net
        card_net = m.net
        a, b = ref[0, :LPIPS_CHECK_PAIRS], dist[0, :LPIPS_CHECK_PAIRS]
        want = cpu_net(a.cpu(), b.cpu())
        got = card_net(a, b).cpu()
        err = float((got - want).abs().max())
        assert err <= LPIPS_RTOL * float(want.abs().max()), f"lpips {net}: card vs CPU max abs err {err}"
        print(f"LPIPS({net}): forward step of {BAPPS_STEP} pairs median {np.median(step_ms):.3f} ms, "
              f"{BAPPS_STEP / np.median(step_ms) * 1e3:.1f} pairs/s, {len(ref)} steps in {sum(step_ms) / 1e3:.2f} s; "
              f"mean distance {float(value):.6f}; {LPIPS_CHECK_PAIRS} pairs card vs CPU max abs err {err:.3e} "
              f"(bound {LPIPS_RTOL * float(want.abs().max()):.3e})")
        _step_profile(lambda: m(ref[0], dist[0]), float(np.median(step_ms)), top=4)
        _print_compile(f"LPIPS({net})", m)
        del m
    del ref, dist


def _div2k_data(device):
    """100 uint8 high-resolution images cut to [3, 1356, 2040] and their
    reconstructions (each pixel off by -8..8, clipped), from RandomState(9),
    drawn as bytes and combined on the card, as [25, 4, 3, 1356, 2040]
    uint8 each."""
    rng = np.random.RandomState(9)
    shape = (DIV2K_STEPS, DIV2K_STEP, 3, *DIV2K_HW)
    hr = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(device)
    noise = torch.from_numpy(rng.randint(-8, 9, shape, dtype=np.int8)).to(device)
    sr = torch.clamp(hr.to(torch.int16) + noise, 0, 255).to(torch.uint8)
    return sr, hr


def _image_ssim_phase(device):
    """PSNR and streaming SSIM over DIV2K's validation split at full size;
    step time and SSIM's window-conv time; the first 2 steps against the port
    on the CPU; the float32 counts against the JAX package's rounding."""
    import torch.nn.functional as F

    from metrics_tpu_torch import PSNR, SSIM
    from metrics_tpu_torch.functional import image_gradients
    from metrics_tpu_torch.functional.image.ssim import _gaussian_kernel
    from metrics_tpu_torch.utils.device import full_float32

    t0 = time.perf_counter()
    sr, hr = _div2k_data(device)
    torch.cuda.synchronize()
    print(f"data: {DIV2K_IMAGES} pairs of uint8 [3, {DIV2K_HW[0]}, {DIV2K_HW[1]}] made and moved in "
          f"{time.perf_counter() - t0:.2f} s")

    def batch(i, dev):
        return sr[i].to(dev).to(torch.float32) / 255.0, hr[i].to(dev).to(torch.float32) / 255.0

    def make(dev):
        return {"psnr": PSNR(data_range=1.0, device=dev), "ssim": SSIM(data_range=1.0, device=dev)}

    warm = make(device)
    for m in warm.values():
        m.update(*batch(0, device))
    del warm
    ms = make(device)
    step_ms = []
    for i in range(DIV2K_STEPS):
        p, t = batch(i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in ms.values():
            m.update(p, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    values = {k: m.compute() for k, m in ms.items()}
    # the full run's float32 counts against the JAX package's: the same
    # float32 additions, rounded past 2**24
    n_map = DIV2K_STEP * 3 * (DIV2K_HW[0] - 10) * (DIV2K_HW[1] - 10)
    n_pix = DIV2K_STEP * 3 * DIV2K_HW[0] * DIV2K_HW[1]
    jax_counts = {"ssim": np.float32(0), "psnr": np.float32(0)}
    for _ in range(DIV2K_STEPS):
        jax_counts["ssim"] = np.float32(jax_counts["ssim"] + np.float32(n_map))
        jax_counts["psnr"] = np.float32(jax_counts["psnr"] + np.float32(n_pix))
    for k, m in ms.items():
        assert m.total.dtype == torch.float32 and float(m.total) == float(jax_counts[k]), (k, float(m.total))
    assert all(bool(torch.isfinite(v)) for v in values.values())

    p, t = batch(0, device)
    pad = 5
    planes = torch.cat([F.pad(x, (pad,) * 4, mode="reflect") for x in (p, t)])
    planes = torch.cat([planes, planes * planes, planes[:DIV2K_STEP] * planes[DIV2K_STEP:]])
    kernel = _gaussian_kernel(3, (11, 11), (1.5, 1.5), torch.float32, device)

    def window():
        with full_float32():
            return F.conv2d(planes, kernel, groups=3)

    conv_ms = _time_ms(window, reps=5, inner=3)
    conv_bytes = (planes.numel() + window().numel()) * 4
    planes_shape = planes.shape
    del planes
    fresh = make(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fresh["ssim"].update(p, t)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    dy, dx = image_gradients(p)
    assert dy.shape == dx.shape == p.shape and float(dy[..., -1, :].abs().max()) == 0.0
    _print_compile("image-ssim", ms)
    print(f"{DIV2K_STEPS} steps of {DIV2K_STEP} images: PSNR + SSIM update median {np.median(step_ms):.3f} ms "
          f"(first {step_ms[0]:.3f}), {DIV2K_STEP / np.median(step_ms) * 1e3:.2f} images/s; SSIM's window "
          f"(one depthwise 11x11 conv over the 5 stacked planes {list(planes_shape)}) {conv_ms:.3f} ms by CUDA events, "
          f"{conv_bytes / conv_ms / 1e6:.1f} GB/s of its input and output; peak memory of an SSIM update "
          f"{peak:.1f} MiB above its inputs; PSNR {float(values['psnr']):.6f} dB, SSIM {float(values['ssim']):.6f}; "
          f"float32 counts PSNR {float(ms['psnr'].total):.0f} (exact {DIV2K_STEPS * n_pix}), SSIM "
          f"{float(ms['ssim'].total):.0f} (exact {DIV2K_STEPS * n_map}), each equal to the JAX package's rounding")
    _step_profile(lambda: [m.update(p, t) for m in fresh.values()], float(np.median(step_ms)), top=5)
    del fresh, dy, dx

    # the card against the port on the CPU over the first 2 steps
    card, host = make(device), make("cpu")
    t0 = time.perf_counter()
    for i in range(SSIM_CHECK_STEPS):
        for dev, group in ((device, card), ("cpu", host)):
            pb, tb = batch(i, dev)
            for m in group.values():
                m.update(pb, tb)
    errs = {k: abs(float(card[k].compute()) - float(host[k].compute())) for k in card}
    assert errs["ssim"] <= SSIM_ATOL and errs["psnr"] <= PSNR_ATOL, errs
    assert float(card["ssim"].total) == float(host["ssim"].total)
    print(f"first {SSIM_CHECK_STEPS} steps card vs CPU ({time.perf_counter() - t0:.1f} s): |diff| {errs} (bounds "
          f"SSIM {SSIM_ATOL:.2e}, PSNR {PSNR_ATOL:.2e} dB)")
    del sr, hr


def _vocab():
    """5,000 seeded word strings (RandomState(20)): one to three syllables
    and an English suffix, so that the Porter stemmer has work; and the
    cumulative Zipf weights (p ~ 1 / rank) the text data draws them with."""
    rng = np.random.RandomState(20)
    onsets = ["b", "c", "d", "f", "g", "h", "l", "m", "n", "p", "r", "s", "t", "v", "w", "br", "ch", "pl", "st", "tr"]
    vowels = ["a", "e", "i", "o", "u", "ai", "ea", "ou"]
    codas = ["", "n", "r", "s", "t", "l", "nd", "st"]
    suffixes = ["", "", "", "s", "ing", "ed", "ation", "ness", "ly", "ies", "ful", "ment"]
    words = set()
    while len(words) < TEXT_VOCAB:
        syllables = "".join(onsets[rng.randint(len(onsets))] + vowels[rng.randint(len(vowels))]
                            + codas[rng.randint(len(codas))] for _ in range(rng.randint(1, 4)))
        words.add(syllables + suffixes[rng.randint(len(suffixes))])
    words = np.array(sorted(words))
    cdf = np.cumsum(1.0 / np.arange(1, TEXT_VOCAB + 1))
    return words[rng.permutation(TEXT_VOCAB)], cdf / cdf[-1]


def _draw(rng, vocab, n):
    words, cdf = vocab
    return list(words[np.minimum(np.searchsorted(cdf, rng.random_sample(n)), len(words) - 1)])


def _edit(rng, vocab, tokens, sub, dele, ins):
    """``tokens`` with each word substituted, deleted or followed by an
    inserted word with the given probabilities."""
    out = []
    for w, r in zip(tokens, rng.rand(len(tokens))):
        if r < dele:
            continue
        out.append(_draw(rng, vocab, 1)[0] if r < dele + sub else w)
        if r > 1 - ins:
            out.append(_draw(rng, vocab, 1)[0])
    return out or list(tokens[:1])


def _text_data(n_wer, n_bleu, n_rouge):
    """The text phases' data, the first ``n_*`` items of each family (one
    RandomState each, 21 to 23, so a prefix costs only itself):
    - wer: 2,620 (hypothesis, reference) utterances of 10-30 words
      (LibriSpeech test-clean's count), 5% each substituted, deleted and
      inserted;
    - bleu: 3,000 (tokenized hypothesis, [reference]) segments of 15-35
      tokens (a WMT newstest's count), 20% substituted, 5% deleted, 5%
      inserted;
    - rouge: 1,000 (summary, highlights) pairs: highlights of 3-4 sentences,
      ~56 words together (CNN/DailyMail's), a summary reusing 60% of their
      words and one sentence of its own;
    - bert: the bleu segments as sentence pairs, every 10th pair identical."""
    vocab = _vocab()

    def pairs(seed, n, lo, hi, sub):
        rng = np.random.RandomState(seed)
        refs, hyps = [], []
        for _ in range(n):
            refs.append(_draw(rng, vocab, rng.randint(lo, hi)))
            hyps.append(_edit(rng, vocab, refs[-1], sub, 0.05, 0.05))
        return refs, hyps

    wer_refs, wer_hyps = pairs(21, n_wer, 10, 31, 0.05)
    bleu_refs, bleu_hyps = pairs(22, n_bleu, 15, 36, 0.2)
    rng = np.random.RandomState(23)
    highlights, summaries = [], []
    for _ in range(n_rouge):
        n = rng.randint(3, 5)
        sents = [_draw(rng, vocab, rng.randint(56 // n - 3, 56 // n + 4)) for _ in range(n)]
        highlights.append(" ".join(" ".join(s).capitalize() + "." for s in sents))
        kept = [[w for w in s if rng.rand() < 0.6] or s[:1] for s in sents]
        summaries.append(" ".join(" ".join(s).capitalize() + "." for s in kept + [_draw(rng, vocab, rng.randint(8, 16))]))
    bert_hyps = [" ".join(h) for h in bleu_hyps]
    bert_refs = [" ".join(r) for r in bleu_refs]
    for i in range(0, n_bleu, 10):
        bert_hyps[i] = bert_refs[i]
    return {
        "wer": ([" ".join(h) for h in wer_hyps], [" ".join(r) for r in wer_refs]),
        "bleu": ([[r] for r in bleu_refs], bleu_hyps),
        "rouge": (summaries, highlights),
        "bert": (bert_hyps, bert_refs),
    }


def _text_metrics(dev):
    from metrics_tpu_torch import WER, BLEUScore, ROUGEScore

    return {"wer": WER(device=dev), "bleu": BLEUScore(device=dev),
            "rouge": ROUGEScore(use_stemmer=True, rouge_keys=ROUGE_KEYS, device=dev)}


def _text_run(data, dev):
    """WER, BLEU and ROUGE over their data in steps; host ms of each update
    (ending in a synchronize on the card) and of each compute()."""
    metrics, update_ms, compute_ms, values = _text_metrics(dev), {}, {}, {}
    for name, m in metrics.items():
        a, b = data[name]
        step = TEXT_STEPS[name]
        update_ms[name] = []
        for i in range(0, len(a), step):
            t0 = time.perf_counter()
            m.update(a[i:i + step], b[i:i + step])
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            update_ms[name].append((time.perf_counter() - t0) * 1e3)
        compute_ms[name] = []
        for _ in range(2):  # the first call also loads the card's kernels
            t0 = time.perf_counter()
            values[name] = _fresh(m)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            compute_ms[name].append((time.perf_counter() - t0) * 1e3)
    return metrics, values, update_ms, compute_ms


def _text_phase(device):
    """WER at LibriSpeech test-clean size, BLEU at newstest size and ROUGE
    (rouge1/2/L/Lsum, stemmed) on 1,000 CNN/DailyMail-size summaries, on the
    card and on the CPU: states equal, WER's value equal, BLEU's within an
    ulp's bound, ROUGE's per-sentence states equal and means within a bound."""
    import metrics_tpu_torch.functional.text.rouge as rouge_mod

    t0 = time.perf_counter()
    data = _text_data(LIBRISPEECH_UTTERANCES, NEWSTEST_SEGMENTS, CNNDM_SUMMARIES)
    print(f"data: {TEXT_VOCAB} words; {LIBRISPEECH_UTTERANCES} utterances, {NEWSTEST_SEGMENTS} segments, "
          f"{CNNDM_SUMMARIES} summaries made in {time.perf_counter() - t0:.2f} s; stemmer: "
          f"{'nltk' if rouge_mod._NLTK_AVAILABLE else 'built-in Porter (nltk absent)'}")
    card, card_values, update_ms, compute_ms = _text_run(data, device)
    cpu, cpu_values, _, _ = _text_run(data, "cpu")
    for name, m in card.items():
        for k, v in m._state.items():
            assert all(x.device == device for x in (v if isinstance(v, list) else [v])), f"{name}.{k} is not on the card"
            w = cpu[name]._state[k]
            if isinstance(v, list):
                assert torch.equal(torch.cat(v).cpu(), torch.cat(w)), f"{name}.{k}: per-sentence values differ"
            else:
                assert torch.equal(v.cpu(), w), f"{name}.{k} differs between the card and the CPU"
    assert torch.equal(card_values["wer"].cpu(), cpu_values["wer"]), "wer value differs"
    bleu_err = abs(float(card_values["bleu"]) - float(cpu_values["bleu"]))
    assert bleu_err <= BLEU_RTOL * float(cpu_values["bleu"]), f"bleu: card vs CPU {bleu_err}"
    rouge_errs = {k: abs(float(v) - float(cpu_values["rouge"][k])) for k, v in card_values["rouge"].items()}
    for k, err in rouge_errs.items():
        assert err <= ROUGE_MEAN_RTOL * float(cpu_values["rouge"][k]), f"rouge {k}: card vs CPU {err}"
    words = sum(len(r.split()) for r in data["wer"][1])
    assert float(card["wer"].total) == words and len(torch.cat(card["rouge"].rouge1_fmeasure)) == CNNDM_SUMMARIES
    for name in card:
        n = len(update_ms[name])
        print(f"{name}: {n} updates, host ms per update median {np.median(update_ms[name]):.3f} (max "
              f"{max(update_ms[name]):.3f}), {sum(update_ms[name]) / 1e3:.2f} s in all; compute() "
              f"{compute_ms[name][0]:.3f} ms the first time, {compute_ms[name][1]:.3f} ms again")
    _print_compile("text", card)
    print(f"WER {float(card_values['wer']):.6f} over {words} reference words (states and value equal to the CPU "
          f"run); BLEU {float(card_values['bleu']):.6f} (states equal; value card vs CPU {bleu_err:.3e}, bound "
          f"{BLEU_RTOL:.1e} relative); ROUGE per-sentence states equal to the CPU run, means "
          + ", ".join(f"{k} {float(v):.6f}" for k, v in card_values["rouge"].items() if k.endswith("fmeasure"))
          + f" (max card vs CPU {max(rouge_errs.values()):.3e}, bound {ROUGE_MEAN_RTOL:.1e} relative)")
    return data


def _bert_base_weights(seed=0):
    """A random bert-base-uncased-width state dict in HF ``BertModel``
    layout, ``bert.``-prefixed, with a pooler the loader ignores, from a
    seeded ``torch.Generator``: weights and biases N(0, 0.02), layer-norm
    scales 1 + N(0, 0.02)."""
    from metrics_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(**BERT_BASE)
    d, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab_size, d),
              "embeddings.position_embeddings.weight": (cfg.max_position_embeddings, d),
              "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, d),
              "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,)}
    for i in range(cfg.num_hidden_layers):
        for name, shape in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (inter, d)), ("output.dense", (d, inter))):
            shapes[f"encoder.layer.{i}.{name}.weight"], shapes[f"encoder.layer.{i}.{name}.bias"] = shape, shape[:1]
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"encoder.layer.{i}.{name}.weight"] = shapes[f"encoder.layer.{i}.{name}.bias"] = (d,)
    shapes["pooler.dense.weight"] = (d, d)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        w = torch.randn(shape, generator=gen) * 0.02
        sd["bert." + k] = w + 1 if k.endswith("LayerNorm.weight") else w
    return cfg, sd


def _last_hidden(model, batch):
    return model(batch["input_ids"], batch["attention_mask"])[-1]


def _bert_errs(got, want):
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in ("precision", "recall", "f1")}


def _bertscore_phase(device, data):
    """BERTScore over 3,000 newstest-size pairs through a bert-base-width
    encoder (random weights loaded through ``load_torch_bert_weights``), in
    30 update steps, and the default encoder with ``idf=True``; encoder
    sentences/s; compute() timed and profiled; the first 64 pairs against
    the port on the CPU; identical pairs, swapped sides and TF32."""
    import metrics_tpu_torch.functional.text.bert as bs_mod
    import metrics_tpu_torch.models.bert as bert_mod
    from metrics_tpu_torch import BERTScore
    from metrics_tpu_torch.models.bert import BertEncoder

    hyps, refs = data["bert"]
    t0 = time.perf_counter()
    cfg, sd = _bert_base_weights()
    enc = BertEncoder(cfg, weights=sd, device=device)
    enc_cpu = BertEncoder(cfg, weights=sd, device="cpu")
    del sd
    params = sum(p.numel() for p in enc.parameters())
    assert all(p.device == device for p in enc.parameters()), "the encoder is not on the card"
    print(f"bert-base-width encoder ({cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, {params} parameters) "
          f"loaded on the card and the CPU in {time.perf_counter() - t0:.2f} s")

    # the encoder alone: CUDA events over forwards of 64 sentences of 128 tokens
    tok = bs_mod.SimpleTokenizer(max_length=BERT_MAX_LEN)(hyps[:BERT_BATCH])
    ids, mask = (torch.as_tensor(tok[k], device=device) for k in ("input_ids", "attention_mask"))
    enc(ids, mask)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ENCODER_REPS):
        enc(ids, mask)
    end.record()
    torch.cuda.synchronize()
    fwd_ms = start.elapsed_time(end) / ENCODER_REPS
    print(f"encoder forward of [{BERT_BATCH}, {BERT_MAX_LEN}] float32 (TF32 off): {fwd_ms:.3f} ms by CUDA events "
          f"(mean of {ENCODER_REPS}), {BERT_BATCH / fwd_ms * 1e3:.1f} sentences/s")

    m = BERTScore(model=enc, user_forward_fn=_last_hidden, max_length=BERT_MAX_LEN, batch_size=BERT_BATCH,
                  device=device)
    assert m.model is enc and not list(m.children())
    step = NEWSTEST_SEGMENTS // BERT_STEPS
    update_ms = []
    for i in range(0, NEWSTEST_SEGMENTS, step):
        t0 = time.perf_counter()
        m.update(hyps[i:i + step], refs[i:i + step])
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    for name in ("preds_input_ids", "target_attention_mask"):
        state = getattr(m, name)
        assert all(s.device == device and s.dtype == torch.int32 and s.shape == (step, BERT_MAX_LEN) for s in state)
    values, prof = _profile_call(lambda: _fresh(m), reps=1)
    _print_compile("bertscore", m)
    print(f"{BERT_STEPS} updates of {step} pairs: host ms per update median {np.median(update_ms):.3f} (tokenizing "
          f"and one copy per state); compute() over {NEWSTEST_SEGMENTS} pairs ({2 * NEWSTEST_SEGMENTS} sentences): "
          f"{2 * NEWSTEST_SEGMENTS / prof['event_ms'] * 1e3:.1f} sentences/s end to end")
    _print_profile(f"BERTScore over {NEWSTEST_SEGMENTS} pairs", prof)
    f1 = np.asarray(values["f1"])
    assert f1.shape == (NEWSTEST_SEGMENTS,) and np.isfinite(f1).all()

    # the first 64 pairs against the port on the CPU, with the TF32 flags
    # off and on; then without the float32 guard and TF32 on
    kw = dict(user_forward_fn=_last_hidden, max_length=BERT_MAX_LEN, batch_size=BERT_BATCH)
    n = BERT_CHECK_PAIRS
    t0 = time.perf_counter()
    want = bs_mod.bert_score(hyps[:n], refs[:n], model=enc_cpu, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    del enc_cpu
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    got = {}
    try:
        for flags in ((False, False), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            got[flags] = bs_mod.bert_score(hyps[:n], refs[:n], model=enc, device=device, **kw)
        guards = (bert_mod.full_float32, bs_mod.full_float32)
        bert_mod.full_float32 = bs_mod.full_float32 = contextlib.nullcontext
        try:
            unguarded = bs_mod.bert_score(hyps[:n], refs[:n], model=enc, device=device, **kw)
        finally:
            bert_mod.full_float32, bs_mod.full_float32 = guards
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    errs = _bert_errs(got[(False, False)], want)
    assert max(errs.values()) <= BERT_ATOL, f"BERTScore, {n} pairs card vs CPU: {errs} > {BERT_ATOL}"
    assert got[(True, True)] == got[(False, False)], "BERTScore moved with TF32 switched on outside the guard"
    in_metric = _bert_errs({k: v[:n] for k, v in values.items()}, got[(False, False)])
    assert max(in_metric.values()) <= BERT_ATOL, in_metric
    unguarded_err = max(_bert_errs(unguarded, want).values())
    print(f"first {n} pairs, card vs the port on the CPU ({cpu_s:.1f} s on the host): max abs err {errs} (bound "
          f"{BERT_ATOL:.3e}); equal with TF32 switched on outside the guard; the metric's own first {n} "
          f"within {max(in_metric.values()):.3e} of them; without the guard, TF32 on: {unguarded_err:.3e} "
          f"({unguarded_err / BERT_ATOL:.1f}x the bound)")

    same = np.arange(0, NEWSTEST_SEGMENTS, 10)
    f1_err = float(np.abs(f1[same] - 1).max())
    assert f1_err <= BERT_ATOL, f"identical pairs: F1 off 1 by {f1_err}"
    swapped = bs_mod.bert_score(
        {"input_ids": torch.cat(m.target_input_ids), "attention_mask": torch.cat(m.target_attention_mask)},
        {"input_ids": torch.cat(m.preds_input_ids), "attention_mask": torch.cat(m.preds_attention_mask)},
        model=enc, device=device, **kw)
    swap_err = max(float(np.abs(np.asarray(swapped["precision"]) - np.asarray(values["recall"])).max()),
                   float(np.abs(np.asarray(swapped["recall"]) - np.asarray(values["precision"])).max()))
    assert swap_err <= BERT_ATOL, f"swapping the sides: P and R off by {swap_err}"
    print(f"all {NEWSTEST_SEGMENTS} pairs: mean F1 {f1.mean():.6f}; the {len(same)} identical pairs' F1 within "
          f"{f1_err:.3e} of 1; swapping the sides swaps P and R within {swap_err:.3e}")
    del m, enc, values, swapped

    # the default encoder (the JAX package's BertConfig(), bert_init weights), idf=True
    t0 = time.perf_counter()
    m = _quiet(lambda: BERTScore(max_length=BERT_MAX_LEN, batch_size=BERT_BATCH, idf=True, device=device))
    for i in range(0, NEWSTEST_SEGMENTS, step):
        m.update(hyps[i:i + step], refs[i:i + step])
    values, prof = _profile_call(lambda: _quiet(lambda: _fresh(m)), reps=1)
    default_s = time.perf_counter() - t0
    assert np.isfinite(values["f1"]).all() and len(values["f1"]) == NEWSTEST_SEGMENTS
    want = _quiet(lambda: bs_mod.bert_score(hyps[:n], refs[:n], idf=True, device="cpu", **dict(kw, user_forward_fn=None)))
    got = _quiet(lambda: bs_mod.bert_score(hyps[:n], refs[:n], idf=True, device=device, **dict(kw, user_forward_fn=None)))
    errs = _bert_errs(got, want)
    assert max(errs.values()) <= BERT_ATOL, f"default BERTScore, {n} pairs card vs CPU: {errs}"
    print(f"default encoder, idf=True: {NEWSTEST_SEGMENTS} pairs in {default_s:.2f} s with its bert_init on the card; "
          f"mean F1 {np.mean(values['f1']):.6f}; first {n} pairs card vs CPU max abs err {errs}")
    _print_profile(f"default BERTScore(idf=True) over {NEWSTEST_SEGMENTS} pairs", prof)
    del m


def _wsj_step(spk, step, device):
    """One step of 100 mixtures of ``spk`` speakers at 8 kHz cut to 32,000
    samples, from RandomState(40 + 10 * spk + step): 16-bit PCM sources,
    drawn as bytes, scaled on the device; each estimate is one source (a
    random permutation) plus 0.2 of the next and 0.3 of 16-bit noise."""
    rng = np.random.RandomState(40 + 10 * spk + step)
    batch = HUNGARIAN_MIXTURES if spk == HUNGARIAN_SPK else WSJ_STEP
    shape = (batch, spk, WSJ_SAMPLES)
    size = int(np.prod(shape)) * 2
    src = torch.frombuffer(bytearray(rng.bytes(size)), dtype=torch.int16).reshape(shape)
    noise = torch.frombuffer(bytearray(rng.bytes(size)), dtype=torch.int16).reshape(shape)
    perm = torch.from_numpy(np.argsort(rng.rand(batch, spk), axis=1))
    target = src.to(device).to(torch.float32) / 32768
    perm = perm.to(device)
    index = perm[:, :, None].expand(shape)
    nxt = torch.roll(perm, 1, dims=1)[:, :, None].expand(shape)
    est = torch.gather(target, 1, index) + torch.gather(target, 1, nxt) * 0.2
    est = est + (noise.to(device).to(torch.float32) / 32768) * 0.3
    return est, target


def _audio_metrics(dev):
    from metrics_tpu_torch import PIT, SI_SDR, SI_SNR, SNR
    from metrics_tpu_torch.functional.audio import si_sdr

    return {"pit": PIT(si_sdr, "max", device=dev), "si_sdr": SI_SDR(device=dev), "si_snr": SI_SNR(device=dev),
            "snr": SNR(device=dev)}


def _audio_step(metrics, est, target):
    """PIT(si_sdr) on the estimates, then SI-SDR, SI-SNR and SNR on the
    estimates put in PIT's order; returns the permutation."""
    from metrics_tpu_torch.functional.audio import pit, pit_permutate, si_sdr

    metrics["pit"].update(est, target)
    _, perm = pit(est, target, si_sdr, "max")
    permuted = pit_permutate(est, perm)
    for name in ("si_sdr", "si_snr", "snr"):
        metrics[name].update(permuted, target)
    return perm


def _pit_margins(est, target):
    """Per mixture, the gap between the best and the second best
    permutation's mean SI-SDR (float32, on the host); read where the card's
    and the CPU's permutations differ."""
    from metrics_tpu_torch.functional.audio import si_sdr
    from metrics_tpu_torch.functional.audio.pit import _metric_matrix, _perm_table

    mtx = _metric_matrix(est, target, si_sdr)
    spk = mtx.shape[-1]
    perms = _perm_table(spk, mtx.device)
    scores = torch.sort(mtx[:, torch.arange(spk)[None, :], perms].mean(-1), dim=-1).values
    return scores[:, -1] - scores[:, -2]


def _audio_phase(device):
    """PIT(si_sdr) and SI-SDR, SI-SNR, SNR on PIT's order at WSJ0-2mix and
    wsj0-3mix test size (3,000 mixtures of 32,000 samples each, 30 steps of
    100), and one batch of 8 speakers through the host Hungarian solve;
    step ms and idle share; against the same run on the CPU."""
    for spk, mixtures in ((2, WSJ_MIXTURES), (3, WSJ_MIXTURES), (HUNGARIAN_SPK, HUNGARIAN_MIXTURES)):
        steps = 1 if spk == HUNGARIAN_SPK else mixtures // WSJ_STEP
        card, cpu = _audio_metrics(device), _audio_metrics("cpu")
        _audio_step(_audio_metrics(device), *_wsj_step(spk, 0, device))  # warm-up
        step_ms, ties, data_s = [], 0, 0.0
        for step in range(steps):
            t0 = time.perf_counter()
            est, target = _wsj_step(spk, step, device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            perm = _audio_step(card, est, target)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            data_s += t1 - t0
            est_cpu, target_cpu = _wsj_step(spk, step, "cpu")
            assert torch.equal(est.cpu(), est_cpu), "the estimates differ between the card and the CPU"
            perm_cpu = _audio_step(cpu, est_cpu, target_cpu)
            differ = (perm.cpu() != perm_cpu).any(-1)
            if bool(differ.any()):  # allowed only where two permutations tie within the bound
                ties += int(differ.sum())
                margin = _pit_margins(est_cpu[differ], target_cpu[differ])
                assert bool((margin <= 2 * AUDIO_DB_ATOL).all()), \
                    f"{spk} speakers: permutations differ where the best leads by {margin.max()} dB"
        for name, m in card.items():
            assert all(v.device == device for v in m._state.values()), f"{name}: a state is not on the card"
            c = cpu[name]
            assert int(m.total) == int(c.total) == mixtures * (1 if name == "pit" else spk), name
            sum_name = next(k for k in c._state if k != "total")
            got, want = float(getattr(m, sum_name)), float(getattr(c, sum_name))
            # per-value bounds of every value, plus each side's float32
            # accumulation: a sum over a step's values, then the steps
            sum_bound = float(c.total) * AUDIO_DB_ATOL + 2 * (np.log2(WSJ_STEP) + steps) * 2.0 ** -24 * abs(want)
            assert abs(got - want) <= sum_bound, f"{spk} speakers, {name}: sum card vs CPU {abs(got - want)}"
            value_err = abs(float(m.compute()) - float(c.compute()))
            assert value_err <= sum_bound / float(c.total) + 2.0 ** -23 * abs(want / float(c.total)), (name, value_err)
        print(f"{spk} speakers ({'Hungarian, host' if spk > 6 else 'exhaustive'} search), {mixtures} mixtures of "
              f"{WSJ_SAMPLES} samples in {steps} step(s): step median {np.median(step_ms):.3f} ms (max "
              f"{max(step_ms):.3f}); data made and moved in {data_s:.2f} s; "
              + ", ".join(f"{k} {float(m.compute()):.4f} dB" for k, m in card.items())
              + f"; states within their bounds of the CPU run, counts equal; permutations equal to the CPU's in "
              f"{mixtures - ties} of {mixtures} mixtures, the {ties} others tied within {2 * AUDIO_DB_ATOL:.1e} dB")
        _print_compile(f"audio, {spk} speakers", card)
        est, target = _wsj_step(spk, 0, device)
        _step_profile(lambda: _audio_step(card, est, target), float(np.median(step_ms)), top=4)
        del card, cpu, est, target
    _integer_target_si_snr(device)


def _integer_target_si_snr(device):
    """SI-SNR of one 2-speaker step's float estimates against its 16-bit PCM
    sources as integer references (ROADMAP C.28: promoted to float32 before
    the zero-mean step, as ``jnp.mean`` does): on the card bit-equal to the
    same references as float32, and within AUDIO_DB_ATOL of the CPU run,
    value by value and as the ``SI_SNR`` mean."""
    from metrics_tpu_torch import SI_SNR
    from metrics_tpu_torch.functional.audio import si_snr

    est, target = _wsj_step(2, 0, device)
    pcm = (target * 32768).to(torch.int64)  # exact: the sources are 16-bit PCM over 32768
    got = si_snr(est, pcm)
    assert torch.equal(got, si_snr(est, pcm.to(torch.float32))), "integer references: not the float32 value"
    err = _check_values("si_snr, integer references", got, si_snr(est.cpu(), pcm.cpu()), AUDIO_DB_ATOL)
    card, cpu = SI_SNR(device=device), SI_SNR(device="cpu")
    card.update(est, pcm)
    cpu.update(est.cpu(), pcm.cpu())
    # the mean of the values, each within AUDIO_DB_ATOL, after float32 sums
    # of log2(n) roundings on either side
    mean = float(cpu.compute())
    bound = AUDIO_DB_ATOL + 2 * float(np.log2(got.numel())) * 2.0 ** -24 * abs(mean)
    mean_err = _check_values("SI_SNR, integer references", card.compute(), cpu.compute(), bound)
    print(f"si_snr against {tuple(pcm.shape)} int64 PCM references: mean {mean:.4f} dB, equal to the float32 "
          f"references on the card; card vs CPU max abs err {err:.3g} dB per value, {mean_err:.3g} dB as SI_SNR "
          f"(bounds {AUDIO_DB_ATOL:.3g}, {bound:.3g})")


# ---------------------------------------------------------------------------
# the compiled hot path
# ---------------------------------------------------------------------------

#: Steps a compiled-phase run takes: the default warm-up of 16 eager steps,
#: then 32 compiled ones (the medians are over the last 24).
COMPILED_STEPS = 48
COMPILED_TAIL = 24
COMPILED_PROFILE_STEPS = 4

#: What the JAX package's ``compile_stats()`` reports for the same calls
#: (``tests/test_torch_compiled.py`` runs both packages on the CPU): the
#: fallback kinds of each member; every other member compiles.
JAX_FALLBACK_KINDS = {
    "flagship": {"acc": {"update", "forward"}},
    "report": {},
    "regression": {},
    "binned": {},
    "audio": {},
}


def _compile_summary(obj):
    """One line of ``compile_stats()``: traces/dispatches and the fallback
    kinds, for a metric, a collection (and its members) or a dict of metrics."""
    from metrics_tpu_torch import MetricCollection

    def one(cs):
        kinds = ",".join(sorted(cs["fallback"] or {})) or "-"
        return f"{cs['traces']}/{cs['dispatches']} fb={kinds}"

    if isinstance(obj, MetricCollection):
        cs = obj.compile_stats()
        return f"collection {one(cs['collection'])}; " + "; ".join(f"{k} {one(v)}" for k, v in cs["members"].items())
    if isinstance(obj, dict):
        return "; ".join(f"{k} {one(m.compile_stats())}" for k, m in obj.items())
    return one(obj.compile_stats())


def _print_compile(what, obj):
    print(f"compile_stats {what} (traces/dispatches, fallback kinds): {_compile_summary(obj)}")


def _check_compiled(name, obj):
    """Every member the JAX package compiles dispatched and fell back
    nowhere; the members it refuses carry its fallback kinds."""
    from metrics_tpu_torch import MetricCollection

    expected = JAX_FALLBACK_KINDS[name]
    if isinstance(obj, MetricCollection):
        cs = obj.compile_stats()
        assert cs["collection"]["fallback"] is None, f"{name}: collection fell back: {cs['collection']['fallback']}"
        members, coll_dispatches = cs["members"], cs["collection"]["dispatches"]
        grouped = {k for keys in obj.compute_group_keys for k in keys}
    else:
        members = {k: m.compile_stats() for k, m in obj.items()}
        coll_dispatches, grouped = 0, set()
    for key, st in members.items():
        kinds = set(st["fallback"] or {})
        assert kinds == expected.get(key, set()), f"{name}.{key}: fallback {st['fallback']}, JAX: {expected.get(key)}"
        if not kinds:
            ran = st["dispatches"] > 0 or (key in grouped and coll_dispatches > 0)
            assert ran, f"{name}.{key}: compiled path never dispatched ({st})"


def _flagship_collection(dev):
    from metrics_tpu_torch import Accuracy, MetricCollection, StatScores

    return MetricCollection({
        "acc": Accuracy(num_classes=NUM_CLASSES, device=dev),
        "stats": StatScores(reduce="macro", num_classes=NUM_CLASSES, device=dev),
    })


def _binned_collection(dev):
    from metrics_tpu_torch import BinnedAveragePrecision, BinnedRecallAtFixedPrecision, MetricCollection

    return MetricCollection({
        "ap": BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=dev),
        "rfp": BinnedRecallAtFixedPrecision(
            num_classes=NUM_CLASSES, min_precision=0.5, thresholds=THRESHOLDS, device=dev),
    })


def _compiled_workloads(device):
    """``(name, make(dev), step(obj, i), steps data)`` of the compiled phase:
    the flagship, the grouped report, the regression and binned collections
    (``forward``) and the 2-speaker audio step (``update``)."""
    rng = np.random.RandomState(0)
    probs = torch.from_numpy(rng.rand(COMPILED_STEPS, BATCH, NUM_CLASSES).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.randint(0, NUM_CLASSES, (COMPILED_STEPS, BATCH))).to(device)
    rep_probs, rep_labels = (x.to(device) for x in _report_data())
    reg_preds, reg_target = (x.to(device) for x in _depth_data())
    audio = [_wsj_step(2, i, device) for i in range(WSJ_MIXTURES // WSJ_STEP)]

    def cycle(preds, target):
        return lambda mc, i: mc(preds[i % len(preds)], target[i % len(preds)])

    def audio_step(metrics, i):
        return _audio_step(metrics, *audio[i % len(audio)])

    return [
        ("flagship", _flagship_collection, cycle(probs, labels)),
        ("report", _report_collection, cycle(rep_probs, rep_labels)),
        ("regression", _regression_collection, cycle(reg_preds, reg_target)),
        ("binned", _binned_collection, cycle(probs, labels)),
        ("audio", _audio_metrics, audio_step),
    ]


def _set_knob(obj, knob):
    for m in obj.values():
        m.compiled_update = knob
    return obj


def _compiled_run(make, step, device, knob):
    """``COMPILED_STEPS`` steps with ``compiled_update=knob`` (``None``: the
    default warm-up, then compiled); host-clock ms of each step ending in a
    synchronize; then a profile of ``COMPILED_PROFILE_STEPS`` more steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    obj = _set_knob(make(device), knob)
    torch.cuda.synchronize()
    step_ms = []
    for i in range(COMPILED_STEPS):
        t0 = time.perf_counter()
        step(obj, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    states = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in _state_leaves_of(obj).items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(COMPILED_STEPS, COMPILED_STEPS + COMPILED_PROFILE_STEPS):
            step(obj, i)
        torch.cuda.synchronize()
    n = COMPILED_PROFILE_STEPS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    graph_launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU and e.name == "cudaGraphLaunch")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3 if kernels else None
    return obj, states, {
        "tail_ms": step_ms[-COMPILED_TAIL:],
        "first_step_ms": step_ms[0],
        "first_compiled_step_ms": step_ms[compiled_warmup_steps()] if knob is None else None,
        "kernels_per_step": len(kernels) / n if kernels else None,
        "graph_launches_per_step": graph_launches / n,
        "syncs_per_step": len(_sync_events(prof)) / n,
        "busy_ms": busy_ms,
    }


def compiled_warmup_steps():
    from metrics_tpu_torch.core.compiled import compiled_warmup

    return compiled_warmup()


def _state_leaves_of(obj):
    if isinstance(obj, dict):
        return {f"{k}.{n}": v for k, m in obj.items() for n, v in m._state.items()}
    return _state_leaves(obj)


def _compiled_phase(smi, device):
    """Each workload with ``compiled_update=False`` (eager) and with the
    default (16 eager steps, then CUDA-graph replays), in turns: step ms,
    kernels and graph launches a step, host syncs, idle share, traces,
    dispatches and fallbacks; the states equal leaf for leaf (``torch.equal``);
    the binned run's B1 launches counted through the replays and its states
    equal to the CPU run's (the kernel's plain twin)."""
    from metrics_tpu_torch.ops import binned_stats

    print(smi)
    results = {}
    for name, make, step in _compiled_workloads(device):
        t0 = time.perf_counter()
        runs, tails = {}, {"eager": [], "compiled": []}
        # in turns (eager, compiled, compiled, eager): the host-bound steps
        # drift between runs; the medians pool both runs of each path
        for label in ("eager", "compiled", "compiled", "eager"):
            launches0 = binned_stats.KERNEL_LAUNCHES
            obj, states, stats = _compiled_run(make, step, device, False if label == "eager" else None)
            stats["b1_launches"] = binned_stats.KERNEL_LAUNCHES - launches0
            tails[label] += stats.pop("tail_ms")
            runs[label] = (obj, states, stats)
        for label, (_, _, st) in runs.items():
            st["step_ms"] = float(np.median(tails[label]))
            st["idle"] = None if st["busy_ms"] is None else 1 - st["busy_ms"] / st["step_ms"]
        (eager, eager_states, e), (comp, comp_states, c) = runs["eager"], runs["compiled"]
        assert sorted(eager_states) == sorted(comp_states)
        for k, v in eager_states.items():
            w = comp_states[k]
            assert v.dtype == w.dtype and torch.equal(v, w), f"{name}: state {k} differs between eager and compiled"
        _check_compiled(name, comp)
        assert all(st["dispatches"] == 0 for st in _stats_of(eager)), f"{name}: the eager run dispatched"
        if name == "binned":
            # two launches a step, eager or replayed; a program's eager
            # warm-up (one per trace) launches the kernel once more
            want = 2 * (COMPILED_STEPS + COMPILED_PROFILE_STEPS) if device.type == "cuda" else 0
            warmups = sum(st["traces"] for st in _stats_of(comp)) if device.type == "cuda" else 0
            assert e["b1_launches"] == want and c["b1_launches"] == want + warmups, (e, c, want, warmups)
            cpu = _set_knob(make("cpu"), False)
            for i in range(COMPILED_STEPS):
                step(_CpuInputs(cpu), i)
            cpu_states = _state_leaves_of(cpu)
            for k, v in comp_states.items():
                assert torch.equal(v.cpu(), cpu_states[k]), f"binned: replayed B1 state {k} differs from the plain twin"
        _print_compile(f"{name} (compiled run)", comp)
        for label, st in (("eager", e), ("compiled", c)):
            idle = "not measured" if st["idle"] is None else f"{100 * st['idle']:.2f}%"
            print(f"{name} {label}: step {st['step_ms']:.4f} ms (median of the last {COMPILED_TAIL} of two runs), "
                  f"{st['kernels_per_step']} kernels/step, {st['graph_launches_per_step']} cudaGraphLaunch/step, "
                  f"{st['syncs_per_step']} cudaStreamSynchronize/step, device busy {st['busy_ms']} ms/step, idle "
                  f"{idle}; B1 launches {st['b1_launches']}"
                  + ("" if st["first_compiled_step_ms"] is None else
                     f"; step {compiled_warmup_steps() + 1} (probe, warm-up and capture) {st['first_compiled_step_ms']:.2f} ms"))
        print(f"{name}: states equal leaf for leaf (torch.equal) between the two runs; {time.perf_counter() - t0:.1f} s")
        results[name] = {"eager": e, "compiled": c}
    print("compiled phase: " + json.dumps(results))
    return results


class _CpuInputs:
    """A step function's collection, fed the step's inputs moved to the CPU."""

    def __init__(self, mc):
        self.mc = mc

    def __call__(self, *args):
        return self.mc(*(a.cpu() for a in args))


def _stats_of(obj):
    from metrics_tpu_torch import MetricCollection

    if isinstance(obj, MetricCollection):
        cs = obj.compile_stats()
        return [cs["collection"], *cs["members"].values()]
    return [m.compile_stats() for m in obj.values()]


# ---------------------------------------------------------------------------
# metricslint: static pre-classification on the card
# ---------------------------------------------------------------------------

#: the environment variable that turns pre-classification off
PRECLASSIFY_ENV = "METRICS_TPU_ANALYSIS_PRECLASSIFY"
#: steps of the residual case (past the 16-step warm-up, so it compiles)
RESIDUAL_STEPS = 20


def _smoke_latch_class():
    """A metric with an undeclared latch (``self.batches``): metricslint
    refutes it from this file's source, before any capture."""
    from metrics_tpu_torch.core.metric import Metric

    class _SmokeLatch(Metric):
        # the qualname the analysis indexes a class nested in a function by
        __qualname__ = "_smoke_latch_class._SmokeLatch"

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
            self.batches = 0

        def update(self, x):
            self.batches += 1
            self.total = self.total + torch.sum(x)

        def compute(self):
            return self.total

    return _SmokeLatch


def _smoke_host_scale(x):
    # a host read metricslint cannot see: module-level helpers are not scanned
    return x * (1.0 + 0.0 * x.sum().item())


def _smoke_hidden_read_class():
    """A metric metricslint calls clean whose update reaches ``.item()``
    through :func:`_smoke_host_scale`: the residual case, found by the CUDA
    graph capture."""
    from metrics_tpu_torch.core.metric import Metric

    class _SmokeHiddenRead(Metric):
        __qualname__ = "_smoke_hidden_read_class._SmokeHiddenRead"

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + torch.sum(_smoke_host_scale(x))

        def compute(self):
            return self.total

    return _SmokeHiddenRead


def _sync_check(device):
    """Each op of the metric pass's host-sync list on a tensor on the card:
    does ``torch.cuda.set_sync_debug_mode("error")`` refuse it, and does a
    CUDA graph capture? Returns the ops the sync debug mode confirmed."""
    x = torch.rand(4096, device=device)
    mask = x > 0.5
    reps = torch.randint(0, 3, (4096,), device=device)
    ops = {
        "float()": lambda: float(x.sum()),
        "int()": lambda: int(reps.sum()),
        "bool()": lambda: bool(mask.any()),
        ".item()": lambda: x.sum().item(),
        "np.asarray()": lambda: np.asarray(x),
        ".cpu()": lambda: x.cpu(),
        ".tolist()": lambda: x[:4].tolist(),
        ".numpy()": lambda: x.numpy(),
        '.to("cpu")': lambda: x.to("cpu"),
        "torch.cuda.synchronize()": lambda: torch.cuda.synchronize(device),
        "nonzero()": lambda: mask.nonzero(),
        "unique()": lambda: torch.unique(reps),
        "masked_select()": lambda: x.masked_select(mask),
        "torch.where(cond)": lambda: torch.where(mask),
        "repeat_interleave()": lambda: torch.repeat_interleave(x, reps),
    }
    out_size = int(reps.sum())
    clean = {  # the forms the list leaves out: no read of the device
        "torch.where(c, a, b)": lambda: torch.where(mask, x, 0.0),
        "repeat_interleave(2)": lambda: x.repeat_interleave(2),
        "repeat_interleave(output_size=)": lambda: torch.repeat_interleave(x, reps, output_size=out_size),
    }
    confirmed, rows = [], []
    for name, fn in list(ops.items()) + list(clean.items()):
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            debug = "ran"
        except Exception as err:  # noqa: BLE001 - the verdict is the exception's kind
            debug = "refused" if "synchroniz" in str(err).lower() else f"raised {type(err).__name__}"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                fn()
            capture = "captured"
        except Exception as err:  # noqa: BLE001
            capture = f"refused ({type(err).__name__})"
        del graph
        torch.cuda.synchronize(device)
        if name in ops and debug == "refused":
            confirmed.append(name)
        rows.append(f"{name}: sync debug mode {debug}, capture {capture}")
    assert torch.equal((x * 2).cpu(), x.cpu() * 2), "the card is not right after the capture checks"
    for name in clean:
        assert any(r.startswith(f"{name}: sync debug mode ran") for r in rows), f"{name} synchronized"
    print("host-sync list on the card: " + "; ".join(rows))
    print(f"sync debug mode confirmed {len(confirmed)} of {len(ops)}: {confirmed}")
    return confirmed


def _analysis_phase(smi, device):
    """metricslint on the card: the lint of the package, each compiled
    configuration's member verdicts and a run of it with pre-classification
    on and off (probes run, the first compiled step's ms, the median of steps
    25-48, states ``torch.equal``, B1's launches equal), a class refuted from
    this file's source before any capture, the residual host read the
    capture refuses, and the sync check of the host-sync list."""
    import metrics_tpu_torch
    import metrics_tpu_torch.core.collections as coll_mod
    import metrics_tpu_torch.core.metric as metric_mod
    from metrics_tpu_torch import MeanSquaredError
    from metrics_tpu_torch.analysis import analyze_paths, iter_python_files, runtime
    from metrics_tpu_torch.ops import binned_stats

    print(smi)
    pkg = os.path.dirname(os.path.abspath(metrics_tpu_torch.__file__))
    t0 = time.perf_counter()
    findings, errors = analyze_paths([pkg])
    lint_s = time.perf_counter() - t0
    assert not findings and not errors, [f.format() for f in findings] + errors
    print(f"metricslint over metrics_tpu_torch: {len(findings)} finding(s), {len(errors)} error(s) across "
          f"{len(iter_python_files([pkg]))} file(s) in {lint_s:.3f} s (host)")

    probes = [0]
    originals = (metric_mod.probe_traceable, coll_mod.probe_traceable)

    def counting(*a, **k):
        probes[0] += 1
        return originals[0](*a, **k)

    previous = os.environ.get(PRECLASSIFY_ENV)
    metric_mod.probe_traceable = coll_mod.probe_traceable = counting
    results = {}
    try:
        for name, make, step in _compiled_workloads(device):
            members = dict(make(device).items())
            os.environ[PRECLASSIFY_ENV] = "1"
            runtime.clear_cache()
            t0 = time.perf_counter()
            verdicts = {k: "/".join(runtime.static_probe_verdict(m, kinds)[0] for kinds in
                                    (("update",), ("update", "compute", "merge"))) for k, m in members.items()}
            analysis_ms = (time.perf_counter() - t0) * 1e3
            print(f"{name} verdicts (update/forward): " + ", ".join(f"{k} {v}" for k, v in verdicts.items())
                  + f"; {analysis_ms:.2f} ms to analyse them from a cold cache (host)")
            runs = {"1": [], "0": []}
            for flag in ("1", "0", "0", "1"):
                os.environ[PRECLASSIFY_ENV] = flag
                runtime.clear_cache()
                probes[0] = 0
                launches0 = binned_stats.KERNEL_LAUNCHES
                obj, states, stats = _compiled_run(make, step, device, None)
                runs[flag].append(dict(stats, probes=probes[0], b1=binned_stats.KERNEL_LAUNCHES - launches0,
                                       states=states, fallback=_compile_summary(obj)))
            first = runs["1"][0]
            for flag, rs in runs.items():
                for r in rs:
                    assert sorted(r["states"]) == sorted(first["states"])
                    for k, v in first["states"].items():
                        assert v.dtype == r["states"][k].dtype and torch.equal(v, r["states"][k]), \
                            f"{name}: state {k} differs with {PRECLASSIFY_ENV}={flag}"
                    assert r["b1"] == first["b1"], f"{name}: B1 launches {r['b1']} with {flag}, {first['b1']} with 1"
                    assert r["fallback"] == first["fallback"], (name, r["fallback"], first["fallback"])
            if name == "binned" and device.type == "cuda":
                # two a step, eager or replayed, and one more in each program's warm-up
                assert first["b1"] >= 2 * (COMPILED_STEPS + COMPILED_PROFILE_STEPS), first["b1"]
            assert max(r["probes"] for r in runs["1"]) <= min(r["probes"] for r in runs["0"]), name
            summary = {}
            for flag, label in (("1", "on"), ("0", "off")):
                rs = runs[flag]
                summary[label] = {
                    "verdicts": verdicts,
                    "cold_analysis_ms": analysis_ms,
                    "probes": [r["probes"] for r in rs],
                    "first_step_ms": [r["first_step_ms"] for r in rs],
                    "first_compiled_step_ms": [r["first_compiled_step_ms"] for r in rs],
                    "tail_median_ms": float(np.median([t for r in rs for t in r["tail_ms"]])),
                    "b1_launches": rs[0]["b1"],
                }
                print(f"{name} pre-classification {label}: probes {summary[label]['probes']}; step 1 (the "
                      "compute-group planner's screen) "
                      + " / ".join(f"{v:.3f}" for v in summary[label]["first_step_ms"])
                      + f" ms; step {compiled_warmup_steps() + 1} (probe, warm-up, capture) "
                      + " / ".join(f"{v:.3f}" for v in summary[label]["first_compiled_step_ms"])
                      + f" ms; steps {COMPILED_STEPS - COMPILED_TAIL + 1}-{COMPILED_STEPS} median "
                      f"{summary[label]['tail_median_ms']:.4f} ms (two runs); B1 launches {rs[0]['b1']}")
            print(f"{name}: states equal (torch.equal) with pre-classification on and off; {first['fallback']}")
            results[name] = summary
    finally:
        metric_mod.probe_traceable, coll_mod.probe_traceable = originals
        if previous is None:
            os.environ.pop(PRECLASSIFY_ENV, None)
        else:
            os.environ[PRECLASSIFY_ENV] = previous
        runtime.clear_cache()

    # dirty: refuted from this file before any capture
    latch_cls = _smoke_latch_class()
    verdict, detail = runtime.static_probe_verdict(latch_cls(device=device), ("update",))
    assert verdict == "dirty" and "chip_smoke.py:" in detail, (verdict, detail)
    rng = np.random.RandomState(14)
    rows = [torch.from_numpy(rng.rand(BATCH).astype(np.float32)) for _ in range(RESIDUAL_STEPS)]
    latch = latch_cls(device=device)
    latch.compiled_update = True
    for r in rows:
        latch.update(r.to(device))
    st = latch.compile_stats()
    assert st["traces"] == 0 and st["dispatches"] == 0 and "chip_smoke.py:" in st["fallback"]["update"], st
    cpu_latch = latch_cls(device="cpu")
    cpu_latch.compiled_update = False
    for r in rows:
        cpu_latch.update(r)
    # float32 sums of 2048 rows, reduced in another order on the card
    assert latch.batches == RESIDUAL_STEPS, latch.batches
    assert abs(float(latch.total) - float(cpu_latch.total)) <= 1e-5 * abs(float(cpu_latch.total)), "latch total"
    print(f"dirty: {latch_cls.__name__} falls back before any capture (traces 0): {st['fallback']['update']}")

    # residual: clean to the analysis, refused by the capture
    hidden_cls = _smoke_hidden_read_class()
    assert runtime.static_probe_verdict(hidden_cls(device=device), ("update",))[0] == "clean"
    hidden, eager = hidden_cls(device=device), hidden_cls(device=device)
    hidden.compiled_update, eager.compiled_update = True, False
    for r in rows:
        hidden.update(r.to(device))
        eager.update(r.to(device))
    st = hidden.compile_stats()
    assert st["dispatches"] == 0 and "compiled dispatch failed" in st["fallback"]["update"], st
    assert torch.equal(hidden.total, eager.total), "the residual metric's state differs from the all-eager run"
    # later work on the card: a compiled metric replays and equals eager
    mse, mse_eager = MeanSquaredError(device=device), MeanSquaredError(device=device)
    mse_eager.compiled_update = False
    for i, r in enumerate(rows):
        target = rows[(i + 1) % len(rows)].to(device)
        mse.update(r.to(device), target)
        mse_eager.update(r.to(device), target)
    assert mse.compile_stats()["dispatches"] > 0 and torch.equal(mse.compute(), mse_eager.compute())
    print(f"residual: {hidden_cls.__name__} (verdict clean, no probe) fails capture: {st['fallback']['update']}; "
          f"it ran eagerly from then on, state equal to the all-eager run; a compiled MeanSquaredError after it "
          f"replayed {mse.compile_stats()['dispatches']} times, equal to eager")

    confirmed = _sync_check(device)
    print("analysis phase: " + json.dumps({"lint_s": lint_s, "configs": results, "sync_confirmed": confirmed}))
    return results


# ---------------------------------------------------------------------------
# compiled_step: the whole step as one program
# ---------------------------------------------------------------------------

#: Collections whose whole-step program the JAX package refuses (its probe
#: refuses Accuracy's mode latch, so the flagship's step runs as phases);
#: every other collection of the phase fuses.
JAX_STEP_REFUSED = {"flagship"}
FUSED_STEPS = 48
IN_GRAPH_STEPS = 8


def _fused_workloads(device):
    """``(name, make(dev), (preds, target))`` of the fused-step phase: the
    grouped report, the binned, the regression and the flagship collections
    at the compiled phase's widths."""
    rng = np.random.RandomState(0)
    probs = torch.from_numpy(rng.rand(FUSED_STEPS, BATCH, NUM_CLASSES).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.randint(0, NUM_CLASSES, (FUSED_STEPS, BATCH))).to(device)
    rep = tuple(x.to(device) for x in _report_data())
    reg = tuple(x.to(device) for x in _depth_data())
    return [("report", _report_collection, rep), ("binned", _binned_collection, (probs, labels)),
            ("regression", _regression_collection, reg), ("flagship", _flagship_collection, (probs, labels))]


def _profile_counts(prof, n):
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {
        "kernels_per_step": len(kernels) / n,
        "graph_launches_per_step": sum(
            1 for e in prof.events() if e.device_type == DeviceType.CPU and e.name == "cudaGraphLaunch") / n,
        "syncs_per_step": len(_sync_events(prof)) / n,
        "busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3 if kernels else None,
        "nccl_kernels_per_step": sum(1 for e in kernels if "nccl" in e.name.lower()) / n,
        "device_op_names": sorted({e.name for e in kernels}),
    }


def _clone_tree(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _trees_equal(a, b):
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _fused_run(make, data, device, how, axis=None, steps=None):
    """``FUSED_STEPS`` steps of update + compute of the accumulated value,
    ``how``: ``"eager"`` (``compiled_update=False``), ``"replay"`` (PR 11's
    default: ``update`` replays per program after the warm-up, ``compute()``
    eager) or ``"step"`` (``compiled_step``, one program a step); host-clock
    ms of each step ending in a synchronize, then a profile of
    ``COMPILED_PROFILE_STEPS`` more."""
    from torch.profiler import ProfilerActivity, profile

    preds, target = data
    steps = FUSED_STEPS if steps is None else steps
    obj = _set_knob(make(device), False if how == "eager" else None)
    state = obj.init_state() if how == "step" else None

    def one(i):
        nonlocal state
        p, t = preds[i % len(preds)], target[i % len(preds)]
        if how == "step":
            state, values = obj.compiled_step(state, p, t, axis_name=axis)
            return values
        obj.update(p, t)
        return obj.compute()

    torch.cuda.synchronize()
    step_ms, first_cpu_ops = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        if i == 0 and axis is not None:
            # the first step builds the program (eager warm-up, then capture):
            # the host-side collective calls it made
            with profile(activities=[ProfilerActivity.CPU]) as first:
                values = one(i)
            first_cpu_ops = [e.name for e in first.events() if "nccl" in e.name.lower() or "c10d" in e.name.lower()]
        else:
            values = one(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    states = ({f"{k}.{n}": v.clone() for k, s in state.items() for n, v in s.items()} if how == "step" else
              {k: v.clone() for k, v in _state_leaves_of(obj).items()})
    values = _clone_tree(values)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps, steps + COMPILED_PROFILE_STEPS):
            one(i)
        torch.cuda.synchronize()
    stats = _profile_counts(prof, COMPILED_PROFILE_STEPS)
    stats["tail_ms"] = step_ms[-COMPILED_TAIL:]
    stats["first_step_ms"] = step_ms[0]
    stats["first_step_collective_ops"] = first_cpu_ops
    return obj, states, values, stats


def _fused_phase(smi, device):
    """The grouped report, the binned (B1 inside the one graph), the
    regression and the flagship collections, each three ways in turns
    (eager, replay, step, step, replay, eager): step ms, ``cudaGraphLaunch``,
    kernels and host syncs a step, idle share; the step's states and values
    equal to the eager composition's bit for bit (``torch.equal``); B1's
    launches counted through the step's replays and its states equal to the
    plain twin's (the CPU run); the flagship's step refused as the JAX
    package refuses it, the refusal counted and printed."""
    from metrics_tpu_torch.ops import binned_stats

    print(smi)
    results = {}
    for name, make, data in _fused_workloads(device):
        t0 = time.perf_counter()
        runs, tails = {}, {"eager": [], "replay": [], "step": []}
        for how in ("eager", "replay", "step", "step", "replay", "eager"):
            launches0 = binned_stats.KERNEL_LAUNCHES
            obj, states, values, stats = _fused_run(make, data, device, how)
            stats["b1_launches"] = binned_stats.KERNEL_LAUNCHES - launches0
            tails[how] += stats.pop("tail_ms")
            runs[how] = (obj, states, values, stats)
        for how, (_o, _s, _v, st) in runs.items():
            st["step_ms"] = float(np.median(tails[how]))
            st["idle"] = None if st["busy_ms"] is None else 1 - st["busy_ms"] / st["step_ms"]
            st.pop("device_op_names")
            st.pop("first_step_collective_ops")
        _e_obj, e_states, e_values, _e = runs["eager"]
        step_obj, s_states, s_values, s = runs["step"]
        assert sorted(e_states) == sorted(s_states), name
        for k, v in e_states.items():
            assert v.dtype == s_states[k].dtype and torch.equal(v, s_states[k]), f"{name}: step state {k} differs"
        for k, v in e_values.items():
            assert _trees_equal(v, s_values[k]), f"{name}: step value {k} differs from the eager composition"
        coll = step_obj.compile_stats()["collection"]
        refusal = (coll["fallback"] or {}).get("step")
        if name in JAX_STEP_REFUSED:
            assert refusal is not None and coll["dispatches"] == 0, f"{name}: the JAX package refuses this step"
            print(f"{name}: compiled_step refused as in the JAX package, counted in compile_stats: {refusal}")
        else:
            assert refusal is None, f"{name}: compiled_step fell back: {refusal}"
            assert coll["dispatches"] == FUSED_STEPS + COMPILED_PROFILE_STEPS and coll["traces"] == 1, coll
            if device.type == "cuda":
                assert s["graph_launches_per_step"] == 1.0, f"{name}: {s['graph_launches_per_step']} graph launches"
        if name == "binned" and device.type == "cuda":
            # two launches a step in every run; the step's programs (one a
            # run) launch B1 twice more in their eager warm-up
            steps = FUSED_STEPS + COMPILED_PROFILE_STEPS
            assert s["b1_launches"] == 2 * steps + 2, (s["b1_launches"], steps)
            cpu = make("cpu")
            cst = cpu.init_state()
            for i in range(FUSED_STEPS):
                cst = cpu.pure_update(cst, data[0][i % len(data[0])].cpu(), data[1][i % len(data[0])].cpu())
            for k, sub in cst.items():
                for n, v in sub.items():
                    assert torch.equal(s_states[f"{k}.{n}"].cpu(), v), f"binned: step's B1 state {k}.{n} differs"
        for how in ("eager", "replay", "step"):
            st = runs[how][3]
            idle = "not measured" if st["idle"] is None else f"{100 * st['idle']:.2f}%"
            print(f"{name} {how}: step {st['step_ms']:.4f} ms (median of the last {COMPILED_TAIL} of two runs), "
                  f"{st['kernels_per_step']} kernels/step, {st['graph_launches_per_step']} cudaGraphLaunch/step, "
                  f"{st['syncs_per_step']} cudaStreamSynchronize/step, device busy {st['busy_ms']} ms/step, idle "
                  f"{idle}; first step {st['first_step_ms']:.2f} ms; B1 launches {st['b1_launches']}")
        _print_compile(f"{name} (compiled_step run)", step_obj)
        print(f"{name}: compiled_step states and values equal the eager composition's (torch.equal); "
              f"{time.perf_counter() - t0:.1f} s")
        results[name] = {how: runs[how][3] for how in runs}
    print("fused-step phase: " + json.dumps(results))
    return results


def _in_graph_sync_phase(device):
    """``compiled_step`` of the grouped report collection with a one-rank
    NCCL group as its axis: the all-reduce is an NCCL kernel captured in the
    step's graph (a two-rank NCCL run needs two cards); its states and
    values equal the run without an axis bit for bit. A gloo group, whose
    collectives a graph cannot hold, is refused for state on the card."""
    import torch.distributed as dist

    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port_no}", world_size=1, rank=0,
                            device_id=device)
    try:
        preds, target = (x.to(device) for x in _report_data())
        data = (preds[:IN_GRAPH_STEPS], target[:IN_GRAPH_STEPS])
        synced = _fused_run(_report_collection, data, device, "step", axis=dist.group.WORLD, steps=IN_GRAPH_STEPS)
        local = _fused_run(_report_collection, data, device, "step", steps=IN_GRAPH_STEPS)
        (s_obj, s_states, s_values, s), (_l, l_states, l_values, l_stats) = synced, local
        for k, v in l_states.items():
            assert torch.equal(s_states[k], v), f"in-graph sync: state {k} differs from the run without an axis"
        for k, v in l_values.items():
            assert _trees_equal(s_values[k], v), f"in-graph sync: value {k} differs from the run without an axis"
        coll = s_obj.compile_stats()["collection"]
        assert coll["fallback"] is None and coll["dispatches"] > 0, coll
        assert s["graph_launches_per_step"] == 1.0, s
        # the build called ProcessGroupNCCL twice a bucket: in the eager
        # warm-up and inside the capture
        nccl_calls = [n for n in s["first_step_collective_ops"] if "nccl" in n.lower()]
        assert nccl_calls, s["first_step_collective_ops"]
        added = sorted(set(s["device_op_names"]) - set(l_stats["device_op_names"]))
        gloo = dist.new_group(backend="gloo")
        refused = "no error"
        try:
            m = _report_collection(device)
            m.compiled_step(m.init_state(), preds[0], target[0], axis_name=gloo)
        except MetricsTPUUserError as err:
            refused = str(err)[:120]
        assert refused != "no error", "a gloo group on card state was not refused"
        print(f"in-graph sync: compiled_step(axis_name=<one-rank NCCL group>) of the report collection, "
              f"{IN_GRAPH_STEPS} steps: {s['graph_launches_per_step']} cudaGraphLaunch/step, "
              f"{s['nccl_kernels_per_step']} NCCL kernels/step inside it (a one-rank communicator runs the "
              f"all-reduce as a copy), {s['kernels_per_step']} device ops/step (without the axis "
              f"{l_stats['kernels_per_step']}; added: {added}); step {np.median(s['tail_ms']):.4f} ms vs "
              f"{np.median(l_stats['tail_ms']):.4f} ms without the axis; the first step's host-side collective "
              f"calls (warm-up and capture): {nccl_calls}; states and values equal the run without an axis bit for "
              f"bit; a gloo group refused: {refused}")
        return {"synced": s, "local": l_stats}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the examples as entry points, and the default towers
# ---------------------------------------------------------------------------

EXAMPLE_EPOCHS, EXAMPLE_STEPS, EXAMPLE_BATCH = 2, 8, 64  # the JAX example's run_training()
EXAMPLE_TIMED_STEPS = 48  # a timing run: 16 steps of warm-up, the median of the last 32
EXAMPLE_PROFILE_STEPS = 8
#: Train loop, card against CPU: each epoch's mean loss within 1e-4
#: relative (float32 GEMMs and Adam updates in another order, carried over
#: 16 steps; the CPU run is within 2.4e-6 of the JAX example), accuracies
#: within one sample of an epoch's 512.
EXAMPLE_LOSS_RTOL = 1e-4
#: Own-model BERTScore, card against CPU: values of size <= 1 from float32
#: attention over 6 tokens of width 4 (as the port's CPU test against JAX).
EXAMPLE_BERT_ATOL = 1e-5
#: The JAX suite's golden pins (``tests/test_golden_pipeline_scores.py``) and
#: their rtol: the 64-tap streaming FID and LPIPS(alex) of the default towers.
GOLDEN_FID_STREAMING, GOLDEN_FID_RTOL = 0.002359572798013687, 2e-3
GOLDEN_LPIPS, GOLDEN_LPIPS_RTOL = 0.13386474549770355, 1e-3
GOLDEN_KID_RTOL = 5e-3
TOWER_ULPS = 4  # a float32 normal of ops/prng.py on two devices (log1p, sqrt may round apart)


def _example(filename):
    """An example module by its file path (the card's machine has a foreign
    ``tests`` package on its path, and ``examples/`` is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", filename)
    spec = importlib.util.spec_from_file_location("example_" + filename[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _max_ulps(a, b):
    def ordered(t):
        i = t.detach().cpu().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return max(int((ordered(a[k]) - ordered(b[k])).abs().max()) for k in b if b[k].numel())


def _train_step_stats(tl, device, graph):
    """A fresh trainer at the example's size, ``EXAMPLE_TIMED_STEPS`` steps
    on the task's batches (host clock, each ending in a synchronize), then
    ``EXAMPLE_PROFILE_STEPS`` more under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    trainer = tl.Trainer(seed=1, batch_size=EXAMPLE_BATCH, device=device, graph=graph)
    steps = EXAMPLE_TIMED_STEPS + EXAMPLE_PROFILE_STEPS
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
               for x, y in tl.task_batches(1, steps, EXAMPLE_BATCH, 1)]
    trainer.start_epoch()
    torch.cuda.synchronize()
    step_ms = []
    for x, y in batches[:EXAMPLE_TIMED_STEPS]:
        t0 = time.perf_counter()
        trainer.step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, y in batches[EXAMPLE_TIMED_STEPS:]:
            trainer.step(x, y)
        torch.cuda.synchronize()
    stats = _profile_counts(prof, EXAMPLE_PROFILE_STEPS)
    stats["median_ms"] = float(np.median(step_ms[16:]))
    stats["first_ms"] = step_ms[0]
    values = trainer.end_epoch()
    assert all(np.isfinite(v) for v in values.values()), values
    return stats


def _fid64(real, fake):
    """FID of two feature sets in float64 on the host (numpy, scipy's sqrtm)."""
    import scipy.linalg

    real, fake = real.double().cpu().numpy(), fake.double().cpu().numpy()
    c1, c2 = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    diff = real.mean(0) - fake.mean(0)
    return float(diff @ diff + np.trace(c1) + np.trace(c2) - 2 * np.trace(scipy.linalg.sqrtm(c1 @ c2).real))


def _kid64(real, fake, idx_real, idx_fake):
    """KID mean and population std in float64 on the host over the given
    subsets (cubic polynomial kernel, unbiased MMD)."""
    def k(a, b):
        return (a @ np.swapaxes(b, -1, -2) / a.shape[-1] + 1.0) ** 3

    x = real.double().cpu().numpy()[idx_real.cpu().numpy()]
    y = fake.double().cpu().numpy()[idx_fake.cpu().numpy()]
    m = x.shape[1]
    off = lambda t: t.sum((-2, -1)) - np.trace(t, axis1=-2, axis2=-1)  # noqa: E731
    mmd = (off(k(x, x)) + off(k(y, y))) / (m * (m - 1)) - 2 * k(x, y).sum((-2, -1)) / m**2
    return float(mmd.mean()), float(mmd.std())


def _kid32_bound(real, fake, idx_real, idx_fake):
    """A first-order bound, from this run's features, on a float32 KID's
    distance from its float64 value, for the mean and for the std.

    Each kernel entry ``k = (g s + 1)^3`` (``g = 1 / D``) takes a float32
    dot ``s`` of D products, off by at most ``D eps sum|x_d y_d|``, then
    four roundings: ``|dk| <= 3 (g|s| + 1)^2 g (D + 4) eps sum|x y| + 4 eps
    |k|``. A subset's MMD is two off-diagonal means and a full mean of the
    entries (``|dk|`` averaged as they are), plus the summation of ``m^2``
    entries (``2 log2(m) eps`` of each mean of ``|k|``). The mean over
    subsets is off by at most the largest subset's bound, the population
    std by twice it."""
    eps = 2.0 ** -24
    x = real.double().cpu().numpy()[idx_real.cpu().numpy()]
    y = fake.double().cpu().numpy()[idx_fake.cpu().numpy()]
    d, m = x.shape[-1], x.shape[1]
    g = 1.0 / d

    def entry_err(a, b):
        s = a @ np.swapaxes(b, -1, -2)
        s_abs = np.abs(a) @ np.swapaxes(np.abs(b), -1, -2)
        k = np.abs(g * s + 1.0) ** 3
        dk = 3 * (g * np.abs(s) + 1.0) ** 2 * g * (d + 4) * eps * s_abs + 4 * eps * k
        return dk, k

    def off_mean(t):
        return (t.sum((-2, -1)) - np.trace(t, axis1=-2, axis2=-1)) / (m * (m - 1))

    (dxx, kxx), (dyy, kyy), (dxy, kxy) = entry_err(x, x), entry_err(y, y), entry_err(x, y)
    per_subset = (off_mean(dxx) + off_mean(dyy) + 2 * dxy.mean((-2, -1))
                  + 2 * np.log2(m) * eps * (off_mean(kxx) + off_mean(kyy) + 2 * kxy.mean((-2, -1))))
    worst = float(per_subset.max())
    return worst, 2 * worst


def _examples_phase(smi, device):
    """The three examples through their own entry points, and the default
    towers. (a) The train loop (``examples/torch_train_loop_integration.py``)
    at the JAX example's size on the CPU, on the card op by op and on the
    card as one CUDA graph a step: per-epoch values equal within
    ``EXAMPLE_LOSS_RTOL`` and one sample; step ms, kernels and
    ``cudaGraphLaunch`` a step of each mode. (b) The sharded eval over a
    one-rank NCCL group (``pure_sync``'s in-program collectives) against
    one collection within 1e-6. (c) Own-model BERTScore, card against CPU.
    (d) ``inception_v3_init``/``lpips_init`` drawn on the card within
    ``TOWER_ULPS`` of the CPU draw; the JAX suite's 64-tap FID, KID and
    LPIPS golden cases on the card within the pins' rtol (the buffered FID
    and a float64 KID of the float64 values, as
    ``tests/test_torch_golden_pipeline_scores.py``), the default float32
    KID within the bound ``_kid32_bound`` derives from the features."""
    from metrics_tpu_torch import FID, KID, LPIPS
    from metrics_tpu_torch.models.inception import InceptionFeatureExtractor, inception_v3_init
    from metrics_tpu_torch.models.lpips_net import lpips_init
    from metrics_tpu_torch.ops import binned_stats

    binned_stats.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    tl = _example("torch_train_loop_integration.py")
    size = dict(num_epochs=EXAMPLE_EPOCHS, steps_per_epoch=EXAMPLE_STEPS, batch_size=EXAMPLE_BATCH)
    want = tl.run_training(device="cpu", **size)
    one_sample = 1.0 / (EXAMPLE_STEPS * EXAMPLE_BATCH)
    for mode, graph in (("eager", False), ("graph", True)):
        got = tl.run_training(device=device, graph=graph, **size)
        for epoch, (g, w) in enumerate(zip(got, want)):
            rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
            assert rel <= EXAMPLE_LOSS_RTOL, f"train loop ({mode}) epoch {epoch}: loss {g['loss']} vs CPU {w['loss']}"
            for k in ("acc", "macro_acc"):
                assert abs(g[k] - w[k]) <= one_sample, f"train loop ({mode}) epoch {epoch}: {k} {g[k]} vs CPU {w[k]}"
        print(f"train loop ({mode}) on the card: " + "; ".join(
            f"epoch {i} " + ", ".join(f"{k}={v:.6f}" for k, v in e.items()) for i, e in enumerate(got))
              + f"; equal to the CPU run within rtol {EXAMPLE_LOSS_RTOL} (loss) and one sample (accuracies)")
    stats = {mode: _train_step_stats(tl, device, graph) for mode, graph in
             (("eager", False), ("graph", True), ("graph", True), ("eager", False))}  # in turns; the second kept
    assert stats["graph"]["graph_launches_per_step"] == 1.0, stats["graph"]
    assert stats["eager"]["graph_launches_per_step"] == 0.0, stats["eager"]
    for mode, st in stats.items():
        print(f"train step ({mode}; forward, cross-entropy, backward, Adam, Accuracy x2 + AverageMeter "
              f"pure_update; batch {EXAMPLE_BATCH}) on {smi}: median {st['median_ms']:.4f} ms (steps 17-"
              f"{EXAMPLE_TIMED_STEPS}, host clock), first step {st['first_ms']:.2f} ms, {st['kernels_per_step']} "
              f"kernels/step, {st['graph_launches_per_step']} cudaGraphLaunch/step, {st['syncs_per_step']} "
              f"cudaStreamSynchronize/step, device busy {st['busy_ms']} ms/step")
    print(f"train step graph / eager: {stats['graph']['median_ms'] / stats['eager']['median_ms']:.4f}")
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    se = _example("torch_sharded_eval.py")
    values = se.main(["--device", "cuda", "--world", "1"])
    errs = se.check(values, se.reference(1, device))
    print(f"sharded eval over a one-rank NCCL group (pure_update x{se.BATCHES}, pure_sync, pure_compute): "
          f"{values}; max abs err against one collection {errs} (bound {se.ATOL})")
    sharded_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    bs = _example("torch_bert_score_own_model.py")
    got, want = bs.run(device), bs.run("cpu")
    bert_err = max(float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))))
                   for k in ("precision", "recall", "f1"))
    assert bert_err <= EXAMPLE_BERT_ATOL, f"own-model BERTScore card vs CPU: {bert_err}"
    print(f"own-model BERTScore on the card: f1 {[round(float(v), 6) for v in got['f1']]}; max abs err against "
          f"the CPU {bert_err:.3g} (bound {EXAMPLE_BERT_ATOL})")
    bert_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ulps = {"inception_v3_init": _max_ulps(inception_v3_init(device=device), inception_v3_init(device="cpu"))}
    for net in ("alex", "vgg"):
        ulps[f"lpips_init({net})"] = _max_ulps(lpips_init(net, device=device), lpips_init(net, device="cpu"))
    assert all(u <= TOWER_ULPS for u in ulps.values()), ulps
    rng = np.random.RandomState(1234)
    real = torch.from_numpy(rng.randint(0, 256, (24, 3, 64, 64), dtype=np.uint8)).to(device)
    fake = torch.from_numpy(rng.randint(0, 256, (24, 3, 64, 64), dtype=np.uint8)).to(device)
    ext = _quiet(lambda: InceptionFeatureExtractor(feature=64, device=device))
    real_f, fake_f = ext(real), ext(fake)
    golden = {}
    for name, make in (("fid_streaming", lambda: FID(lambda f: f, feature_dim=64, streaming=True, device=device)),
                       ("fid_buffered", lambda: FID(lambda f: f, feature_dim=64, device=device))):
        m = make()
        m.update(real_f, True)
        m.update(fake_f, False)
        golden[name] = float(m.compute())
    kid = KID(lambda f: f, subsets=4, subset_size=16, device=device)
    kid.update(real_f, True)
    kid.update(fake_f, False)
    golden["kid_mean"], golden["kid_std"] = (float(v) for v in kid.compute())
    kid64_card = KID(lambda f: f, subsets=4, subset_size=16, device=device)
    kid64_card.set_dtype(torch.float64)
    kid64_card.update(real_f, True)
    kid64_card.update(fake_f, False)
    golden["kid_mean_f64"], golden["kid_std_f64"] = (float(v) for v in kid64_card.compute())
    lp = _quiet(lambda: LPIPS(net_type="alex", device=device))
    lp.update(torch.from_numpy(np.random.RandomState(5).rand(4, 3, 64, 64).astype(np.float32) * 2 - 1).to(device),
              torch.from_numpy(np.random.RandomState(6).rand(4, 3, 64, 64).astype(np.float32) * 2 - 1).to(device))
    golden["lpips"] = float(lp.compute())
    subsets = kid.subset_indices(24, 24)
    kid64 = _kid64(real_f, fake_f, *subsets)
    want = {"fid_streaming": (GOLDEN_FID_STREAMING, GOLDEN_FID_RTOL),
            "fid_buffered": (_fid64(real_f, fake_f), GOLDEN_FID_RTOL),
            "kid_mean_f64": (kid64[0], GOLDEN_KID_RTOL), "kid_std_f64": (kid64[1], GOLDEN_KID_RTOL),
            "lpips": (GOLDEN_LPIPS, GOLDEN_LPIPS_RTOL)}
    rel = {k: abs(golden[k] - w) / abs(w) for k, (w, _) in want.items()}
    for k, (w, rtol) in want.items():
        assert rel[k] <= rtol, f"golden {k} on the card: {golden[k]} vs {w} (rtol {rtol})"
    # the default float32 KID: ~5e-5 is a difference of kernel means of size
    # ~2, so its float32 noise is a fraction of a percent of it: held to
    # the bound derived from this run's features
    kid_err = (abs(golden["kid_mean"] - kid64[0]), abs(golden["kid_std"] - kid64[1]))
    kid_bound = _kid32_bound(real_f, fake_f, *subsets)
    assert kid_err[0] <= kid_bound[0] and kid_err[1] <= kid_bound[1], (kid_err, kid_bound)
    print(f"default towers drawn on the card vs the CPU, max ulps: {ulps}; golden cases on the card: "
          + ", ".join(f"{k} {golden[k]!r} (rel err {rel[k]:.3g} of {want[k][0]!r}, rtol {want[k][1]})" for k in want)
          + f"; float32 KID mean {golden['kid_mean']!r}, std {golden['kid_std']!r}: rel err {kid_err[0] / kid64[0]:.3g}"
          f", {kid_err[1] / kid64[1]:.3g} of float64 (abs {kid_err[0]:.3g}, {kid_err[1]:.3g}; bound {kid_bound[0]:.3g}, "
          f"{kid_bound[1]:.3g})")
    towers_s = time.perf_counter() - t0
    launches = binned_stats.KERNEL_LAUNCHES
    print(f"examples phase: train loop {train_s:.1f} s, sharded eval {sharded_s:.1f} s, own-model BERTScore "
          f"{bert_s:.1f} s, towers and golden cases {towers_s:.1f} s; B1 launches {launches} (no binned metric on "
          "these paths)")
    return {"train": stats, "golden": golden, "ulps": ulps, "launches": launches}


# ---------------------------------------------------------------------------
# telemetry and wrappers
# ---------------------------------------------------------------------------

#: The JAX package's telemetry schema (``metrics_tpu/observability/registry.py:46-121``):
#: every key a snapshot of either package carries, domain by domain.
JAX_TELEMETRY_KEYS = {
    "compile": {"traces", "dispatches", "cache_hits", "steps_seen", "fallback"},
    "sync": {"launched", "resolved", "stale_resolves", "degraded", "cancelled", "served_local", "gather_s",
             "resolve_wait_s", "overlap_saved_s", "intra_tier_bytes", "inter_tier_bytes", "inter_tier_bytes_saved"},
    "checkpoint": {"saves", "loads", "pruned_steps", "refused", "auto_snapshots"},
    "health": {"sync_failures", "degraded", "errors"},
    "plan": {"builds", "cache_hits", "invalidations", "invalidate_reasons", "fused_steps"},
    "process": {"watchdog_fired", "channel_suspect_latched", "channel_resets", "channel_readmits",
                "membership_transitions", "quorum_shrinks", "quorum_readmits", "suspect_episode_s",
                "watchdog_margin_s", "adaptive_timeout_s", "channel_suspect"},
}
#: ImageNet-1k val top-1 bootstrapped: 50,000 images in 25 updates of 2,000.
IMAGENET_VAL, BOOT_STEP, BOOT_COPIES, BOOT_CHECK_STEPS = 50_000, 2_000, 100, 5
BOOT_QUANTILES = (0.025, 0.975)
#: float32 mean/std/quantile of 100 copies, reduced in another order on the card
BOOT_ATOL = 2 * (float(np.log2(BOOT_COPIES)) + 2) * 2.0 ** -24
TRACKER_EPOCHS, TRACKER_ROWS = 10, 10_000
#: a SimCLR batch: 2 x 2048 views, 128-wide projections
SIMCLR_BATCH, SIMCLR_DIM = 4096, 128
#: cosine similarity of unit rows: 128 products and their sum round once each
#: (2 x 128 ulps), the normalisation a few more; a mean over 4096 entries adds
#: log2(4096) roundings of its magnitude
SIMILARITY_ATOL = (2 * SIMCLR_DIM + 6) * 2.0 ** -24
SIMILARITY_MEAN_ATOL = (2 * SIMCLR_DIM + 6 + float(np.log2(SIMCLR_BATCH))) * 2.0 ** -24


def _check_snapshot_encodings(snapshot):
    """Both encodings of a collection's ``telemetry()`` parse, and every key
    of the JAX package's schema is in each block."""
    from metrics_tpu_torch.observability import telemetry_jsonl, telemetry_prometheus

    rows = [json.loads(line) for line in telemetry_jsonl(snapshot).splitlines()]
    blocks = [(None, snapshot["collection"])] + list(snapshot["members"].items())
    for member, snap in blocks:
        for domain, keys in JAX_TELEMETRY_KEYS.items():
            assert keys <= set(snap[domain]), (member, domain, keys - set(snap[domain]))
            row = [r for r in rows if r.get("member") == member and r["domain"] == domain]
            assert len(row) == 1 and keys <= set(row[0]), (member, domain)
    text = telemetry_prometheus(snapshot)
    samples = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            continue
        name, value = line.rsplit(" ", 1)
        samples.setdefault(name.split("{")[0], []).append(float(value))
    for domain, keys in JAX_TELEMETRY_KEYS.items():
        for key in keys - {"fallback", "errors", "invalidate_reasons"}:  # strings and maps
            assert f"metrics_tpu_{domain}_{key}" in samples, f"metrics_tpu_{domain}_{key}"
    return len(rows), sum(len(v) for v in samples.values())


def _telemetry_phase(device, make, batches):
    """The flagship collection with the journal off and on: the step's host
    time, its ``cudaStreamSynchronize`` count (equal both ways: no span reads
    the device) and its events; a save and load journaled and counted; the
    journal exported as a Chrome trace and read back; the ``telemetry()``
    encodings against the JAX package's schema; the cost of one record."""
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch import load_checkpoint, observability as obs, save_checkpoint

    preds, target = batches[0].to(device), batches[1].to(device)
    steps = len(preds)
    runs = {}
    for on in (False, True, True, False):  # in turns; the second of each is kept
        obs.disable()
        obs.clear()
        if on:
            obs.enable()
        mc = make(device)
        mc(preds[0], target[0])
        torch.cuda.synchronize()
        step_ms = []
        for i in range(1, steps):
            t0 = time.perf_counter()
            mc(preds[i], target[i])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        events = len(obs.events())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(4):
                mc(preds[i], target[i])
            torch.cuda.synchronize()
        runs[on] = {"ms": float(np.median(step_ms)), "syncs": len(_sync_events(prof)) / 4,
                    "events_per_step": events / (steps - 1), "mc": mc}
        _print_compile(f"flagship, journal {'on' if on else 'off'}", mc)
    assert runs[True]["syncs"] == runs[False]["syncs"], \
        f"journal on: {runs[True]['syncs']} cudaStreamSynchronize a step, off: {runs[False]['syncs']}"
    print(f"flagship step, journal off: median {runs[False]['ms']:.4f} ms, {runs[False]['syncs']:.1f} "
          f"cudaStreamSynchronize; journal on: median {runs[True]['ms']:.4f} ms "
          f"({100 * (runs[True]['ms'] / runs[False]['ms'] - 1):+.2f}%), {runs[True]['syncs']:.1f} "
          f"cudaStreamSynchronize (equal), {runs[True]['events_per_step']:.2f} events a step (a one-process "
          "forward crosses no sync, group, health or checkpoint boundary; after the warm-up each compiled "
          "dispatch journals compiled.dispatch, on the host side of its replay)")
    mc = runs[True]["mc"]
    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        obs.clear()
        obs.enable()
        save_checkpoint(mc, root, step=0, rank=0, world=1)
        save_checkpoint(mc, root, step=1, rank=0, world=1, keep_last=1)
        loaded = load_checkpoint(make(device), root, rank=0, world=1)
        assert mc.telemetry()["collection"]["checkpoint"]["saves"] == 2
        assert mc.telemetry()["collection"]["checkpoint"]["pruned_steps"] == 1
        assert loaded.telemetry()["collection"]["checkpoint"]["loads"] == 1
        # the first save reads the compiled member's states: that hand-out
        # journals one plan.invalidate (core/plan.py) before the save
        kinds = [e.kind for e in obs.events()]
        assert [k for k in kinds if not k.startswith("plan.")] == [
            "checkpoint.save", "checkpoint.save", "checkpoint.prune", "checkpoint.load"], kinds
        assert kinds.count("plan.invalidate") <= 1, kinds
        path = os.path.join(root, "trace.json")
        obs.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
        assert {t["pid"] for t in trace} == {0} and all(t["ts"] >= 0 for t in trace if t["ph"] != "M")
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    rows, samples = _check_snapshot_encodings(mc.telemetry())
    n = 20_000
    obs.clear()
    obs.enable()
    t0 = time.perf_counter()
    for i in range(n):
        obs.record("sync.gather", label="MetricCollection[acc, stats]", sync_epoch=0, states=7, fused=None)
    record_us = (time.perf_counter() - t0) / n * 1e6
    obs.disable()
    t0 = time.perf_counter()
    for i in range(n):
        if obs.journal.ACTIVE:
            obs.record("sync.gather")
    off_us = (time.perf_counter() - t0) / n * 1e6
    obs.clear()
    print(f"save x2 (one pruned) and a load journaled {kinds} and counted in telemetry(); Chrome trace written, "
          f"reloaded: {len(trace)} events, one pid, no negative ts; telemetry(): {rows} JSON lines and {samples} "
          f"Prometheus samples, every key of the JAX schema in each; one record() on the host "
          f"{record_us:.3f} us with the recorder on, a guarded site {off_us:.3f} us with it off")


def _imagenet_batch(rng, device):
    """One update of seeded ImageNet-1k val scores: uniform noise, with the
    true class raised above it in 76% of the rows (a ResNet-50's top-1)."""
    probs = rng.rand(BOOT_STEP, REPORT_CLASSES).astype(np.float32)
    labels = rng.randint(0, REPORT_CLASSES, BOOT_STEP)
    hit = rng.rand(BOOT_STEP) < 0.76
    probs[hit, labels[hit]] += 1.0
    return torch.from_numpy(probs).to(device), torch.from_numpy(labels).to(device)


def _boot_states(boot):
    return [{k: v.cpu() for k, v in m._state.items()} for m in boot.metrics]


def _poisson_near_tie(key, lam, draws):
    """Does some running sum of ``log(u)`` of the draw of ``key``, in float64,
    lie within a few float32 ulps of ``-lam``?"""
    from metrics_tpu_torch.ops import prng

    rng, total = key.cpu(), 0.0
    for _ in range(draws + 2):
        keys = prng.split(rng)
        rng = keys[0]
        if abs(total + lam) <= 8 * float(np.finfo(np.float32).eps) * max(1.0, lam):
            return True
        total += float(torch.log(prng.uniform(keys[1], 1).double()))
    return False


def _bootstrap_run(device, strategy, steps, check=None):
    """``BootStrapper(Accuracy(num_classes=1000), 100)`` over ``steps`` seeded
    ImageNet-1k val batches; with ``check`` (the card's subkeys of each
    update), the resample counts or draws of those keys on this device too."""
    from metrics_tpu_torch import Accuracy, BootStrapper
    from metrics_tpu_torch.ops import prng

    boot = BootStrapper(Accuracy(num_classes=REPORT_CLASSES, device=device), num_bootstraps=BOOT_COPIES,
                        quantile=list(BOOT_QUANTILES), raw=True, sampling_strategy=strategy, seed=0)
    rng = np.random.RandomState(11)
    keys, draws, step_ms, reads = [], [], [], []
    for step in range(steps):
        preds, target = _imagenet_batch(rng, device)
        if step < BOOT_CHECK_STEPS:
            chain = [boot._key]
            for _ in range(BOOT_COPIES):  # the subkeys this update takes
                chain.append(prng.split(chain[-1])[0])
            subkeys = torch.stack([prng.split(k)[1] for k in chain[:-1]])
            keys.append(subkeys)
            draws.append(prng.poisson(subkeys, 1.0, BOOT_STEP) if strategy == "poisson"
                         else prng.randint(subkeys, BOOT_STEP, 0, BOOT_STEP))
        if device != "cpu":
            torch.cuda.synchronize()
        loops = prng.HOST_READS["poisson"]
        t0 = time.perf_counter()
        boot.update(preds, target)
        if device != "cpu":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(prng.HOST_READS["poisson"] - loops)
        if step == BOOT_CHECK_STEPS - 1:
            states = _boot_states(boot)
            values = {k: v.cpu() for k, v in boot.compute().items()}
            boot._computed = None
    return boot, keys, draws, step_ms, reads, states, values


def _wrappers_phase(device):
    """BootStrapper at ImageNet-1k val size (Poisson and multinomial) against
    the CPU over its first updates; MetricTracker over 10 epochs against the
    CPU; ``embedding_similarity`` on a SimCLR batch against the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch import Accuracy, MetricTracker
    from metrics_tpu_torch.functional import embedding_similarity

    steps = IMAGENET_VAL // BOOT_STEP
    for strategy in ("poisson", "multinomial"):
        t0 = time.perf_counter()
        boot, keys, draws, step_ms, reads, states, values = _bootstrap_run(device, strategy, steps)
        t1 = time.perf_counter()
        cpu = _bootstrap_run("cpu", strategy, BOOT_CHECK_STEPS)
        t2 = time.perf_counter()
        near_ties, affected = [], set()
        for step in range(BOOT_CHECK_STEPS):
            assert torch.equal(keys[step].cpu(), cpu[1][step]), f"{strategy}: other keys at update {step}"
            got, want = draws[step].cpu(), cpu[2][step]
            for b, i in torch.nonzero(got != want).tolist():
                assert strategy == "poisson", f"multinomial draw {b}, {i} differs at update {step}"
                assert _poisson_near_tie(keys[step][b], 1.0, int(max(got[b, i], want[b, i]))), \
                    f"Poisson draw {b}, {i} at update {step}: {int(got[b, i])} vs {int(want[b, i])}, no near-tie"
                near_ties.append((step, b, i))
                affected.add(b)
        for b, (s_got, s_want) in enumerate(zip(states, cpu[5])):
            if b not in affected:
                for name, v in s_want.items():
                    assert torch.equal(s_got[name], v), f"{strategy} copy {b}: state {name} differs from the CPU"
        errs = {}
        if not affected:
            for k, v in cpu[6].items():
                errs[k] = float((values[k].double() - v.double()).abs().max())
                assert errs[k] <= BOOT_ATOL, f"{strategy} {k}: card vs CPU {errs[k]} (bound {BOOT_ATOL:.3e})"
        preds, target = _imagenet_batch(np.random.RandomState(12), device)
        boot.update(preds, target)  # warm
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        # the runtime's synchronisations and copies only: the ~30,000 host
        # operations of an update would cost the profiler seconds to record
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            boot.update(preds, target)
            torch.cuda.synchronize()
        syncs, d2h = _host_reads(prof)
        assert syncs >= BOOT_COPIES, f"the profile saw {syncs} cudaStreamSynchronize in an update"
        t4 = time.perf_counter()
        out = boot.compute()
        assert out["raw"].shape == (BOOT_COPIES,) and bool(torch.isfinite(out["raw"]).all())
        lo, hi = out["quantile"].tolist()
        print(f"BootStrapper(Accuracy(1000), {BOOT_COPIES}) {strategy}: {steps + 2} updates of [{BOOT_STEP}, "
              f"{REPORT_CLASSES}]; update median {np.median(step_ms):.3f} ms (max {max(step_ms):.3f}), "
              f"{syncs} cudaStreamSynchronize and {d2h} DtoH copies in one update ({np.mean(reads):.1f} of them "
              f"the Poisson loop's any()); top-1 {float(out['mean']):.6f} +- {float(out['std']):.6f}, 95% interval "
              f"[{lo:.6f}, {hi:.6f}]; first {BOOT_CHECK_STEPS} updates against the CPU: keys and "
              f"{'counts' if strategy == 'poisson' else 'draws'} equal, {len(near_ties)} Poisson near-tie "
              f"mismatches {near_ties}, copies' states equal"
              + (f", mean/std/quantile/raw within {BOOT_ATOL:.3e}: {errs}" if errs else
                 f" except the {len(affected)} copies with a near-tie draw")
              + f"; the card's run {t1 - t0:.1f} s, the CPU's {t2 - t1:.1f} s, the profiled update {t4 - t3:.1f} s")
        _print_compile(f"BootStrapper {strategy}", boot)
        del boot

    # MetricTracker: an epoch's predictions get better, then worse
    rng = np.random.RandomState(13)
    epochs = []
    for epoch in range(TRACKER_EPOCHS):
        labels = rng.randint(0, REPORT_CLASSES, TRACKER_ROWS)
        probs = rng.rand(TRACKER_ROWS, REPORT_CLASSES).astype(np.float32)
        probs[np.arange(TRACKER_ROWS), labels] += 0.2 * np.sin(np.pi * epoch / TRACKER_EPOCHS) + 0.5
        epochs.append((torch.from_numpy(probs), torch.from_numpy(labels)))
    best, tracker_s = {}, {}
    for dev in (device, "cpu"):
        tracker = MetricTracker(Accuracy(num_classes=REPORT_CLASSES, device=dev))
        t0 = time.perf_counter()
        for probs, labels in epochs:
            tracker.increment()
            for half in torch.arange(TRACKER_ROWS).tensor_split(2):
                tracker(probs[half].to(dev), labels[half].to(dev))
        best[str(dev)] = tracker.best_metric(return_step=True)
        tracker_s[str(dev)] = time.perf_counter() - t0
        assert tracker.device == torch.device(dev) and tracker.n_steps == TRACKER_EPOCHS
        if dev != "cpu":
            all_values = tracker.compute_all()
    assert best[str(device)] == best["cpu"], best
    print(f"MetricTracker(Accuracy(1000)) over {TRACKER_EPOCHS} epochs of {TRACKER_ROWS} rows: best "
          f"{best['cpu'][0]:.6f} at epoch {best['cpu'][1]} on the card and on the CPU; the card's run "
          f"{tracker_s[str(device)] * 1e3:.1f} ms (the host-to-card copies of "
          f"{TRACKER_EPOCHS * TRACKER_ROWS * REPORT_CLASSES * 4 / 1e6:.0f} MB included), the CPU's "
          f"{tracker_s['cpu']:.1f} s; values {[round(float(v), 4) for v in all_values]}")

    # embedding_similarity on a SimCLR batch
    z = torch.from_numpy(np.random.RandomState(14).randn(SIMCLR_BATCH, SIMCLR_DIM).astype(np.float32))
    zc = z.to(device)
    for reduction, atol in (("none", SIMILARITY_ATOL), ("mean", SIMILARITY_MEAN_ATOL)):
        got = embedding_similarity(zc, "cosine", reduction, True)
        want = embedding_similarity(z, "cosine", reduction, True)
        err = float((got.cpu() - want).abs().max())
        assert err <= atol, f"embedding_similarity {reduction}: card vs CPU {err} (bound {atol:.3e})"
        if reduction == "none":
            assert bool((torch.diagonal(got) == 0).all()) and got.shape == (SIMCLR_BATCH, SIMCLR_BATCH)
        ms = _time_ms(lambda: embedding_similarity(zc, "cosine", reduction, True), reps=10, inner=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        embedding_similarity(zc, "cosine", reduction, True)
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        flops = 2 * SIMCLR_BATCH * SIMCLR_BATCH * SIMCLR_DIM
        print(f"embedding_similarity(cosine, {reduction}, zero_diagonal) on [{SIMCLR_BATCH}, {SIMCLR_DIM}]: "
              f"{ms:.4f} ms (CUDA events), {flops / ms / 1e9:.1f} TFLOP/s of the float32 product "
              f"(TF32 off), peak {peak_mib:.1f} MiB above the input; card vs CPU {err:.3e} (bound {atol:.3e})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2

    from metrics_tpu_torch import (
        Accuracy,
        BinnedAveragePrecision,
        BinnedRecallAtFixedPrecision,
        ConfusionMatrix,
        IoU,
        MetricCollection,
        Precision,
        Recall,
        StatScores,
    )
    from metrics_tpu_torch.functional import dice_score
    from metrics_tpu_torch.ops import _build, binned_stats, confusion_counts

    _phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)

    _phase("build")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build['seconds']:.2f} s)")
    print(_build.last_build["log"].strip())
    if "--compiled-only" in sys.argv[1:]:
        # a quick run of the compiled phase alone (no result lines)
        _phase("compiled: CUDA-graph replay against eager")
        _compiled_phase(smi, device)
        return 0
    if "--analysis-only" in sys.argv[1:]:
        # the metricslint phase alone (no result lines)
        _phase("analysis: metricslint pre-classification on and off, dirty, residual, sync check")
        _analysis_phase(smi, device)
        return 0
    if "--resilience-only" in sys.argv[1:]:
        # the resilience phase alone (no result lines)
        _phase(f"resilience and tiers: {RESILIENCE_WORLD} gloo ranks on the card")
        _resilience_phase(device)
        return 0
    if "--examples-only" in sys.argv[1:]:
        # the examples phase alone (no result lines)
        _phase("examples: the train loop as one CUDA graph, the sharded eval, own-model BERTScore, default towers")
        _examples_phase(smi, device)
        return 0
    if "--fused-only" in sys.argv[1:]:
        # the fused-step, in-graph sync and overlap phases alone (no result lines)
        _phase("fused step: compiled_step against eager and per-program replay")
        _fused_phase(smi, device)
        _phase("in-graph sync: compiled_step over a one-rank NCCL group")
        _in_graph_sync_phase(device)
        _phase("overlap: two gloo ranks on the card, blocking against overlap")
        _overlap_only_phase(device)
        return 0

    _phase("kernel vs plain on the card")
    max_err = 0.0
    base = dict(unsorted=False, target_dtype=np.float32, nan_thresholds=False, inf_preds=False)
    cases = [(s, base) for s in TEST_SHAPES + SLICE_SHAPES[:2]]
    cases += [((300, 7, 50), dict(base, unsorted=True)), ((300, 7, 50), dict(base, target_dtype=np.int64)),
              ((300, 7, 50), dict(base, target_dtype=np.int32))]
    cases += [
        ((300, 7, 50), dict(base, nan_thresholds=True)),
        ((300, 7, 50), dict(base, unsorted=True, nan_thresholds=True, inf_preds=True)),
        ((300, 7, 50), dict(base, inf_preds=True)),
        ((300, 7, 1), base),
        ((300, 1000, 100), dict(base, unsorted=True, nan_thresholds=True)),
        # 16-byte loads of int64 and int32 targets, a threshold table above
        # 48 KB of shared memory, and thresholds too many for the histogram
        ((512, 12, 50), dict(base, unsorted=True, target_dtype=np.int64)),
        ((512, 12, 50), dict(base, target_dtype=np.int32)),
        ((256, 4, 5000), dict(base, unsorted=True)),
        ((64, 3, 16000), base),
    ]
    sm_count, smem_limit = binned_stats._sm_count(0), binned_stats._SMEM_OPTIN
    print(f"card: {sm_count} SMs; plans assume {smem_limit} bytes of opt-in shared memory per block (sm_90)")
    for seed, ((n, c, t), opts) in enumerate(cases):
        preds, target, thr = _binned_inputs(n, c, t, seed, device, **opts)
        want = binned_stats.binned_stat_scores(preds, target, thr, use_kernel=False)
        bucket = binned_stats._binned_stats_bucket(preds, target, thr)
        plan = binned_stats._plan(n, c, thr.numel(), smem_limit, sm_count)
        for design, got in (
            (plan[0], binned_stats.binned_stat_scores(preds, target, thr)),
            ("compare", binned_stats._binned_stats_kernel(preds, target, thr, design="compare")),
            ("plain bucket", bucket),
        ):
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("tp", "fp", "fn")):
                err = float((g - w).abs().max()) if g.numel() else 0.0
                max_err = max(max_err, err)
                assert torch.equal(g, w), f"{design} {what} differs from the compare form at {(n, c, t)}: {err}"
        flags = " ".join(k for k, v in opts.items() if v is True)
        print(f"shape N={n} C={c} T={thr.numel()} {flags} target {target.dtype}: plan {plan}; "
              "kernel, forced compare kernel and plain bucket bit-exact")

    timings = {}
    for n, c, t in SLICE_SHAPES:
        preds, target, thr = _binned_inputs(n, c, t, 0, device)
        plan = binned_stats._plan(n, c, t, smem_limit, sm_count)

        def wrapper():
            return binned_stats.binned_stat_scores(preds, target, thr)

        def compare():
            return binned_stats._binned_stats_kernel(preds, target, thr, design="compare")

        ms = _time_ms(wrapper)
        launch_ms = _time_ms(_launch_only(preds, target, thr))
        compare_ms = _time_ms(_launch_only(preds, target, thr, design="compare"))
        launch_ms_2 = _time_ms(_launch_only(preds, target, thr))
        plain_ms = _time_ms(lambda: binned_stats._binned_stats_bucket(preds, target, thr))
        plain_compare_ms = _time_ms(lambda: binned_stats.binned_stat_scores(preds, target, thr, use_kernel=False))
        ops, device_ms, op_names = _device_profile(wrapper)
        compare_ops, compare_device_ms, _ = _device_profile(compare)
        _, device_ms_2, _ = _device_profile(wrapper)
        assert ops is None or ops <= 2, f"a wrapper call put {ops} operations on the card: {op_names}"
        bound_ms, bound_by = _bound(n, c, t)
        timings[(n, c, t)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bare_launch_ms=launch_ms,
            bare_launch_ms_again=launch_ms_2, device_ms=device_ms, device_ms_again=device_ms_2,
            compare_bare_launch_ms=compare_ms, compare_device_ms=compare_device_ms, compare_device_ops=compare_ops,
            plain_compare_ms=plain_compare_ms, device_ops_per_call=ops, plan=list(plan),
        )
        share = "not measured" if device_ms is None else f"{100 * bound_ms / device_ms:.2f}% of it"
        print(f"binned_stats N={n} C={c} T={t} plan {plan}: wrapper {ms:.5f} ms; bare launch (host clock of "
              f"back-to-back C calls, CUDA events) histogram {launch_ms:.5f} / {launch_ms_2:.5f} ms, compare "
              f"{compare_ms:.5f} ms; device time per call (torch.profiler) histogram {device_ms} / {device_ms_2} ms "
              f"in {ops} ops {op_names}, compare {compare_device_ms} ms in {compare_ops} ops; plain bucket "
              f"{plain_ms:.5f} ms, plain compare {plain_compare_ms:.5f} ms; bound {bound_ms:.6f} ms ({bound_by}), "
              f"{share}; no single PyTorch call computes this")
    confusion_rows, confusion_err = _confusion_rows()

    _phase("flagship collection: Accuracy + StatScores(macro)")
    rng = np.random.RandomState(0)
    probs = torch.from_numpy(rng.rand(STEPS, BATCH, NUM_CLASSES).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, NUM_CLASSES, (STEPS, BATCH)))

    def flagship(dev):
        return MetricCollection({
            "acc": Accuracy(num_classes=NUM_CLASSES, device=dev),
            "stats": StatScores(reduce="macro", num_classes=NUM_CLASSES, device=dev),
        })

    _run_collection(flagship, (probs, labels), device)  # warm-up: loads the CUDA modules
    mc_gpu, v_gpu, step_ms, compute_ms, _ = _run_collection(flagship, (probs, labels), device)
    mc_cpu, v_cpu, _, _, _ = _run_collection(flagship, (probs, labels), "cpu")
    _check_states(mc_gpu, mc_cpu)
    for key in v_cpu:
        _check_values(key, v_gpu[key], v_cpu[key])
    assert v_gpu["stats"].shape == (NUM_CLASSES, 5)
    print(f"forward step on the card (host clock, after a warm-up run): median {np.median(step_ms):.4f} ms, "
          f"max {max(step_ms):.4f} ms; compute {compute_ms:.4f} ms; acc {float(v_gpu['acc']):.6f}; "
          "states equal to the CPU run, values within 1e-6")
    flagship_step_ms = float(np.median(step_ms))

    _phase("binned collection: BinnedAveragePrecision + BinnedRecallAtFixedPrecision")

    def binned(dev):
        return MetricCollection({
            "ap": BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=dev),
            "rfp": BinnedRecallAtFixedPrecision(
                num_classes=NUM_CLASSES, min_precision=0.5, thresholds=THRESHOLDS, device=dev),
        })

    _run_collection(binned, (probs, labels), device)  # warm-up
    binned_stats.KERNEL_LAUNCHES = 0
    mc_gpu, v_gpu, step_ms, compute_ms, _ = _run_collection(binned, (probs, labels), device)
    launches = binned_stats.KERNEL_LAUNCHES
    assert launches == 2 * STEPS, f"binned_stats kernel launched {launches} times, expected {2 * STEPS}"
    mc_cpu, v_cpu, _, _, _ = _run_collection(binned, (probs, labels), "cpu")
    _check_states(mc_gpu, mc_cpu)
    for key in v_cpu:
        _check_values(key, v_gpu[key], v_cpu[key])
    print(f"forward step on the card (host clock, after a warm-up run): median {np.median(step_ms):.4f} ms, "
          f"max {max(step_ms):.4f} ms; compute {compute_ms:.4f} ms; kernel launches {launches}; "
          "states equal to the CPU run, values within 1e-6")
    binned_step_ms = float(np.median(step_ms))

    _phase("report collection: Precision/Recall/F1/Specificity (macro), ConfusionMatrix, MCC, kappa, Hamming "
           f"over {REPORT_CLASSES} classes, with and without compute groups")
    report_probs, report_labels = _report_data()
    report = _report_collection

    def report_ungrouped(dev):
        return _report_collection(dev, compute_groups=False)

    report_runs = {}
    for name, make in (("grouped", report), ("ungrouped", report_ungrouped)):
        _run_collection(make, (report_probs, report_labels), device)  # warm-up
    # in turns: grouped, ungrouped, ungrouped, grouped; the second of each is kept
    confusion_counts.KERNEL_LAUNCHES = 0
    for name, make in (("grouped", report), ("ungrouped", report_ungrouped), ("ungrouped", report_ungrouped),
                       ("grouped", report)):
        report_runs[name] = _run_collection(make, (report_probs, report_labels), device)
    # ConfusionMatrix, MatthewsCorrcoef and CohenKappa: a launch each a step
    report_launches = confusion_counts.KERNEL_LAUNCHES
    assert report_launches == 4 * 3 * STEPS, \
        f"confusion_counts kernel launched {report_launches} times in 4 report runs, expected {4 * 3 * STEPS}"
    mc_gpu, v_gpu, step_ms, compute_ms, _ = report_runs["grouped"]
    mc_ungrouped, v_ungrouped, step_ms_ungrouped, _, _ = report_runs["ungrouped"]
    groups = mc_gpu.compute_group_keys
    assert groups == [["f1", "prec", "rec", "spec"]], f"report compute groups {groups}"
    assert mc_ungrouped.compute_group_keys == []
    mc_cpu, v_cpu, _, _, _ = _run_collection(report, (report_probs, report_labels), "cpu")
    _check_states(mc_gpu, mc_cpu)
    for (key, m_g), (_, m_u) in zip(mc_gpu.items(), mc_ungrouped.items()):
        for name, v in m_g._state.items():
            assert torch.equal(v, m_u._state[name]), f"grouped state {key}.{name} differs from the ungrouped run"
    for key in v_ungrouped:
        assert torch.equal(v_gpu[key], v_ungrouped[key]), f"grouped {key} differs from the ungrouped run"
    errs = {key: _check_values(key, v_gpu[key], v_cpu[key], VALUE_ATOL_BY_METRIC.get(key, VALUE_ATOL)) for key in v_cpu}
    assert v_gpu["confmat"].shape == (REPORT_CLASSES, REPORT_CLASSES) and mc_gpu["confmat"].confmat.dtype == torch.int64
    print(f"compute groups {groups}; forward step on the card (host clock, after a warm-up run): grouped median "
          f"{np.median(step_ms):.4f} ms (max {max(step_ms):.4f}), ungrouped median {np.median(step_ms_ungrouped):.4f} "
          f"ms (max {max(step_ms_ungrouped):.4f}); compute {compute_ms:.4f} ms; confusion_counts launches "
          f"{report_launches} in 4 runs; grouped states and values equal to "
          f"the ungrouped run bit for bit; states equal to the CPU run; max abs err against it {errs}; values "
          + ", ".join(f"{k} {float(v_gpu[k]):.6g}" for k in v_gpu if k != "confmat"))
    report_step_ms = float(np.median(step_ms))
    report_ungrouped_step_ms = float(np.median(step_ms_ungrouped))
    report_gpu, report_values = mc_gpu, v_gpu  # the sync phase's one-process reference
    for name, make in (("grouped", report), ("ungrouped", report_ungrouped)):
        print(f"peak device memory of a {name} step above its inputs: "
              f"{_step_peak_mib(make, (report_probs[0], report_labels[0]), device):.1f} MiB")
    del report_runs, mc_ungrouped, v_ungrouped

    def composed(dev):
        p = Precision(average="macro", num_classes=REPORT_CLASSES, device=dev)
        r = Recall(average="macro", num_classes=REPORT_CLASSES, device=dev)
        return p, r, 2 * (p * r) / (p + r)

    comp_values = {}
    for dev in (device, "cpu"):
        p, r, comp = composed(dev)
        assert comp.device == torch.device(dev)
        preds, target = report_probs.to(dev), report_labels.to(dev)
        for i in range(STEPS):
            comp(preds[i], target[i])
        value, pv, rv = comp.compute(), p.compute(), r.compute()
        assert torch.equal(value, 2 * (pv * rv) / (pv + rv)), f"composite on {dev}: {value} vs its operands' values"
        comp_values[str(dev)] = value
    comp_err = _check_values("2 * (p * r) / (p + r)", comp_values[str(device)], comp_values["cpu"])
    print(f"CompositionalMetric 2 * (p * r) / (p + r) over macro Precision/Recall: {float(comp_values['cpu']):.6g}, "
          f"equal to the value composed from p and r on each device; max abs err card vs CPU {comp_err}")

    _phase(f"segmentation collection: IoU + ConfusionMatrix over {SEG_CLASSES} classes, dice_score, at "
           f"{SEG_HW[0]}x{SEG_HW[1]}")
    rng = np.random.RandomState(2)
    seg_probs = torch.from_numpy(rng.rand(SEG_STEPS, 1, SEG_CLASSES, *SEG_HW).astype(np.float32))
    seg_labels = torch.from_numpy(rng.randint(0, SEG_CLASSES, (SEG_STEPS, 1, *SEG_HW)))

    def segmentation(dev):
        return MetricCollection({
            "iou": IoU(num_classes=SEG_CLASSES, device=dev),
            "confmat": ConfusionMatrix(SEG_CLASSES, device=dev),
        })

    _run_collection(segmentation, (seg_probs[:1], seg_labels[:1]), device, dice_score)  # warm-up
    confusion_counts.KERNEL_LAUNCHES = 0
    mc_gpu, v_gpu, step_ms, compute_ms, dice_gpu = _run_collection(
        segmentation, (seg_probs, seg_labels), device, dice_score)
    seg_launches = confusion_counts.KERNEL_LAUNCHES  # IoU and ConfusionMatrix: a launch each a step
    assert seg_launches == 2 * SEG_STEPS, \
        f"confusion_counts kernel launched {seg_launches} times, expected {2 * SEG_STEPS}"
    mc_cpu, v_cpu, _, _, dice_cpu = _run_collection(segmentation, (seg_probs, seg_labels), "cpu", dice_score)
    _check_states(mc_gpu, mc_cpu)
    errs = {key: _check_values(key, v_gpu[key], v_cpu[key]) for key in v_cpu}
    errs["dice"] = _check_values("dice_score", dice_gpu, dice_cpu)
    assert int(v_gpu["confmat"].sum()) == SEG_STEPS * SEG_HW[0] * SEG_HW[1], "pixels lost from the confusion matrix"
    print(f"step on the card (forward of both + dice_score; host clock, after a warm-up step): median "
          f"{np.median(step_ms):.4f} ms, max {max(step_ms):.4f} ms; compute {compute_ms:.4f} ms; confusion_counts "
          f"launches {seg_launches}; states equal to the CPU run; max abs err against it {errs}; "
          f"mIoU {float(v_gpu['iou']):.6f}, dice {[round(float(d), 6) for d in dice_gpu]}")
    seg_step_ms = float(np.median(step_ms))
    print(f"peak device memory of a step above its inputs: "
          f"{_step_peak_mib(segmentation, (seg_probs[0], seg_labels[0]), device, dice_score):.1f} MiB")

    _phase(f"curves collection: AUROC + AveragePrecision (macro, with_capacity) + CalibrationError over "
           f"{CURVE_CLASSES} classes; binary curves on {BINARY_ROWS} tied scores")
    curves_runs = _curves_phase(smi, device)

    _phase("regression collection: MSE, RMSE, MAE, MSLE, MAPE, SMAPE, R2Score, ExplainedVariance, PearsonCorrcoef, "
           f"TweedieDevianceScore(power=2) over {REG_STEPS} steps of {DEPTH_PIXELS} depths")
    reg_data, reg_gpu, reg_values, reg_bounds, reg_step_ms = _regression_phase(device)

    _phase("regression-cat: SpearmanCorrcoef and CosineSimilarity(mean), list mode and with_capacity"
           f"({CAT_CAPACITY})")
    _regression_cat_phase(device)

    _phase(f"retrieval collection: MRR, MAP, nDCG@10, P@10, R@100, FallOut@100, MAP(skip) at MS MARCO passage dev "
           f"size ({MSMARCO_QUERIES} queries x {MSMARCO_DEPTH} candidates), list mode and with_capacity")
    retrieval_runs = _retrieval_phase(smi, device)

    _phase("checkpoint: save, verified load and a corrupted file, for the curves and retrieval collections")
    _checkpoint_phase(device, curves_runs["capacity"]["collection"], retrieval_runs["capacity"]["collection"])
    del curves_runs

    _phase("telemetry: the flagship collection with the journal off and on, a journaled save and load, the Chrome "
           "trace, the telemetry() encodings")
    _telemetry_phase(device, flagship, (probs, labels))

    _phase(f"image-fid: FID (buffered and streaming), KID({KID_SUBSETS}x{KID_SUBSET_SIZE}) and IS({IS_SPLITS}) at "
           f"CIFAR-10 FID-10k size ({CIFAR_IMAGES} real + {CIFAR_IMAGES} generated 32x32 uint8 images in "
           f"{CIFAR_STEPS} steps of {CIFAR_STEP}), fidelity Inception-v3 with random weights; CPU checks on "
           f"{FEATURE_CHECK_IMAGES} images' features and on each compute() over the card's states")
    _image_fid_phase(device)

    _phase(f"image-lpips: LPIPS(alex) and LPIPS(vgg) on {BAPPS_PAIRS} pairs of {BAPPS_HW}x{BAPPS_HW} patches (BAPPS "
           f"size) in {BAPPS_PAIRS // BAPPS_STEP} steps of {BAPPS_STEP}; CPU check on {LPIPS_CHECK_PAIRS} pairs")
    _image_lpips_phase(device)

    _phase(f"image-ssim: PSNR and SSIM (data_range=1, streaming) on DIV2K validation size ({DIV2K_IMAGES} images "
           f"of [3, {DIV2K_HW[0]}, {DIV2K_HW[1]}] in {DIV2K_STEPS} steps of {DIV2K_STEP}), image_gradients; CPU check "
           f"on the first {SSIM_CHECK_STEPS} steps")
    _image_ssim_phase(device)

    _phase(f"text: WER ({LIBRISPEECH_UTTERANCES} LibriSpeech test-clean-size utterances), BLEU ({NEWSTEST_SEGMENTS} "
           f"newstest-size segments), ROUGE (rouge1/2/L/Lsum, stemmed, {CNNDM_SUMMARIES} CNN/DailyMail-size "
           "summaries); against the CPU run")
    text_data = _text_phase(device)

    _phase(f"bertscore: BERTScore over {NEWSTEST_SEGMENTS} newstest-size pairs through a bert-base-width encoder "
           f"(random weights, max_length {BERT_MAX_LEN}, batch {BERT_BATCH}), and the default encoder with idf; "
           f"CPU check on {BERT_CHECK_PAIRS} pairs")
    _bertscore_phase(device, text_data)
    del text_data

    _phase(f"audio: PIT(si_sdr), SI-SDR, SI-SNR, SNR at WSJ0-2mix and wsj0-3mix test size ({WSJ_MIXTURES} mixtures of "
           f"{WSJ_SAMPLES} samples, {WSJ_MIXTURES // WSJ_STEP} steps of {WSJ_STEP}) and {HUNGARIAN_MIXTURES} "
           f"mixtures of {HUNGARIAN_SPK} speakers (Hungarian); against the CPU run")
    _audio_phase(device)

    _phase(f"compiled: the flagship, grouped report, regression, binned (B1 inside the graph) and 2-speaker audio "
           f"steps, {COMPILED_STEPS} steps eager and then with the compiled path (16 eager, then CUDA-graph replays)")
    _compiled_phase(smi, device)

    _phase(f"analysis: metricslint over the package; the compiled configurations, {COMPILED_STEPS} steps each with "
           "static pre-classification on and off; a class refuted from this file; the residual host read the "
           "capture refuses; the host-sync list under the sync debug mode")
    _analysis_phase(smi, device)

    _phase(f"fused step: compiled_step (update, in-program sync, compute as one CUDA graph) of the grouped report, "
           f"binned (B1 inside), regression and flagship collections, {FUSED_STEPS} steps each eager, with per-program "
           "replay and as one program")
    _fused_phase(smi, device)

    _phase(f"in-graph sync: compiled_step of the report collection over a one-rank NCCL group, {IN_GRAPH_STEPS} steps")
    _in_graph_sync_phase(device)

    _phase(f"wrappers: BootStrapper(Accuracy(1000), {BOOT_COPIES}) at ImageNet-1k val size ({IMAGENET_VAL} x "
           f"{REPORT_CLASSES} in updates of {BOOT_STEP}), Poisson and multinomial; MetricTracker over "
           f"{TRACKER_EPOCHS} epochs; embedding_similarity on a SimCLR batch ({SIMCLR_BATCH} x {SIMCLR_DIM})")
    _wrappers_phase(device)

    _phase(f"sync: {SYNC_WORLD} ranks on the one card (gloo), the report, ranking, regression and retrieval "
           "collections, the text metrics and BERTScore, divergence cases, and an elastic resume of the ranks' shards into one process")
    _sync_phase(device, report_gpu, report_values, (reg_gpu, reg_values, reg_bounds),
                retrieval_runs["capacity"]["values"])
    del retrieval_runs

    _phase(f"resilience and tiers: {RESILIENCE_WORLD} gloo ranks on the card, tier size {RESILIENCE_TIER} (full, "
           "bf16 and int8 slow hops against the flat sync), probation after a straggler's watchdog, quorum after a "
           "rank leaves")
    _resilience_phase(device)

    _phase(f"examples: the train loop ({EXAMPLE_EPOCHS} epochs x {EXAMPLE_STEPS} steps x {EXAMPLE_BATCH}) eager and "
           "as one CUDA graph a step, the sharded eval over a one-rank NCCL group, own-model BERTScore; the default "
           "Inception and LPIPS draws and the golden FID, KID and LPIPS cases on the card")
    _examples_phase(smi, device)

    _phase("where a step's time goes (torch.profiler)")
    for name, make, ms_step in (("flagship", flagship, flagship_step_ms), ("binned", binned, binned_step_ms)):
        print(f"{name} collection:")
        _profile(make, (probs, labels), device, ms_step)
    for name, make, ms_step in (("grouped", report, report_step_ms),
                                ("ungrouped", report_ungrouped, report_ungrouped_step_ms)):
        print(f"report collection, {name}:")
        _profile(make, (report_probs, report_labels), device, ms_step)
    print("segmentation collection (with dice_score):")
    _profile(segmentation, (seg_probs, seg_labels), device, seg_step_ms, steps=SEG_STEPS - 1, per_step=dice_score)
    print("regression collection:")
    _profile(_regression_collection, reg_data, device, reg_step_ms)

    main = timings[SLICE_SHAPES[0]]
    kernels = [{
        "name": "binned_stats",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_stats.cu",
        "replaces": "metrics_tpu/ops/pallas_binned.py:156",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "design": "histogram",
        "shape": list(SLICE_SHAPES[0]),
        "bare_launch_ms": main["bare_launch_ms"],
        "device_ms": main["device_ms"],
        "compare_bare_launch_ms": main["compare_bare_launch_ms"],
        "compare_device_ms": main["compare_device_ms"],
        "plain_compare_ms": main["plain_compare_ms"],
        "device_ops_per_call": main["device_ops_per_call"],
        "other_shapes": [dict(v, shape=list(s)) for s, v in timings.items() if s != SLICE_SHAPES[0]],
    }]
    # one row a main-path shape; launches are those of the collection run at
    # that shape (segmentation: 2 a step over SEG_STEPS; report: 3 a step
    # over 4 runs of STEPS)
    for name, row in confusion_rows.items():
        kernels.append(dict(
            name="confusion_counts",
            route="cuda",
            source="metrics_tpu_torch/csrc/confusion_counts.cu",
            replaces="metrics_tpu/functional/classification/confusion_matrix.py:19 (an XLA composition)",
            launches=report_launches if name.startswith("report") else seg_launches,
            max_abs_err=confusion_err,
            bound_by="bytes",
            library_ms=None,
            design=row["plan"][0],
            case=name,
            **row,
        ))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
