"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. build every CUDA source of the port (`tinyrecurrentunet_torch/ops/csrc`);
2. hold the GRU recurrence kernel against its plain PyTorch version on the
   card at the flagship's three launch shapes (FGRU forward and reverse,
   TGRU), the three of large16k and one ragged shape per path of the kernel
   (registers, cluster, general), check that each shape ran on the path its
   name says, and time it beside the plain version, its bound and
   torch.nn.GRU (cuDNN, a yardstick the port never calls); the same at the
   streaming path's launch shapes (one hop of the flagship, 4 hops a call,
   64 streams a call, one hop of large16k), with device times under
   torch.profiler;
3. drive the serving path: the offline `Denoiser` with config/proc16k.json
   and artifacts/TRUNet-proc/pretrained.npz on a seeded 4 s clip, with the
   launch counts set to 0 just before and read just after each call: the
   bucket's first call (the body warmed up and captured into the bucket's
   CUDA graph: 3 gru_fwd a run; its seconds) and a replayed call (3
   gru_fwd, nothing else); check the replayed output and the uncaptured
   body's against the same Denoiser in float64 on the CPU (its float32 run
   there logged beside it) and against each other (GRAPH_ATOL), the same
   for the clip led by 0.5 s of digital silence; time both (median, p99,
   max, kernels a call, the device's idle share) beside the card's name
   and power limit; the graph pool's bytes after the 4 s bucket and after
   three more (1, 2, 3 s) called in turns with it, each call held to the
   body;
4. hold the training kernels (forward with residuals, BPTT, the two
   weight-gradient reduction kernels) against their plain versions at the
   flagship training step's three launch shapes (batch 64 of 2 s clips),
   and time each, by device time under torch.profiler (in turns with the
   PyTorch call, the lower of two readings; a reading that lost kernel
   records is taken again) and by CUDA events around the call, beside its
   plain version, its bound and a PyTorch call computing the same function
   (torch.nn.GRU forward and backward, a matmul, a sum); check that the
   forward and the BPTT ran on their resident paths there (timing the
   general kernels and the SIMT reduction beside them, each held against
   the plain version too) and that two calls of the BPTT, of the reduction
   and of the sum on the same inputs give the same bits; hold the forward
   (out, h_T and saved each) and the BPTT at one small ragged shape per
   path and direction, and the forward at large16k's two training launch
   shapes (batch 16), timed beside the general kernel;
5. drive the training path: the port's `train()` on config/proc16k.json in
   float32 (train_compute_dtype cleared, nothing else changed), batch 64 of
   2 s synthetic clips, 5 steps, with the launch counts set to 0 just before
   and read just after (the train step replayed from its CUDA graph: 12 of
   each training kernel in the first call, 3 warm-ups and the replay, 3 in
   each later one: 24); check the losses, gradient norms and weights are
   finite; the replayed step against the same body uncaptured from the same
   weights on the same batches, one step and 5 more (loss terms, grad_norm,
   parameters after the first step; a second body run gives the body's own
   spread), both timed (median ms by host clock and CUDA events, the
   device's idle share, kernels a step, the first call's seconds, the graph
   pool's bytes, peak memory) beside the card's name and power limit; one
   step at batch 4 on the card against the same step on the CPU, each
   against a float64 step on its own input features;
6. drive the streaming path: `StreamingDenoiser` streams the same 4 s clip
   at one hop a call, with the launch counts set to 0 just before and read
   just after (3 gru_fwd a hop, nothing else); check it against the same
   streaming on the CPU and, at the 3-hop shift, against the card's offline
   Denoiser.run; stream the clip led by 0.5 s of digital silence against
   the same streaming on the CPU (its distances to float64 logged); at 1
   and 4 hops a call, the step replayed from its CUDA graph held against
   the same body run uncaptured over the clip (GRAPH_ATOL), and the per-hop
   latency of each (median, p99, max, deadline misses against the hop, RTF,
   kernels a hop, the device's idle share) beside the card's name and power
   limit; `MultiStreamDenoiser` at 1, 16, 64 and 256 streams, replayed and
   uncaptured (3 of 64 streams checked against their single runs), a 10 s
   soak through the native stream host (built from cpp/ into
   build/trunet_host/) and one `stream_file` run, both replayed;
7. drive the training path in bf16: `train()` on config/proc16k.json as
   shipped (train_compute_dtype bfloat16), batch 64 of 2 s clips, 5 steps
   on phase 5's dataset and initial weights, launch counts around it (24 of
   each training kernel, no gru_fwd); log kernels a replayed step and device
   ms by kind under torch.profiler (every recurrent kernel must be one of
   the port's), the device ms of the casts at the three GRU call sites; the
   replayed step against the body as in phase 5, both timed; hold the
   clipped gradient of one step against the float32 step on the card (batch
   64 and 4) and against the CPU's bf16 step (batch 4);
8. score the flagship's quality on the card, float32, bf16 and the int8
   pack, on the 16-file procedural testset (seed 7,000,000) with the
   metrics on the host, every file through its bucket's replayed graph
   (seconds a run): float32 SI-SDR within 0.05 dB of 12.578, bf16 within
   0.05 dB of float32, int8 within 0.05 dB of float32 less 0.019; bf16's
   graph held to its uncaptured body (GRAPH_ATOL) and to float32 by SNR,
   both timed;
9. drive training as users run it: (a) `train()` on config/proc16k.json as
   shipped (bf16) on a 128-item procedural corpus and its 32-item validation
   set, 3 steps at batch 64, launch counts around it (18 of each training
   kernel, 12 gru_fwd for the validation pass at iteration 0: the eval
   slot's 3 warm-ups and its replayed graph), its checkpoint
   resumed into a fresh state whose replayed step is held to the continued
   one's, the device corpus bit-equal to `dataset.get`, the replayed step
   against the body on the corpus's batches as in phase 5; the validation
   pass of the trained state through a new eval step, with the launch
   counts set to 0 just before and read just after its capturing call (12
   gru_fwd) and a replayed call (3 gru_fwd, nothing else), the replayed
   loss terms held to the body's (GRAPH_ATOL relative), both timed (median,
   idle share) beside the eval graph pool's bytes; (b) `train()`
   with a profile directory, 13 steps at batch 8 in float32, whose trace of
   steps 10-12 (replays of the step's graph) names each training kernel;
   (c) two ranks on this card under
   torchrun (gloo), `scripts/torch_dp_step.py`, one step at 8 clips a rank
   in float32 against the single-process card step on the same 16 clips:
   loss terms within 1e-5, grad_norm within 1e-4 relative, parameters by
   phase 5's measure, the ranks bit-equal, 3 launches of each training
   kernel a rank (gloo's step runs its body, which each rank reports), and
   the steps timed; then `scripts/torch_dp_step.py` alone, a group of one
   rank over NCCL, held the same way against the single-process step on
   its 8 clips: its step replayed from a CUDA graph holding the
   collectives (12 launches of each training kernel in the capturing call),
   then 3 steps of fresh weights replayed (the first capturing) against 3
   of the body under torch.backends.cudnn.deterministic, bit-equal, 3
   launches of each training kernel a replay, the all-reduces issued while capturing from
   the main thread and from autograd's, the NCCL kernels torch.profiler
   names in a replay, graph and body timed; (d) `export_pretrained` of (a)'s
   checkpoint served by a card Denoiser, bit-equal to one built from (a)'s
   model (3 gru_fwd a replayed call; cuDNN's deterministic algorithms), the npz holding the
   model's parameters and statistics bit for bit; (e) `train/scaling.py` in bf16 at batch 32, 64 and 128
   (step ms, audio-s per s, peak memory, MFU beside the card's name and
   power limit); (f) phase 8's oracle report;
10. export and the tools beside it: (a) `export_onnx`, `export_torchscript`
   and `export_program` of the flagship on the host (sizes, parity with the
   port's model, torch's version), the TorchScript artifact loaded onto the
   card and held against the port's model with its kernels at the 251-frame
   export shape (3 gru_fwd), and that model against its plain version
   (`use_pallas_gru` "never", no launch) there; (b) the port's int8 pack of pretrained.npz
   byte-equal to the committed model_int8.trq; (c) `export/rt_bench.py`'s
   four engines (seconds and RTF; 3 gru_fwd a call of the full clip and of a
   frame, none in the TorchScript artifact), the port's three replayed from
   their CUDA graphs and as their bodies, each graph engine's output held
   to its body's (GRAPH_ATOL: the full clip, the int8 engine, 20 frames and
   the carry); (d) `ops/gru_bench.py`'s five
   rows (plain version against gru_fwd, times and the largest difference of
   their outputs); (e) the kernel A/B of `train/scaling.py` at batch 64 in
   float32, each replayed from its graph, "never" launching none of the
   five kernels and "always" 3 of each training kernel a step (warm-ups
   included);
11. the other shipped models, large16k (4.4M parameters, FGRU H 256, TGRU H
   512) and proc48k (48 kHz), with their configs and committed weights:
   (a) `Denoiser.from_pretrained` on a seeded 4 s clip at each config's
   rate as phase 3 serves the flagship: 3 gru_fwd a run of the capturing
   call and a replayed call (large16k's on "cluster" by the launches'
   paths), graph and body against a float64 run on the CPU and each other,
   20 calls of each timed, and large16k's `use_pallas_gru` "never" against
   "always", each replayed and as the body; (b) `StreamingDenoiser` at
   one hop a call against the CPU and at the 3-hop shift against offline,
   the replayed step against the uncaptured body (GRAPH_ATOL) and the
   per-hop latency of each against the config's own hop (8 ms, 2.667 ms at
   48 kHz), for proc48k also at two hops a call (5.333 ms, the JAX
   package's promoted 48 kHz mode), misses logged and not held; for proc48k
   `MultiStreamDenoiser` at 16 and 64 streams and a 10 s soak; (c) `run_quality_eval`, float32 and
   the int8 pack, on 16 files of the procedural testset at each rate,
   against the JAX package's scores on the same files; (d) `train()` as
   shipped (bf16, batch 16) on large16k, proc48k and tbptt16k (8 s crops in
   2 s TBPTT segments), launches by path (large16k's BPTT on "cluster" and
   its reduction on the tensor cores, 21 each: 4 iterations, a slot's 3
   warm-ups; tbptt16k 33), step time, audio-s per s, peak memory, a
   profiled step (device time by kind, the GRU kernels' total), the
   replayed step (a TBPTT segment) against the body as in phase 5, both
   timed, and large16k's clipped gradient against float32 on the card and
   against the CPU's bf16 step; (e) every kernel at the launch shapes only
   these models give (large16k's training shapes on the cluster forward,
   the cluster BPTT and the tensor-core reduction, timed beside the general
   BPTT and the SIMT reduction they replace; proc48k's training and
   1,602-frame serving shapes), held against its plain version and timed
   beside its bound and its PyTorch call. Part (e) runs right
   after phase 4, before any profiled training step: after those,
   torch.profiler lost the kernel records of whole readings;
12. drive the training CLI as users start it, in processes of its own under
   their own time limit: `python -m tinyrecurrentunet_torch.train.loop`
   with config/proc16k.json as shipped at 16 clips a rank, validation and
   checkpoints every 2 iterations, `--procedural --procedural_items 64
   --data_parallel` and no launcher, so over every card this process sees
   (one card: a group of one over NCCL, the collectives inside the step's
   graph): `--max_iters 5` (a validation pass, checkpoints 2 and 4), then
   `--max_iters 6`, which must resume from checkpoint 4; every rank must
   exit 0 within 150 s, rank 0 log the ranks and a global batch of 16 x
   them, and each rank's process launch each training kernel 3 times a step
   and 9 more (a slot's first call), rank 0 `gru_fwd` 3 times a validation
   pass and 9 more; the ranks, each run's seconds and the seconds from the
   last step to each rank's exit.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W, dense): HBM bytes/s; FLOP/s in
# float32 outside the tensor cores, in TF32 and in bf16 on them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# Kernel vs plain version, both float32 on the card: dot products of length
# H summed in another order (~H * 2^-24 relative per step), carried through
# up to ~750 steps of a contracting recurrence.
KERNEL_ATOL = 1e-4
# Denoiser on the card vs the same Denoiser in float64 on the CPU (model and
# input in float64, the reference): cuFFT and the CPU FFT differ in the last
# bit, which moves the float32 rounding of the ~1e3 rad unwrapped phase
# behind the demod features (~1e-4 on a few bins); the waveform stays well
# inside this bound (CPU port vs JAX measured 4.2e-5 on a 4 s clip). The
# card's distance is about the same on every machine (3.34e-5-3.35e-5 for
# the flagship's 4 s clip, 3.95e-5 / 3.71e-5 for large16k's and proc48k's,
# NVIDIA H100 80GB HBM3); the CPU's float32 output's is not (its FFT's
# rounding follows the host's instruction set: 2.2e-5 to 6.7e-5 from float64
# on four hosts, and on a fifth the card lay 2.39e-4 from it), so the card
# is held against float64 and its distance to the CPU's float32 output is
# logged.
DENOISE_ATOL = 2e-4
# Weight gradients, kernel vs plain version: sums over rows * T = 257,024
# row-steps taken in another order (per split, then over the splits) and, at
# H 64 and 128, as TF32 products with bf16 correction terms on the tensor
# cores (measured 4e-6 to 9e-6), so the error is held relative to the
# largest entry, max|a - b| / max|b|.
DW_RTOL = 1e-4
# One train step at batch 4 from the same weights and batch, on the card and
# on the CPU. The float32 gradient of this network is ill-conditioned
# (train-mode BatchNorm divides by batch standard deviations, the
# log-magnitude loss by bin magnitudes), and most of it comes from the
# rounding of the input features: cuFFT and the CPU's FFT round the noisy
# spectrogram differently, and the unwrapped phase carries that to ~1e-4 on
# some features. Each run is therefore held against a float64 step on the
# CPU that reads that run's own float32 input features
# (`signal.features.Float32Features`): what is left is the float32
# arithmetic of the network and the loss, 9.0e-4 relative L2 of all
# gradients on the CPU and 5.5-5.8e-4 on the card (NVIDIA H100 80GB HBM3,
# 700 W), while the two references lie 3.8e-2 apart (this script, phase 5).
# With a CPU-only PyTorch the same step is 9.9e-4 from its reference,
# 1.1e-2 from a float64 step on float64 features, and the JAX package's
# float32 step 9.2e-3 (tests/torch_step_conditioning.py). The card may be
# STEP_VS_F64 times as far from its reference as the CPU is from its own,
# or within the floors: about 3x the card's reading.
STEP_VS_F64 = 2.0
STEP_GRAD_FLOOR = 1e-3  # relative L2 of all gradients; measured 5.5-5.8e-4
STEP_NORM_FLOOR = 3e-5  # relative, grad_norm; measured 4.3-8.7e-6 (CPU 1.07e-5)
STEP_LOSS_RTOL = 1e-4  # each loss term, card vs CPU: the loss is well conditioned
STEP_STATS_ATOL = 1e-4  # BatchNorm running statistics after the step, card vs CPU
# Parameters after the AdamW step, card vs CPU. The first Adam step of an
# entry is lr(0) g / (|g| + 1e-8) plus weight decay: where both runs'
# gradients are at least ADAM_SIGN_TAU and of one sign, both steps are
# lr(0) sign(g) to 1e-3 lr(0), so PARAM_ATOL holds (float32 weights round at
# ~6e-8). Elsewhere a near-zero gradient steps by +-lr(0) with either sign:
# 2 lr(0). That is at most 1 - PARAM_EXACT_SHARE of the entries: 9.6% of
# them have a gradient below 1e-5 (tests/torch_step_conditioning.py), and
# 12.4% were below it in either run or of two signs in this script's
# reading (parameters elsewhere within 6.0e-8).
ADAM_SIGN_TAU = 1e-5
PARAM_ATOL = 1e-6
PARAM_EXACT_SHARE = 0.8
TRAIN_BATCH = 64
TRAIN_STEPS = 5
# The train step replayed from its CUDA graph (`train/step.py`) against the
# same body run uncaptured (`step(..., replay=False)`) over TRAIN_GRAPH_CALLS
# calls (one step, then 5 more), each body call from the state the graph's
# call started from: each loss term within TRAIN_GRAPH_LOSS_RTOL and
# grad_norm within TRAIN_GRAPH_NORM_RTOL (relative) at every call;
# parameters after the first step by phase 5's measure (PARAM_ATOL where
# both gradients are clear of 0 and of one sign, 2 lr(0) elsewhere). Where
# cuDNN's backward is not bit-deterministic, as two runs of the body show,
# graph and body run again under torch.backends.cudnn.deterministic and are
# held to those bounds there; in cuDNN's default setting, as train() runs,
# grad_norm is held within TRAIN_GRAPH_NORM_RTOL_NONDET, or twice the two
# bodies' largest spread where that is larger. The flagship's float32 step
# at batch 64 is such a step on an NVIDIA H100 80GB HBM3: its float32 weight
# gradients differ run to run, body and graph alike, and how far grad_norm
# spreads depends on the weights. From the initial weights it falls in two
# clusters 3.5e-5 apart (4.57e-5 the widest spread of 64 runs), from the
# weights 1-5 steps later 1.4e-6-1.8e-5 (32 runs each); under
# cudnn.deterministic every run is bit-equal
# (scripts/torch_train_nondeterminism.py). At the 4th call of one run of
# this script, one body lay 1.10e-4 from the graph and from the other body.
# Two bodies that agree while the graph lands apart differ by that for no
# fault of the graph's, so the default setting's bound is 9 times the
# widest spread seen; the deterministic setting keeps the tight bounds
# (graph and body bit-equal there, every call).
TRAIN_GRAPH_CALLS = 6
TRAIN_GRAPH_LOSS_RTOL = 1e-6
TRAIN_GRAPH_NORM_RTOL = 1e-5
TRAIN_GRAPH_NORM_RTOL_NONDET = 1e-3
PROFILE_PAD_S = 0.01  # idle time at each end of a torch.profiler window (device_ms)
# Streaming (phase 6), card against CPU on the 4 s clip: as DENOISE_ATOL, the
# FFTs' last bit carried by the unwrapped phase. N streams against single
# streams on the card: cuDNN may take another convolution algorithm at
# another batch size; held to the same bound, the error is logged.
STREAM_ATOL = DENOISE_ATOL
# The 3-hop alignment of the streaming output with the offline output.
# The stream starts from zeros where the offline STFT reflects the clip, and
# with the trained flagship that start decays slowly (the TGRU's memory; the
# JAX package streams the same output, tests/test_torch_streaming.py). The
# relative RMS error by shift is logged from block 60 (the window of the
# JAX package's test, with random weights) and from ALIGN_FROM, and held
# from ALIGN_FROM: the 3-hop shift within ALIGN_RMS (measured 0.130), every
# other shift of 0-6 hops at least ALIGN_MARGIN times as far (measured
# >= 1.248).
ALIGN_FROM = 300
ALIGN_RMS = 0.25
ALIGN_MARGIN = 4.0
STREAM_COUNTS = (1, 16, 64, 256)  # multi-stream batch sizes timed
# The streaming step replayed from its CUDA graph against the same body run
# uncaptured (`_process(..., replay=False)`) on the same clip from the same
# start: the same kernels in the same order on the same buffers (0 measured
# at the flagship's and proc48k's widths, 3.0e-8 at large16k's).
GRAPH_ATOL = 1e-6
SOAK_SECONDS = 10.0
# Phases 3 and 6 also denoise and stream the 4 s clip led by this much
# digital silence: torch.fft.rfft gives an exactly-zero bin a real part of
# -0.0 about half the time, and the featurizer puts such bins at +0 before
# taking the phase (a bin at pi moved the JAX package's output by 5.5e-2).
# Offline the card is held against float64 on the CPU (DENOISE_ATOL), as
# the plain clip is. The stream is held against the same streaming on the
# CPU (STREAM_ATOL), as the plain clip is: its float32 running unwrap puts
# a float32 stream, the CPU's as much as the card's, ~8e-4 from float64 on
# this clip (both distances to float64 are logged).
SILENCE_SECONDS = 0.5

# kind of a kernel in a profiled step, first match on its name
KERNEL_KINDS = (
    ("gru_kernels", r"gru_"),
    ("fft", r"fft|FFT"),
    ("convolution", r"conv|cudnn|implicit|wgrad|dgrad|fprop|Conv"),
    ("matmul", r"gemm|cutlass|sm90_xmma|ampere_sgemm|Kernel2|nvjet"),
    ("reduction", r"reduce|Reduce|norm|Norm"),
    ("copy", r"copy|Copy|cat|transpose|Transpose|im2col|col2im|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise|foreach"),
)
# A recurrent kernel, the port's or a library's (cuDNN's RNN, a GRU or LSTM
# of its own); "gru" only at the start of a word, as cuDNN's convolution
# kernels carry "Congruous" in their names
LIBRARY_RNN = r"(?i)rnn|lstm|\bgru|_gru"
# The training step in bf16 (phase 7), measured on the CPU with a CPU-only
# PyTorch at full width from the initial weights (seed 0) on 2 s clips: the
# clipped gradient lies 0.34 (relative L2, batch 4) and 0.25 (batch 8) from
# the float32 step's, and 0.19 / 0.14 from the same bf16 step on an input
# moved by 1e-6 of itself (float32 steps: 8e-3 / 1.1e-2 apart). The bf16
# gradient of this network is mostly rounding (tests/test_torch_bf16.py),
# so two bf16 steps that round differently, as the card and the CPU do, lie
# about as far apart as bf16 lies from float32. Both held at twice the
# CPU's batch-4 bf16-vs-float32 reading.
BF16_GRAD_VS_F32 = 0.7
BF16_GRAD_CARD_VS_CPU = 0.7
# each loss term, the same pairs (CPU: <= 4.7e-4 bf16 vs float32, <= 2.2e-4 moved input)
BF16_LOSS_RTOL = 2e-3
# grad_norm, the same pairs (CPU: <= 1.6e-2 bf16 vs float32, <= 8.5e-3 moved input)
BF16_NORM_RTOL = 0.05
SERVING_CALLS = 20  # denoise calls timed per serving dtype (phase 8)
# bf16 serving against float32 on the card, dB of waveform over their
# difference (tests/test_torch_cuda.py's bound; the CPU's bf16 lies 41.4 dB
# from its float32)
BF16_SERVING_SNR_DB = 30.0
SERVING_LATENCY_CALLS = 100  # the flagship's calls timed, replayed and uncaptured each (phase 3)
# Phase 9: the procedural corpus and steps of the bf16 run; the clips a rank
# of the 2-rank step (float32); its launcher's time limit; the scaling rungs.
PROC_ITEMS = 128
PROC_STEPS = 3
DP_BATCH = 8
DP_TIMEOUT_S = 300
DP_GRAPH_STEPS = 3  # the one-rank NCCL step: replayed steps held bit-equal to the body's
EVAL_CALLS = 20  # validation passes timed, replayed and as the body (phase 9 (a))
SCALING_BATCHES = (32, 64, 128)
# The 2-rank step against the single-process step on the same clips, both on
# the card in float32: the same arithmetic but for the order of the global
# sums (BatchNorm's statistics and the loss's reductions across ranks, the
# gradients' all-reduce) and cuDNN's choice at batch 8 against 16. On the
# CPU at the tests' width: loss terms 6.4e-7, grad_norm 9.6e-6
# (tests/test_torch_parallel.py); on the card at 2 x 8 clips: 7.7e-8 and
# 2.6-3.3e-5, at 4 cards x 16 clips (scripts/torch_dp_cards.py, nccl): 9.3e-8
# and 6.2e-7-1.4e-6.
DP_LOSS_RTOL = 1e-5
DP_NORM_RTOL = 1e-4
# Of the single-process step's gradient entries of at least ADAM_SIGN_TAU,
# the share the data-parallel step matches in sign and size (1.0 and 0.9994
# at the tests' width on the CPU, 2 and 4 ranks; 0.9991 at 4 cards x 16 clips)
DP_SIGN_AGREEMENT = 0.99
# Phase 12: the training CLI as users start it, `--data_parallel` with no
# launcher over every card the process sees: the flagship as shipped at
# CLI_BATCH clips a rank on a CLI_ITEMS-item procedural corpus, validation
# and checkpoints every 2 iterations; a first run of CLI_ITERS[0] iterations
# (0-4: checkpoints 2 and 4), then one of CLI_ITERS[1] that resumes from 4.
# Each run ends within CLI_TIMEOUT_S or fails the phase.
CLI_BATCH = 16
CLI_ITEMS = 64
CLI_ITERS = (5, 6)
CLI_TIMEOUT_S = 150
# The training kernels' names in a trace (any path of each)
TRAINING_KERNEL_NAMES = {
    "gru_fwd_train": r"gru_fwd_resident_kernel|gru_fwd_train_kernel",
    "gru_bwd": r"gru_bwd_resident_kernel|gru_bwd_kernel",
    "gru_dw_partial": r"gru_dw_mma_kernel|gru_dw_partial_kernel",
    "gru_dw_sum": r"gru_dw_sum_kernel",
}
# Quality (phase 8): the flagship on the 16-file procedural testset that
# BENCH_r05.json scored (seed 7,000,000, 4 s files). float32 within
# QUALITY_SI_SDR_ATOL of its 12.578 dB, bf16 within it of float32 (the
# JAX package's delta: -0.002 dB), the int8 pack within it of float32 less
# QUALITY.json's int8 gap of 0.019 dB. The CPU port scores 12.5879 (float32),
# 12.5720 (bf16) and 12.5783 (int8).
QUALITY_FILES = 16
QUALITY_SEED = 7_000_000
QUALITY_F32_SI_SDR = 12.578
QUALITY_INT8_GAP = 0.019
QUALITY_SI_SDR_ATOL = 0.05
# Export (phase 10): the export module (torch.nn.GRU) against the port's
# model, on the host and, as the TorchScript artifact, on the card against
# the model with its kernels, at the 251-frame export shape: the same
# float32 math in another order, the JAX package's export tolerance (the CPU
# port measured 7.2e-7 with the flagship's weights).
EXPORT_ATOL = 1e-4
# Phase 11: the two other shipped models, each with its config and
# committed weights: large16k (4.4M parameters, FGRU H 256, TGRU H 512) and
# proc48k (48 kHz: a hop of 128 samples is 2.667 ms).
SHIPPED = {"large16k": "TRUNet-large", "proc48k": "TRUNet-proc48"}
SHIPPED_CALLS = 20  # warm offline calls timed a model
SHIPPED_STREAM_COUNTS = (16, 64)  # MultiStreamDenoiser at 48 kHz
# (config, iterations of train()) as shipped: bf16, batch 16, synthetic clips
SHIPPED_TRAINING = (("large16k", 4), ("proc48k", 4), ("tbptt16k", 2))
# The 3-hop alignment of streaming with offline (phase 6's check, from
# ALIGN_FROM): (3-hop shift's relative RMS at most, every other shift at
# least this many times as far). proc48k holds the flagship's bounds (CPU:
# 0.128, others >= 1.24). large16k's stream converges more slowly from its
# zero start (TGRU H 512): on the CPU its 3-hop shift is 0.362 from hop 300
# of the 4 s clip (others >= 1.10, 3.0x), 0.252 from hop 500 and 0.208 from
# hop 1,100 of a 12 s clip, the JAX package streaming the same.
SHIPPED_ALIGN = {"large16k": (0.5, 2.0), "proc48k": (ALIGN_RMS, ALIGN_MARGIN)}
# Quality (phase 11 (c)): float32 and the int8 pack on the first
# SHIPPED_QUALITY_FILES files of the procedural testset (seed 7,000,000, 4 s
# files at the config's rate) against the JAX package's scores on the same
# files (float32 SI-SDR, int8 minus float32; dB), computed with the JAX
# package on the CPU: its quality CLI, `tinyrecurrentunet_tpu/infer/quality.py`
# run as a module (python -m) under JAX_PLATFORMS=cpu with
#   -c config/<config>.json --pretrained artifacts/<dir> \
#   --int8 artifacts/<dir>/model_int8.trq --num_files 16 --out /tmp/jax_quality_<config>.json
# and beside them, for reference only, the 60-file record of the same recipe.
SHIPPED_QUALITY_FILES = 16
SHIPPED_QUALITY = {
    "large16k": (13.39231548810356, 0.029911317414260452, 13.526, "QUALITYLARGE.json"),
    "proc48k": (10.614109827065626, 0.000500177801123769, 11.522, "QUALITY48.json"),
}


REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")
CLIP_SECONDS = 4.0


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str | None = None, iters: int = 10, launches: int | None = None) -> float:
    """Mean device time in ms of the kernels whose name contains `name`
    (default: every kernel) over `iters` calls of fn(), from torch.profiler:
    the host's launch cost is left out, which CUDA events around a kernel of
    a few microseconds would measure instead.

    A reading counts the kernel records it matched and holds only if they
    are `iters` times the kernels one call launches (`launches`; by default
    as many as a profiled single call of fn() gives, read beside it): the
    profiler has been seen to return fewer records than were launched (1 to
    7 of 20 missing, three readings in a row, on one machine), and such a
    reading would be low. It is taken again, up to three times in all, and
    then this raises; but where a call launches one kernel and at least
    half the records arrived, their mean is the kernel's time (seen: 9
    records of 10 launches, three readings in a row). The window
    is padded with PROFILE_PAD_S of idle time at each end, in case records
    near its edges are what goes missing. A
    call whose kernels are not the port's (`launches` None: a library call)
    may launch more on some calls than on the single call counted (cuDNN's
    training-mode GRU forward was seen launching 39 kernels over 10 calls of
    3, three readings in a row, on one machine): its reading holds with at
    least `iters` times that count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def read(calls: int) -> tuple[int, float]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and (name is None or name in e.key)]
        return sum(e.count for e in events), sum(e.device_time_total for e in events)

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(3):
        per_call = launches if launches is not None else read(1)[0]
        count, total = read(iters)
        readings.append((per_call, count))
        if per_call > 0 and (count == iters * per_call or (launches is None and count > iters * per_call)):
            return total / iters / 1e3
        if per_call == 1 and iters // 2 <= count < iters:
            # each record is one launch of the one kernel a call: the mean of
            # the records that arrived is its device time
            log(f"[device_ms] {name or 'any kernel'}: {count} kernel records of {iters} launches, their mean taken")
            return total / count / 1e3
        log(f"[device_ms] {name or 'any kernel'}: {count} kernel records of {iters} x {per_call}, taken again")
    raise AssertionError(f"torch.profiler: kernel records of {name or 'any kernel'} over {iters} calls "
                         f"(per call, counted) {readings}, never {iters} x the kernels of one call")


def library_device_ms(fn, iters: int = 10) -> tuple[float, str]:
    """(ms, how measured) of a PyTorch call, a yardstick: `device_ms`, or,
    where torch.profiler keeps losing the call's kernel records (seen for
    torch.matmul at large16k's weight-gradient shape, 4,016 x 16 x 256: 0
    records of one call, then 8 over 10 calls of 2 kernels, three readings
    in a row), CUDA events around `iters` calls, which at a millisecond or
    more a call measure the device rather than the host's launch."""
    try:
        return device_ms(fn, iters=iters), "torch.profiler"
    except AssertionError as err:
        log(f"[device_ms] {err}: timed by CUDA events instead")
        return cuda_ms(fn, iters), "cuda_events"


def denoise_errors(cfg, artifact: str, clip: np.ndarray, out: np.ndarray, body: np.ndarray | None = None) -> dict:
    """Max abs distance of the card's denoised `clip` (`out`, replayed from
    its bucket's graph) to the same Denoiser on the CPU in float32 and in
    float64 (model and padded input in float64), of the CPU's float32 output
    to float64 and, given the uncaptured body's output `body`, of the body to
    float64 and to the graph. DENOISE_ATOL holds "card_vs_cpu_f64" and
    "body_vs_cpu_f64", GRAPH_ATOL "graph_vs_body"."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cpu = Denoiser.from_pretrained(cfg, artifact, device="cpu")
    ref = cpu(clip)
    bucket = Denoiser._bucket(len(clip), cfg.featurizer.hop_length)
    cpu.model.double()
    f64 = cpu.run(torch.from_numpy(np.pad(clip, (0, bucket - len(clip))).astype(np.float64))).numpy()[: len(clip)]
    errors = {"card_vs_cpu_f64": float(np.abs(out - f64).max()), "card_vs_cpu": float(np.abs(out - ref).max()),
              "cpu_vs_cpu_f64": float(np.abs(ref - f64).max()), "peak": float(np.abs(f64).max())}
    if body is not None:
        errors["body_vs_cpu_f64"] = float(np.abs(body - f64).max())
        errors["graph_vs_body"] = float(np.abs(out - body).max())
    return errors


def make_clip(sample_rate: int, seed: int = 0) -> np.ndarray:
    """CLIP_SECONDS of a few harmonic tones plus white noise at
    `sample_rate` (a config's featurizer.sample_rate), float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(CLIP_SECONDS * sample_rate)) / sample_rate
    clip = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 220.0), (0.2, 660.0), (0.1, 1500.0)))
    clip = clip + 0.1 * rng.standard_normal(t.shape)
    return clip.astype(np.float32)


def silence_led(clip: np.ndarray, sample_rate: int) -> np.ndarray:
    """`clip` of the same length starting with SILENCE_SECONDS of digital
    silence (exact zeros): the STFT bins of the silent frames are exactly 0,
    whose phase the featurizer must take as 0, as the JAX package's FFT
    gives it."""
    lead = int(SILENCE_SECONDS * sample_rate)
    return np.concatenate([np.zeros(lead, np.float32), clip[: len(clip) - lead]])


def stream_cpu_f64(cfg, sd, clip: np.ndarray) -> np.ndarray:
    """`clip` streamed at one hop a call on the CPU in float64: the model,
    the samples and the stream's state (the reference of phase 6's
    silence-led clip)."""
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser, StreamState

    den = StreamingDenoiser(cfg, sd, device="cpu")
    den.model.double()
    den._input = lambda samples: torch.as_tensor(samples, dtype=torch.float64)
    first = den.init_state

    def init_state():
        st = first()
        f64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
        return StreamState(f64(st.in_buffer), type(st.feat_state)(*map(f64, st.feat_state)), f64(st.tgru_h),
                           f64(st.ola_buffer))

    den.init_state = init_state
    return den.process(clip)[0]


def crop_frames(cfg) -> int:
    """STFT frames of one training crop of the config."""
    return int(cfg.trainset.crop_length_sec * cfg.trainset.sample_rate) // cfg.featurizer.hop_length + 1


def gru_inputs(rows: int, steps: int, hidden: int, seed: int, device):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(hidden)
    arrays = (
        rng.standard_normal((rows, steps, 3 * hidden)) * 0.5,
        rng.standard_normal((rows, hidden)) * 0.1,
        rng.uniform(-k, k, (hidden, 3 * hidden)),
        rng.uniform(-k, k, (3 * hidden,)),
    )
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def gru_bound(rows: int, steps: int, hidden: int) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, FLOPs) of one recurrence call: each
    input read once and each output written once; 2*H*3H FLOPs for h @ Wh
    and ~12 H for biases and gates per row and step."""
    g = 3 * hidden
    nbytes = 4 * (rows * steps * g + rows * hidden + hidden * g + g + rows * steps * hidden + rows * hidden)
    flops = rows * steps * (2 * hidden * g + 12 * hidden)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes, flops
    return t_ops * 1e3, "operations", nbytes, flops


def bound(nbytes: float, flops: float, tensor_cores: bool = False) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the HBM rate or the operations
    over the peak rate of their type, whichever is larger. The type is
    float32 outside the tensor cores, or, for a kernel that runs its product
    on them as `gru_dw_partial` does, one TF32 and two bf16 instructions per
    product, each at its own peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_TF32_FLOPS + 2 * flops / PEAK_BF16_FLOPS if tensor_cores else flops / PEAK_F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def train_kernel_work(kernel: str, rows: int, steps: int, hidden: int, splits: int):
    """(bytes, FLOPs) of one launch of a training kernel: each input read
    once, each output written once. Per row and step: the forward does
    h @ Wh (2 H 3H) and ~12 H of gates; the BPTT d_hp @ Wh^T (2 3H H) and
    ~20 H; the reduction h_prev^T d_hp (2 H 3H) and 4 H for dbh and dn r."""
    n, g = rows * steps, 3 * hidden
    dw = g * (hidden + 1)
    work = {
        "gru_fwd_train": (4 * (n * g + rows * hidden + hidden * g + g + n * hidden + rows * hidden
                               + n * 4 * hidden), n * (2 * hidden * g + 12 * hidden)),
        # g, g_hT, out (as h_prev), saved, h0, Wh in; d_xp, dh0 out
        "gru_bwd": (4 * (n * hidden + rows * hidden + n * hidden + n * 4 * hidden + rows * hidden
                         + hidden * g + n * g + rows * hidden), n * (2 * g * hidden + 20 * hidden)),
        # out (as h_prev), h0, d_xp, r of saved in; the partials out
        "gru_dw_partial": (4 * (n * hidden + rows * hidden + n * g + n * hidden + splits * dw),
                           n * (2 * hidden * g + 4 * hidden)),
        "gru_dw_sum": (4 * (splits * dw + dw), splits * dw),
    }
    return work[kernel]


def torch_gru_module(wh, bh) -> torch.nn.GRU:
    """torch.nn.GRU computing the recurrence over x_proj: identity input
    weights and zero input bias turn its input projection into x_proj."""
    g = wh.shape[-1]
    gru = torch.nn.GRU(g, g // 3, batch_first=True).to(wh.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(g))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(wh.T)
        gru.bias_hh_l0.copy_(bh)
    return gru


def torch_gru_same_function(x_proj, h0, wh, bh, reverse):
    """A call of torch.nn.GRU computing the same recurrence."""
    gru = torch_gru_module(wh, bh)
    xs = x_proj.flip(1) if reverse else x_proj

    def call():
        return gru(xs, h0[None])

    return call


def check_kernel(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 2 at one launch shape, which must run on `path` of gru_fwd."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    out_k, hT_k = cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    plan = cuda_gru.last_fwd_plan
    out_p, hT_p = gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    err = max((out_k - out_p).abs().max().item(), (hT_k - hT_p).abs().max().item())
    finite = bool(torch.isfinite(out_k).all() and torch.isfinite(hT_k).all())

    lib_call = torch_gru_same_function(x_proj, h0, wh, bh, reverse)
    with torch.no_grad():
        out_l, hT_l = lib_call()
    if reverse:
        out_l = out_l.flip(1)
    lib_err = max((out_l - out_p).abs().max().item(), (hT_l[0] - hT_p).abs().max().item())

    kernel_ms = cuda_ms(lambda: cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse), 20)
    plain_ms = cuda_ms(lambda: gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse), 3, 1)
    with torch.no_grad():
        library_ms = cuda_ms(lib_call, 20)
    bound_ms, bound_by, nbytes, flops = gru_bound(rows, steps, hidden)
    row = {
        "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
        "path": plan.path, "rows_per_tile": plan.rows_per_tile,
        "max_abs_err": err, "library_max_abs_err": lib_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }
    log(f"[kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_fwd {name}: ran on the {plan.path} path, expected {path}")
    if not finite:
        raise AssertionError(f"gru_fwd {name}: non-finite output")
    if err > KERNEL_ATOL:
        raise AssertionError(f"gru_fwd {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def check_streaming_kernel(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 2 at a launch shape of the streaming path: `check_kernel`, then
    device times under torch.profiler of the kernel, of torch.nn.GRU and of
    the plain version (a matmul and the gates a step). At T = 1 the event
    time around a call is the host's launch."""
    row = check_kernel(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops)
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, torch.device("cuda"))
    library = torch_gru_same_function(x_proj, h0, wh, bh, reverse)
    with torch.no_grad():
        row["device_ms"] = device_ms(lambda: cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse),
                                     iters=20, launches=1)
        row["library_device_ms"] = device_ms(library, iters=20)
        row["plain_device_ms"] = device_ms(
            lambda: gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse), iters=5)
    log(f"[stream-kernel] {json.dumps(row)}")
    return row


def randn(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_abs(a, b) / max(b.abs().max().item(), 1e-30)


def torch_gru_train_calls(x_proj, h0, wh, bh, reverse, g, g_hT, want_out):
    """(forward call, backward call, max abs error of its outputs) of
    torch.nn.GRU computing the same recurrence in training: cuDNN's training
    forward and its backward for upstream (g, g_hT). A yardstick the port
    never calls."""
    gru = torch_gru_module(wh, bh)
    xs = (x_proj.flip(1) if reverse else x_proj).detach().requires_grad_()
    h0l = h0[None].detach().requires_grad_()
    out_l, h_l = gru(xs, h0l)
    err = max_abs(out_l.flip(1) if reverse else out_l, want_out)
    grads = (g.flip(1) if reverse else g, g_hT[None])
    inputs = [xs, h0l, gru.weight_hh_l0, gru.bias_hh_l0]
    return (lambda: gru(xs, h0l),
            lambda: torch.autograd.grad((out_l, h_l), inputs, grads, retain_graph=True), err)


def fwd_train_errors(got, want) -> dict[str, float]:
    """Max abs error of each output of the training forward: out, h_T, saved."""
    return {k: max_abs(a, b) for k, a, b in zip(("out", "h_T", "saved"), got, want)}


# the paths of the training kernels at the flagship's training shapes (phase 4)
RESIDENT_TRAIN_PATHS = {"gru_fwd_train": "registers", "gru_bwd": "registers", "gru_dw_partial": "tensor_cores"}


def check_train_kernels(name, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops, paths=None):
    """Phase 4 (and 11) at one launch shape: each training kernel against
    its plain version on the same inputs, then timed: device time under
    torch.profiler ("ms") and CUDA events around the wrapper's call
    ("call_ms"), the same two for the PyTorch call, for `gru_fwd_train` and
    `gru_bwd` the device time of the general kernel and for `gru_dw_partial`
    that of the SIMT kernel (the path itself where the shape takes it), each
    held against the plain version too. The forward, the BPTT and the
    reduction must run on `paths` (default RESIDENT_TRAIN_PATHS); the BPTT,
    the reduction and the sum must give the same bits on a second call.
    Returns one row per kernel."""
    paths = paths or RESIDENT_TRAIN_PATHS
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    g = randn((rows, steps, hidden), seed + 100, device)
    g_hT = randn((rows, hidden), seed + 200, device)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count

    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    fwd_plan = cuda_gru.last_fwd_train_plan
    fwd_general = cuda_gru.FwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))
    fwd_general_got = cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, reverse, plan=fwd_general)
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    out, _, saved = want
    bwd_args = (g, g_hT, out, saved, h0, wh)
    d_xp, dh0 = cuda_gru.bptt(*bwd_args, reverse=reverse)
    bwd_plan = cuda_gru.last_bwd_plan
    bwd_again = cuda_gru.bptt(*bwd_args, reverse=reverse)
    general = cuda_gru.BwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))
    gd_xp, gdh0 = cuda_gru._launch_bwd(*bwd_args, reverse, plan=general)
    p_dxp, p_dwh, p_dbh, p_dh0 = gru_ops.gru_recurrence_bwd(*bwd_args, reverse=reverse)
    part = cuda_gru.dw_partial(out, h0, p_dxp, saved, reverse=reverse)
    dw_plan = cuda_gru.last_dw_plan
    part_again = cuda_gru.dw_partial(out, h0, p_dxp, saved, reverse=reverse)
    simt = cuda_gru.DwPlan("simt", *cuda_gru.dw_splits(rows * steps, hidden, num_sms, "simt"))
    simt_dwh, simt_dbh = cuda_gru.dw_sum(cuda_gru._launch_dw(out, h0, p_dxp, saved, reverse, plan=simt), hidden)
    dwh, dbh = cuda_gru.dw_sum(part, hidden)
    sum_plan = cuda_gru.last_sum_plan
    dw_again = torch.cat([t.reshape(-1) for t in cuda_gru.dw_sum(part, hidden)])
    dw_sum_want = part.sum(dim=0)
    torch.cuda.synchronize()
    bit_identical = {
        "gru_bwd": bool(torch.equal(d_xp, bwd_again[0]) and torch.equal(dh0, bwd_again[1])),
        "gru_dw_partial": bool(torch.equal(part, part_again)),
    }
    dw_got = torch.cat([dwh.reshape(-1), dbh])
    fwd_errors = fwd_train_errors(got, want)
    fwd_general_errors = fwd_train_errors(fwd_general_got, want)
    errors = {
        "gru_fwd_train": max(fwd_errors.values()),
        "gru_bwd": max(max_abs(d_xp, p_dxp), max_abs(dh0, p_dh0)),
        "gru_dw_partial": max(max_abs(dwh, p_dwh), max_abs(dbh, p_dbh)),
        "gru_dw_sum": max_abs(dw_got, dw_sum_want),
    }
    general_err = max(max_abs(gd_xp, p_dxp), max_abs(gdh0, p_dh0))
    fwd_general_err = max(fwd_general_errors.values())
    rel = {
        "gru_dw_partial": max(max_rel(dwh, p_dwh), max_rel(dbh, p_dbh)),
        "gru_dw_sum": max_rel(dw_got, dw_sum_want),
    }
    simt_rel = max(max_rel(simt_dwh, p_dwh), max_rel(simt_dbh, p_dbh))
    finite = all(bool(torch.isfinite(t).all()) for t in (*got, d_xp, dh0, dwh, dbh))

    fwd_lib, bwd_lib, lib_err = torch_gru_train_calls(x_proj, h0, wh, bh, reverse, g, g_hT, out)
    hidden_prev = torch.cat([out[:, 1:], h0[:, None]], 1) if reverse else torch.cat([h0[:, None], out[:, :-1]], 1)
    hp_flat = hidden_prev.reshape(-1, hidden)
    dhp_flat = torch.cat([p_dxp[..., : 2 * hidden], p_dxp[..., 2 * hidden :] * saved[..., :hidden]], -1)
    dhp_flat = dhp_flat.reshape(-1, 3 * hidden)
    timing = {
        "gru_fwd_train": (
            lambda: cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse),
            lambda: gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse),
            fwd_lib,
        ),
        "gru_bwd": (
            lambda: cuda_gru.bptt(*bwd_args, reverse=reverse),
            lambda: gru_ops.gru_recurrence_bwd(*bwd_args, reverse=reverse),
            bwd_lib,
        ),
        "gru_dw_partial": (
            lambda: cuda_gru.dw_partial(out, h0, p_dxp, saved, reverse=reverse),
            lambda: gru_ops.gru_weight_grads(out, h0, p_dxp, saved, reverse),
            lambda: torch.matmul(hp_flat.T, dhp_flat),
        ),
        "gru_dw_sum": (
            lambda: cuda_gru.dw_sum(part, hidden),
            lambda: part.sum(dim=0),
            lambda: torch.sum(part, dim=0),
        ),
    }
    # the general kernels and the SIMT reduction, which these shapes do not take
    generals = {
        "gru_fwd_train": lambda: cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, reverse, plan=fwd_general),
        "gru_bwd": lambda: cuda_gru._launch_bwd(*bwd_args, reverse, plan=general),
        "gru_dw_partial": lambda: cuda_gru._launch_dw(out, h0, p_dxp, saved, reverse, plan=simt),
    }
    rows_out = []
    for kernel, (run, plain, library) in timing.items():
        nbytes, flops = train_kernel_work(kernel, rows, steps, hidden, part.shape[0])
        tensor_cores = kernel == "gru_dw_partial" and dw_plan.path == "tensor_cores"
        bound_ms, bound_by = bound(nbytes, flops, tensor_cores=tensor_cores)
        # kernel, PyTorch call (and general kernel) in turns, the lower of two readings each
        turns = [(device_ms(run, launches=1), library_device_ms(library),
                  device_ms(generals[kernel], launches=1) if kernel in generals else None) for _ in range(2)]
        kernel_ms, library_ms, general_ms = zip(*turns)
        row = {
            "kernel": kernel, "shape": name, "rows": rows, "T": steps, "H": hidden,
            "reverse": reverse, "max_abs_err": errors[kernel], "max_rel_err": rel.get(kernel),
            "ms": min(kernel_ms), "call_ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain, 2, 1),
            "library_ms": min(ms for ms, _ in library_ms),
            "library_ms_by": "+".join(sorted({by for _, by in library_ms})),
            "library_call_ms": cuda_ms(library, 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        }
        if kernel in ("gru_fwd_train", "gru_bwd"):
            row["general_ms"] = min(general_ms)
        if kernel == "gru_fwd_train":
            row["library_max_abs_err"] = lib_err
            row["path"], row["rows_per_tile"] = fwd_plan
            row["max_abs_err_by_output"] = fwd_errors
            row["general_rows_per_block"], row["general_max_abs_err"] = fwd_general.rows_per_tile, fwd_general_err
        if kernel == "gru_bwd":
            row["path"], row["rows_per_tile"] = bwd_plan
            row["general_rows_per_block"], row["general_max_abs_err"] = general.rows_per_tile, general_err
            row["bit_identical"] = bit_identical[kernel]
        if kernel == "gru_dw_partial":
            row["path"], row["splits"], row["steps_per_split"] = dw_plan
            # the float32 SIMT kernel, forced, and the float32 bound it has
            row["simt_ms"], row["simt_splits"], row["simt_max_rel_err"] = min(general_ms), simt.splits, simt_rel
            row["bound_ms_float32"] = bound(nbytes, flops)[0]
            row["bit_identical"] = bit_identical[kernel]
        if kernel == "gru_dw_sum":
            row["cols"], row["groups"] = sum_plan
            row["bit_identical"] = bool(torch.equal(dw_got, dw_again))
        log(f"[train-kernel] {json.dumps(row)}")
        rows_out.append(row)
    if not finite:
        raise AssertionError(f"training kernels {name}: non-finite output")
    ran = {"gru_fwd_train": fwd_plan.path, "gru_bwd": bwd_plan.path, "gru_dw_partial": dw_plan.path}
    for kernel, path in paths.items():
        if ran[kernel] != path:
            raise AssertionError(f"{kernel} {name}: ran on the {ran[kernel]} path, expected {path}")
    for kernel, err in (("gru_fwd_train", errors["gru_fwd_train"]), ("gru_fwd_train general", fwd_general_err),
                        ("gru_bwd", errors["gru_bwd"]), ("gru_bwd general", general_err)):
        if err > KERNEL_ATOL:
            raise AssertionError(f"{kernel} {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    for kernel, value in (*rel.items(), ("gru_dw_partial simt", simt_rel)):
        if value > DW_RTOL:
            raise AssertionError(f"{kernel} {name}: max rel err {value:.3e} > {DW_RTOL:.0e}")
    if not torch.equal(dw_got, dw_again):
        raise AssertionError(f"gru_dw_sum {name}: two calls on the same partials differ")
    for kernel, same in bit_identical.items():
        if not same:
            raise AssertionError(f"{kernel} {name}: two calls on the same inputs differ")
    return rows_out


def check_fwd_train_shape(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 4 at a small ragged shape: `gru_fwd_train` against its plain
    version, out, h_T and saved each on its own, on `path`."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    plan = cuda_gru.last_fwd_train_plan
    errs = fwd_train_errors(got, gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse))
    torch.cuda.synchronize()
    row = {"kernel": "gru_fwd_train", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
           "path": plan.path, "rows_per_tile": plan.rows_per_tile, "max_abs_err": max(errs.values()),
           "max_abs_err_by_output": errs}
    log(f"[train-kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_fwd_train {name}: ran on the {plan.path} path, expected {path}")
    if rows % plan.rows_per_tile == 0 or steps % 2 == 0:
        raise AssertionError(f"gru_fwd_train {name} is not ragged: {row}")
    for what, err in errs.items():
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"gru_fwd_train {name}: {what} max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def check_fwd_train_large(name, path, rows, steps, hidden, seed, cuda_gru, gru_ops):
    """Phase 4 at a launch shape of large16k's training: `gru_fwd_train` on
    `path` against its plain version, timed by device time in turns with the
    general kernel and torch.nn.GRU's training forward."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh)
    plan = cuda_gru.last_fwd_train_plan
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    general = cuda_gru.FwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))
    general_got = cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, False, plan=general)
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh)
    errs, general_errs = fwd_train_errors(got, want), fwd_train_errors(general_got, want)
    fwd_lib, _, lib_err = torch_gru_train_calls(x_proj, h0, wh, bh, False, want[0], want[1], want[0])

    def run():
        return cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh)

    turns = [(device_ms(run, launches=1), device_ms(fwd_lib),
              device_ms(lambda: cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, False, plan=general), launches=1))
             for _ in range(2)]
    kernel_ms, library_ms, general_ms = (min(t) for t in zip(*turns))
    nbytes, flops = train_kernel_work("gru_fwd_train", rows, steps, hidden, 0)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"kernel": "gru_fwd_train", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": False,
           "path": plan.path, "rows_per_tile": plan.rows_per_tile, "max_abs_err": max(errs.values()),
           "max_abs_err_by_output": errs, "ms": kernel_ms, "call_ms": cuda_ms(run, 5),
           "plain_ms": cuda_ms(lambda: gru_ops.gru_recurrence_train(x_proj, h0, wh, bh), 2, 1),
           "library_ms": library_ms, "library_max_abs_err": lib_err, "general_ms": general_ms,
           "general_rows_per_block": general.rows_per_tile, "general_max_abs_err": max(general_errs.values()),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
    log(f"[train-kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_fwd_train {name}: ran on the {plan.path} path, expected {path}")
    for what, err in (*errs.items(), *(("general " + k, v) for k, v in general_errs.items())):
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"gru_fwd_train {name}: {what} max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def check_bwd_shape(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 4 at a small ragged shape: `gru_bwd` against its plain version,
    on `path`."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    g = randn((rows, steps, hidden), seed + 100, device)
    g_hT = randn((rows, hidden), seed + 200, device)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    d_xp, dh0 = cuda_gru.bptt(g, g_hT, out, saved, h0, wh, reverse=reverse)
    plan = cuda_gru.last_bwd_plan
    p_dxp, _, _, p_dh0 = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.cuda.synchronize()
    err = max(max_abs(d_xp, p_dxp), max_abs(dh0, p_dh0))
    row = {"kernel": "gru_bwd", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
           "path": plan.path, "rows_per_tile": plan.rows_per_tile, "max_abs_err": err}
    log(f"[train-kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_bwd {name}: ran on the {plan.path} path, expected {path}")
    if rows % plan.rows_per_tile == 0 or steps % 2 == 0:
        raise AssertionError(f"gru_bwd {name} is not ragged: {row}")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"gru_bwd {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def float32_training(cfg):
    """proc16k with train_compute_dtype cleared: the port trains in float32."""
    opt = dataclasses.replace(cfg.train.optimization, train_compute_dtype="")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))


def batch_of(dataset, count: int, device, start: int = 0):
    items = [dataset.get(i) for i in range(start, start + count)]
    return [torch.from_numpy(np.stack([x[k] for x in items])).to(device) for k in (0, 1)]


def batches_of(dataset, batch: int, count: int) -> list:
    """`count` batches of `batch` consecutive items of `dataset` on the card."""
    return [tuple(batch_of(dataset, batch, "cuda", i * batch)) for i in range(count)]


def phase_workdir(name: str) -> str:
    """An empty scratch directory of the build tree, where a config's
    relative log directory (./ckpt) resolves, so no earlier run is resumed."""
    workdir = os.path.join(REPO, "build", name)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    return workdir


def with_batch(cfg, batch: int):
    opt = dataclasses.replace(cfg.train.optimization, batch_size_per_device=batch)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))


def compare_train_step(cfg, dataset):
    """One step at batch 4 from the same weights and batch: on the card and
    on the CPU in float32, and for each a float64 step on the CPU that reads
    its float32 input features, the reference."""
    from tinyrecurrentunet_torch.signal import Featurizer
    from tinyrecurrentunet_torch.signal.features import Float32Features
    from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    cfg = with_batch(cfg, 4)
    opt = cfg.train.optimization
    runs = {}
    for name, device, dtype, features_on in (
        ("card", "cuda", torch.float32, None), ("cpu", "cpu", torch.float32, None),
        ("card_f64", "cpu", torch.float64, "cuda"), ("cpu_f64", "cpu", torch.float64, "cpu"),
    ):
        state = create_train_state(cfg, device=device)
        state.model.to(dtype)
        clean, noisy = (t.to(dtype) for t in batch_of(dataset, 4, device))
        featurizer = Float32Features(Featurizer(cfg.featurizer), features_on) if features_on else None
        t0 = time.perf_counter()
        state, metrics = make_train_step(cfg, featurizer=featurizer)(state, clean, noisy)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": torch.cat([p.grad.reshape(-1).double().cpu() for p in state.model.parameters()]),
            "params": torch.cat([p.detach().reshape(-1).double().cpu() for p in state.model.parameters()]),
            "stats": torch.cat([b.reshape(-1).double().cpu() for b in state.model.buffers()]),
            "s": time.perf_counter() - t0,
        }
    card, cpu = runs["card"], runs["cpu"]

    def norm_err(run, ref):
        return abs(run["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) / ref["metrics"]["grad_norm"]

    lr0 = linear_warmup_cosine_decay(opt.learning_rate, opt.n_iters, opt.lr_divider, opt.warmup_proportion)(0)
    exact = (torch.minimum(cpu["grads"].abs(), card["grads"].abs()) >= ADAM_SIGN_TAU) & (
        cpu["grads"].sign() == card["grads"].sign())
    param_err = (card["params"] - cpu["params"]).abs()
    report = {
        "loss_rel_err_card_vs_cpu": {k: abs(card["metrics"][k] - cpu["metrics"][k]) / abs(cpu["metrics"][k])
                                     for k in cpu["metrics"] if k != "grad_norm"},
        "grad_rel_l2_vs_f64": {"card": rel_l2(card["grads"], runs["card_f64"]["grads"]),
                               "cpu": rel_l2(cpu["grads"], runs["cpu_f64"]["grads"])},
        "grad_norm_rel_err_vs_f64": {"card": norm_err(card, runs["card_f64"]),
                                     "cpu": norm_err(cpu, runs["cpu_f64"])},
        "grad_rel_l2_card_vs_cpu": rel_l2(card["grads"], cpu["grads"]),
        "grad_rel_l2_f64_references": rel_l2(runs["card_f64"]["grads"], runs["cpu_f64"]["grads"]),
        "param_exact_share": exact.double().mean().item(),
        "param_max_abs_err_card_vs_cpu_exact": param_err[exact].max().item(),
        "param_max_abs_err_card_vs_cpu": param_err.max().item(), "lr0": lr0,
        "bn_stats_max_abs_err_card_vs_cpu": (card["stats"] - cpu["stats"]).abs().max().item(),
        "step_s": {k: r["s"] for k, r in runs.items()}, "loss": card["metrics"]["loss"],
        "grad_norm": card["metrics"]["grad_norm"],
    }
    log(f"[train-step batch 4: card, cpu, each against float64 on its own features] {json.dumps(report)}")
    for name, err in report["loss_rel_err_card_vs_cpu"].items():
        if not err <= STEP_LOSS_RTOL:
            raise AssertionError(f"train step card vs CPU: {name} rel err {err:.3e} > {STEP_LOSS_RTOL:.0e}")
    for what, floor in (("grad_rel_l2_vs_f64", STEP_GRAD_FLOOR), ("grad_norm_rel_err_vs_f64", STEP_NORM_FLOOR)):
        errs = report[what]
        if not errs["card"] <= max(STEP_VS_F64 * errs["cpu"], floor):
            raise AssertionError(f"train step: card {what} {errs['card']:.3e} against the CPU's {errs['cpu']:.3e}")
    if not report["param_exact_share"] >= PARAM_EXACT_SHARE:
        raise AssertionError(f"train step card vs CPU: gradients of one sign on {report['param_exact_share']:.3f}")
    if not report["param_max_abs_err_card_vs_cpu_exact"] <= PARAM_ATOL:
        raise AssertionError(f"train step card vs CPU: params {report['param_max_abs_err_card_vs_cpu_exact']:.3e}")
    if not report["param_max_abs_err_card_vs_cpu"] <= 2 * lr0 + PARAM_ATOL:
        raise AssertionError(f"train step card vs CPU: params {report['param_max_abs_err_card_vs_cpu']:.3e}")
    if not report["bn_stats_max_abs_err_card_vs_cpu"] <= STEP_STATS_ATOL:
        raise AssertionError(f"train step card vs CPU: BN stats {report['bn_stats_max_abs_err_card_vs_cpu']:.3e}")
    return report


def train_updates(calls: int) -> int:
    """Updates the card runs over `calls` calls of one train-step slot: one
    a call, and the capturing call's warm-up steps (3 launches of each
    training kernel an update)."""
    from tinyrecurrentunet_torch.utils import graphs

    return calls + graphs.WARMUP


def train_launches(calls: int) -> int:
    return 3 * train_updates(calls)


def train_calls(batches, seg_len: int, calls: int) -> list:
    """The inputs of `calls` consecutive train-step calls over `batches`
    [(clean, noisy) (B, L)] taken in turn: (clean, noisy, starts_batch); a
    TBPTT batch gives one call a segment of seg_len samples, and its carry
    starts from zeros."""
    out, b = [], 0
    while len(out) < calls:
        clean, noisy = batches[b % len(batches)]
        if seg_len:
            for s in range(clean.shape[-1] // seg_len):
                sl = slice(s * seg_len, (s + 1) * seg_len)
                out.append((clean[:, sl], noisy[:, sl], s == 0))
        else:
            out.append((clean, noisy, True))
        b += 1
    return out[:calls]


def state_vectors(state) -> dict:
    """Gradients, parameters and buffers of the state's model, each one
    float64 vector on the host."""
    model = state.model
    return {"grads": torch.cat([p.grad.reshape(-1).double().cpu() for p in model.parameters()]),
            "params": torch.cat([p.detach().reshape(-1).double().cpu() for p in model.parameters()]),
            "stats": torch.cat([b.reshape(-1).double().cpu() for b in model.buffers()])}


def train_state_copy(state, carry) -> dict:
    """The train state as a step reads it, copied to the host: the model's
    parameters and buffers, the optimizer's state, the update count and the
    TBPTT carry the next call is given."""
    model, opt = state.model, state.optimizer
    return {"model": [t.detach().cpu().clone() for t in (*model.parameters(), *model.buffers())],
            "optimizer": [{k: v.cpu().clone() for k, v in opt.state[p].items()} if p in opt.state else None
                          for p in model.parameters()],
            "step": state.step, "carry": None if carry is None else carry.cpu().clone()}


@torch.no_grad()
def load_train_state(state, copy: dict):
    """`train_state_copy` written back into `state` in place (the step's
    slots keep their addresses)."""
    model, opt = state.model, state.optimizer
    for t, v in zip((*model.parameters(), *model.buffers()), copy["model"]):
        t.copy_(v)
    for p, saved in zip(model.parameters(), copy["optimizer"]):
        if (saved is None) != (p not in opt.state):
            raise AssertionError("the optimizer's state is not the copy's")
        for k, v in (saved or {}).items():
            opt.state[p][k].copy_(v)
    state.step = copy["step"]


def train_run(cfg, state, calls: list, seg_len: int, copies: list | None = None, profiled: bool = True) -> dict:
    """`calls` through one make_train_step on `state`: without `copies`
    replayed from the step's CUDA graph, the carry passed on from call to
    call, the state before each call copied to the host; with them as the
    uncaptured body, each call from the copy of the graph's state before
    it (`load_train_state`; the carry a foreign one), so that every call is
    one step from the state the graph's call started from. Each call's
    metrics, host-clock and CUDA-event ms of the step alone (synchronised),
    the state after the first call; then, where `profiled`, kernels, copies
    and device busy ms a call of 2 more calls of the last input under
    torch.profiler (`hop_profile`); peak memory; for the graph the pool's
    bytes and the reserve around the capture."""
    from tinyrecurrentunet_torch.train.step import make_train_step
    from tinyrecurrentunet_torch.utils import graphs

    replay = copies is None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, with_carry=seg_len > 0)
    carry, rows, first, made = None, [], None, []
    for i, (clean, noisy, starts) in enumerate(calls):
        if replay:
            if seg_len and starts:
                carry = step.buffers(state, tuple(clean.shape), clean.dtype).carry.zero_()
            made.append(train_state_copy(state, carry))
        else:
            load_train_state(state, copies[i])
            carry = None if copies[i]["carry"] is None else copies[i]["carry"].cuda()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = step(state, clean, noisy, *([carry] if seg_len else []), replay=replay)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        carry = out[2] if seg_len else None
        rows.append({"metrics": {k: float(v) for k, v in out[1].items()}, "host_ms": host_ms,
                     "event_ms": start.elapsed_time(end)})
        if i == 0:
            first = state_vectors(state)
    run = {"first_call_s": rows[0]["host_ms"] / 1e3,
           "median_ms_host_clock": float(np.median([r["host_ms"] for r in rows[1:]])),
           "median_ms_cuda_events": float(np.median([r["event_ms"] for r in rows[1:]])),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "captures": step.captures, "slots": len(step._slots)}
    if profiled:
        last = (calls[-1][0], calls[-1][1], *([carry] if seg_len else []))
        prof = hop_profile(lambda: step(state, *last, replay=replay), 2)
        run.update({"kernels_a_step": prof["kernels"], "copies_a_step": prof["copies"],
                    "device_busy_ms": prof["device_busy_ms"],
                    "device_idle_share": 1.0 - prof["device_busy_ms"] / run["median_ms_host_clock"]})
    if replay:
        memory = next(iter(step._slots.values())).memory
        pool = graphs.pool_bytes(step._pool)
        # the reserve had the warm-up's cached blocks not been freed before
        # the capture: what the general pool held then, plus the graph's pool
        run.update({"graph_pool_bytes": pool, "capture_memory": memory,
                    "reserved_without_empty_cache_gb": (memory["reserved_after_warmup"] + (pool or 0)) / 1e9})
    return {"summary": run, "calls": rows, "first": first, "copies": made}


def train_graph_vs_body(tag: str, cfg, make_state, batches, seg_len: int = 0,
                        calls: int = TRAIN_GRAPH_CALLS) -> dict:
    """The train step replayed from its CUDA graph over `calls` calls
    (`train_calls`) from `make_state()`, then the same body uncaptured,
    twice, each call from the state the graph's call started from
    (`train_run`): graph against body at every call, body against body for
    the body's own spread. Held: each loss term within TRAIN_GRAPH_LOSS_RTOL
    and grad_norm within TRAIN_GRAPH_NORM_RTOL (relative), or within twice
    the bodies' largest spread over the calls where that is larger; the
    parameters after the first step by phase 5's measure (as phase 9 (c)
    takes it at batch 64: the share of entries both runs move by lr sign(g)
    at least DP_SIGN_AGREEMENT of those whose gradient is clear of 0). Where
    the two bodies differ (cuDNN's float32 weight gradients are not
    bit-deterministic run to run), grad_norm is held within
    TRAIN_GRAPH_NORM_RTOL_NONDET instead, and graph and body run once more
    under torch.backends.cudnn.deterministic, unprofiled, where they are held
    to TRAIN_GRAPH_LOSS_RTOL and TRAIN_GRAPH_NORM_RTOL with no spread
    allowed, and the parameters as above. The default setting's runs are
    timed (`train_run`) beside the card's name and power limit. The runs go
    one after another, each from an emptied allocator cache: a graph's pool
    beside a body's working set would not fit at the flagship's float32
    batch."""
    from tinyrecurrentunet_torch.train.state import make_schedule

    inputs = train_calls(batches, seg_len, calls)
    lr0 = make_schedule(cfg)(0)

    def run_pair(names, profiled=True):
        for name in names:
            state = make_state()
            runs[name] = train_run(cfg, state, inputs, seg_len,
                                   None if name.startswith("graph") else runs[names[0]]["copies"], profiled)
            del state
            torch.cuda.empty_cache()

    def rel(a, b):
        return abs(a - b) / abs(b)

    def per_call(run, ref):
        return [{"loss": max(rel(c["metrics"][k], r["metrics"][k]) for k in r["metrics"] if k != "grad_norm"),
                 "grad_norm": rel(c["metrics"]["grad_norm"], r["metrics"]["grad_norm"])}
                for c, r in zip(run["calls"], ref["calls"])]

    def first_step(graph, body) -> dict:
        g, b = graph["first"], body["first"]
        clear = b["grads"].abs() >= ADAM_SIGN_TAU
        exact = (torch.minimum(g["grads"].abs(), b["grads"].abs()) >= ADAM_SIGN_TAU) & (
            g["grads"].sign() == b["grads"].sign())
        param_err = (g["params"] - b["params"]).abs()
        return {"param_exact_share": exact.double().mean().item(), "clear_share": clear.double().mean().item(),
                "param_max_abs_err_exact": param_err[exact].max().item() if exact.any() else 0.0,
                "param_max_abs_err": param_err.max().item(),
                "bn_stats_max_abs_err": (g["stats"] - b["stats"]).abs().max().item()}

    def hold(setting, got, bound, params, graph_run):
        for i, err in enumerate(got):
            for k in ("loss", "grad_norm"):
                if not err[k] <= bound[k]:
                    raise AssertionError(f"{tag} {setting} call {i}: {k} graph vs body {err[k]:.3e} > "
                                         f"{bound[k]:.3e} (report above)")
        exact_floor = min(PARAM_EXACT_SHARE, DP_SIGN_AGREEMENT * params["clear_share"])
        if not (params["param_exact_share"] >= exact_floor and params["param_max_abs_err_exact"] <= PARAM_ATOL
                and params["param_max_abs_err"] <= 2 * lr0 + PARAM_ATOL):
            raise AssertionError(f"{tag} {setting} graph vs body, parameters after the first step: {params}")
        summary = graph_run["summary"]
        if summary["captures"] != 1 or summary["slots"] != 1:
            raise AssertionError(f"{tag} {setting}: the graph run captured {summary['captures']} times "
                                 f"in {summary['slots']} slots")

    runs = {}
    run_pair(("graph", "body", "body_again"))
    got, spread = per_call(runs["graph"], runs["body"]), per_call(runs["body_again"], runs["body"])
    nondeterministic = (any(sp[k] > 0 for sp in spread for k in sp)
                        or not torch.equal(runs["body"]["first"]["grads"], runs["body_again"]["first"]["grads"]))
    norm_rtol = TRAIN_GRAPH_NORM_RTOL_NONDET if nondeterministic else TRAIN_GRAPH_NORM_RTOL
    bound = {k: max(rtol, 2 * max(sp[k] for sp in spread))
             for k, rtol in (("loss", TRAIN_GRAPH_LOSS_RTOL), ("grad_norm", norm_rtol))}
    report = {
        "calls": calls, "segment_samples": seg_len, "cudnn_nondeterministic": nondeterministic,
        "graph_vs_body": got, "body_vs_body": spread, "bound": bound, **first_step(runs["graph"], runs["body"]),
        "lr0": lr0, "graph": runs["graph"]["summary"], "body": runs["body"]["summary"],
        "body_again": runs["body_again"]["summary"], "device": nvidia_smi_line(),
    }
    if nondeterministic:
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            run_pair(("graph_deterministic", "body_deterministic"), profiled=False)
        finally:
            torch.backends.cudnn.deterministic = before
        graph, body = runs["graph_deterministic"], runs["body_deterministic"]
        report["cudnn_deterministic"] = {
            "graph_vs_body": per_call(graph, body),
            "bound": {"loss": TRAIN_GRAPH_LOSS_RTOL, "grad_norm": TRAIN_GRAPH_NORM_RTOL},
            "bit_equal_grads_first_step": torch.equal(graph["first"]["grads"], body["first"]["grads"]),
            **first_step(graph, body), "captures": graph["summary"]["captures"],
        }
    log(f"{tag} graph vs body: {json.dumps(report)}")
    hold("cuDNN default", got, bound, report, runs["graph"])
    if runs["body"]["summary"]["captures"] != 0:
        raise AssertionError(f"{tag}: the body run captured")
    if nondeterministic:
        det = report["cudnn_deterministic"]
        hold("cudnn.deterministic", det["graph_vs_body"], det["bound"], det, runs["graph_deterministic"])
    return report


def train_main_path(cfg, cuda_gru):
    """Phase 5: the port's train() for TRAIN_STEPS steps at the config's
    batch, launch counts around it; then the replayed step against the
    uncaptured body, both timed (`train_graph_vs_body`), and the card-vs-CPU
    step."""
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
    from tinyrecurrentunet_torch.train.loop import train
    from tinyrecurrentunet_torch.train.state import create_train_state

    opt = cfg.train.optimization
    if opt.batch_size_per_device != TRAIN_BATCH or cfg.trainset.crop_length_sec != 2:
        raise AssertionError("proc16k trains on batches of 64 clips of 2 s")
    dataset = SyntheticPairDataset(num_items=2 * TRAIN_BATCH, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    workdir = phase_workdir("chip_smoke_train")
    cwd = os.getcwd()
    os.chdir(workdir)
    # PyTorch's default for cuDNN: train() must turn TF32 off itself
    torch.backends.cudnn.allow_tf32 = True
    try:
        cuda_gru.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = train(cfg, dataset=dataset, max_iters=TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = cuda_gru.launch_counts()
        with open(os.path.join(workdir, "ckpt", cfg.train.exp_path, "logs", "metrics.jsonl")) as f:
            first = json.loads(f.readline())
    finally:
        os.chdir(cwd)
    log(f"[train] {TRAIN_STEPS} steps through train(): {train_s:.2f} s, launches {counts}, "
        f"step 0 loss {first['Train/Train-Loss']:.6f} grad_norm {first['Train/Gradient-Norm']:.4f}, "
        f"step {TRAIN_STEPS - 1} loss {metrics['loss']:.6f} grad_norm {metrics['grad_norm']:.4f}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train() on the card left TF32 on")
    # a slot's first call: 3 warm-up steps and the replay of its capture
    expected = {k: train_launches(TRAIN_STEPS) for k in counts}
    expected["gru_fwd"] = 0  # train mode never runs the inference kernel
    if counts != expected:
        raise AssertionError(f"launches in {TRAIN_STEPS} train steps: {counts}, expected {expected}")
    logged = [first["Train/Train-Loss"], first["Train/Gradient-Norm"], metrics["loss"], metrics["grad_norm"]]
    if not (np.isfinite(logged).all() and all(bool(torch.isfinite(p).all()) for p in state.model.parameters())):
        raise AssertionError(f"training produced non-finite values: {logged}")
    del state

    # the replayed step against the uncaptured body from the initial weights,
    # both timed
    report = train_graph_vs_body("[train]", cfg, lambda: create_train_state(cfg, device="cuda"),
                                 batches_of(dataset, TRAIN_BATCH, 2))
    graph = report["graph"]
    audio_s = TRAIN_BATCH * cfg.trainset.crop_length_sec
    summary = {
        "main_path": "train() proc16k float32", "batch": TRAIN_BATCH, "clip_s": cfg.trainset.crop_length_sec,
        "steps": TRAIN_STEPS, "train_s": train_s, "step_ms_cuda_events": graph["median_ms_cuda_events"],
        "step_ms_host_clock": graph["median_ms_host_clock"],
        "audio_s_per_s": audio_s / (graph["median_ms_host_clock"] / 1e3),
        "peak_mem_gb": graph["peak_mem_gb"], "launches": counts,
        "final_loss": metrics["loss"], "final_grad_norm": metrics["grad_norm"], "graph_vs_body": report,
    }
    log(json.dumps({k: v for k, v in summary.items() if k != "graph_vs_body"}))
    summary["card_vs_cpu"] = compare_train_step(cfg, dataset)
    return summary, counts


def percentiles_ms(seconds) -> dict:
    lat = np.asarray(seconds) * 1e3
    return {"median_ms": float(np.median(lat)), "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max())}


def hop_profile(step, calls: int) -> dict:
    """Kernels, memory copies and device busy time a call of step(), over
    `calls` calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    return {
        "kernels": sum(e.count for e in kernels) / calls,
        "copies": sum(e.count for e in copies) / calls,
        "device_busy_ms": sum(e.device_time_total for e in events) / calls / 1e3,
        "gru_fwd_device_ms": sum(e.device_time_total for e in kernels if "gru_fwd" in e.key) / calls / 1e3,
    }


def stream_latency(den, audio: np.ndarray, budget_s: float, replay: bool = True) -> tuple[dict, np.ndarray]:
    """Per-call latency on the host clock of `den.process_block` (the step
    replayed from its CUDA graph) or, with `replay` False, of the same body
    uncaptured (`den._process(..., replay=False)`) over the whole of
    `audio` from a fresh state, numpy block in, numpy block out
    (synchronised: the copy back waits for the device), then the device's
    share of it. Returns the row and the output."""
    hop = den.hop

    def call(state, block):
        return den.process_block(state, block) if replay else den._process(state, block, replay=False)

    blocks = [audio[i : i + hop] for i in range(0, len(audio) - hop + 1, hop)]
    state = den.init_state()
    for block in blocks[:5]:
        state = call(state, block)[1]
    state = den.init_state()
    lat, outs = [], []
    for block in blocks:
        t0 = time.perf_counter()
        out, state = call(state, block)
        outs.append(out.cpu().numpy())
        lat.append(time.perf_counter() - t0)
    box = {"state": den.init_state()}

    def step():
        box["state"] = call(box["state"], blocks[0])[1]

    prof = hop_profile(step, 20)
    row = {"step": "graph" if replay else "body", "chunk_frames": den.chunk_frames, "calls": len(lat),
           "budget_ms": budget_s * 1e3, **percentiles_ms(lat),
           "deadline_misses": int(np.sum(np.asarray(lat) > budget_s)),
           "rtf": float(np.sum(lat)) / (len(lat) * budget_s), **prof}
    row["kernels_a_hop"] = prof["kernels"] / den.chunk_frames
    row["device_idle_share"] = 1.0 - prof["device_busy_ms"] / row["median_ms"]
    return row, np.concatenate(outs)


def stream_steps(den, audio: np.ndarray, budget_s: float, tag: str) -> dict:
    """The replayed step and the uncaptured body of `den` over `audio` from
    the same start (`stream_latency`, each): both rows logged, the outputs
    held to GRAPH_ATOL of each other."""
    graph, out_graph = stream_latency(den, audio, budget_s)
    body, out_body = stream_latency(den, audio, budget_s, replay=False)
    err = float(np.abs(out_graph - out_body).max())
    smi = nvidia_smi_line()
    for row in (graph, body):
        log(f"{tag} {json.dumps({**row, 'device': smi})}")
    log(f"{tag} chunk {den.chunk_frames}: graph vs body over {len(out_graph)} samples, max abs err {err:.3e} "
        f"(tolerance {GRAPH_ATOL:.0e}); captures {den._captures}")
    if err > GRAPH_ATOL or not np.isfinite(out_graph).all():
        raise AssertionError(f"streaming graph vs body {err:.3e} > {GRAPH_ATOL:.0e}")
    if den._captures != 1:
        raise AssertionError(f"the denoiser captured its graph {den._captures} times")
    return {"graph": graph, "body": body, "graph_vs_body_max_abs_err": err}


def offline_calls(den, clip: np.ndarray, replay: bool, calls: int) -> tuple[dict, np.ndarray]:
    """Per-call latency on the host clock of `den(clip)` (replayed from its
    bucket's CUDA graph) or, with `replay` False, of the same body
    uncaptured (`den._denoise(..., replay=False)`), numpy in and out (the
    copy out waits for the device), `calls` calls after 3 warm ones; then
    kernels, copies and device busy a call under torch.profiler
    (`hop_profile`, 10 calls) and the device's idle share of the median
    call. Returns the row and the last output."""

    def call():
        return den._denoise(clip, replay=replay)

    for _ in range(3):
        call()
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = call()
        lat.append(time.perf_counter() - t0)
    prof = hop_profile(call, 10)
    row = {"step": "graph" if replay else "body", "calls": calls, **percentiles_ms(lat), **prof}
    row["device_idle_share"] = 1.0 - prof["device_busy_ms"] / row["median_ms"]
    return row, out


def graph_pool_bytes(den) -> dict:
    """Bytes the card reserves in the segments of `den`'s shared graph pool
    (`utils.graphs.pool_bytes`) and in all (torch.cuda.memory_reserved)."""
    from tinyrecurrentunet_torch.utils import graphs

    return {"pool_reserved_bytes": graphs.pool_bytes(den._pool), "card_reserved_bytes": torch.cuda.memory_reserved()}


def serve_offline(name: str, cfg, artifact: str, den, clip: np.ndarray, path: str, calls: int, cuda_gru,
                  tag: str) -> dict:
    """The offline Denoiser `den` on `clip`, the launch counts set to 0 just
    before each call and read just after: the bucket's first call (the body
    warmed up graphs.WARMUP times and captured, 3 gru_fwd a run, on `path`; its
    seconds) and a replayed call (3 gru_fwd on `path`, nothing else). The
    replayed output and the uncaptured body's each held against the same
    Denoiser in float64 on the CPU (DENOISE_ATOL) and against each other
    (GRAPH_ATOL), the same for the clip led by digital silence; `calls`
    calls of each timed (`offline_calls`) beside the card's name and power
    limit."""
    from tinyrecurrentunet_torch.utils import graphs

    runs = graphs.WARMUP + 1
    torch.cuda.synchronize()
    cuda_gru.reset_launch_counts()
    t0 = time.perf_counter()
    den(clip)
    capture_s = time.perf_counter() - t0
    capture_paths = cuda_gru.launch_paths()
    cuda_gru.reset_launch_counts()
    out = den(clip)
    counts, paths = cuda_gru.launch_counts(), cuda_gru.launch_paths()
    log(f"{tag} {name} offline: the bucket's first call (warm-up and capture) {capture_s:.3f} s, launches by path "
        f"{capture_paths}; a replayed call {counts}, by path {paths}")
    if capture_paths != {"gru_fwd": {path: 3 * runs}} or den._captures != 1:
        raise AssertionError(f"{name}: the capturing call launched {capture_paths}, captures {den._captures}; "
                             f"expected {3 * runs} gru_fwd on {path}")
    if counts != {**{k: 0 for k in counts}, "gru_fwd": 3} or paths != {"gru_fwd": {path: 3}}:
        raise AssertionError(f"{name}: a replayed call launched {counts} by path {paths}; expected 3 gru_fwd on {path}")
    if out.shape != clip.shape or not np.isfinite(out).all():
        raise AssertionError(f"{name} denoised output bad: shape {out.shape}, finite {np.isfinite(out).all()}")
    errors = denoise_errors(cfg, artifact, clip, out, den._denoise(clip, replay=False))
    silent = silence_led(clip, cfg.featurizer.sample_rate)
    silent_errors = denoise_errors(cfg, artifact, silent, den(silent), den._denoise(silent, replay=False))
    log(f"{tag} {name} max abs err, 4 s clip: {json.dumps(errors)}; led by {SILENCE_SECONDS} s of zeros: "
        f"{json.dumps(silent_errors)} (graph and body vs CPU float64 held to {DENOISE_ATOL:.0e}, graph vs body "
        f"to {GRAPH_ATOL:.0e})")
    for what, errs in (("clip", errors), ("silence-led clip", silent_errors)):
        if max(errs["card_vs_cpu_f64"], errs["body_vs_cpu_f64"]) > DENOISE_ATOL or errs["graph_vs_body"] > GRAPH_ATOL:
            raise AssertionError(f"{name} denoise, {what}: {errs}")
    smi = nvidia_smi_line()
    latency = []
    for replay in (True, False):
        row, last = offline_calls(den, clip, replay, calls)
        if float(np.abs(last - out).max()) > GRAPH_ATOL:
            raise AssertionError(f"{name}: a timed {row['step']} call moved {float(np.abs(last - out).max()):.3e}")
        log(f"{tag} {name} latency {json.dumps({**row, 'device': smi})}")
        latency.append(row)
    if den._captures != 1:
        raise AssertionError(f"{name}: the denoiser captured {den._captures} graphs for one bucket")
    return {"capture_s": capture_s, "capture_launches": capture_paths, "launches": counts, "paths": paths,
            "max_abs_err": errors, "silence_led_max_abs_err": silent_errors, "latency": latency, "device": smi}


def relative_rms(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def stream_clip(cfg, sd, clip: np.ndarray, cuda_gru, align=(ALIGN_RMS, ALIGN_MARGIN), tag="[stream]"):
    """`clip` streamed on the card at one hop a call with weights `sd`, the
    launch counts set to 0 just before and read just after (3 gru_fwd a hop,
    no other kernel); held against the same streaming on the CPU
    (STREAM_ATOL) and, at the 3-hop shift from ALIGN_FROM, against the
    card's offline Denoiser.run: relative RMS within align[0], every other
    shift of 0-6 hops at least align[1] times as far. Returns the card's
    StreamingDenoiser and a report."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    hop = cfg.featurizer.hop_length
    hops = len(clip) // hop
    den = StreamingDenoiser(cfg, sd, device="cuda")
    den.process(clip[: 8 * hop])  # warm: cuDNN's first calls, the kernels' first launch
    torch.cuda.synchronize()
    cuda_gru.reset_launch_counts()
    t0 = time.perf_counter()
    out, state = den.process(clip)
    wall = time.perf_counter() - t0
    counts, paths = cuda_gru.launch_counts(), cuda_gru.launch_paths()
    log(f"{tag} launches streaming {hops} hops: {counts}, by path {paths}")
    if counts != {**{k: 0 for k in counts}, "gru_fwd": 3 * hops}:
        raise AssertionError(f"expected {3 * hops} gru_fwd launches (3 a hop) and no other, got {counts}")
    if out.shape != clip.shape or not np.isfinite(out).all() or int(state.feat_state.frame_count) != hops:
        raise AssertionError(f"streamed output bad: shape {out.shape}, finite {np.isfinite(out).all()}")
    ref, _ = StreamingDenoiser(cfg, sd, device="cpu").process(clip)
    err = float(np.abs(out - ref).max())
    log(f"{tag} max abs err card vs CPU {err:.3e} (tolerance {STREAM_ATOL:.0e}), peak {float(np.abs(ref).max()):.3f}")
    if err > STREAM_ATOL:
        raise AssertionError(f"streaming card vs CPU {err:.3e} > {STREAM_ATOL:.0e}")

    offline = Denoiser(cfg, sd, device="cuda").run(torch.from_numpy(clip).cuda()).cpu().numpy()

    def by_shift(k0: int, k1: int = hops - 6) -> dict:
        want = offline[(k0 - 3) * hop : (k1 - 3) * hop]
        shifts = {s: relative_rms(out[(k0 - 3 + s) * hop : (k1 - 3 + s) * hop], want) for s in range(7)}
        log(f"{tag} relative RMS error against offline, blocks {k0}-{k1}, by shift: {shifts}")
        return shifts

    by_shift(60)
    shifts = by_shift(ALIGN_FROM)
    others = min(v for s, v in shifts.items() if s != 3)
    if shifts[3] > align[0] or others < align[1] * shifts[3]:
        raise AssertionError(f"streaming output not at the 3-hop shift of offline: {shifts}, bounds {align}")
    return den, {"hops": hops, "stream_s": wall, "max_abs_err_vs_cpu": err, "align_rms_by_shift": shifts,
                 "counts": counts, "paths": paths}


def multistream_rows(cfg, sd, stream_counts, cuda_gru, tag="[multistream]") -> list:
    """Per-call latency of `MultiStreamDenoiser` at each of `stream_counts`
    streams (35 timed calls of seeded noise after 5 warm ones), gru_fwd
    launches a call and the streams one card keeps in real time: the step
    replayed from its CUDA graph, then the same body uncaptured."""
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser

    hop = cfg.featurizer.hop_length
    budget_s = hop / cfg.featurizer.sample_rate
    rng = np.random.default_rng(6)
    smi = nvidia_smi_line()
    rows = []
    for n in stream_counts:
        ms = MultiStreamDenoiser(cfg, sd, n, device="cuda")
        blocks = (0.1 * rng.standard_normal((40, n, hop))).astype(np.float32)
        for replay in (True, False):
            state = ms.init_state()
            for b in blocks[:5]:
                state = ms._process(state, b, replay=replay)[1]
            lat = []
            cuda_gru.reset_launch_counts()
            for b in blocks[5:]:
                t0 = time.perf_counter()
                o, state = ms.process_block(state, b) if replay else ms._process(state, b, replay=False)
                o.cpu().numpy()
                lat.append(time.perf_counter() - t0)
            launches = cuda_gru.launch_counts()["gru_fwd"] / len(lat)
            row = {"step": "graph" if replay else "body", "streams": n, "calls": len(lat),
                   "budget_ms": budget_s * 1e3, **percentiles_ms(lat),
                   "deadline_misses": int(np.sum(np.asarray(lat) > budget_s)), "gru_fwd_a_call": launches}
            row["realtime_streams"] = n * budget_s / (row["median_ms"] / 1e3)
            log(f"{tag} {json.dumps({**row, 'device': smi})}")
            rows.append(row)
    return rows


def streaming_main_path(cfg, clip: np.ndarray, cuda_gru) -> dict:
    """Phase 6: the port's streaming path on the card with the flagship's
    weights. The 4 s clip streamed at one hop a call (`stream_clip`). At 1
    and 4 hops a call the replayed step against the uncaptured body
    (`stream_steps`). Then logged: per-hop latency of both, the multi-stream call
    at STREAM_COUNTS streams (and 3 of 64 streams held against their single
    runs), a SOAK_SECONDS soak through the native host and one stream_file
    run."""
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.infer.soak import run_soak
    from tinyrecurrentunet_torch.infer.stream import stream_file
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser
    from tinyrecurrentunet_torch.runtime import native
    from tinyrecurrentunet_torch.weights import load_pretrained

    sd = load_pretrained(ARTIFACT, cfg)
    hop, sample_rate = cfg.featurizer.hop_length, cfg.featurizer.sample_rate
    budget_s = hop / sample_rate
    den, report = stream_clip(cfg, sd, clip, cuda_gru)
    silent = silence_led(clip, sample_rate)
    silent_out = den.process(silent)[0]
    silent_cpu = StreamingDenoiser(cfg, sd, device="cpu").process(silent)[0]
    silent_f64 = stream_cpu_f64(cfg, sd, silent)
    silent_errs = {"card_vs_cpu": float(np.abs(silent_out - silent_cpu).max()),
                   "card_vs_cpu_f64": float(np.abs(silent_out - silent_f64).max()),
                   "cpu_vs_cpu_f64": float(np.abs(silent_cpu - silent_f64).max())}
    log(f"[stream] silence-led clip ({SILENCE_SECONDS} s of zeros): max abs err {json.dumps(silent_errs)} "
        f"(card vs CPU held to {STREAM_ATOL:.0e})")
    if not np.isfinite(silent_out).all() or silent_errs["card_vs_cpu"] > STREAM_ATOL:
        raise AssertionError(f"silence-led streaming card vs CPU {silent_errs['card_vs_cpu']:.3e} > {STREAM_ATOL:.0e}")
    report["silence_led_max_abs_err"] = silent_errs

    latency = [stream_steps(den, clip, budget_s, "[stream-latency]")]
    latency.append(stream_steps(StreamingDenoiser(cfg, sd, chunk_frames=4, device="cuda"), clip, 4 * budget_s,
                                "[stream-latency]"))

    multi = multistream_rows(cfg, sd, STREAM_COUNTS, cuda_gru)
    ms64 = MultiStreamDenoiser(cfg, sd, 64, device="cuda")
    sec = sample_rate  # 1 s of 64 different streams
    streams = np.stack([np.roll(clip, 977 * i)[:sec] * (0.5 + i / 128) for i in range(64)]).astype(np.float32)
    batched, _ = ms64.process(streams)
    multi_err = max(float(np.abs(batched[i] - den.process(streams[i])[0]).max()) for i in (0, 31, 63))
    log(f"[multistream] streams 0, 31, 63 of 64 against their single runs: max abs err {multi_err:.3e} "
        f"(tolerance {STREAM_ATOL:.0e})")
    if multi_err > STREAM_ATOL:
        raise AssertionError(f"multi-stream vs single streams {multi_err:.3e} > {STREAM_ATOL:.0e}")

    soak = run_soak(cfg, sd, duration_s=SOAK_SECONDS, device="cuda")
    log(f"[soak] {json.dumps(soak)} native library {native.library_path().relative_to(REPO)}, "
        f"through the replayed step, {nvidia_smi_line()}")
    work = os.path.join(REPO, "build", "chip_smoke_stream")
    os.makedirs(work, exist_ok=True)
    from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav

    wav_in, wav_out = os.path.join(work, "noisy.wav"), os.path.join(work, "enhanced.wav")
    write_wav(wav_in, clip[:sec], sample_rate)
    file_stats = stream_file(cfg, sd, wav_in, wav_out, device="cuda")
    enhanced, _ = read_wav(wav_out)
    log(f"[stream_file] {json.dumps(file_stats)}")
    if file_stats["blocks_processed"] != sec // hop or enhanced.shape != (sec,) or not np.isfinite(enhanced).all():
        raise AssertionError(f"stream_file: {file_stats}, output {enhanced.shape}")
    return {**report, "latency": latency, "multistream": multi, "multistream_max_abs_err": multi_err,
            "soak": soak, "stream_file": file_stats}


def kind_of(name: str) -> str:
    for kind, pattern in KERNEL_KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def clipped_grads(state) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1).double().cpu() for p in state.model.parameters()])


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def one_step(cfg, device, clean, noisy):
    """One train step from the config's initial weights: (clipped gradients,
    metrics as floats)."""
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    state = create_train_state(cfg, device=device)
    state, metrics = make_train_step(cfg)(state, clean.to(device), noisy.to(device))
    return clipped_grads(state), {k: float(v) for k, v in metrics.items()}


def compare_steps(name, got, want, grad_bound, tag="[train-bf16]") -> dict:
    """Phase 7's measure of two train steps (clipped gradients, metrics):
    gradients within `grad_bound` (relative L2), each loss term within
    BF16_LOSS_RTOL, grad_norm within BF16_NORM_RTOL."""
    (g, m), (g_ref, m_ref) = got, want
    row = {"grad_rel_l2": rel_l2(g, g_ref),
           "loss_rel_err": {k: abs(m[k] - m_ref[k]) / abs(m_ref[k]) for k in m_ref if k != "grad_norm"},
           "grad_norm": m["grad_norm"], "grad_norm_ref": m_ref["grad_norm"],
           "grad_norm_rel_err": abs(m["grad_norm"] - m_ref["grad_norm"]) / m_ref["grad_norm"]}
    log(f"{tag} {name}: {json.dumps(row)}")
    if not all(np.isfinite(v) for v in m.values()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite loss terms or gradients: {m}")
    if not row["grad_rel_l2"] <= grad_bound:
        raise AssertionError(f"{name}: clipped gradients {row['grad_rel_l2']:.3e} apart > {grad_bound}")
    for term, err in row["loss_rel_err"].items():
        if not err <= BF16_LOSS_RTOL:
            raise AssertionError(f"{name}: loss term {term} rel err {err:.3e} > {BF16_LOSS_RTOL:.0e}")
    if not row["grad_norm_rel_err"] <= BF16_NORM_RTOL:
        raise AssertionError(f"{name}: grad_norm rel err {row['grad_norm_rel_err']:.3e} > {BF16_NORM_RTOL}")
    return row


def edge_casts_ms(shapes) -> dict:
    """Device ms of the casts at the three GRU call sites of a bf16 step, at
    the step's shapes, each timed alone by CUDA events around 20 casts in a
    row (each moves 100-600 MB, far above a launch): forward, x_proj bf16
    -> float32 and the outputs float32 -> bf16; backward, the outputs'
    gradient bf16 -> float32 and d_xproj float32 -> bf16 (the small h0, h_T,
    Wh and bh casts are left out: (rows, H) and (H, 3H) against (rows, T,
    3H))."""
    rows = {}
    for name, r, t, h in shapes:
        wide_bf, wide_f = torch.zeros((r, t, 3 * h), dtype=torch.bfloat16, device="cuda"), torch.zeros(
            (r, t, 3 * h), device="cuda")
        out_bf, out_f = torch.zeros((r, t, h), dtype=torch.bfloat16, device="cuda"), torch.zeros(
            (r, t, h), device="cuda")
        rows[name] = {
            "forward_ms": cuda_ms(lambda: wide_bf.float(), 20) + cuda_ms(lambda: out_f.to(torch.bfloat16), 20),
            "backward_ms": cuda_ms(lambda: out_bf.float(), 20) + cuda_ms(lambda: wide_f.to(torch.bfloat16), 20),
        }
    rows["total_ms"] = sum(v["forward_ms"] + v["backward_ms"] for v in rows.values())
    return rows


def profile_step(step, state, clean, noisy, steps: int = 2) -> dict:
    """Kernels a step, device ms by kind, the device ms under every cast
    (aten::_to_copy) and the names of every kernel of a recurrent kind, from
    torch.profiler over `steps` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, clean, noisy)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_kind, kernels, rnn_names, casts_ms = {}, 0, {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            ms = evt.self_device_time_total / 1e3 / steps
            by_kind[kind_of(evt.key)] = by_kind.get(kind_of(evt.key), 0.0) + ms
            kernels += evt.count
            if re.search(LIBRARY_RNN, evt.key):
                rnn_names[evt.key] = evt.count / steps
        elif evt.key == "aten::_to_copy":
            casts_ms += evt.device_time_total / 1e3 / steps
    device = sum(by_kind.values())
    return {"wall_ms_profiled": wall_ms, "device_ms": device, "device_idle_share": 1.0 - device / wall_ms,
            "kernels_a_step": kernels / steps,
            "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "all_casts_device_ms": casts_ms, "recurrent_kernels_a_step": rnn_names}


def profile_port_step(step, state, clean, noisy, segments: int, tag: str) -> dict:
    """`profile_step`, where every recurrent kernel must be one of the
    port's: 3 gru_fwd_train, 3 gru_bwd, 3 gru_dw_partial and 3 gru_dw_sum
    for each of the step's `segments` updates, and no other. A reading that
    lost kernel records (see device_ms) is taken again."""
    want = 12 * segments
    for _ in range(3):
        prof = profile_step(step, state, clean, noisy)
        recurrent = prof["recurrent_kernels_a_step"]
        foreign = {k: v for k, v in recurrent.items() if not re.search(r"\bgru_\w+_kernel\b", k)}
        if foreign or sum(recurrent.values()) == want:
            break
        log(f"{tag} profiled step: {recurrent}, taken again")
    if foreign or sum(recurrent.values()) != want:
        raise AssertionError(f"recurrent kernels of a step: {prof['recurrent_kernels_a_step']}; expected the port's "
                             f"{want} (a quarter each gru_fwd_train, gru_bwd, gru_dw_partial, gru_dw_sum), no other")
    log(f"{tag} profiled step: {json.dumps(prof)}")
    return prof


def bf16_training_path(cfg, f32_cfg, cuda_gru) -> dict:
    """Phase 7: the port's train() on config/proc16k.json as shipped
    (train_compute_dtype bfloat16) for TRAIN_STEPS steps at the config's
    batch, on phase 5's dataset and initial weights, launch counts around
    it; then a profiled replayed step, the casts at the GRU call sites, the
    replayed step against the uncaptured body, both timed
    (`train_graph_vs_body`), and the clipped gradients of one step against
    the float32 step on the card (batch 64) and against the CPU's bf16 step
    (batch 4)."""
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
    from tinyrecurrentunet_torch.train.loop import train
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    if cfg.train.optimization.train_compute_dtype != "bfloat16":
        raise AssertionError("config/proc16k.json ships train_compute_dtype bfloat16")
    dataset = SyntheticPairDataset(num_items=2 * TRAIN_BATCH, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    workdir = phase_workdir("chip_smoke_train_bf16")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        cuda_gru.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = train(cfg, dataset=dataset, max_iters=TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = cuda_gru.launch_counts()
    finally:
        os.chdir(cwd)
    log(f"[train-bf16] {TRAIN_STEPS} steps through train(): {train_s:.2f} s, launches {counts}, "
        f"last loss {metrics['loss']:.6f} grad_norm {metrics['grad_norm']:.4f}")
    expected = {k: train_launches(TRAIN_STEPS) for k in counts}
    expected["gru_fwd"] = 0
    if counts != expected:
        raise AssertionError(f"launches in {TRAIN_STEPS} bf16 train steps: {counts}, expected {expected}")
    if state.model.compute_dtype != torch.bfloat16 or any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("the bf16 training model must compute in bf16 on float32 parameters")
    if not (np.isfinite(list(metrics.values())).all() and all(bool(torch.isfinite(p).all())
                                                               for p in state.model.parameters())):
        raise AssertionError(f"bf16 training produced non-finite values: {metrics}")

    # the replayed step of the trained state under torch.profiler: every
    # recurrent kernel of a replay the port's
    step = make_train_step(cfg)
    clean, noisy = batch_of(dataset, TRAIN_BATCH, "cuda")
    step(state, clean, noisy)
    train_frames = crop_frames(cfg)
    fb = state.model.bottleneck_freqs(cfg.featurizer.num_freqs)
    net = cfg.network
    casts = edge_casts_ms([("fgru_fwd", TRAIN_BATCH * train_frames, fb, net.fgru_hidden),
                           ("fgru_bwd", TRAIN_BATCH * train_frames, fb, net.fgru_hidden),
                           ("tgru", TRAIN_BATCH * fb, train_frames, net.tgru_hidden)])
    log(f"[train-bf16] casts at the GRU call sites: {json.dumps(casts)}")
    prof = profile_port_step(step, state, clean, noisy, 1, "[train-bf16]")
    del step, state
    torch.cuda.empty_cache()
    report = train_graph_vs_body("[train-bf16]", cfg, lambda: create_train_state(cfg, device="cuda"),
                                 batches_of(dataset, TRAIN_BATCH, 2))
    graph = report["graph"]
    audio_s = TRAIN_BATCH * cfg.trainset.crop_length_sec
    summary = {
        "main_path": "train() proc16k bfloat16 as shipped", "batch": TRAIN_BATCH,
        "clip_s": cfg.trainset.crop_length_sec, "steps": TRAIN_STEPS, "train_s": train_s,
        "step_ms_cuda_events": graph["median_ms_cuda_events"], "step_ms_host_clock": graph["median_ms_host_clock"],
        "audio_s_per_s": audio_s / (graph["median_ms_host_clock"] / 1e3), "peak_mem_gb": graph["peak_mem_gb"],
        "launches": counts, "profile": prof, "gru_edge_casts": casts, "final_loss": metrics["loss"],
        "graph_vs_body": report,
    }
    log(json.dumps({k: v for k, v in summary.items() if k != "graph_vs_body"}))
    torch.cuda.empty_cache()

    # the clipped gradient of one step from the initial weights: bf16 against
    # float32 on the card at the config's batch, and the card's bf16 against
    # the CPU's at batch 4
    clean, noisy = (t.cpu() for t in batch_of(dataset, TRAIN_BATCH, "cpu"))
    summary["bf16_vs_f32_on_card"] = compare_steps(
        f"bf16 vs float32 on the card, batch {TRAIN_BATCH}", one_step(cfg, "cuda", clean, noisy),
        one_step(f32_cfg, "cuda", clean, noisy), BF16_GRAD_VS_F32)
    summary["bf16_vs_f32_on_card_batch4"] = compare_steps(
        "bf16 vs float32 on the card, batch 4", one_step(cfg, "cuda", clean[:4], noisy[:4]),
        one_step(f32_cfg, "cuda", clean[:4], noisy[:4]), BF16_GRAD_VS_F32)
    summary["card_vs_cpu_bf16"] = compare_steps(
        "bf16 card vs bf16 CPU, batch 4", one_step(cfg, "cuda", clean[:4], noisy[:4]),
        one_step(cfg, "cpu", clean[:4], noisy[:4]), BF16_GRAD_CARD_VS_CPU)
    torch.cuda.empty_cache()
    return summary, counts


def quality_path(cfg) -> dict:
    """Phase 8: the flagship's quality eval on the card, float32, bf16
    (network.compute_dtype) and the int8 pack, on the 16-file procedural
    testset; the metrics are computed on the host."""
    from tinyrecurrentunet_torch.infer.quality import denoiser_from_int8, denoiser_from_pretrained, run_quality_eval

    work = os.path.join(REPO, "build", "chip_smoke_quality")
    shutil.rmtree(work, ignore_errors=True)
    bf16 = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, compute_dtype="bfloat16"))
    runs = {
        "float32": lambda: denoiser_from_pretrained(cfg, ARTIFACT, device="cuda"),
        "bfloat16": lambda: denoiser_from_pretrained(bf16, ARTIFACT, device="cuda"),
        "int8": lambda: denoiser_from_int8(cfg, os.path.join(ARTIFACT, "model_int8.trq"), device="cuda"),
    }
    # the 4 s clip's call latency, float32 and bf16 in turns
    clip = make_clip(cfg.featurizer.sample_rate)
    denoisers = {name: runs[name]() for name in ("float32", "bfloat16")}
    latency = {name: [] for name in denoisers}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        den = denoisers[name]
        for _ in range(3):
            den(clip)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_CALLS):
            den(clip)
        torch.cuda.synchronize()
        latency[name].append((time.perf_counter() - t0) / SERVING_CALLS * 1e3)
    latency = {name: {"call_ms_host_clock": ms, "rtf": [m / 1e3 / CLIP_SECONDS for m in ms]}
               for name, ms in latency.items()}
    log(f"[serving] 4 s clip, call latency by serving dtype, in turns: {json.dumps(latency)}")
    # bf16 through its graph: held to its uncaptured body (GRAPH_ATOL) and,
    # as bf16 rounds at 2^-8, to float32 by SNR (BF16_SERVING_SNR_DB), as
    # the card tests hold it; both ways timed
    bf16_den, smi = denoisers["bfloat16"], nvidia_smi_line()
    bf16_rows = []
    for replay in (True, False):
        row, out = offline_calls(bf16_den, clip, replay, SERVING_CALLS)
        bf16_rows.append(row)
        log(f"[serving] bf16 latency {json.dumps({**row, 'device': smi})}")
    graph_out = bf16_den(clip)
    f32_out = denoisers["float32"](clip)
    bf16_check = {"graph_vs_body_max_abs_err": float(np.abs(graph_out - out).max()),
                  "snr_vs_float32_db": float(10 * np.log10(np.sum(f32_out.astype(np.float64) ** 2)
                                                           / np.sum((f32_out - graph_out).astype(np.float64) ** 2))),
                  "captures": bf16_den._captures}
    log(f"[serving] bf16 graph: {json.dumps(bf16_check)} (graph vs body held to {GRAPH_ATOL:.0e}, SNR to "
        f"{BF16_SERVING_SNR_DB} dB)")
    if (bf16_check["graph_vs_body_max_abs_err"] > GRAPH_ATOL or bf16_check["snr_vs_float32_db"] < BF16_SERVING_SNR_DB
            or bf16_den._captures != 1):
        raise AssertionError(f"bf16 serving through its graph: {bf16_check}")
    latency["bfloat16"].update(graph=bf16_rows[0], body=bf16_rows[1], **bf16_check)

    results = {}
    for name, make in runs.items():
        t0 = time.perf_counter()
        result = run_quality_eval(cfg if name != "bfloat16" else bf16, denoisers.get(name) or make(),
                                  testset_dir=os.path.join(work, "testset"), num_files=QUALITY_FILES,
                                  seed=QUALITY_SEED, enhanced_dir=os.path.join(work, name))
        results[name] = {"enhanced": result["enhanced"], "noisy": result["noisy_baseline"],
                         "improvement": result["improvement"], "per_noise_kind": result["per_noise_kind"],
                         "oracle": result["oracle"], "s": time.perf_counter() - t0}
        log(f"[quality] {name}: {json.dumps(results[name])}")
    f32 = results["float32"]["enhanced"]["si_sdr"]
    report = {"si_sdr_float32": f32, "si_sdr_bf16": results["bfloat16"]["enhanced"]["si_sdr"],
              "si_sdr_int8": results["int8"]["enhanced"]["si_sdr"]}
    report["bf16_delta_db"] = report["si_sdr_bf16"] - f32
    report["int8_delta_db"] = report["si_sdr_int8"] - f32
    log(f"[quality] {json.dumps(report)}")
    if not abs(f32 - QUALITY_F32_SI_SDR) <= QUALITY_SI_SDR_ATOL:
        raise AssertionError(f"float32 SI-SDR {f32:.4f} dB, not within {QUALITY_SI_SDR_ATOL} of {QUALITY_F32_SI_SDR}")
    if not abs(report["bf16_delta_db"]) <= QUALITY_SI_SDR_ATOL:
        raise AssertionError(f"bf16 - float32 SI-SDR {report['bf16_delta_db']:.4f} dB")
    if not abs(report["int8_delta_db"] + QUALITY_INT8_GAP) <= QUALITY_SI_SDR_ATOL:
        raise AssertionError(f"int8 - float32 SI-SDR {report['int8_delta_db']:.4f} dB, gap {QUALITY_INT8_GAP}")
    return {**report, "serving_latency": latency, "runs": results}


def procedural_training(cfg, clip: np.ndarray, cuda_gru) -> tuple[dict, dict]:
    """Phase 9 (a) and (d): train() on config/proc16k.json as shipped (bf16)
    on a PROC_ITEMS-item procedural corpus and its 32-item validation set,
    PROC_STEPS steps at batch 64, launch counts around it; its checkpoint
    resumed into a fresh state, whose replayed step is held to the
    continued one's (`resumed_step`); the device corpus against
    dataset.get; the replayed step against the uncaptured body on the
    corpus's batches (`train_graph_vs_body`); then export_pretrained on its
    checkpoint, served by a card Denoiser beside one built from the trained
    model."""
    from tinyrecurrentunet_torch.data import ProceduralSpeechDataset
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.train import export_pretrained
    from tinyrecurrentunet_torch.train.loop import train, upload_corpus
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.weights import load_pretrained

    length = cfg.trainset.crop_length_sec
    t0 = time.perf_counter()
    dataset = ProceduralSpeechDataset(num_items=PROC_ITEMS, length_sec=length, sample_rate=cfg.trainset.sample_rate)
    valid = ProceduralSpeechDataset(num_items=32, length_sec=length, sample_rate=cfg.trainset.sample_rate,
                                    seed=6_000_000)
    workdir = phase_workdir("chip_smoke_proc")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        cuda_gru.reset_launch_counts()
        t1 = time.perf_counter()
        state, metrics = train(cfg, dataset=dataset, max_iters=PROC_STEPS, valid_dataset=valid, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        counts = cuda_gru.launch_counts()
        export_dir = os.path.join(workdir, "export")
        export_pretrained.main(["-c", CONFIG, "--out", export_dir, "--device", "cuda"])
        # iteration 0 is the logged one (iters_per_valid 500), with the validation loss
        with open(os.path.join(workdir, "ckpt", cfg.train.exp_path, "logs", "metrics.jsonl")) as f:
            first = json.loads(f.readline())
        resumed = resumed_step(cfg, state, batch_of(dataset, cfg.train.optimization.batch_size_per_device, "cuda"))
    finally:
        os.chdir(cwd)
    log(f"[proc-train] {PROC_STEPS} steps of train() on {PROC_ITEMS} procedural items, bf16, batch "
        f"{cfg.train.optimization.batch_size_per_device}: {train_s:.2f} s (synthesis included), launches {counts}, "
        f"{json.dumps(metrics)}")
    # 3 launches of each training kernel a step; the validation pass at
    # iteration 0 (iters_per_valid divides 0) runs in eval mode under no_grad,
    # the eval slot's first call: 3 gru_fwd in each of its 3 warm-ups and 3
    # in its replayed graph
    expected = {k: train_launches(PROC_STEPS) for k in counts}
    expected["gru_fwd"] = 3 * (3 + 1)
    if counts != expected:
        raise AssertionError(f"launches in {PROC_STEPS} procedural train steps: {counts}, expected {expected}")
    logged = [first["Train/Train-Loss"], first["Valid/Valid-Loss"], *metrics.values()]
    log(f"[proc-train] iteration 0: loss {first['Train/Train-Loss']:.6f}, validation loss "
        f"{first['Valid/Valid-Loss']:.6f} on 32 procedural items")
    if not (np.isfinite(logged).all() and all(bool(torch.isfinite(p).all()) for p in state.model.parameters())):
        raise AssertionError(f"procedural training produced non-finite values: {first} {metrics}")
    corpus = upload_corpus(dataset, cfg.train.optimization.seed, "cuda")
    for i in (0, 1, PROC_ITEMS // 2, PROC_ITEMS - 1):
        for k in (0, 1):
            if not np.array_equal(corpus[k][i].cpu().numpy(), dataset.get(i)[k]):
                raise AssertionError(f"device corpus item {i} differs from dataset.get")
    batch = cfg.train.optimization.batch_size_per_device
    corpus_batches = [(corpus[0][i * batch:(i + 1) * batch], corpus[1][i * batch:(i + 1) * batch]) for i in range(2)]
    graph_vs_body = train_graph_vs_body("[proc-train]", cfg, lambda: create_train_state(cfg, device="cuda"),
                                        corpus_batches)
    del corpus, corpus_batches
    validation = eval_graph_vs_body(cfg, state, valid, cuda_gru)

    trained = state.model.state_dict()
    loaded = load_pretrained(export_dir, cfg)  # checks the artifact meta
    if loaded.keys() != trained.keys() or not all(torch.equal(loaded[k].cuda(), trained[k]) for k in trained):
        raise AssertionError("pretrained.npz does not hold the trained model's parameters and statistics bit for bit")
    served = Denoiser(cfg, trained, device="cuda")
    exported = Denoiser.from_pretrained(cfg, export_dir, device="cuda")
    # cuDNN may take a nondeterministic algorithm for a transposed convolution
    # (its backward-data kernels): the two waveforms are compared with
    # deterministic algorithms, as the same Denoiser gives the same bits then
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = served(clip)
        exported(clip)  # captures the bucket's graph
        cuda_gru.reset_launch_counts()
        got = exported(clip)
        torch.cuda.synchronize()
        export_counts = cuda_gru.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[export] pretrained.npz of iteration {PROC_STEPS - 1}: replayed Denoiser call launches {export_counts}, "
        f"max abs diff to the trained model's Denoiser {float(np.abs(got - want).max()):.3e}")
    if export_counts != {**{k: 0 for k in export_counts}, "gru_fwd": 3}:
        raise AssertionError(f"exported Denoiser: {export_counts}, expected 3 gru_fwd and nothing else")
    if not np.array_equal(got, want) or not np.isfinite(got).all():
        raise AssertionError("the exported weights do not serve the trained model's waveform bit for bit")
    summary = {"items": PROC_ITEMS, "steps": PROC_STEPS, "train_s": train_s, "phase_s": time.perf_counter() - t0,
               "launches": counts, "metrics": metrics, "valid_loss_iteration_0": first["Valid/Valid-Loss"],
               "export_launches": export_counts, "resumed_vs_continued": resumed, "graph_vs_body": graph_vs_body,
               "validation": validation}
    del state
    torch.cuda.empty_cache()
    return summary, counts


def eval_graph_vs_body(cfg, state, valid, cuda_gru) -> dict:
    """Phase 9 (a): the validation pass of `train()` on the trained `state`
    through a new eval step, on the batch train() makes in its slot
    (`loop.validation_batch`): the slot's first call (3 warm-ups and the
    capture: 12 gru_fwd) and a replayed call (3 gru_fwd, nothing else), the
    launch counts set to 0 just before and read just after each; the
    replayed loss terms against the body's (`replay=False`) within
    GRAPH_ATOL relative; EVAL_CALLS passes of each (the call and the read of
    its loss) timed on the host clock, and kernels, device busy and idle
    share under torch.profiler (`hop_profile`), beside the eval graph
    pool's bytes and the card's name and power limit."""
    from tinyrecurrentunet_torch.train.loop import validation_batch
    from tinyrecurrentunet_torch.train.step import make_eval_step
    from tinyrecurrentunet_torch.utils import graphs

    evaluate = make_eval_step(cfg)
    batch = validation_batch(evaluate, state, valid, cfg.train.optimization.batch_size_per_device)
    counts = {}
    for name in ("capturing_call", "replayed_call"):
        cuda_gru.reset_launch_counts()
        t0 = time.perf_counter()
        got = evaluate(state, *batch)
        torch.cuda.synchronize()
        counts[name] = cuda_gru.launch_counts()
        if name == "capturing_call":
            first_s = time.perf_counter() - t0
    want = evaluate(state, *batch, replay=False)
    errs = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k])) for k in want}
    rows = {}
    for name, replay in (("graph", True), ("body", False)):
        def call():
            return float(evaluate(state, *batch, replay=replay)["loss"])

        call()
        lat = []
        for _ in range(EVAL_CALLS):
            t0 = time.perf_counter()
            call()
            lat.append(time.perf_counter() - t0)
        prof = hop_profile(call, 5)
        rows[name] = {"step": name, "calls": EVAL_CALLS, **percentiles_ms(lat), **prof}
        rows[name]["device_idle_share"] = 1.0 - prof["device_busy_ms"] / rows[name]["median_ms"]
    report = {"batch": list(batch[0].shape), "launches": counts, "first_call_s": first_s,
              "graph_vs_body_rel_err": errs, "graph": rows["graph"], "body": rows["body"],
              "pool_bytes": graphs.pool_bytes(evaluate._pool), "captures": evaluate.captures,
              "device": nvidia_smi_line()}
    log(f"[proc-train] validation pass, replayed vs body: {json.dumps(report)}")
    only = {k: 0 for k in counts["replayed_call"]}
    if counts != {"capturing_call": {**only, "gru_fwd": 12}, "replayed_call": {**only, "gru_fwd": 3}}:
        raise AssertionError(f"validation pass launches {counts}: expected 12 and 3 gru_fwd, nothing else")
    if not all(err <= GRAPH_ATOL for err in errs.values()) or not np.isfinite(list(errs.values())).all():
        raise AssertionError(f"validation pass, graph vs body {errs} > {GRAPH_ATOL:.0e}")
    if evaluate.captures != 1 or len(evaluate._slots) != 1:
        raise AssertionError(f"the eval step captured {evaluate.captures} times in {len(evaluate._slots)} slots")
    return report


def resumed_step(cfg, state, batch) -> dict:
    """The latest checkpoint of the run whose trained `state` is given,
    restored into a fresh state (in the run's directory: the config's log
    directory is relative): one replayed step of each on `batch`, and the
    continued state's step once more from the same state for the step's own
    spread; held as `train_graph_vs_body` holds the graph to the body in
    cuDNN's default setting (the same tolerances, the parameters by phase
    5's measure). One step after
    the other, so that one graph pool at a time holds the step's working
    set; the trained state is put back as it was after."""
    from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
    from tinyrecurrentunet_torch.train.state import create_train_state, make_schedule
    from tinyrecurrentunet_torch.train.step import make_train_step

    fresh = create_train_state(cfg, device="cuda")
    fresh, iteration, _ = CheckpointManager(cfg.train.log.directory, cfg.train.exp_path).restore(fresh)
    if fresh.step != state.step:
        raise AssertionError(f"the checkpoint of iteration {iteration} holds {fresh.step} updates, not {state.step}")
    before, updates = train_state_copy(state, None), fresh.step
    runs = []
    for st in (fresh, state, state):
        if st is state:
            load_train_state(state, before)
        _, metrics = make_train_step(cfg)(st, *batch)
        runs.append(({k: float(v) for k, v in metrics.items()}, state_vectors(st)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    load_train_state(state, before)  # the trained state, as its checkpoint and export hold it

    def rel(a, b):
        return {"loss": max(abs(a[k] - b[k]) / abs(b[k]) for k in b if k != "grad_norm"),
                "grad_norm": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]}

    (m, v), (m_ref, v_ref), (m_again, v_again) = runs
    got, spread = rel(m, m_ref), rel(m_again, m_ref)
    nondeterministic = (spread["loss"] > 0 or spread["grad_norm"] > 0
                        or not torch.equal(v_ref["grads"], v_again["grads"]))
    clear = v_ref["grads"].abs() >= ADAM_SIGN_TAU
    exact = (torch.minimum(v["grads"].abs(), v_ref["grads"].abs()) >= ADAM_SIGN_TAU) & (
        v["grads"].sign() == v_ref["grads"].sign())
    lr = make_schedule(cfg)(state.step - 1)
    report = {"iteration": iteration, "updates": updates, "resumed_vs_continued": got,
              "continued_vs_continued": spread, "cudnn_nondeterministic": nondeterministic,
              "param_exact_share": exact.double().mean().item(), "clear_share": clear.double().mean().item(),
              "param_max_abs_err_exact": (v["params"] - v_ref["params"]).abs()[exact].max().item(),
              "param_max_abs_err": (v["params"] - v_ref["params"]).abs().max().item(), "lr": lr}
    log(f"[proc-train] the checkpoint resumed into a fresh state, its replayed step vs the continued one: "
        f"{json.dumps(report)}")
    ok = (got["loss"] <= max(TRAIN_GRAPH_LOSS_RTOL, 2 * spread["loss"])
          and got["grad_norm"] <= max(TRAIN_GRAPH_NORM_RTOL_NONDET if nondeterministic else TRAIN_GRAPH_NORM_RTOL,
                                      2 * spread["grad_norm"])
          and report["param_exact_share"] >= min(PARAM_EXACT_SHARE, DP_SIGN_AGREEMENT * report["clear_share"])
          and report["param_max_abs_err_exact"] <= PARAM_ATOL and report["param_max_abs_err"] <= 2 * lr + PARAM_ATOL)
    if not ok:
        raise AssertionError(f"resumed vs continued step: {report}")
    return report


def profiled_training(f32_cfg) -> dict:
    """Phase 9 (b): train() with profile_dir, 13 steps at batch 8 in float32;
    the trace names the four training kernels."""
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
    from tinyrecurrentunet_torch.train.loop import train

    cfg = with_batch(f32_cfg, 8)
    workdir = phase_workdir("chip_smoke_profile")
    dataset = SyntheticPairDataset(num_items=16, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        train(cfg, dataset=dataset, max_iters=13, device="cuda", profile_dir=os.path.join(workdir, "trace"))
        train_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    path = os.path.join(workdir, "trace", "trace_rank0.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {name: sum(bool(re.search(pattern, k)) for k in kernels) for name, pattern in TRAINING_KERNEL_NAMES.items()}
    row = {"steps": 13, "batch": 8, "train_s": train_s, "trace": os.path.relpath(path, REPO),
           "trace_mb": os.path.getsize(path) / 1e6, "kernel_events": len(kernels), "training_kernels": found}
    log(f"[profile] {json.dumps(row)}")
    # steps 10, 11 and 12 launch each training kernel 9 times; the profiler
    # has been seen to drop a few kernel records (device_ms), so each must
    # be named, and the counts are logged
    if not all(found.values()):
        raise AssertionError(f"the --profile trace of steps 10-12 names the training kernels {found} times")
    return row


def data_parallel_step(f32_cfg, ranks: int = 2, batch: int = DP_BATCH, backend: str = "gloo",
                       device: str = "cuda:0", graph_steps: int = 0) -> tuple[dict, list]:
    """Phase 9 (c): `ranks` ranks of scripts/torch_dp_step.py under torchrun
    (one rank: the script alone, which makes its group of one), by default
    two on this card (gloo: NCCL refuses two ranks on one card), one train()
    step each at `batch` clips of 2 s, float32; against the single-process
    step on the first card on the same ranks x batch clips in rank-major
    order; then the ranks' steps (replayed over NCCL, the body over gloo) and
    their bodies timed beside the single-process step
    (scripts/torch_dp_cards.py runs one rank per card with nccl). With
    `graph_steps`, each rank also holds that many replayed steps bit-equal
    to the body's under cudnn.deterministic (`--graph_vs_body`)."""
    from tinyrecurrentunet_torch.config import config_to_dict
    from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    cfg = with_batch(f32_cfg, batch)
    workdir = phase_workdir("chip_smoke_dp")
    cfg_path = os.path.join(workdir, "proc16k_f32.json")
    with open(cfg_path, "w") as f:
        json.dump(config_to_dict(cfg), f)
    out_dir = os.path.join(workdir, "out")
    launcher = [] if ranks == 1 else ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(ranks)]
    cmd = [sys.executable, *launcher, os.path.join(REPO, "scripts", "torch_dp_step.py"), "-c", cfg_path,
           "--out", out_dir, "--items", str(ranks * batch), "--device", device, "--backend", backend,
           "--time_steps", "5", "--graph_vs_body", str(graph_steps)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=workdir, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"the {ranks}-rank step did not end in {DP_TIMEOUT_S} s:\n{str(e.stdout)[-3000:]}\n"
                             f"{str(e.stderr)[-3000:]}") from e
    run_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the {ranks}-rank step failed ({res.returncode}):\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    runs = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            runs.append({**json.load(f), "arrays": dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))})
    a = runs[0]
    for b in runs[1:]:
        for key in a["arrays"]:
            if key.startswith(("param/", "buffer/", "grad/")) and not np.array_equal(a["arrays"][key], b["arrays"][key]):
                raise AssertionError(f"ranks 0 and {b['rank']}: {key} differs after the step")
        if a["metrics"] != b["metrics"]:
            raise AssertionError(f"the ranks' metrics differ: {a['metrics']} {b['metrics']}")

    clean, noisy = (torch.from_numpy(np.concatenate([run["arrays"][k] for run in runs])).cuda()
                    for k in ("clean", "noisy"))
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    state, metrics = step(state, clean, noisy)
    metrics = {k: float(v) for k, v in metrics.items()}
    names = [n for n, _ in state.model.named_parameters()]
    grads = torch.cat([p.grad.reshape(-1).double().cpu() for p in state.model.parameters()])
    params = torch.cat([p.detach().reshape(-1).double().cpu() for p in state.model.parameters()])
    dp_grads = torch.cat([torch.from_numpy(a["arrays"][f"grad/{n}"]).reshape(-1).double() for n in names])
    dp_params = torch.cat([torch.from_numpy(a["arrays"][f"param/{n}"]).reshape(-1).double() for n in names])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        step(state, clean, noisy)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t1) / 5 * 1e3

    opt = cfg.train.optimization
    lr0 = linear_warmup_cosine_decay(opt.learning_rate, opt.n_iters, opt.lr_divider, opt.warmup_proportion)(0)
    clear = grads.abs() >= ADAM_SIGN_TAU
    exact = (torch.minimum(grads.abs(), dp_grads.abs()) >= ADAM_SIGN_TAU) & (grads.sign() == dp_grads.sign())
    param_err = (dp_params - params).abs()
    report = {
        "ranks": ranks, "batch_per_rank": batch, "backend": backend, "device": [run["device"] for run in runs],
        "loss_rel_err": {k: abs(a["metrics"][k] - metrics[k]) / abs(metrics[k]) for k in metrics if k != "grad_norm"},
        "grad_norm_rel_err": abs(a["metrics"]["grad_norm"] - metrics["grad_norm"]) / metrics["grad_norm"],
        "grad_rel_l2": rel_l2(dp_grads, grads), "param_exact_share": exact.double().mean().item(),
        "clear_share": clear.double().mean().item(), "sign_agreement": (exact.sum() / clear.sum()).item(),
        "param_max_abs_err_exact": param_err[exact].max().item(), "param_max_abs_err": param_err.max().item(),
        "launches_per_rank": [run["launches"] for run in runs], "replayed": [run["replayed"] for run in runs],
        "step_ms_ranks": [run["step_ms"] for run in runs], "body_ms_ranks": [run["body_ms"] for run in runs],
        "step_ms_single_process": single_ms, "run_s": run_s, "metrics": a["metrics"],
        "graph_vs_body": [run.get("graph_vs_body") for run in runs], "nvidia_smi": nvidia_smi_line(),
    }
    log(f"[dp] {ranks}-rank step vs the single-process step on the same {ranks * batch} clips: {json.dumps(report)}")
    for name, err in report["loss_rel_err"].items():
        if not err <= DP_LOSS_RTOL:
            raise AssertionError(f"{ranks}-rank step: loss term {name} rel err {err:.3e} > {DP_LOSS_RTOL:.0e}")
    if not report["grad_norm_rel_err"] <= DP_NORM_RTOL:
        raise AssertionError(f"{ranks}-rank step: grad_norm rel err {report['grad_norm_rel_err']:.3e} > "
                             f"{DP_NORM_RTOL:.0e}")
    # phase 5's share, or, where the single-process gradient itself has fewer
    # entries of at least ADAM_SIGN_TAU (0.78 at 64 clips), DP_SIGN_AGREEMENT of those
    exact_floor = min(PARAM_EXACT_SHARE, DP_SIGN_AGREEMENT * report["clear_share"])
    if not report["param_exact_share"] >= exact_floor:
        raise AssertionError(f"{ranks}-rank step: gradients of one sign on {report['param_exact_share']:.3f} "
                             f"< {exact_floor:.3f}")
    if not report["param_max_abs_err_exact"] <= PARAM_ATOL:
        raise AssertionError(f"{ranks}-rank step: params {report['param_max_abs_err_exact']:.3e}")
    if not report["param_max_abs_err"] <= 2 * lr0 + PARAM_ATOL:
        raise AssertionError(f"{ranks}-rank step: params {report['param_max_abs_err']:.3e}")
    # over NCCL the step's first call warms up 3 times and replays the graph
    # it captured, over gloo it runs the body once
    replayed = backend == "nccl"
    for run in runs:
        want = {k: 12 if replayed else 3 for k in run["launches"]}
        want["gru_fwd"] = 0
        if run["launches"] != want or run["replayed"] is not replayed or run["captures"] != int(replayed):
            raise AssertionError(f"rank {run['rank']} ({backend}): replayed {run['replayed']}, captures "
                                 f"{run['captures']}, launched {run['launches']}; expected replayed {replayed}, "
                                 f"{want}")
        if graph_steps:
            check_dp_graph_vs_body(run, graph_steps)
    del state
    torch.cuda.empty_cache()
    return report, report["launches_per_rank"]


def check_dp_graph_vs_body(run: dict, steps: int):
    """A rank's `--graph_vs_body` report: every call replayed and bit-equal
    to the body (metrics, parameters, gradients, buffers), 12 launches of
    each training kernel in the capturing call and 3 in each later one, one
    capture, and all-reduces captured from the main thread (BatchNorm, the
    loss, the gradients' sum) and from autograd's (the sum-backward)."""
    report = run["graph_vs_body"]
    calls = report["calls"]
    for i, call in enumerate(calls):
        want = {k: 12 if i == 0 else 3 for k in call["launches"]}
        want["gru_fwd"] = 0
        if not (call["replayed"] and call["metrics_equal"] and call["state_equal"] and call["launches"] == want):
            raise AssertionError(f"rank {run['rank']} call {i}: graph vs body under cudnn.deterministic {call}, "
                                 f"expected bit-equal, replayed, launches {want}")
    captured = report["captured_all_reduces"]
    if (len(calls) != steps or report["captures"] != 1 or report["body_captures"] != 0
            or captured["main_thread"] < 1 or captured["autograd_thread"] < 1):
        raise AssertionError(f"rank {run['rank']}: graph vs body {report}")


def cli_run(commands: list, cwd: str, timeout: float) -> dict:
    """Start each launcher command (argv, extra environment) in a session of
    its own and time-stamp its output lines until every launcher has
    exited, or end each session at `timeout` (SIGTERM, which a launcher
    passes to its ranks, then SIGKILL 10 s later). A launcher exits after
    every rank it started. Returns the exit codes, the lines and the
    seconds until the last launcher exited."""
    import signal
    import threading

    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, cwd=cwd, env={**os.environ, **env}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for argv, env in commands]
    lines = [[] for _ in procs]

    def read(i):
        for line in procs[i].stdout:
            lines[i].append((time.perf_counter() - t0, line.rstrip("\n")))

    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(len(procs))]
    for thread in readers:
        thread.start()
    codes, timed_out = [], False
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=max(t0 + timeout - time.perf_counter(), 0)))
        except subprocess.TimeoutExpired:
            codes.append(None)
            timed_out = True
    wall = time.perf_counter() - t0
    if timed_out:
        for sig in (signal.SIGTERM, signal.SIGKILL):
            for proc in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, sig)
            if sig == signal.SIGTERM:
                time.sleep(10)
        for proc in procs:
            proc.wait()
    for thread in readers:
        thread.join(timeout=10)
    return {"rc": codes, "timed_out": timed_out, "wall_s": wall, "lines": lines}


def cli_report(run: dict) -> dict:
    """What a CLI run's output says: the iterations rank 0 logged and their
    times, validation passes, checkpoints announced (and by which
    launcher), a resume, the world size and global batch it logged, the
    ranks that ended (each rank's `rank r ended` line, with its GRU kernel
    launches), seconds a step between the logged iterations after the
    first, and the seconds from the last step's line (an iteration logged or
    a checkpoint saved) to each rank's end and to the launchers' exit."""
    report = {"saved": [], "saved_by_launcher": [], "valid": 0, "resumed": None, "world": None,
              "global_batch": None, "launches": {}}
    logged, ended, last = {}, {}, None
    for i, launcher in enumerate(run["lines"]):
        for t, line in launcher:
            # the ranks write to one pipe at once: a line may hold pieces of several
            for m in re.finditer(r"rank (\d+) ended(?:: GRU kernel launches (\{[^{}]*\}))?", line):
                ended[int(m.group(1))] = t
                if m.group(2):
                    report["launches"][int(m.group(1))] = json.loads(m.group(2))
            if m := re.search(r"data parallel: (\d+) ranks .* global batch (\d+)", line):
                report["world"], report["global_batch"] = int(m.group(1)), int(m.group(2))
            if m := re.search(r"resumed from checkpoint at iteration (\d+)", line):
                report["resumed"] = int(m.group(1))
            step = False
            if m := re.search(r"iteration: (\d+)\s", line):
                logged[int(m.group(1))] = t
                report["valid"] += "valid:" in line
                step = True
            if m := re.search(r"model at iteration (\d+) is saved", line):
                report["saved"].append(int(m.group(1)))
                report["saved_by_launcher"].append(i)
                step = True
            if step:
                last = t if last is None else max(last, t)
    its = sorted(logged)
    return {
        **report, "iterations_logged": its, "rc": run["rc"], "timed_out": run["timed_out"],
        "wall_s": run["wall_s"], "first_iteration_s": logged[its[0]] if its else None,
        "s_per_step": (logged[its[-1]] - logged[its[1]]) / (its[-1] - its[1]) if len(its) > 2 else None,
        "ranks": sorted(ended),
        "last_step_to_end_s": {r: None if last is None else ended[r] - last for r in sorted(ended)},
        "last_step_to_exit_s": None if last is None or run["timed_out"] else run["wall_s"] - last,
    }


def cli_failures(report: dict, iters: int, world: int, resumed_from: int | None, saves: list) -> list:
    """What a CLI run (cli_report) misses against the contract: every
    launcher exited 0 within the time limit, ranks 0 to `world` - 1 each
    printed its end; `world` ranks logged
    with a global batch of `world` x CLI_BATCH; the checkpoints `saves` and
    the final one (iteration `iters` - 1) announced once each, by process
    0's launcher, and one file each in the directory; from scratch
    (`resumed_from` None) a validation pass logged, else the resume; each
    rank's kernel launches: of each training kernel 3 a step of its run and
    9 more (the slot's 3 warm-ups in its first call), of gru_fwd on rank 0
    3 a validation pass and 9 more, on the others none."""
    bad = []
    steps = iters - 1 - (-1 if resumed_from is None else resumed_from)
    for r in range(world):
        want = {k: 3 * steps + 9 for k in ("gru_fwd_train", "gru_bwd", "gru_dw_partial", "gru_dw_sum")}
        want["gru_fwd"] = 3 * report["valid"] + 9 if r == 0 and report["valid"] else 0
        if report["launches"].get(r) != want:
            bad.append(f"rank {r} launched {report['launches'].get(r)}, expected {want}")
    if report["timed_out"] or any(report["rc"]):
        bad.append(f"exit: rc {report['rc']}, timed out {report['timed_out']}")
    if report["ranks"] != list(range(world)) or report["world"] != world or \
            report["global_batch"] != world * CLI_BATCH:
        bad.append(f"ranks ended {report['ranks']}, logged world {report['world']} and global batch "
                   f"{report['global_batch']}; expected {world} and {world * CLI_BATCH}")
    announced = sorted(saves + [iters - 1])
    if sorted(report["saved"]) != announced or any(report["saved_by_launcher"]):
        bad.append(f"checkpoints announced {report['saved']} by launchers {report['saved_by_launcher']}, "
                   f"expected {announced} by launcher 0")
    if not {f"{k}.pt" for k in announced} <= set(report["checkpoints"]) or \
            not all(re.fullmatch(r"\d+\.pt", name) for name in report["checkpoints"]):
        bad.append(f"checkpoint files {report['checkpoints']}")
    if resumed_from is None and report["valid"] < 1:
        bad.append("no validation pass logged")
    if report["resumed"] != resumed_from:
        bad.append(f"resumed from {report['resumed']}, expected {resumed_from}")
    return bad


def cli_config(cfg, path: str, **dist) -> str:
    """`cfg` at CLI_BATCH clips a rank, validation and checkpoints every 2
    iterations (and `dist` fields, if any), written to `path` as JSON."""
    from tinyrecurrentunet_torch.config import config_to_dict

    log = dataclasses.replace(cfg.train.log, iters_per_valid=2, iters_per_ckpt=2)
    cfg = with_batch(cfg, CLI_BATCH)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log=log),
                              dist=dataclasses.replace(cfg.dist, **dist))
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f)
    return path


def cli_command(cfg_path: str, iters: int, items: int = CLI_ITEMS, launcher: tuple = ()) -> list:
    """The training CLI as users start it, `--data_parallel`."""
    return [sys.executable, *launcher, "-m", "tinyrecurrentunet_torch.train.loop", "-c", cfg_path, "--procedural",
            "--procedural_items", str(items), "--data_parallel", "--max_iters", str(iters)]


def cli_resume_pair(commands_for, workdir: str, ckpt_dir: str, world: int,
                    timeout: float = CLI_TIMEOUT_S) -> tuple[list, list]:
    """Two runs of the CLI in `workdir` (`commands_for(iters)` gives the
    launcher commands), checkpoints in `ckpt_dir`: CLI_ITERS[0] iterations
    from scratch, then CLI_ITERS[1] resumed from the first's last
    checkpoint. Returns their reports and what each misses
    (`cli_failures`); a run that misses anything keeps the last 40 lines of
    each launcher's output."""
    first, second = CLI_ITERS
    reports, failures = [], []
    for iters, resumed_from, saves in ((first, None, [2, 4]), (second, first - 1, [])):
        run = cli_run(commands_for(iters), workdir, timeout)
        report = cli_report(run)
        report["checkpoints"] = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
        bad = cli_failures(report, iters, world, resumed_from, saves)
        if bad:
            report["output_tail"] = [[line for _, line in launcher][-40:] for launcher in run["lines"]]
        reports.append(report)
        failures.append(bad)
    return reports, failures


def cli_data_parallel(cfg) -> dict:
    """Phase 12: the training CLI, `--data_parallel` with no launcher, over
    every card this process sees (one card: a group of one over NCCL, the
    collectives in the step's graph), twice: CLI_ITERS[0] iterations, then
    CLI_ITERS[1] resumed from the first's checkpoint 4."""
    cards = torch.cuda.device_count()
    workdir = phase_workdir("chip_smoke_cli")
    cfg_path = cli_config(cfg, os.path.join(workdir, "proc16k_cli.json"))
    env = {"PYTHONPATH": REPO}
    ckpt_dir = os.path.join(workdir, "ckpt", cfg.train.exp_path, "checkpoint")
    reports, failures = cli_resume_pair(lambda iters: [(cli_command(cfg_path, iters), env)], workdir, ckpt_dir,
                                        cards)
    row = {"cards": cards, "runs": [{k: v for k, v in r.items() if k != "output_tail"} for r in reports],
           "nvidia_smi": nvidia_smi_line()}
    log(f"[cli] {json.dumps(row)}")
    for report, bad in zip(reports, failures):
        if bad:
            raise AssertionError(f"the training CLI over {cards} card(s): {bad}\n" +
                                 "\n".join("\n".join(t) for t in report.get("output_tail") or []))
    return row


def scaling_ladder(cfg) -> list:
    """Phase 9 (e): train/scaling.py's rows in bf16 at SCALING_BATCHES."""
    from tinyrecurrentunet_torch.train.scaling import measure_or_oom

    card = nvidia_smi_line()
    rows = []
    for batch in SCALING_BATCHES:
        row = measure_or_oom(cfg, batch, "bfloat16", reps_hi=3, reps_lo=1, device="cuda")
        row["nvidia_smi"] = card
        log(f"[scaling] {json.dumps(row)}")
        if row.get("oom") or not np.isfinite(row["step_ms"]):
            raise AssertionError(f"scaling rung at batch {batch}: {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def export_and_benches(cfg, cuda_gru) -> tuple[dict, dict]:
    """Phase 10: (a) the export of the flagship on the host (ONNX,
    TorchScript, the two programs), the TorchScript artifact on the card
    against the port's model with its kernels at the 251-frame export shape,
    and that model against its plain version there; (b) the int8 pack, byte for byte the committed one; (c) `rt_bench`'s four
    engines, 3 gru_fwd a call of the full clip and of a frame; (d)
    `gru_bench`'s five rows, each kernel output held against the plain
    version's; (e) the kernel A/B at batch 64 in float32:
    "never" launches none of the five kernels, "always" 3 of each training
    kernel a step. Returns (summary, launches of each kernel by part)."""
    import filecmp

    from tinyrecurrentunet_torch.export import export as export_mod
    from tinyrecurrentunet_torch.export import onnx_export, quantize, rt_bench
    from tinyrecurrentunet_torch.ops import gru_bench
    from tinyrecurrentunet_torch.signal.features import from_reference_layout
    from tinyrecurrentunet_torch.train.scaling import kernel_ab_rows
    from tinyrecurrentunet_torch.weights import artifact_meta, load_pretrained, read_npz

    workdir = phase_workdir("chip_smoke_export")
    state_dict = load_pretrained(ARTIFACT, cfg)
    card = nvidia_smi_line()
    summary = {"torch": torch.__version__, "nvidia_smi": card}
    launches = {}

    # (a) export on the host; the TorchScript artifact on the card
    t0 = time.perf_counter()
    onnx_report = onnx_export.export_onnx(cfg, state_dict, os.path.join(workdir, "trunet.onnx"))
    ts_report = onnx_export.export_torchscript(cfg, state_dict, os.path.join(workdir, "trunet.ts.pt"))
    programs = export_mod.export_program(cfg, state_dict, workdir)
    summary["export_s"] = time.perf_counter() - t0
    summary["sizes_bytes"] = {name: os.path.getsize(path) for name, path in
                              [("onnx", onnx_report["path"]), ("torchscript", ts_report["path"]), *programs.items()]}
    summary["host_parity"] = {"onnx": onnx_report["max_abs_err"], "torchscript": ts_report["max_abs_err"]}
    log(f"[export] torch {torch.__version__}: sizes {summary['sizes_bytes']}, module vs the port's model on the "
        f"host (max abs) {summary['host_parity']}, {summary['export_s']:.1f} s")
    if min(summary["sizes_bytes"].values()) < 1_000_000 or max(summary["host_parity"].values()) > EXPORT_ATOL:
        raise AssertionError(f"export: {summary}")
    feats_tcf = torch.from_numpy(onnx_export.export_features(cfg)).cuda()
    artifact = torch.jit.load(ts_report["path"], map_location="cuda").eval()
    model = onnx_export.float32_model(cfg, state_dict, "cuda")
    cuda_gru.reset_launch_counts()
    with torch.no_grad():
        ref, _ = model(from_reference_layout(feats_tcf))
    torch.cuda.synchronize()
    launches["export_eager"] = cuda_gru.launch_counts()
    with torch.no_grad():
        got = artifact(feats_tcf)
    err = float((got - ref.transpose(-1, -2)).abs().max())
    summary["torchscript_on_card_vs_kernels_max_abs"] = err
    log(f"[export] TorchScript artifact on the card (cuDNN GRU) vs the port's model with its kernels, "
        f"{feats_tcf.shape[0]} frames: max abs {err:.3e} (tolerance {EXPORT_ATOL:.0e}); "
        f"the model's launches {launches['export_eager']}")
    if err > EXPORT_ATOL or launches["export_eager"] != {**{k: 0 for k in launches["export_eager"]}, "gru_fwd": 3}:
        raise AssertionError(f"TorchScript artifact on the card: {err}, {launches['export_eager']}")
    # the same model with the plain recurrences, at the shapes rt_bench's
    # full-clip engines give gru_fwd
    never = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, use_pallas_gru="never"))
    plain = onnx_export.float32_model(never, state_dict, "cuda")
    cuda_gru.reset_launch_counts()
    with torch.no_grad():
        plain_out, _ = plain(from_reference_layout(feats_tcf))
    torch.cuda.synchronize()
    plain_counts = cuda_gru.launch_counts()
    err = float((ref - plain_out).abs().max())
    summary["kernels_vs_plain_max_abs"] = err
    log(f"[export] the port's model with its kernels vs with the plain recurrences, {feats_tcf.shape[0]} frames: "
        f"max abs {err:.3e} (tolerance {EXPORT_ATOL:.0e}); the plain model's launches {plain_counts}")
    if err > EXPORT_ATOL or any(plain_counts.values()):
        raise AssertionError(f"kernels vs plain at the export shape: {err}, {plain_counts}")

    # (b) the int8 pack
    variables, _ = read_npz(os.path.join(ARTIFACT, "pretrained.npz"))
    pack = os.path.join(workdir, "model_int8.trq")
    size = quantize.save_quantized(pack, variables["params"], variables["batch_stats"], meta=artifact_meta(cfg))
    same = filecmp.cmp(pack, os.path.join(ARTIFACT, "model_int8.trq"), shallow=False)
    summary["int8_pack"] = {"bytes": size, "equals_committed": same}
    log(f"[export] int8 pack {size} bytes, byte-equal to the committed model_int8.trq: {same}")
    if not same:
        raise AssertionError("the port's int8 pack differs from artifacts/TRUNet-proc/model_int8.trq")

    # (c) rt_bench: the graph engines, then their bodies; each graph engine
    # held to its body
    for key, replay in (("rt_bench", True), ("rt_bench_body", False)):
        cuda_gru.reset_launch_counts()
        bench = rt_bench.run_bench(cfg, state_dict, ts_report["path"], device="cuda", reps_hi=20, reps_lo=4,
                                   frame_reps_hi=50, frame_reps_lo=10, replay=replay)
        torch.cuda.synchronize()
        launches[key] = cuda_gru.launch_counts()
        bench["nvidia_smi"] = card
        summary[key] = bench
        log(f"[rt_bench] {'graph' if replay else 'body'}: {json.dumps(bench)}")
        per_call = bench["gru_fwd_per_call"]
        if (per_call != {"graph_full_clip": 3, "graph_per_frame": 3, "int8_full_clip": 3, "torchscript_full_clip": 0}
                or any(v for k, v in launches[key].items() if k != "gru_fwd")
                or not all(np.isfinite(v) and v > 0 for k, v in bench.items() if k.endswith(("_s", "_rtf")))):
            raise AssertionError(f"{key}: {bench}, launches {launches[key]}")
    summary["rt_bench_graph_vs_body"] = rt_bench_graph_vs_body(cfg, state_dict, feats_tcf, cuda_gru)

    # (d) gru_bench
    cuda_gru.reset_launch_counts()
    rows = gru_bench.run(reps=50, plain_reps=3, device="cuda")
    torch.cuda.synchronize()
    launches["gru_bench"] = cuda_gru.launch_counts()
    for row in rows:
        log(f"[gru_bench] {json.dumps({**row, 'nvidia_smi': card})}")
    if len(rows) != 5 or not all(np.isfinite(r["speedup"]) and r["speedup"] > 0 and r["max_abs_err"] <= KERNEL_ATOL
                                 for r in rows):
        raise AssertionError(f"gru_bench (kernel vs plain tolerance {KERNEL_ATOL:.0e}): {rows}")
    summary["gru_bench"] = rows

    # (e) the kernel A/B at batch 64, float32: train/scaling.py's "never" and
    # "always" rows in one run. "never" launches nothing and "always" 3 of
    # each training kernel a step (warm-up and FLOP count included), so the
    # run's counts are 3 x the "always" row's steps.
    cuda_gru.reset_launch_counts()
    ab = kernel_ab_rows(cfg, [TRAIN_BATCH], reps_hi=2, reps_lo=1, device="cuda")
    torch.cuda.synchronize()
    counts = launches["kernel_ab"] = cuda_gru.launch_counts()
    always = next(r for r in ab if r["use_pallas_gru"] == "always")
    want = {**{k: 3 * always.get("steps", 0) for k in counts}, "gru_fwd": 0}
    for row in ab:
        row["nvidia_smi"] = card
        log(f"[kernel-ab] {json.dumps(row)}")
    log(f"[kernel-ab] launches of the run {counts}, want {want}")
    if any(r.get("oom") or not np.isfinite(r["step_ms"]) for r in ab) or counts != want:
        raise AssertionError(f"kernel A/B: {ab}, launches {counts}, want {want}")
    summary["kernel_ab"] = {"rows": ab, "launches": counts}
    torch.cuda.empty_cache()
    return summary, launches


def rt_bench_graph_vs_body(cfg, state_dict, feats_tcf, cuda_gru, frames: int = 20) -> dict:
    """Phase 10 (c): each of rt_bench's graph engines of the port's model
    against the same engine's body on the export shape's features: the full
    clip and the int8 engine one call, the per-frame engine `frames` frames
    from a zero carry (each frame's output and the carry after), within
    GRAPH_ATOL; 3 gru_fwd a replay, nothing else."""
    from tinyrecurrentunet_torch.export import rt_bench
    from tinyrecurrentunet_torch.signal.features import from_reference_layout

    feats = from_reference_layout(feats_tcf)
    graph_engines = rt_bench.engines(cfg, state_dict, feats)
    bodies = rt_bench.engines(cfg, state_dict, feats, replay=False)
    report = {}
    for name, engine in graph_engines.items():
        errs, counts = [], []
        for _ in range(frames if name.endswith("per_frame") else 1):
            cuda_gru.reset_launch_counts()
            got = engine().clone()
            torch.cuda.synchronize()
            counts.append(cuda_gru.launch_counts())
            errs.append(float((got - bodies[name]()).abs().max()))
        if name.endswith("per_frame"):
            errs.append(float((engine.carry - bodies[name].carry).abs().max()))
        only = {**{k: 0 for k in counts[0]}, "gru_fwd": 3}
        report[name] = {"calls": len(counts), "max_abs_err": max(errs), "launches_a_replay": counts[0]}
        if max(errs) > GRAPH_ATOL or any(c != only for c in counts) or engine.graph is None:
            raise AssertionError(f"rt_bench {name}, graph vs body: {report[name]}, launches {counts}")
    log(f"[rt_bench] graph engines vs their bodies (tolerance {GRAPH_ATOL:.0e}): {json.dumps(report)}")
    return report


def serving_main_path(cfg, clip: np.ndarray, cuda_gru) -> dict:
    """Phase 3: the flagship served offline (`serve_offline`), then the
    graph pool's bytes after the 4 s bucket and after three more buckets
    (1, 2 and 3 s of the clip) called in turns with it, each call held to
    the body: one pool for all of the denoiser's graphs."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    hop, sample_rate = cfg.featurizer.hop_length, cfg.featurizer.sample_rate
    bucket = Denoiser._bucket(len(clip), hop)
    denoiser = Denoiser.from_pretrained(cfg, ARTIFACT, device="cuda")
    serving = serve_offline("flagship", cfg, ARTIFACT, denoiser, clip, "registers", SERVING_LATENCY_CALLS,
                            cuda_gru, "[main]")
    serving["pool"] = {"after_4s": graph_pool_bytes(denoiser)}
    pool_err = 0.0
    for seconds in (1, 4, 2, 4, 3, 4):
        part = clip[: seconds * sample_rate]
        pool_err = max(pool_err, float(np.abs(denoiser(part) - denoiser._denoise(part, replay=False)).max()))
    serving["pool"]["after_1_2_3_4s"] = graph_pool_bytes(denoiser)
    serving["pool"]["graph_vs_body_max_abs_err"] = pool_err
    log(f"[main] graph pool of 4 buckets: {json.dumps(serving['pool'])}, captures {denoiser._captures}, "
        f"{nvidia_smi_line()}")
    if pool_err > GRAPH_ATOL or denoiser._captures != 4 or len(denoiser._slots) != 4:
        raise AssertionError(f"four buckets: graph vs body {pool_err:.3e}, captures {denoiser._captures}")
    audio_dev = torch.from_numpy(np.pad(clip, (0, bucket - len(clip)))).cuda()
    graph_row, body_row = serving["latency"]
    log(json.dumps({
        "main_path": "Denoiser proc16k offline", "clip_s": CLIP_SECONDS, "bucket_samples": bucket,
        "frames": bucket // hop + 1, "run_ms_cuda_events": cuda_ms(lambda: denoiser.run(audio_dev), 20, 3),
        "call_ms_host_clock": graph_row["median_ms"], "body_call_ms_host_clock": body_row["median_ms"],
        "rtf": graph_row["median_ms"] / 1e3 / CLIP_SECONDS, "capture_s": serving["capture_s"],
        "max_abs_err_vs_cpu_f64": serving["max_abs_err"]["card_vs_cpu_f64"],
        "max_abs_err_vs_cpu": serving["max_abs_err"]["card_vs_cpu"],
    }))
    return serving


def shipped_offline(name, cfg, cuda_gru) -> dict:
    """Phase 11 (a): the shipped model `name` served offline on the card by
    `Denoiser.from_pretrained` on the seeded 4 s clip at its config's rate
    (`serve_offline`: the capturing call and a replayed call, 3 gru_fwd
    each run, large16k's on "cluster"; graph and body against float64 on the
    CPU and each other; SHIPPED_CALLS calls of each timed); for large16k also
    `network.use_pallas_gru` "never" against "always" in turns, each
    replayed from its graph and run as the body (replayed outputs within
    KERNEL_ATOL, "never" launching nothing)."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.weights import load_pretrained

    artifact = os.path.join(REPO, "artifacts", SHIPPED[name])
    sample_rate, hop = cfg.featurizer.sample_rate, cfg.featurizer.hop_length
    clip = make_clip(sample_rate)
    bucket = Denoiser._bucket(len(clip), hop)
    den = Denoiser.from_pretrained(cfg, artifact, device="cuda")
    path = "cluster" if name == "large16k" else "registers"
    served = serve_offline(name, cfg, artifact, den, clip, path, SHIPPED_CALLS, cuda_gru, "[shipped]")
    graph_row = served["latency"][0]
    row = {"model": name, "sample_rate": sample_rate, "clip_s": CLIP_SECONDS, "frames": bucket // hop + 1,
           **served, "rtf": graph_row["median_ms"] / 1e3 / CLIP_SECONDS}
    if name == "large16k":
        # the port's counterpart of bench.py's large_offline_rtf_scan / _pallas
        sd = load_pretrained(artifact, cfg)
        dens = {v: Denoiser(dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, use_pallas_gru=v)), sd,
                            device="cuda") for v in ("always", "never")}
        capture_s = {}
        for v, d in dens.items():
            t0 = time.perf_counter()
            d(clip)
            capture_s[v] = time.perf_counter() - t0
        outs, ab, body, ab_launches, graph_vs_body = {}, {v: [] for v in dens}, {v: [] for v in dens}, {}, {}
        for v in ("always", "never", "never", "always"):
            outs[v] = dens[v](clip)
            cuda_gru.reset_launch_counts()
            for _ in range(SHIPPED_CALLS // 2):
                t0 = time.perf_counter()
                dens[v](clip)
                ab[v].append(time.perf_counter() - t0)
            ab_launches[v] = cuda_gru.launch_counts()["gru_fwd"] / (SHIPPED_CALLS // 2)
            for _ in range(SHIPPED_CALLS // 4):
                t0 = time.perf_counter()
                eager = dens[v]._denoise(clip, replay=False)
                body[v].append(time.perf_counter() - t0)
            graph_vs_body[v] = float(np.abs(eager - outs[v]).max())
        row["use_pallas_gru"] = {v: {**percentiles_ms(ab[v]), "gru_fwd_a_call": ab_launches[v],
                                     "capture_s": capture_s[v], "body": percentiles_ms(body[v]),
                                     "graph_vs_body_max_abs_err": graph_vs_body[v]} for v in dens}
        row["never_vs_always_max_abs"] = float(np.abs(outs["never"] - outs["always"]).max())
        if (ab_launches != {"always": 3, "never": 0} or row["never_vs_always_max_abs"] > KERNEL_ATOL
                or max(graph_vs_body.values()) > GRAPH_ATOL):
            raise AssertionError(f"large16k use_pallas_gru A/B: launches {ab_launches}, "
                                 f"max abs {row['never_vs_always_max_abs']:.3e}, graph vs body {graph_vs_body}")
    log(f"[shipped] offline {json.dumps(row)}")
    return row


def shipped_streaming(name, cfg, cuda_gru) -> dict:
    """Phase 11 (b): the shipped model `name` streamed on the card at one
    hop a call over the seeded 4 s clip at its config's rate (`stream_clip`:
    3 gru_fwd a hop, against the CPU, the 3-hop shift within the model's
    SHIPPED_ALIGN bounds), the replayed step against the uncaptured body
    and the per-hop latency of each against the config's own budget,
    hop_length / sample_rate (`stream_steps`; for proc48k also at two hops a
    call against twice the budget); for proc48k also `MultiStreamDenoiser`
    at SHIPPED_STREAM_COUNTS streams and a SOAK_SECONDS soak through the
    native host. No result is held to real time: the misses are logged."""
    from tinyrecurrentunet_torch.infer.soak import run_soak
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser
    from tinyrecurrentunet_torch.weights import load_pretrained

    sd = load_pretrained(os.path.join(REPO, "artifacts", SHIPPED[name]), cfg)
    budget_s = cfg.featurizer.hop_length / cfg.featurizer.sample_rate
    clip = make_clip(cfg.featurizer.sample_rate)
    den, report = stream_clip(cfg, sd, clip, cuda_gru, align=SHIPPED_ALIGN[name], tag=f"[shipped] {name} stream")
    if report["paths"] != {"gru_fwd": {"cluster" if name == "large16k" else "registers": 3 * report["hops"]}}:
        raise AssertionError(f"{name} streaming: launches by path {report['paths']}")
    report["latency"] = [stream_steps(den, clip, budget_s, f"[shipped] {name} stream-latency")]
    if name == "proc48k":  # the JAX package's promoted 48 kHz mode: two hops a call
        report["latency"].append(stream_steps(StreamingDenoiser(cfg, sd, chunk_frames=2, device="cuda"), clip,
                                              2 * budget_s, f"[shipped] {name} stream-latency"))
    if name == "proc48k":
        report["multistream"] = multistream_rows(cfg, sd, SHIPPED_STREAM_COUNTS, cuda_gru,
                                                 tag=f"[shipped] {name} multistream")
        report["soak"] = soak = run_soak(cfg, sd, duration_s=SOAK_SECONDS, device="cuda")
        log(f"[shipped] {name} soak {json.dumps(soak)}, through the replayed step, {nvidia_smi_line()}")
        if soak["streaming_soak_sample_rate"] != cfg.featurizer.sample_rate:
            raise AssertionError(f"{name} soak at {soak['streaming_soak_sample_rate']} Hz")
    return report


def shipped_quality(name, cfg) -> dict:
    """Phase 11 (c): `run_quality_eval` of the shipped model `name` on the
    card, float32 and its committed int8 pack, on SHIPPED_QUALITY_FILES
    files of the procedural testset at the config's rate: float32 SI-SDR
    within QUALITY_SI_SDR_ATOL of the JAX package's on the same files, int8
    within it of float32 plus the JAX package's int8 gap there."""
    from tinyrecurrentunet_torch.infer.quality import denoiser_from_int8, denoiser_from_pretrained, run_quality_eval

    artifact = os.path.join(REPO, "artifacts", SHIPPED[name])
    jax_f32, jax_gap, record, record_file = SHIPPED_QUALITY[name]
    work = os.path.join(REPO, "build", f"chip_smoke_quality_{name}")
    shutil.rmtree(work, ignore_errors=True)
    results = {}
    for kind, make in (("float32", lambda: denoiser_from_pretrained(cfg, artifact, device="cuda")),
                       ("int8", lambda: denoiser_from_int8(cfg, os.path.join(artifact, "model_int8.trq"),
                                                           device="cuda"))):
        t0 = time.perf_counter()
        result = run_quality_eval(cfg, make(), testset_dir=os.path.join(work, "testset"),
                                  num_files=SHIPPED_QUALITY_FILES, seed=QUALITY_SEED,
                                  enhanced_dir=os.path.join(work, kind))
        results[kind] = {"enhanced": result["enhanced"], "noisy": result["noisy_baseline"],
                         "improvement": result["improvement"], "s": time.perf_counter() - t0}
        if result["testset"]["sample_rate"] != cfg.trainset.sample_rate:
            raise AssertionError(f"{name} quality testset at {result['testset']['sample_rate']} Hz")
    f32, int8 = (results[k]["enhanced"]["si_sdr"] for k in ("float32", "int8"))
    report = {"model": name, "files": SHIPPED_QUALITY_FILES, "si_sdr_float32": f32, "si_sdr_int8": int8,
              "int8_delta_db": int8 - f32, "jax_si_sdr_float32": jax_f32, "jax_int8_delta_db": jax_gap,
              f"record_60_files_{record_file}": record, "s": {k: v["s"] for k, v in results.items()}}
    log(f"[shipped] quality {json.dumps(report)}")
    log(f"[shipped] quality {name} runs {json.dumps(results)}")
    if not abs(f32 - jax_f32) <= QUALITY_SI_SDR_ATOL:
        raise AssertionError(f"{name} float32 SI-SDR {f32:.4f} dB, not within {QUALITY_SI_SDR_ATOL} of JAX's {jax_f32}")
    if not abs(int8 - (f32 + jax_gap)) <= QUALITY_SI_SDR_ATOL:
        raise AssertionError(f"{name} int8 SI-SDR {int8:.4f} dB, not within {QUALITY_SI_SDR_ATOL} of float32 "
                             f"{f32:.4f} plus JAX's gap {jax_gap:.4f}")
    return report


def expected_train_paths(cfg, launches: int) -> dict:
    """Launches by path of the training kernels after `launches` updates of
    the config's model: the FGRU (two directions) and the TGRU, each on the
    path its hidden size takes (H 64 / 128: registers, registers, tensor
    cores; H 256 / 512: cluster, cluster, tensor cores)."""
    paths = {}
    for hidden, count in ((cfg.network.fgru_hidden, 2), (cfg.network.tgru_hidden, 1)):
        resident = "registers" if hidden in (64, 128) else "cluster"
        for kernel, path in (("gru_fwd_train", resident), ("gru_bwd", resident),
                             ("gru_dw_partial", "tensor_cores"), ("gru_dw_sum", "sum")):
            by_path = paths.setdefault(kernel, {})
            by_path[path] = by_path.get(path, 0) + count * launches
    return paths


def shipped_training(name, cfg, steps: int, cuda_gru) -> dict:
    """Phase 11 (d): `train()` on the shipped config `name` as shipped (bf16,
    its batch, its crop, TBPTT segments where it sets them) on synthetic
    clips for `steps` iterations, launch counts and paths around it (3 of
    each training kernel an update, the capturing call's warm-ups included,
    none of gru_fwd); then finite losses and weights, the steady-state
    iteration by CUDA events, audio-s per s, peak memory and a profiled
    iteration (every recurrent kernel the port's), all replayed; the
    replayed step (a TBPTT segment) against the uncaptured body, both timed
    (`train_graph_vs_body`). For
    large16k also the clipped gradient of one step from the initial weights:
    bf16 against float32 on the card at its batch, and the card's bf16
    against the CPU's at batch 4 x 2 s, by phase 7's measure and bounds."""
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
    from tinyrecurrentunet_torch.train.loop import train
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    opt = cfg.train.optimization
    batch, crop, sample_rate = opt.batch_size_per_device, cfg.trainset.crop_length_sec, cfg.trainset.sample_rate
    if opt.train_compute_dtype != "bfloat16":
        raise AssertionError(f"config/{name}.json ships train_compute_dtype bfloat16")
    hop = cfg.featurizer.hop_length
    seg_len = int(opt.tbptt_segment_sec * sample_rate) // hop * hop if opt.tbptt_segment_sec > 0 else 0
    segments = int(crop * sample_rate) // seg_len if seg_len else 1
    dataset = SyntheticPairDataset(num_items=2 * batch, length_sec=crop, sample_rate=sample_rate)
    workdir = phase_workdir(f"chip_smoke_train_{name}")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        cuda_gru.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = train(cfg, dataset=dataset, max_iters=steps, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts, paths = cuda_gru.launch_counts(), cuda_gru.launch_paths()
    finally:
        os.chdir(cwd)
    log(f"[shipped] train {name}: {steps} iterations of train() ({segments} updates each): {train_s:.2f} s, "
        f"launches {counts}, by path {paths}, last loss {metrics['loss']:.6f} grad_norm {metrics['grad_norm']:.4f}")
    expected = {**{k: train_launches(segments * steps) for k in counts}, "gru_fwd": 0}
    want_paths = expected_train_paths(cfg, train_updates(segments * steps))
    if counts != expected or paths != want_paths:
        raise AssertionError(f"{name} training: launches {counts}, by path {paths}; expected {expected}, {want_paths}")
    if not (np.isfinite(list(metrics.values())).all()
            and all(bool(torch.isfinite(p).all()) for p in state.model.parameters())):
        raise AssertionError(f"{name} training produced non-finite values: {metrics}")

    step = make_train_step(cfg, with_carry=seg_len > 0)

    def iteration(state, clean, noisy):
        """One iteration of train(): an update per TBPTT segment, the carry passed on."""
        if not seg_len:
            return step(state, clean, noisy)
        tgru_h = state.model.init_tgru_state(clean.shape[0], cfg.featurizer.num_freqs, clean.device)
        for s in range(segments):
            sl = slice(s * seg_len, (s + 1) * seg_len)
            state, _, tgru_h = step(state, clean[:, sl], noisy[:, sl], tgru_h)
        return state

    clean, noisy = batch_of(dataset, batch, "cuda")
    iteration(state, clean, noisy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iter_ms = cuda_ms(lambda: iteration(state, clean, noisy), 3, 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_port_step(iteration, state, clean, noisy, segments, f"[shipped] train {name}")
    gru_ms = prof["device_ms_by_kind"].get("gru_kernels", 0.0)
    log(f"[shipped] train {name}: iteration {iter_ms:.2f} ms (CUDA events, replayed), device {prof['device_ms']:.2f} "
        f"ms of which the GRU kernels {gru_ms:.2f} ms, by kind {json.dumps(prof['device_ms_by_kind'])}")
    del step, state
    torch.cuda.empty_cache()
    report = train_graph_vs_body(f"[shipped] train {name}", cfg, lambda: create_train_state(cfg, device="cuda"),
                                 batches_of(dataset, batch, 2), seg_len)
    summary = {
        "model": name, "batch": batch, "crop_s": crop, "sample_rate": sample_rate, "segments": segments,
        "iterations": steps, "train_s": train_s, "iteration_ms_cuda_events": iter_ms,
        "audio_s_per_s": batch * crop / (iter_ms / 1e3), "peak_mem_gb": peak_gb, "launches": counts,
        "paths": paths, "final_loss": metrics["loss"], "profile": prof, "gru_kernels_device_ms": gru_ms,
        "graph_vs_body": report,
    }
    log(f"[shipped] train {name} {json.dumps({k: v for k, v in summary.items() if k not in ('profile', 'graph_vs_body')})}")
    torch.cuda.empty_cache()
    if name == "large16k":
        f32_cfg = float32_training(cfg)
        clean, noisy = batch_of(dataset, batch, "cpu")
        summary["bf16_vs_f32_on_card"] = compare_steps(
            f"large16k bf16 vs float32 on the card, batch {batch}", one_step(cfg, "cuda", clean, noisy),
            one_step(f32_cfg, "cuda", clean, noisy), BF16_GRAD_VS_F32, tag="[shipped]")
        summary["card_vs_cpu_bf16"] = compare_steps(
            "large16k bf16 card vs bf16 CPU, batch 4", one_step(cfg, "cuda", clean[:4], noisy[:4]),
            one_step(cfg, "cpu", clean[:4], noisy[:4]), BF16_GRAD_CARD_VS_CPU, tag="[shipped]")
        torch.cuda.empty_cache()
    return summary


def shipped_kernels(models: dict, cuda_gru, gru_ops) -> tuple[list, list]:
    """Phase 11 (e): the kernels at the launch shapes only the other shipped
    models give them, each against its plain version, phase 4's way:
    `gru_fwd` at proc48k's serving shapes (the 4 s clip, 1,602 frames), and
    all four training kernels at large16k's and proc48k's training shapes
    (batch 16 of 2 s crops), the FGRU in both directions: large16k's on the
    paths only it takes (the cluster forward, the cluster BPTT, the
    tensor-core reduction at H 256 / 512), beside the general BPTT and the
    SIMT reduction it took before. Returns (gru_fwd rows, training kernel
    rows)."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.models import TRUNet

    proc48 = models["proc48k"]
    frames = Denoiser._bucket(int(CLIP_SECONDS * proc48.featurizer.sample_rate), proc48.featurizer.hop_length) // (
        proc48.featurizer.hop_length) + 1
    fb = TRUNet(proc48.network, device="meta").bottleneck_freqs(proc48.featurizer.num_freqs)
    fh, th = proc48.network.fgru_hidden, proc48.network.tgru_hidden
    fwd_rows = [
        check_kernel(name, "registers", r, t, h, rev, 200 + seed, cuda_gru, gru_ops)
        for seed, (name, r, t, h, rev) in enumerate((
            ("proc48k_fgru_fwd", frames, fb, fh, False), ("proc48k_fgru_bwd", frames, fb, fh, True),
            ("proc48k_tgru", fb, frames, th, False)))
    ]
    train_rows = []
    for seed, name in enumerate(("large16k", "proc48k")):
        cfg = models[name]
        batch, frames = cfg.train.optimization.batch_size_per_device, crop_frames(cfg)
        fb = TRUNet(cfg.network, device="meta").bottleneck_freqs(cfg.featurizer.num_freqs)
        paths = ({"gru_fwd_train": "cluster", "gru_bwd": "cluster", "gru_dw_partial": "tensor_cores"}
                 if name == "large16k" else RESIDENT_TRAIN_PATHS)
        for i, (shape, r, t, h, rev) in enumerate((
                (f"{name}_batch{batch}_fgru_fwd", batch * frames, fb, cfg.network.fgru_hidden, False),
                (f"{name}_batch{batch}_fgru_bwd", batch * frames, fb, cfg.network.fgru_hidden, True),
                (f"{name}_batch{batch}_tgru", batch * fb, frames, cfg.network.tgru_hidden, False))):
            train_rows += check_train_kernels(shape, r, t, h, rev, 210 + 3 * seed + i, cuda_gru, gru_ops, paths)
    return fwd_rows, train_rows


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.models import TRUNet
    from tinyrecurrentunet_torch.ops import build, cuda_gru
    from tinyrecurrentunet_torch.ops import gru as gru_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.time()
    logs = build.build_all()
    log(f"[build] {sorted(logs)} in {time.time() - t0:.2f} s")
    for name, text in logs.items():
        log(f"[build:{name}] {text.strip()}")

    # 2. kernel against its plain version at the main path's shapes
    cfg = load_config(CONFIG)
    large = load_config(os.path.join(REPO, "config", "large16k.json"))
    clip = make_clip(cfg.featurizer.sample_rate)
    bucket = Denoiser._bucket(len(clip), cfg.featurizer.hop_length)
    frames = bucket // cfg.featurizer.hop_length + 1
    fb = TRUNet(cfg.network, device="meta").bottleneck_freqs(cfg.featurizer.num_freqs)
    net = cfg.network
    large_fb = TRUNet(large.network, device="meta").bottleneck_freqs(large.featurizer.num_freqs)
    shapes = [
        # name, path of gru_fwd, rows, T, H, reverse
        ("fgru_fwd", "registers", frames, fb, net.fgru_hidden, False),
        ("fgru_bwd", "registers", frames, fb, net.fgru_hidden, True),
        ("tgru", "registers", fb, frames, net.tgru_hidden, False),
        ("large16k_fgru_fwd", "cluster", frames, large_fb, large.network.fgru_hidden, False),
        ("large16k_fgru_bwd", "cluster", frames, large_fb, large.network.fgru_hidden, True),
        ("large16k_tgru", "cluster", large_fb, frames, large.network.tgru_hidden, False),
        # rows not a multiple of the row tile, T odd: one per path
        ("ragged_registers", "registers", 133, 7, net.tgru_hidden, True),
        ("ragged_cluster", "cluster", 133, 5, large.network.fgru_hidden, False),
        ("ragged_general", "general", 301, 9, 40, True),
    ]
    rows = [
        check_kernel(name, path, r, t, h, rev, seed, cuda_gru, gru_ops)
        for seed, (name, path, r, t, h, rev) in enumerate(shapes)
    ]
    for row in rows[6:]:
        if row["rows"] % row["rows_per_tile"] == 0 or row["T"] % 2 == 0:
            raise AssertionError(f"{row['shape']} is not ragged: {row}")
    main_rows = rows[:3]  # the three launches of one flagship denoise call
    # gru_fwd at the streaming path's launch shapes: one hop of the flagship,
    # 4 hops a call, 64 streams a call, one hop of large16k
    fh, th, lfh, lth = net.fgru_hidden, net.tgru_hidden, large.network.fgru_hidden, large.network.tgru_hidden
    stream_shapes = [
        # name, path of gru_fwd, rows, T, H, reverse
        ("stream_fgru_fwd", "registers", 1, fb, fh, False),
        ("stream_fgru_bwd", "registers", 1, fb, fh, True),
        ("stream_tgru", "registers", fb, 1, th, False),
        ("stream_chunk4_fgru_fwd", "registers", 4, fb, fh, False),
        ("stream_chunk4_fgru_bwd", "registers", 4, fb, fh, True),
        ("stream_chunk4_tgru", "registers", fb, 4, th, False),
        ("stream_64_fgru_fwd", "registers", 64, fb, fh, False),
        ("stream_64_fgru_bwd", "registers", 64, fb, fh, True),
        ("stream_64_tgru", "registers", 64 * fb, 1, th, False),
        ("large16k_stream_fgru_fwd", "cluster", 1, large_fb, lfh, False),
        ("large16k_stream_fgru_bwd", "cluster", 1, large_fb, lfh, True),
        ("large16k_stream_tgru", "cluster", large_fb, 1, lth, False),
    ]
    streaming_rows = [
        check_streaming_kernel(name, path, r, t, h, rev, 100 + seed, cuda_gru, gru_ops)
        for seed, (name, path, r, t, h, rev) in enumerate(stream_shapes)
    ]

    # 3. the serving path
    serving = serving_main_path(cfg, clip, cuda_gru)
    launches = serving["launches"]["gru_fwd"]

    # 4. the training kernels at the flagship training step's launch shapes
    train_cfg = float32_training(cfg)
    train_frames = crop_frames(train_cfg)
    train_shapes = [
        ("train_fgru_fwd", TRAIN_BATCH * train_frames, fb, net.fgru_hidden, False),
        ("train_fgru_bwd", TRAIN_BATCH * train_frames, fb, net.fgru_hidden, True),
        ("train_tgru", TRAIN_BATCH * fb, train_frames, net.tgru_hidden, False),
    ]
    train_rows = [
        row
        for seed, (name, r, t, h, rev) in enumerate(train_shapes)
        for row in check_train_kernels(name, r, t, h, rev, 10 + seed, cuda_gru, gru_ops)
    ]
    # gru_fwd_train at rows not a multiple of the row tile and T odd, both
    # directions, on each path
    ragged_fwd_shapes = [
        (path, r, t, h, rev)
        for path, r, t, h in (("registers", 1001, 13, 64), ("registers", 133, 7, 128),
                              ("cluster", 133, 5, 256), ("cluster", 19, 3, 512), ("general", 301, 9, 40))
        for rev in (False, True)
    ]
    ragged_fwd = [
        check_fwd_train_shape(f"ragged_{path}_h{h}_{'rev' if rev else 'fwd'}", path, r, t, h, rev, 60 + i,
                              cuda_gru, gru_ops)
        for i, (path, r, t, h, rev) in enumerate(ragged_fwd_shapes)
    ]
    # gru_fwd_train at large16k's training launch shapes, at its own batch
    large_batch = large.train.optimization.batch_size_per_device
    large_frames = crop_frames(large)
    large_fwd = [
        check_fwd_train_large("large16k_train_fgru", "cluster", large_batch * large_frames, large_fb,
                              large.network.fgru_hidden, 70, cuda_gru, gru_ops),
        check_fwd_train_large("large16k_train_tgru", "cluster", large_batch * large_fb, large_frames,
                              large.network.tgru_hidden, 71, cuda_gru, gru_ops),
    ]
    # gru_bwd at rows not a multiple of the row tile and T odd, both
    # directions, on each path
    ragged_bwd_shapes = [
        (path, r, t, h, rev)
        for path, r, t, h in (("registers", 1001, 13, 64), ("registers", 133, 7, 128), ("cluster", 133, 5, 256),
                              ("cluster", 19, 3, 512), ("general", 301, 9, 40))
        for rev in (False, True)
    ]
    ragged_bwd = [
        check_bwd_shape(f"ragged_{path}_h{h}_{'rev' if rev else 'fwd'}", path, r, t, h, rev, 40 + i,
                        cuda_gru, gru_ops)
        for i, (path, r, t, h, rev) in enumerate(ragged_bwd_shapes)
    ]

    # 11 (e), run here: the kernels at the launch shapes only the other shipped
    # models give, timed while torch.profiler still keeps its kernel records
    # (after the profiled training steps of phases 7 and 11 it lost whole
    # readings, 0 records of 10 calls, on two machines)
    t = time.time()
    models = {name: load_config(os.path.join(REPO, "config", f"{name}.json")) for name in (*SHIPPED, "tbptt16k")}
    shipped_fwd_rows, shipped_train_rows = shipped_kernels(models, cuda_gru, gru_ops)
    log(f"[shipped] kernels in {time.time() - t:.1f} s")

    # 5. the training path
    train_summary, train_counts = train_main_path(train_cfg, cuda_gru)

    # 6. the streaming path
    t6 = time.time()
    stream = streaming_main_path(cfg, clip, cuda_gru)
    log(f"[stream] phase 6 in {time.time() - t6:.1f} s")

    # 7. the training path in bf16, the config as shipped
    t7 = time.time()
    bf16_summary, bf16_counts = bf16_training_path(cfg, train_cfg, cuda_gru)
    log(f"[train-bf16] phase 7 in {time.time() - t7:.1f} s")

    # 8. quality: float32, bf16 and int8 serving on the 16-file testset
    t8 = time.time()
    quality = quality_path(cfg)
    log(f"[quality] phase 8 in {time.time() - t8:.1f} s")

    # 9. training as users run it: the procedural corpus, export, the
    # profiler hook, two ranks, the scaling ladder; phase 8's oracle
    t9 = time.time()
    proc_summary, proc_counts = procedural_training(cfg, clip, cuda_gru)
    profile_row = profiled_training(train_cfg)
    dp_report, dp_counts = data_parallel_step(train_cfg)
    nccl_report, _ = data_parallel_step(train_cfg, ranks=1, backend="nccl", graph_steps=DP_GRAPH_STEPS)
    ladder = scaling_ladder(cfg)
    if "oracle" not in quality["runs"]["float32"]:
        raise AssertionError("the quality result has no oracle report")
    log(f"[quality] oracle, all files: {json.dumps(quality['runs']['float32']['oracle']['all'])}")
    log(f"[train-users] phase 9 in {time.time() - t9:.1f} s")

    # 10. export (ONNX, TorchScript, the programs, the int8 pack), the
    # latency bench across engines, gru_bench and the kernel A/B
    t10 = time.time()
    export_summary, export_counts = export_and_benches(cfg, cuda_gru)
    log(f"[export] phase 10 in {time.time() - t10:.1f} s")

    # 11. the other shipped models, large16k and proc48k: served, streamed,
    # scored and trained (with tbptt16k) on the card; part (e) ran after phase 4
    t11 = time.time()
    torch.cuda.empty_cache()
    shipped, part_s = {}, {}
    for part, run in (
        ("offline", lambda: {name: shipped_offline(name, models[name], cuda_gru) for name in SHIPPED}),
        ("streaming", lambda: {name: shipped_streaming(name, models[name], cuda_gru) for name in SHIPPED}),
        ("quality", lambda: {name: shipped_quality(name, models[name]) for name in SHIPPED}),
        ("training", lambda: {name: shipped_training(name, models[name], steps, cuda_gru)
                              for name, steps in SHIPPED_TRAINING}),
    ):
        t = time.time()
        shipped[part] = run()
        part_s[part] = time.time() - t
        log(f"[shipped] {part} in {part_s[part]:.1f} s")
        torch.cuda.empty_cache()
    log(f"[shipped] phase 11 in {time.time() - t11:.1f} s: {json.dumps(part_s)}")

    # 12. the training CLI over every visible card, --data_parallel with no
    # launcher, then resumed
    t12 = time.time()
    torch.cuda.empty_cache()
    cli_row = cli_data_parallel(cfg)
    log(f"[cli] phase 12 in {time.time() - t12:.1f} s")

    kernel = {
        "name": "gru_fwd",
        "route": "cuda",
        "source": "tinyrecurrentunet_torch/ops/csrc/gru_fwd.cu",
        "replaces": "tinyrecurrentunet_tpu/ops/pallas_gru.py:32",
        "launches": launches,
        # the bucket's first call: graphs.WARMUP eager runs of the body, then the captured one
        "capture_call_launches": sum(serving["capture_launches"]["gru_fwd"].values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "shapes": rows,
        # one hop of the streaming path: 3 launches (phase 6)
        "streaming_launches": stream["counts"]["gru_fwd"],
        "streaming_hops": stream["hops"],
        "streaming_shapes": streaming_rows,
        # phase 10: the eager model at the export shape (3), rt_bench's engines
        # (3 a call of the full clip and of a frame), gru_bench's kernel calls
        "export_launches": export_counts["export_eager"]["gru_fwd"],
        "rt_bench_launches": export_counts["rt_bench"]["gru_fwd"],
        # a replay of each of rt_bench's graph engines (full clip, a frame, int8)
        "rt_bench_graph_launches": {k: v for k, v in export_summary["rt_bench"]["gru_fwd_per_call"].items()
                                    if not k.startswith("torchscript")},
        # phase 9 (a): a replayed validation pass of the trained flagship
        "eval_graph_launches": proc_summary["validation"]["launches"]["replayed_call"]["gru_fwd"],
        "gru_bench_launches": export_counts["gru_bench"]["gru_fwd"],
        # phase 12: the training CLI's first run, each rank (rank 0's validation passes)
        "cli_launches_per_rank": [c["gru_fwd"] for _, c in sorted(cli_row["runs"][0]["launches"].items())],
        "gru_bench_max_abs_err": max(r["max_abs_err"] for r in export_summary["gru_bench"]),
    }
    # phase 11: the other shipped models, 3 a denoise call and 3 a streaming
    # hop each; gru_fwd at proc48k's serving shapes
    kernel["shipped_launches"] = {
        **{f"{name}_offline": r["launches"]["gru_fwd"] for name, r in shipped["offline"].items()},
        **{f"{name}_streaming": r["counts"]["gru_fwd"] for name, r in shipped["streaming"].items()},
    }
    kernel["shipped_shapes"] = shipped_fwd_rows
    kernel["max_abs_err"] = max(kernel["max_abs_err"], max(r["max_abs_err"] for r in streaming_rows),
                                kernel["gru_bench_max_abs_err"], max(r["max_abs_err"] for r in shipped_fwd_rows))
    kernel["max_err"] = kernel["max_abs_err"]
    kernel["kernel_ms"] = kernel["ms"]
    kernels = [kernel]
    replaces = {
        "gru_fwd_train": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:74",
        "gru_bwd": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:118",
        "gru_dw_partial": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:118",
        "gru_dw_sum": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:118",
    }
    for name, site in replaces.items():
        mine = [r for r in train_rows if r["kernel"] == name]  # one train step's three launches
        entry = {
            "name": name,
            "route": "cuda",
            "source": "tinyrecurrentunet_torch/ops/csrc/gru_train.cu",
            "replaces": site,
            "launches": train_counts[name],
            # the bf16 training path (phase 7): the same kernels at bf16 edges
            "bf16_train_launches": bf16_counts[name],
            # phase 9: the procedural bf16 run (3 steps), each rank of the 2-rank step
            "procedural_train_launches": proc_counts[name],
            "data_parallel_launches_per_rank": [c[name] for c in dp_counts],
            # phase 9 (c): a replayed step of the one-rank NCCL group, the graph
            # holding its collectives
            "dp_graph_launches_per_rank": [gvb["calls"][-1]["launches"][name]
                                           for gvb in nccl_report["graph_vs_body"]],
            # phase 10: the kernel A/B's run, 3 a step of its "always" row and
            # none of its "never" row
            "kernel_ab_launches": export_counts["kernel_ab"][name],
            # phase 12: the training CLI's first run (5 steps), each rank
            "cli_launches_per_rank": [c[name] for _, c in sorted(cli_row["runs"][0]["launches"].items())],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # dWh and dbh are sums over 257k row-steps, entries up to ~1e3:
            # their tolerance is relative (DW_RTOL)
            "max_rel_err": max((r["max_rel_err"] for r in mine if r["max_rel_err"] is not None),
                               default=None),
            # device time (torch.profiler), the PyTorch call's too; call_ms
            # by CUDA events around the wrapper
            "ms": sum(r["ms"] for r in mine),
            "call_ms": sum(r["call_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine) else "operations",
            "library_ms": sum(r["library_ms"] for r in mine),
            "shapes": mine,
        }
        # phase 11: train() on the other shipped configs; the kernel at
        # large16k's and proc48k's training shapes
        entry["shipped_train_launches"] = {cfg_name: r["launches"][name]
                                           for cfg_name, r in shipped["training"].items()}
        theirs = [r for r in shipped_train_rows if r["kernel"] == name]
        entry["shipped_shapes"] = theirs
        entry["max_abs_err"] = max(entry["max_abs_err"], max(r["max_abs_err"] for r in theirs))
        if entry["max_rel_err"] is not None:
            entry["max_rel_err"] = max(entry["max_rel_err"], max(r["max_rel_err"] for r in theirs))
        if name == "gru_fwd_train":
            # the resident kernel of gru_fwd.cu, with its residuals saved; the
            # general kernel (any other H) is in gru_train.cu
            entry["source"] = "tinyrecurrentunet_torch/ops/csrc/gru_fwd.cu"
            entry["general_source"] = "tinyrecurrentunet_torch/ops/csrc/gru_train.cu"
            entry["max_abs_err"] = max(r["max_abs_err"] for r in mine + ragged_fwd + large_fwd + theirs)
            entry["general_ms"] = sum(r["general_ms"] for r in mine)
            entry["paths"] = sorted({r["path"] for r in mine + ragged_fwd + large_fwd + theirs})
            entry["ragged_shapes"] = ragged_fwd
            entry["large16k_shapes"] = large_fwd
        if name == "gru_bwd":
            entry["max_abs_err"] = max(r["max_abs_err"] for r in mine + ragged_bwd + theirs)
            entry["general_ms"] = sum(r["general_ms"] for r in mine)
            entry["paths"] = sorted({r["path"] for r in mine + ragged_bwd + theirs})
            entry["ragged_shapes"] = ragged_bwd
        if name == "gru_dw_partial":
            entry["simt_ms"] = sum(r["simt_ms"] for r in mine)
            entry["paths"] = sorted({r["path"] for r in mine + theirs})
        kernels.append(entry)
    log(json.dumps({"train_bf16": {k: v for k, v in bf16_summary.items() if k != "profile"},
                    "quality": {k: v for k, v in quality.items() if k != "runs"},
                    "train_users": {"procedural": proc_summary, "profile": profile_row,
                                    "data_parallel": dp_report, "data_parallel_nccl_one_rank": nccl_report,
                                    "scaling": ladder, "cli": cli_row},
                    "export": export_summary, "shipped": shipped}))
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
