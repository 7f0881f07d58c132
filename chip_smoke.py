#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi), library versions;
  2. the build of every CUDA kernel from src/repro_torch/kernels/csrc
     (one nvcc per source, all started together);
  3. every kernel against its plain PyTorch version on the card at the
     main path's shapes and at ragged ones, with the stated tolerances,
     and the bitwise determinism of the Lloyd, min-distance, RBF,
     fused-KL-loss and flash-attention kernels across two runs (the Lloyd
     kernel also for several clients in one launch, one launch a call,
     and on its wide route at flattened image widths, 784 and 3072, two
     a call; the min-distance kernel also at lm_tokens' and the image
     widths, and with a threshold passed as a float; the RBF kernel also
     at the image path's four KuLSIF shapes, 784 and 3072 wide, on
     pixel-like rows; the Lloyd, min-distance and RBF
     kernels on inputs with a NaN row, a ±inf row and a -inf row, or a
     NaN centroid, with NaN and ±inf where the plain version has them and
     equal masks and argmins; flash attention also on strided views in
     the model's layout, and its autograd function's gradients against
     autograd of the plain version); then the cohort engine's routes, each
     kernel over a client axis: the Lloyd kernel for 10 and 34 clients
     against each client's own launch, bitwise, on both routes; the
     min-distance kernel for C clients (a shared x, a report, or each
     client's own, a calibration; thresholds a device tensor) against
     each client's 2-D launch bitwise and the plain version, also on
     non-finite inputs; the RBF kernel on a shared a against C clients' b
     (one launch of the stacked b) against each client's launch bitwise,
     sentinel rows exactly 0; the fused KL loss over clients (ragged
     weights, an all-zero lane) against the plain version and each
     client's 2-D launch bitwise, and through a 16-step distill phase
     with a lane whose weights are zero at every step (a sampled-out
     lane: its loss and gradient 0, its weights bitwise unchanged); flash
     attention under vmap at the token cohort's training step (10
     clients, (64, 32/8, 16, 128), the model's layout): one launch on the
     folded batch, each client's slice bitwise its own launch, forward
     and q/k/v gradients against the vmapped plain version, and a folded
     batch past grid axis z's 65535 launched in chunks; and
     benchmarks/scale.py's fleet shapes, 1024 clients a launch: B1 at
     (16, 50, 10), B2's report at (64, 50, 10) and calibration at (16, 50,
     10), the fused loss at (16, 10), then a 1024-lane grid on every
     client-axis route (B1 and B2 wide, B5 over a stacked b) within CUDA's
     grid limits; B6 at hubert-xlarge's head width 80 on both routes,
     causal and full (the short route also over an output whose memory
     held NaN, so an unwritten chunk fails), and at the vlm's
     cross-attention shapes over 1601 vision keys, with gradients; B6 at
     the (1, 2) mesh's local heads of the model axis's runs (hubert's 8
     of 16 heads of 80, full; the vlm's 32 of 64 query heads over 4 of 8
     kv heads, causal, and over 1601 vision keys at the training step's
     and the prefill's shapes); the fused loss's wide-row route (K > 1024,
     a cluster of blocks a row) at its first widths, on both sides of the
     portable cluster size, at the FD trainers' vocabularies and past
     shared memory, each with masked, zero and no weights, and over
     clients at (3, 16, 50304); B6's long route (Sq > 32) at Sq 33 and
     300, GQA groups 1-16 (3 and 6 among them, which straddle a tile's
     positions), h 64, 80 and 128, causal and full, at train_100m's and
     hubert's shapes that take one key group a block, over 1601 keys, on
     poisoned outputs, and its gradients at GQA 16 and 3;
  4. k-means fits through the kernel on the card against fits through
     the plain version on the card and on the CPU, from the same seeds (an
     unclustered input and every client of the main path's strong and
     weak runs): n_iter, assignments, centroids, DRE thresholds, reported;
     the cohort's batched fit and calibration against each client's own
     fit on the card: n_iter, assignments, centroids, thresholds, bitwise
     (asserted); the proxy's Gaussian mechanism (core/privacy.py) with a
     CUDA generator: the main path's proxy rows clipped, the noise's std
     within 10% of sigma, and a KMeans-DRE (B1, B2) filtering privatized
     rows, balanced accuracy above 0.8 at epsilon 100;
  5. small fed_train runs (edgefd and selective-fd on features, edgefd on
     mnist_like and cifar_like images, cuDNN's TF32 turned on first to
     check that the entry point pins fp32) on the card against the same
     runs on the CPU (which takes the plain versions), and a small
     lm_tokens edgefd run (the reduced granite backbone) on the card
     against the CPU from the same initial weights, on the loop engine
     and on the cohort engine (4 clients: every flash-attention launch's
     batch a multiple of the 4 lanes, and a second card run bitwise equal
     to the first, wall_s and phase_s apart); small cohort-engine
     runs card vs CPU (edgefd, selective-fd and fkd strong, the mixed zoo
     over 6 clients, and over 9 in waves of 2); partial-participation
     overlap runs on both engines (fraction 0.5, fixed phase costs) card
     vs CPU, participants, staleness, bytes and the simulated timeline
     equal; robustness runs on both engines (tests/test_faults.py's
     scenarios: each fault mode, trimmed_mean, median and krum_row under a
     colluding flip, 3 edge aggregators with a subset and with
     Selective-FD, quarantine) card vs CPU, scrubbed rows, quarantined
     clients, participants and bytes equal; the state layer: a run's
     snapshots at every boundary of round 1 (overlap, fraction 0.75,
     staleness decay 0.5, fixed costs) written with save_state on the
     card and restored into a fresh CPU experiment, on each engine, one
     the other way round, and a selective-fd run's (B5 on the path), each
     drained and held to the source's uninterrupted run (participants,
     staleness, bytes and the timeline equal), and the divergence
     watchdog card vs CPU (rollbacks, quarantined clients and finiteness
     equal);
  6. the main path: fed_train, 10 clients with MNIST's split sizes
     (n_train 60000, n_test 10000), 1 round, proxy batch 512 — edgefd and
     selective-fd, strong and weak, and the seven methods without a kernel
     of their own (fedmd, feded, dsfl, fkd, pls, indlearn, server_distill),
     strong — the image path at the same sizes with the Tables I/II CNN
     zoo (mnist_like edgefd strong and weak and selective-fd strong,
     cifar_like with n_train 50000 edgefd and selective-fd strong), each
     run's peak device memory, a non-finite loss passing only where the
     same phase rerun in float64 leaves float32's range too (a
     divergence) — then the transformer scenario at
     granite-8b's widths
     (d_model 4096, 32/8 heads of 128, d_ff 14336; depth cut to 2 layers
     and vocab to the 32 labels): lm_tokens edgefd strong, 10 clients,
     n_train 6000, n_test 1000, 1 round, batch 64, proxy batch 256, with
     its peak device memory; each kernel's launch count (counts set to 0
     just before and read just after), the Lloyd kernel's launches by
     (d, k) and by route, the min-distance kernel's by class (calibration
     or report, d, k) and the RBF kernel's by shape and width, and the
     fused KL loss launched once per distill step; then the cohort
     engine's path, its launches counted from 0: edgefd strong and weak,
     selective-fd strong and fkd strong at the same sizes, each held to
     its loop run; the mixed zoo over 100 clients (iid, n_train 60000)
     unwaved, in waves of 16 and on the loop engine, held to each other;
     mnist_like edgefd strong and weak (ten one-client cohorts) each held
     to a loop run, both engines with cuDNN's deterministic algorithms;
     lm_tokens edgefd strong at granite-8b's widths, its 10 clients
     stacked on the card unwaved, held to the loop run (its peak device
     memory, round and phase seconds beside the loop's, flash attention's
     launches by folded batch: a whole number of forwards of the layers,
     every batch a multiple of 10);
     asserting one Lloyd launch an iteration a uniform cohort, one
     min-distance launch a cohort a report and a calibration, two RBF
     launches a cohort a report, one fused-loss launch a cohort a distill
     step; then the full scheduler's path, its launches counted from 0:
     128 clients at fraction 0.5 (sync and overlap on the cohort engine,
     sync on the loop, held to each other), the mixed zoo over 30 clients
     with concurrent cohorts off and on under fixed costs (the timeline
     equal to a CPU run's), benchmarks/scale.py's heavy traffic (churn,
     dropout, bursty arrivals, waves of 32) with its 4 edge aggregators
     held to a flat server's run, selective-fd and fkd
     under round-robin participation held to their loop runs; each run's
     simulated makespan, rounds a second and staleness; then the
     robustness path, its launches counted from 0: benchmarks/robust_agg.py's
     accuracy knobs at n_train 60000 (the fault-free mean, then a
     colluding flip at 0.3 under the mean, trimmed_mean, median and
     krum_row, final accuracies printed, the trimmed_mean run also on the
     loop engine held to its cohort run), quarantine (iid, 10 clients:
     every Byzantine client quarantined and out of the next round), a nan
     attack under the sanitize pass (rows scrubbed every round, finite
     losses); then the fleet path, its launches counted from 0:
     benchmarks/scale.py's headline_c16k_w1k (16384 clients, waves of
     1024, 8 edges, 2 rounds) and traffic_c1k (1024 clients, waves of 256,
     4 edges, fraction 0.5, bursty arrivals, churn, dropout), asserting
     one B1 launch a wave an iteration, one B2 launch a wave a calibration
     and a report, one fused-loss launch a wave a distill step, printing
     set-up and round seconds, peak device memory and bytes_up beside
     BENCH_scale.json's; then the resumable service
     (launch/fed_serve.py) at the main path's width as subprocesses
     (``--serve`` below), its launches counted: the loop engine in sync
     and the cohort engine in overlap (fraction 0.75, decay 0.5) each
     killed by its crash hook in round 1 (SIGKILL, a checkpoint and the
     log sidecar left), resumed, and held bit for bit to an
     uninterrupted run (wall_s and phase_s apart), then the watchdog
     under a nan burst (clean, broken, guarded runs: rollbacks,
     quarantine, finite logs, pre-burst rounds equal); each checkpoint's
     bytes and write seconds, the resume's rebuild and overlay seconds, a
     fresh start's build and the watchdog's snapshot seconds printed;
     then the device mesh (``--mesh-child`` ranks of a torch.distributed
     group on a file store, the card's name and power limit beside each
     run): (a) a world of one over NCCL, a small mnist_feat cohort run on
     num_devices=1 and on (1, 1) bitwise the unsharded engine's; lm_tokens
     edgefd strong at granite-8b's widths, 4 clients, 1 round, unsharded,
     then (b) on two ranks of the one card over gloo on the 1-D client
     mesh and (c) on the (1, 2) mesh (each client's heads, ff and vocab
     split over the ranks), each held to the unsharded run (losses rtol
     1e-3, accuracies within a test sample), every rank's logs equal, each
     rank's state bytes and allocator peak printed beside the unsharded
     run's and held at (c) to 0.55 and 0.77 of it, (c)'s state then
     gathered to rank 0 alone, a lane row of a leaf at a time (timed),
     each leaf's norm within rtol 1e-3 of the unsharded run's, (b) and
     (c) each in a world of fresh ranks, each rank's own host peak (its
     resident set sampled in the rank) printed beside ``VmHWM`` where the
     kernel has it and ``ru_maxrss`` (ROADMAP C11, C12), B6
     launched at (c)'s local 16/4 heads and checked there
     against its plain version; each rank opens its group through the
     port's ``fed.mesh.init_distributed``; (d) token clients of the ssm
     and hybrid families (ROADMAP A11.7) at published widths, one group
     each (xlstm-350m's mLSTM and sLSTM blocks; recurrentgemma-2b's two
     RG-LRU blocks and its local attention), vocab 32, at (c)'s sizes,
     unsharded, then on (1, 2) over gloo: held to the unsharded run as
     (c), each rank's state bytes printed beside it, B1, B2 and the fused
     loss launched on every rank, B6 on none; then the trainer path (ROADMAP
     A11): (a) ``launch.train`` on granite-moe-1b-a400m whole (24 layers,
     full widths, batch 8 × 128, AdamW on the reference's warmup-cosine
     rate, 12 of its 50 steps), the first batch's loss falling, seconds a
     step, tokens a second and the allocator's peak printed, B6 launched on its
     long route, two more steps profiled; then the first 3 steps again
     from the same weights, bitwise (a)'s, each step's loss held within
     rtol 1e-3 to the plain attention's on the same weights and batch;
     (b) ``decode_demo.prefill_then_decode`` at full size (batch 4,
     prompt 16, 16 new tokens, no expert dropping), the replay's logits
     held to the prefill's, tokens a second printed; (c) the FD trainer
     at granite-moe's widths and 2 layers: ``fd_round_local`` on two
     clients, then ``make_fd_train_step`` on two ``--mesh-child`` ranks
     of the one card over gloo, one client a rank, held to it (losses
     rtol 1e-4, updated leaves' norms rtol 1e-5); (d) xlstm-350m and (e)
     recurrentgemma-2b (ROADMAP A11.1): ``launch.train`` as (a) ((d)
     whole for 8 steps, one more on the sLSTM's plain-autograd route;
     (e) at 18 of its 24 layers for 10 steps, widths as published: the
     cuts below),
     the first batch's loss falling and no kernel launched; decode as (b)
     on the whole model (the replay held to the prefill); and
     ``fd_round_local`` on two clients at one group (2 and 3 layers, a
     depth cut), B1 and the fused loss launched at the archs' widths and
     vocabularies; each model's built parameter count beside
     ``cfg.param_count()``; (f) hubert-xlarge whole (ROADMAP A11.2):
     ``launch.train``'s 25 steps of 8 x 128 frames, the first batch's loss
     falling, B6 on its long route at h = 80, full, 48 launches a step, 3
     steps again held to the plain attention, 2 profiled; (g)
     llama-3.2-vision-90b at full widths and a depth cut, its gates at
     0.5: one group's train_loss forward and backward held to the plain
     attention (loss and every gradient's norm), two groups' prefill,
     ``init_cache(vision=, params=)``, the prompt's replay held to the
     prefill and 16 new tokens, and ``launch.train.main --reduced``;
     then the model axis (ROADMAP A11.7), one world of two
     ``--mesh-child`` ranks of the card over gloo on the (1, 2) mesh,
     each run held to the unsharded run of the same weights and batch,
     drawn here first: (h) hubert-xlarge whole, one AdamW step (loss and
     every gradient leaf's norm rtol 1e-3, B6 at the local 8 of 16 heads
     of 80, 48 launches a rank), a second timed, a third under bf16_psum
     (loss within 1e-2 relative), each rank's peak and the step's
     all-reduces and gathers with their bytes; (i) the vlm's one group's
     train_loss forward and backward at (g)'s batch (loss and every
     gradient's norm rtol 1e-3; B6 at 32 of 64 query heads over 4 of 8
     kv heads) and its two groups' prefill and decode (the tokens equal,
     the logits within 2e-2); (j) xlstm-350m, recurrentgemma-2b and
     granite-moe-1b-a400m whole, prefill and decode at (b)'s sizes (the
     tokens equal and the logits within 1e-3; xLSTM's logits within
     1e-2 relative and its greedy choices where the unsharded margin
     clears twice the gap: float32 through its gating parts any two
     orders of summation by more), new tokens a second beside the
     unsharded run's; the dry run (launch/dryrun.py) held to the card
     inside these runs: its meta-device count of (a)'s step (fp32,
     unsharded, the batch's distinct tokens) equal to the FLOPs
     FlopCounterMode counts in one real step of (a)'s model on the card
     on the plain attention, (a)'s seconds a step no faster than the
     count's roofline bound (the card's fp32 peak and HBM rate, its share
     printed), the count's peak within 25% of (a)'s allocator peak, and
     (h)'s all-reduces and gathers and their bytes on each rank equal to
     the recording mesh's for that rank; then examples_torch/'s five
     scripts, each a subprocess on the card (quickstart,
     edgefd_vs_baselines, fd_transformers in a world of one and
     train_100m at 60 of its 300 steps at once, then fed_shardmap on
     eight gloo ranks of the card) exiting 0, their seconds printed;
  7. each kernel's time (CUDA events around many calls, the host's
     per-call work included), its plain version's time, a PyTorch library
     call's time where one call computes the same function, its bound
     from the shapes, and the device-only times of each with the host's
     per-call work taken out (the Lloyd, min-distance and RBF kernels at
     each of their shapes, the image path's among them and the Lloyd
     kernel's wide route too, with the share of the bound and the main
     path's launches times the gap, the
     min-distance kernel beside an empty kernel's launch); one distill
     step's loss and gradient by
     four routes in turns (fused kernel, the per-sample kernels under
     autograd, plain, library) beside an empty kernel's launch and the
     autograd engine's floor; each route over clients at the cohort's
     shapes, beside C launches of its 2-D route (flash attention on the
     token cohort's folded batch of 640, also through the vmap rule and
     beside scaled_dot_product_attention); B1, B2's report and the
     fused loss at the fleet's shapes (1024 clients a launch); B6 at the
     (1, 2) mesh's local heads, a rank's folded batch of 256; B6 at the
     trainer's (8, 16, 128, 64) with 8 kv heads and the fused loss at the
     FD trainer's (16, 49155), (16, 50304) and (16, 256000), B1 at its
     fits' (8, 1024, 1) and (8, 2560, 1); B6 at h = 80 on both routes and
     at the cross-attention shapes over 1601 keys, and at the (1, 2)
     mesh's local heads of (h) and (i), beside
     scaled_dot_product_attention; each of the trainer path's loss and
     B6 rows with the share of its bound and its launches x (device -
     bound).
The next-to-last line is the kernels JSON, the last line the ok JSON.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.

    python3 chip_smoke.py --time-flash [--src DIR]
    python3 chip_smoke.py --time-kernels [--src DIR]
    python3 chip_smoke.py --serve FED_SERVE_ARGS...
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --trainer
    python3 chip_smoke.py --ssm-witness
    python3 chip_smoke.py --examples
    python3 chip_smoke.py --mesh-child OUT SPEC

time only B6 at the transformer path's shapes, per call and device only,
in both layouts, or only B1 (k = 1, 2, 3, 10, 64, and its wide route at
the image path's shapes), B2 (every main-path class and the image widths)
and B5 (its fit's and a report's shapes, private sizes even and odd, and
at the image widths), beside an empty kernel, then the fused loss at the
main path's (64, 10) and the FD trainers' wide rows and B6 at its long
route's trainer, encoder, vlm and model-axis shapes and its short route's
(``TIMED_KL``, ``TIMED_ATTN``), from the package under DIR
(default: this checkout's src/); run one for two trees in turns to compare
them on one card. ``--serve`` runs ``python -m repro_torch.launch.fed_serve
FED_SERVE_ARGS`` in-process with the launch counters and timers of phase 6
around it (a ``serve-stats {json}`` line after every node). ``--mesh``
runs phases 1 and 2 and the mesh path alone (with its phase-7 row),
``--trainer`` the trainer path alone (with its rows), ``--ssm-witness``
the xLSTM decode's witness (``run_ssm_witness``), ``--examples`` the
build and examples_torch/ alone; ``--mesh-child``
is one rank of the mesh path, of the trainer path's (c) or of the model
axis (``mesh_child``).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s outside
# the tensor cores; every kernel here is fp32 CUDA-core work
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
TEMPERATURE = 3.0
# tolerances, as in tests/test_torch_kernels_ref.py
LLOYD_RTOL = LLOYD_ATOL = 1e-5
KL_RTOL, KL_ATOL = 1e-5, 1e-6
# min distance: |Δd²| ≤ rtol·(x² + c²) + atol; RBF: |ΔK| ≤ K·rtol·(a² +
# b²)/(2σ²) + atol — each relative to the terms the matmul form cancels
DIST_RTOL = DIST_ATOL = 1e-5
RBF_RTOL, RBF_ATOL = 1e-5, 1e-6
SIGMA = 4.0                          # Selective-FD's KuLSIF bandwidth
MAIN_LLOYD = dict(n=6000, d=50)      # one strong client's private set
MAIN_KL = (64, 10)                   # one distill step: batch x classes
# the fused loss: a feature-path and FedDF-student step, an lm_tokens
# distill step and its proxy batch, a ragged grid (19 blocks of 16 rows,
# the last part-full), a wide row, and one past 1024 classes (the wide-row
# route, one block a row)
KL_LOSS_SHAPES = (MAIN_KL, (64, 32), (256, 32), (300, 10), (4096, 1000),
                  (5, 1500))
KL_WEIGHTS = ("masked", "none", "zero")
# the fused loss's wide-row route (K > 1024: a cluster of ceil(K / 8192)
# blocks a row, at most 16): the first width past the register route (1
# block), a ragged one-block row, the first of 2 blocks, the portable
# clusters' last size (8) and the first non-portable one (9), the FD
# trainers' vocabularies (7, 7 and 16 blocks), and a row whose chunks do
# not fit shared memory (re-read at each pass)
KL_WIDE_SHAPES = ((16, 1025), (16, 4097), (16, 8193), (16, 65536),
                  (16, 65537), (16, 49155), (16, 50304), (16, 256000),
                  (3, 500000))


def kl_ds_atol(k):
    """ds's atol at K columns: ``KL_ATOL`` up to the register route's 1024;
    past it scaled by 1024 / K, as ds's entries shrink with the row's mean
    probability 1 / K (at 256000, ~1e-6 an entry: a flat 1e-6 would pass
    a ds halved or zeroed)."""
    return KL_ATOL * min(1.0, 1024 / k)
MAIN_DIST = (512, 50, 1)             # one strong client's report: t, d, k
WIDE_DS = (784, 3072)                # mnist_like / cifar_like, flattened
# a client's private set on the image path: MNIST's 60000 and CIFAR-10's
# 50000 training images over 10 clients
IMAGE_N = {784: 6000, 3072: 5000}
# B2's shapes: feature-path reports (strong, weak) and calibrations over a
# client's private set; lm_tokens' report and calibration; the image
# path's (mnist_like strong and weak, cifar_like strong); flattened images
# at 10 centroids (the iid scenario)
DIST_SHAPES = (MAIN_DIST, (512, 50, 3), (6000, 50, 1), (6000, 50, 3),
               (256, 16, 1), (600, 16, 1), (512, 784, 1), (512, 784, 3),
               (6000, 784, 1), (6000, 784, 3), (512, 3072, 1),
               (5000, 3072, 1), (512, 784, 10), (512, 3072, 10))
MAIN_RBF = (512, 6000, 50)           # k_tp of one report: proxy x private
# B1's centroid counts: strong (1), weak (a client's labels), iid (10), and
# the widest instance; B5's four shapes: a KuLSIF fit's K11 and K12, a
# report's k_ta and k_tp, each private size also odd (its rows then start
# inside a 32-byte sector)
LLOYD_KS = (1, 2, 3, 10, 64)
# B1's wide route (two launches) on the image path: a client's private set
# at the strong and weak scenarios' centroid counts, and 10 (iid)
LLOYD_WIDE = ((6000, 784, 1), (6000, 784, 3), (5000, 3072, 1),
              (6000, 784, 10), (6000, 3072, 10))
RBF_SHAPES = ((256, 256, 50), (256, 6000, 50), (512, 256, 50), MAIN_RBF,
              (256, 6001, 50), (512, 6001, 50))
# the four KuLSIF shapes on flattened images (Selective-FD's fit and
# report), the private sets odd-sized as most of the image path's are
RBF_IMAGE_SHAPES = tuple((n, m, d) for d in WIDE_DS
                         for n, m in ((256, 256), (256, IMAGE_N[d] + 1),
                                      (512, 256), (512, IMAGE_N[d] + 1)))
# flash attention: |Δo| ≤ atol + rtol·|o| — f32 FMAs summed in another
# order than cuBLAS's, over at most 4096 keys
ATTN_RTOL, ATTN_ATOL = 1e-5, 2e-5
# a training step at granite-8b's widths: batch, heads, kv heads, S, h
MAIN_ATTN = (64, 32, 8, 16, 128)
ATTN_SHAPES = (MAIN_ATTN,
               (3, 32, 8, 300, 128),      # ragged S (two 256-blocks on TPU)
               (16, 4, 1, 16, 16),        # the reduced backbone, GQA 4
               (4, 8, 8, 40, 64),         # GQA 1, two small query tiles
               (1, 32, 8, 4096, 128),     # one long causal sequence
               # the short route (Sq <= 32) beyond the main path's shape
               (16, 16, 2, 16, 128),      # qwen2.5-3b's 16/2: two row tiles
               (4, 128, 8, 16, 128),      # llama3-405b's 128/8: four
               (64, 32, 8, 1, 128),       # Sq = 1
               (16, 32, 8, 32, 128),      # Sq = 32: two row and key tiles
               (16, 32, 8, 16, 64),       # h 64 and 32 at GQA 4
               (16, 32, 8, 16, 32))
# the transformer path's launch shapes: a training or distill step, a
# report's proxy batch, an eval batch (timed also in the model's layout)
PATH_ATTN = (MAIN_ATTN, (256, 32, 8, 16, 128), (512, 32, 8, 16, 128))
# B6's long route (Sq > 32) at GQA groups 1, 2, 4, 8 and 16 and head
# widths 64, 80 and 128, at the shortest long Sq (33: a second,
# one-position query tile at group 1) and a ragged one (300), each causal
# and full; groups 3 and 6, which do not divide the 64-row tile (a tile's
# rows straddle positions); and items >= 2 x SMs (one key group a block)
# at h 64 and 80: train_100m's (12 heads over 4 kv heads, batch 8, S 256)
# and hubert at batch 16
LONG_ATTN = ((2, 8, 8, 33, 64), (2, 16, 8, 300, 80), (2, 16, 4, 33, 128),
             (2, 16, 2, 300, 64), (2, 32, 2, 33, 80), (2, 16, 1, 300, 128),
             (1, 16, 1, 33, 64), (2, 8, 8, 300, 80), (2, 12, 4, 300, 80),
             (2, 12, 2, 33, 128), (8, 12, 4, 256, 64),
             (16, 16, 16, 128, 80))
# depth cut to keep the script inside its time with the mesh path: the
# main path's and the cohort path's runs take 1 round (were 3, then 2:
# the model axis's runs took their time; edgefd strong still passes 0.7
# after one), the full-width lm_tokens runs 1 (were 3, then 2: the
# encoder and vlm families' runs took their time)
MAIN_ROUNDS = 1
LM_ROUNDS = 1
LM_LR = 5e-4          # see run_lm_full_width
METHODS_WITHOUT_KERNELS = ("fedmd", "feded", "dsfl", "fkd", "pls",
                           "indlearn", "server_distill")
# the image path at the paper's split sizes: (dataset, method, scenario,
# n_train), 10 clients, n_test 10000, MAIN_ROUNDS rounds, proxy batch 512
IMAGE_RUNS = (("mnist_like", "edgefd", "strong", "60000"),
              ("mnist_like", "edgefd", "weak", "60000"),
              ("mnist_like", "selective-fd", "strong", "60000"),
              ("cifar_like", "edgefd", "strong", "50000"),
              ("cifar_like", "selective-fd", "strong", "50000"))


def log(msg: str) -> None:
    print(msg, flush=True)


def fmt(ms) -> str:
    return "not measured (host-bound)" if ms is None else f"{ms:.5f}"


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call over ``iters`` calls after ``warmup``, between two
    CUDA events (inputs stay in L2 between calls, as on the main path)."""
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
    end.synchronize()
    return start.elapsed_time(end) / iters


def per_call_readings(fn, n: int = 9) -> str:
    """``n`` readings of ``time_ms`` (a call's host work moves from reading
    to reading with the host's load), sorted, and their median."""
    ms = sorted(time_ms(fn) for _ in range(n))
    return (f"{n} readings, ms: " + " ".join(f"{v:.5f}" for v in ms)
            + f"; median {ms[n // 2]:.5f}")


def device_ms(fn, iters: int = 50):
    """Mean device ms per call with the host's per-call overhead taken out:
    a sleep kernel holds the stream while ``iters`` calls queue behind it,
    so the events bracket back-to-back device work. None when a call
    synchronises, or the host could not queue them all within the sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(100_000_000)           # ~50 ms of GPU clock cycles
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    marks[2].record()
    marks[2].synchronize()
    if host_ms >= marks[0].elapsed_time(marks[1]):
        return None
    return marks[1].elapsed_time(marks[2]) / iters


def bound(bytes_moved: float, ops: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 3
def lloyd_inputs(n, d, k, seed, c=1):
    import torch
    g = torch.Generator().manual_seed(seed)
    # clustered, off-centre rows like a client's feature set; centroids
    # near data rows but never on one
    x = torch.randn((c, n, d), generator=g) + 3.0
    pick = torch.randint(n, (k,), generator=g)
    cents = x[:, pick] + 0.5 * torch.randn((c, k, d), generator=g)
    return x.cuda(), cents.cuda()


def check_lloyd(n, d, k, seed=0, c=1):
    """Kernel vs plain version for c clients in one launch; returns the max
    abs error of min_d2 and sums. Distances carry an error that scales
    with the terms the matmul form cancels (x2 + c2), sums one that scales
    with the summed magnitudes, so each tolerance is rtol·scale + atol."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.kmeans_dist import ops, ref
    x, cents = lloyd_inputs(n, d, k, seed, c)
    before = ops.lloyd_step_cuda.launches
    got = ops.lloyd_step_cuda(x, cents)
    want = ref.lloyd_step(x, cents)
    again = ops.lloyd_step_cuda(x, cents)
    torch.cuda.synchronize()
    label = f"lloyd_step C={c} n={n} d={d} k={k}"
    # one count a launch: one a call, two on the wide route (assignments,
    # then sums)
    if ops.lloyd_step_cuda.launches - before != 2 * ops.lloyd_launches(d):
        raise AssertionError(f"{label}: not {ops.lloyd_launches(d)} "
                             "launches a call")
    for u, v in zip(got, again):
        if not torch.equal(u, v):
            raise AssertionError(f"{label}: two runs differ")
    m_err = s_err = 0.0
    flips = 0
    for i in range(c):
        a_k, m_k, s_k, c_k = (o[i] for o in got)
        a_r, m_r = want[0][i], want[1][i]
        xi, ci = x[i], cents[i]
        d2 = ref.pairwise_sq_dists(xi, ci)                   # (n, k)
        x2 = torch.sum(xi * xi, -1)
        c2 = torch.sum(ci * ci, -1)
        scale = x2 + c2[a_k.long()]
        chosen = torch.gather(d2, 1, a_k.long()[:, None])[:, 0]
        # an argmin may differ from the plain one only on a tie within error
        if bool((chosen - m_r > LLOYD_ATOL + LLOYD_RTOL * scale).any()):
            raise AssertionError(f"{label} client {i}: assignment is not an "
                                 "argmin within tolerance")
        err = (m_k - m_r).abs()
        if bool((err > LLOYD_ATOL + LLOYD_RTOL * scale).any()):
            raise AssertionError(f"{label} client {i}: min_d2 off by "
                                 f"{float(err.max())}")
        m_err = max(m_err, float(err.max()))
        oh = F.one_hot(a_k.long(), k).float()
        s_own = oh.T @ xi
        s_mag = oh.T @ xi.abs()
        err = (s_k - s_own).abs()
        if bool((err > LLOYD_ATOL + LLOYD_RTOL * s_mag).any()):
            raise AssertionError(f"{label} client {i}: sums off by "
                                 f"{float(err.max())}")
        s_err = max(s_err, float(err.max()))
        if not torch.equal(c_k, oh.sum(0)):
            raise AssertionError(f"{label} client {i}: counts differ")
        flips += int((a_k != a_r).sum())
    log(f"  {label}: max|min_d2 err|={m_err:.3e} max|sums err|={s_err:.3e} "
        f"(tol {LLOYD_ATOL:g} + {LLOYD_RTOL:g}*scale) argmin ties={flips} "
        f"launches a call {ops.lloyd_launches(d)}, deterministic=yes")
    return max(m_err, s_err)


def kl_inputs(n, k, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    s = (torch.randn((n, k), generator=g) * 3).cuda()
    t = (torch.randn((n, k), generator=g) * 3).cuda()
    gr = torch.randn((n,), generator=g).cuda()
    return s, t, gr


def check_kl(n, k, seed=0):
    """Forward, ds and dt kernels vs the plain version and its autograd;
    returns the max abs error of each."""
    import torch
    from repro_torch.kernels.distill_kl import ops, ref
    s, t, g = kl_inputs(n, k, seed)
    s_ = s.clone().requires_grad_(True)
    t_ = t.clone().requires_grad_(True)
    out_r = ref.kd_kl_per_sample(s_, t_, TEMPERATURE)
    ds_r, dt_r = torch.autograd.grad(out_r, (s_, t_), g)
    pairs = (("fwd", ops.kd_kl_fwd_cuda(s, t, TEMPERATURE), out_r.detach()),
             ("ds", ops.kd_kl_bwd_ds_cuda(s, t, g, TEMPERATURE), ds_r),
             ("dt", ops.kd_kl_bwd_dt_cuda(s, t, g, TEMPERATURE), dt_r))
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in pairs:
        torch.testing.assert_close(got, want, rtol=KL_RTOL, atol=KL_ATOL)
        errs[name] = float((got - want).abs().max())
    log(f"  kd_kl n={n} K={k}: max|err| fwd={errs['fwd']:.3e} "
        f"ds={errs['ds']:.3e} dt={errs['dt']:.3e} "
        f"(rtol {KL_RTOL:g}, atol {KL_ATOL:g})")
    return errs


def kl_weights(n, kind, seed):
    """A distill step's per-sample weight: the teacher's validity mask
    times a weight in [0, 1) ("masked", a third of the rows 0), none (the
    plain mean) or all zero (no valid teacher: the max(sum w, 1) clamp)."""
    import torch
    if kind == "none":
        return None
    if kind == "zero":
        return torch.zeros((n,), device="cuda")
    g = torch.Generator().manual_seed(seed + 7)
    w = torch.rand((n,), generator=g) * (torch.rand((n,), generator=g) > 0.33)
    return w.cuda()


def check_kl_loss(n, k, weights, seed=0):
    """The fused loss kernel vs its plain version (the per-sample plain
    version, the weighted mean, autograd for the student): kl, loss and
    ds; two launches bitwise equal, and a launch without ds gives the
    same kl and loss. Returns the max abs error of each."""
    import torch
    from repro_torch.kernels.distill_kl import ops, ref
    s, t, _ = kl_inputs(n, k, seed)
    w = kl_weights(n, weights, seed)
    got = ops.kd_kl_loss_cuda(s, t, w, TEMPERATURE)
    again = ops.kd_kl_loss_cuda(s, t, w, TEMPERATURE)
    no_ds = ops.kd_kl_loss_cuda(s, t, w, TEMPERATURE, want_ds=False)
    s_ = s.clone().requires_grad_(True)
    kl_r = ref.kd_kl_per_sample(s_, t, TEMPERATURE)
    loss_r = ref.weighted_mean(kl_r, w)
    ds_r, = torch.autograd.grad(loss_r, s_)
    torch.cuda.synchronize()
    label = f"kd_kl_loss n={n} K={k} weights={weights}"
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"{label}: two launches differ")
    if no_ds[2] is not None or not (torch.equal(got[0], no_ds[0])
                                    and torch.equal(got[1], no_ds[1])):
        raise AssertionError(f"{label}: a launch without ds differs")
    errs = {}
    for name, g, want in (("loss", got[0], loss_r.detach()),
                          ("kl", got[1], kl_r.detach()), ("ds", got[2], ds_r)):
        torch.testing.assert_close(
            g, want, rtol=KL_RTOL,
            atol=kl_ds_atol(k) if name == "ds" else KL_ATOL)
        errs[name] = float((g - want).abs().max())
    log(f"  {label}: max|err| loss={errs['loss']:.3e} kl={errs['kl']:.3e} "
        f"ds={errs['ds']:.3e} (rtol {KL_RTOL:g}, atol {KL_ATOL:g}, ds "
        f"{kl_ds_atol(k):.3g}) loss {float(got[0]):.6e}, deterministic=yes")
    return errs


def check_min_dist(t, d, k, seed=0):
    """Min-distance kernel vs plain version, at a device threshold that
    splits the rows in half, the same threshold passed as a float, and an
    infinite one as a device scalar and as a float (the calibration's);
    returns the max abs error of the distances."""
    import torch
    from repro_torch.kernels.kmeans_dist import ops, ref
    x, cents = (v[0] for v in lloyd_inputs(t, d, k, seed))
    want_d, _ = ref.min_dist_and_mask(x, cents, float("inf"))
    thr = torch.quantile(want_d, 0.5).reshape(1)
    want_m = want_d <= thr
    got_d, got_m = ops.min_dist_and_mask_cuda(x, cents, thr)
    again = ops.min_dist_and_mask_cuda(x, cents, thr)
    by_value = ops.min_dist_and_mask_cuda(x, cents, float(thr))
    inf_m = ops.min_dist_and_mask_cuda(
        x, cents, torch.full((1,), float("inf"), device="cuda"))[1]
    inf_value = ops.min_dist_and_mask(x, cents, float("inf"))
    torch.cuda.synchronize()
    label = f"min_dist_and_mask t={t} d={d} k={k}"
    if not (torch.equal(got_d, again[0]) and torch.equal(got_m, again[1])):
        raise AssertionError(f"{label}: two runs differ")
    if not (torch.equal(got_d, by_value[0])
            and torch.equal(got_m, by_value[1])
            and torch.equal(got_d, inf_value[0])):
        raise AssertionError(f"{label}: a threshold passed as a float "
                             "gives other bits")
    if not (bool(inf_m.all()) and bool(inf_value[1].all())):
        raise AssertionError(f"{label}: an infinite threshold left rows "
                             "out")
    scale = torch.sum(x * x, -1) + torch.amax(torch.sum(cents * cents, -1))
    tol2 = DIST_ATOL + DIST_RTOL * scale
    err2 = (got_d * got_d - want_d * want_d).abs()
    if bool((err2 > tol2).any()):
        raise AssertionError(f"min_dist_and_mask t={t} k={k}: d² off by "
                             f"{float(err2.max())}")
    clear = (want_d * want_d - thr * thr).abs() > tol2
    if not torch.equal(got_m[clear], want_m[clear]):
        raise AssertionError(f"min_dist_and_mask t={t} k={k}: masks differ "
                             "away from the threshold")
    err = float((got_d - want_d).abs().max())
    log(f"  {label}: max|dist err|={err:.3e} "
        f"(tol on d²: {DIST_ATOL:g} + {DIST_RTOL:g}*scale), mask flips "
        f"{int((got_m != want_m).sum())} (all within tolerance of the "
        "threshold) deterministic=yes, float thresholds bitwise equal")
    return err


# ---- non-finite inputs: the reference's semantics (NaN through the clamp
# and the minimum, the argmin at the first NaN, the one-hot product's 0 * x)
def bits(t):
    """A float tensor's bit patterns (two NaNs compare equal here)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_nonfinite(got, want):
    """NaN, +inf and -inf at the same positions."""
    import torch
    return all(torch.equal(f(got), f(want)) for f in
               (torch.isnan, torch.isposinf, torch.isneginf))


def nonfinite_rows(x):
    """Rows 1-3 of x poisoned: a NaN feature; a +inf and a -inf feature
    (the ±inf row); one -inf feature (against centroids positive there,
    an infinite d2, not a NaN)."""
    x = x.clone()
    x[1, 3] = float("nan")
    x[2, 0], x[2, 5] = float("inf"), float("-inf")
    x[3, 2] = float("-inf")
    return x


def nonfinite_inputs(n, d, k, case, seed=0):
    """``case`` "rows": x with ``nonfinite_rows``; "centroid": centroid 1
    (0 when k = 1) holds a NaN feature."""
    x, cents = (v[0] for v in lloyd_inputs(n, d, k, seed))
    if case == "rows":
        return nonfinite_rows(x), cents
    cents = cents.clone()
    cents[min(1, k - 1), 4] = float("nan")
    return x, cents


def check_nonfinite_lloyd(n, d, k, case):
    """The Lloyd kernel vs its plain version on non-finite inputs: NaN and
    ±inf at the same places in min_d2 and sums, the same argmin on every
    row whose min_d2 is not finite (finite rows: an argmin within
    tolerance), counts of the kernel's own assignments, two runs bitwise
    equal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.kmeans_dist import ops, ref
    x, cents = nonfinite_inputs(n, d, k, case)
    got = ops.lloyd_step(x, cents)
    again = ops.lloyd_step(x, cents)
    want = ref.lloyd_step(x, cents)
    torch.cuda.synchronize()
    label = f"lloyd_step non-finite {case} n={n} d={d} k={k}"
    if not all(torch.equal(bits(u), bits(v)) for u, v in zip(got, again)):
        raise AssertionError(f"{label}: two runs differ")
    a_k, m_k, s_k, c_k = got
    a_r, m_r, s_r, _ = want
    for name, g, w in (("min_d2", m_k, m_r), ("sums", s_k, s_r)):
        if not same_nonfinite(g, w):
            raise AssertionError(f"{label}: {name} not finite at other "
                                 "places than the plain version's")
    bad = ~torch.isfinite(m_r)
    if not torch.equal(a_k[bad], a_r[bad]):
        raise AssertionError(f"{label}: argmins of non-finite rows differ")
    scale = torch.sum(x * x, -1) + torch.sum(cents * cents, -1)[a_k.long()]
    fin = ~bad & torch.isfinite(scale)
    tol = LLOYD_ATOL + LLOYD_RTOL * scale[fin]
    chosen = torch.gather(ref.pairwise_sq_dists(x[fin], cents), 1,
                          a_k[fin].long()[:, None])[:, 0]
    if bool((chosen - m_r[fin] > tol).any()):
        raise AssertionError(f"{label}: a finite row's assignment is not an "
                             "argmin within tolerance")
    if bool(((m_k[fin] - m_r[fin]).abs() > tol).any()):
        raise AssertionError(f"{label}: finite min_d2 off")
    if not torch.equal(c_k, F.one_hot(a_k.long(), k).float().sum(0)):
        raise AssertionError(f"{label}: counts differ")
    log(f"  {label}: NaN/inf positions of min_d2 and sums equal, "
        f"{int(bad.sum())} non-finite rows with equal argmins, "
        f"{int(torch.isnan(s_r).sum())} NaN sums, deterministic=yes")


def check_nonfinite_min_dist(t, d, k, case):
    """The estimation kernel vs its plain version on non-finite inputs:
    NaN and ±inf distances at the same places, equal masks on those rows
    (NaN: never ID), at a finite device threshold and at an infinite float
    one; two runs bitwise equal."""
    import torch
    from repro_torch.kernels.kmeans_dist import ops, ref
    x, cents = nonfinite_inputs(t, d, k, case)
    want_d, _ = ref.min_dist_and_mask(x, cents, float("inf"))
    fin = torch.isfinite(want_d)
    thr = (torch.quantile(want_d[fin], 0.5) if bool(fin.any())
           else torch.tensor(3.0, device="cuda")).reshape(1)
    label = f"min_dist_and_mask non-finite {case} t={t} d={d} k={k}"
    for threshold in (thr, float("inf")):
        got_d, got_m = ops.min_dist_and_mask(x, cents, threshold)
        again = ops.min_dist_and_mask(x, cents, threshold)
        want_m = ref.min_dist_and_mask(x, cents, threshold)[1]
        torch.cuda.synchronize()
        if not (torch.equal(bits(got_d), bits(again[0]))
                and torch.equal(got_m, again[1])):
            raise AssertionError(f"{label}: two runs differ")
        if not same_nonfinite(got_d, want_d):
            raise AssertionError(f"{label}: distances not finite at other "
                                 "places than the plain version's")
        if not torch.equal(got_m[~fin], want_m[~fin]):
            raise AssertionError(f"{label}: masks of non-finite rows differ")
        if bool(got_m[torch.isnan(got_d)].any()):
            raise AssertionError(f"{label}: a NaN distance is ID")
    scale = torch.sum(x * x, -1) + torch.amax(torch.sum(cents * cents, -1))
    err2 = (got_d * got_d - want_d * want_d).abs()[fin]
    if bool((err2 > DIST_ATOL + DIST_RTOL * scale[fin]).any()):
        raise AssertionError(f"{label}: finite d² off by {float(err2.max())}")
    log(f"  {label}: NaN/inf positions equal ({int(torch.isnan(want_d).sum())}"
        f" NaN, {int(torch.isinf(want_d).sum())} inf), masks of those rows "
        "equal at a finite and an infinite threshold, deterministic=yes")


def check_nonfinite_rbf(n, m, d, case):
    """The RBF Gram kernel vs its plain version on non-finite rows: NaN at
    the same places, equal values (0 or NaN) in every row and column with
    a non-finite feature, the rest within the RBF tolerance; "rows" poisons
    a, "centroid" b (a NaN row and a +inf row)."""
    import torch
    from repro_torch.kernels.kulsif_rbf import ops, ref
    a, b = rbf_inputs(n, m, d, seed=0)
    if case == "rows":
        a = nonfinite_rows(a)
    else:
        b = b.clone()
        b[1, 4] = float("nan")
        b[2, 0] = float("inf")
    got = ops.rbf_matrix_cuda(a, b, SIGMA)
    again = ops.rbf_matrix_cuda(a, b, SIGMA)
    want = ref.rbf_matrix(a, b, SIGMA)
    torch.cuda.synchronize()
    label = f"rbf_matrix non-finite {case} n={n} m={m} d={d}"
    if not torch.equal(bits(got), bits(again)):
        raise AssertionError(f"{label}: two runs differ")
    if not same_nonfinite(got, want):
        raise AssertionError(f"{label}: NaN at other places than the plain "
                             "version's")
    bad = (~torch.isfinite(a).all(-1))[:, None] | (
        ~torch.isfinite(b).all(-1))[None, :]
    sel = bad & ~torch.isnan(want)
    if not torch.equal(got[sel], want[sel]):
        raise AssertionError(f"{label}: values of non-finite rows differ")
    scale = torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
    tol = want * RBF_RTOL * scale / (2 * SIGMA * SIGMA) + RBF_ATOL
    if bool(((got - want).abs() > tol)[~bad].any()):
        raise AssertionError(f"{label}: finite pairs off")
    log(f"  {label}: {int(torch.isnan(want).sum())} NaN at the plain "
        f"version's places, {int(sel.sum())} other values of non-finite "
        "rows equal, deterministic=yes")


def rbf_inputs(n, m, d, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    # feature-like rows (the main path's features have std ~2), or
    # pixel-like ones in (-1, 1) at the image widths: proxy rows a, private
    # rows b, half of a near rows of b
    pixels = d in WIDE_DS
    b = torch.randn((m, d), generator=g) * 2.0 + 0.5
    a = torch.randn((n, d), generator=g) * 2.0 + 0.5
    near = torch.randint(m, (n // 2,), generator=g)
    noise = 0.05 if pixels else 0.3
    if pixels:
        b, a = torch.tanh(b / 2), torch.tanh(a / 2)
    a[: n // 2] = b[near] + noise * torch.randn((n // 2, d), generator=g)
    return a.cuda(), b.cuda()


def check_rbf(n, m, d, seed=0):
    """RBF Gram kernel vs plain version; returns the max abs error."""
    import torch
    from repro_torch.kernels.kulsif_rbf import ops, ref
    a, b = rbf_inputs(n, m, d, seed)
    got = ops.rbf_matrix_cuda(a, b, SIGMA)
    again = ops.rbf_matrix_cuda(a, b, SIGMA)
    want = ref.rbf_matrix(a, b, SIGMA)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"rbf_matrix ({n}, {m}, {d}): two runs differ")
    scale = torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
    tol = want * RBF_RTOL * scale / (2 * SIGMA * SIGMA) + RBF_ATOL
    err = (got - want).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"rbf_matrix ({n}, {m}, {d}): off by "
                             f"{float(err.max())}")
    rel = float((err / tol).max())
    log(f"  rbf_matrix n={n} m={m} d={d} sigma={SIGMA:g}: max|err|="
        f"{float(err.max()):.3e} (tol K*{RBF_RTOL:g}*scale/(2σ²) + "
        f"{RBF_ATOL:g}; worst err/tol {rel:.3f}), K in "
        f"[{float(want.min()):.2e}, {float(want.max()):.2e}] "
        "deterministic=yes")
    return float(err.max())


def attn_inputs(b, n, nkv, s, h, seed, sk=None):
    """q (b, n, s, h) and k, v (b, nkv, sk, h) (sk: default s) on the
    card, normal from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sk = s if sk is None else sk
    q, k, v = (torch.randn(shape, generator=g) for shape in
               ((b, n, s, h), (b, nkv, sk, h), (b, nkv, sk, h)))
    return q.cuda(), k.cuda(), v.cuda()


def model_layout(t):
    """A (B, N, S, h) view of a (B, S, N, h) copy of ``t``: what the model
    hands the kernel (``dispatch.flash_attention``)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def check_flash(b, n, nkv, s, h, causal=True, seed=0, sk=None,
                poison=False):
    """Flash-attention kernel vs plain version; also on strided (B, N, S,
    h) views of (B, S, N, h) tensors (the model's layout), which must give
    the same bits. ``sk``: keys other than ``s`` (cross-attention).
    ``poison``: the output's memory holds NaN before the first launch (a
    block of its size freed to the caching allocator just before), so a
    column the kernel does not write fails the check. Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = attn_inputs(b, n, nkv, s, h, seed, sk=sk)
    if poison:
        nan = torch.full_like(q, float("nan"))
        ptr = nan.data_ptr()
        del nan
    got = ops.flash_attention_cuda(q, k, v, causal)
    if poison and got.data_ptr() != ptr:
        raise AssertionError("the poisoned block was not reused")
    again = ops.flash_attention_cuda(q, k, v, causal)
    strided = ops.flash_attention_cuda(*map(model_layout, (q, k, v)), causal)
    want = ref.attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    label = (f"flash_attention ({b}, {n}, {s}, {h}) kv {nkv}"
             + ("" if sk is None else f" over {sk} keys")
             + f" causal={causal}" + (", poisoned output" if poison else ""))
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs differ")
    if not torch.equal(got, strided):
        raise AssertionError(f"{label}: strided views give other bits")
    torch.testing.assert_close(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    err = float((got - want).abs().max())
    log(f"  {label}: max|err|={err:.3e} (rtol {ATTN_RTOL:g}, atol "
        f"{ATTN_ATOL:g}) deterministic=yes, strided views bitwise equal")
    return err


def check_flash_grads(b, n, nkv, s, h, seed=0, causal=True, sk=None):
    """The autograd function (kernel forward, recompute backward) against
    autograd of the plain version: one launch, gradients to q, k, v."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = attn_inputs(b, n, nkv, s, h, seed, sk=sk)
    g = attn_inputs(b, n, n, s, h, seed + 1)[0]
    kern = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.flash_attention_cuda.launches
    ops.flash_attention(*kern, causal=causal).backward(g)
    if ops.flash_attention_cuda.launches - before != 1:
        raise AssertionError("the autograd function did not launch the "
                             "kernel exactly once")
    ref.attention_gqa(*plain, causal=causal).backward(g)
    torch.cuda.synchronize()
    errs = []
    for name, a, w in zip("qkv", kern, plain):
        torch.testing.assert_close(a.grad, w.grad, rtol=1e-4, atol=1e-5)
        errs.append(f"d{name} {float((a.grad - w.grad).abs().max()):.3e}")
    log(f"  flash_attention grads ({b}, {n}, {s}, {h}) kv {nkv}"
        + ("" if sk is None else f" over {sk} keys")
        + f" causal={causal}: max|err| "
        + ", ".join(errs) + " (rtol 1e-4, atol 1e-5)")


def check_long_route():
    """B6's long route (Sq > 32) at ``LONG_ATTN``, causal and full; on a
    poisoned output (a column left unwritten fails) at GQA 8 and h 80 over
    1601 keys, at GQA 16, and at train_100m's GQA 3 and hubert's batch 16
    (one key group a block); the gradients at GQA 16 and GQA 3."""
    for shape in LONG_ATTN:
        for causal in (True, False):
            check_flash(*shape, causal=causal)
    check_flash(2, 16, 2, 33, 80, causal=False, sk=1601, poison=True)
    check_flash(2, 16, 1, 300, 128, causal=True, seed=1, poison=True)
    check_flash(8, 12, 4, 256, 64, causal=True, seed=1, poison=True)
    check_flash(16, 16, 16, 128, 80, causal=False, seed=1, poison=True)
    check_flash_grads(2, 32, 2, 33, 80)
    check_flash_grads(8, 12, 4, 256, 64)


# B6 over a cohort: granite-8b's attention at a training step's batch for
# 10 clients (the full-width cohort run's), and the reduced backbone's at
# 129 clients x eval batch 512, a folded batch past grid axis z's 65535
COHORT_ATTN = (10,) + MAIN_ATTN
CHUNKED_ATTN = (129, 512, 4, 1, 16, 16)


def attn_clients_inputs(c, b, n, nkv, s, h, seed):
    """q (C, B, S, N, h) and k, v (C, B, S, Nkv, h) on the card, the
    cohort's stacked activations in the model's layout (the attention
    reads (C, B, N, S, h) views of them), and an output gradient."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((c, b, s, heads, h), generator=g).cuda()
               for heads in (n, nkv, nkv))
    go = torch.randn((c, b, n, s, h), generator=g).cuda()
    return q, k, v, go


def check_flash_clients(c, b, n, nkv, s, h, seed=0):
    """B6 under ``vmap`` (the cohort's ``vmap`` over ``functional_call``):
    one launch for the whole client axis, folded into the batch; each
    client's slice bitwise its own launch on its own tensors; forward and
    q/k/v gradients against autograd of the vmapped plain version.
    Returns the forward's max abs error."""
    import torch
    from torch.func import vmap
    from repro_torch.kernels.flash_attention import ops, ref
    base = attn_clients_inputs(c, b, n, nkv, s, h, seed)
    go = base[3]
    kern = [t.clone().requires_grad_(True) for t in base[:3]]
    plain = [t.clone().requires_grad_(True) for t in base[:3]]

    def attn(q, k, v):
        return ops.FlashAttentionFunction.apply(q, k, v, True)

    def attn_plain(q, k, v):
        return ref.attention_gqa(q, k, v, causal=True)
    before = ops.flash_attention_cuda.launches
    got = vmap(attn)(*(t.transpose(2, 3) for t in kern))
    launched = ops.flash_attention_cuda.launches - before
    label = (f"flash_attention under vmap, C={c} ({b}, {n}, {s}, {h}) kv "
             f"{nkv}")
    if launched != 1:
        raise AssertionError(f"{label}: {launched} launches, not one")
    want = vmap(attn_plain)(*(t.transpose(2, 3) for t in plain))
    for i in range(c):
        # client i's own (B, S, N, h) tensors, as its loop-engine forward
        # hands them over
        mine = ops.flash_attention_cuda(
            *(own(t[i]).transpose(1, 2) for t in base[:3]), True)
        if not torch.equal(got[i], mine):
            raise AssertionError(f"{label}: client {i}'s slice differs from "
                                 "its own launch")
    torch.testing.assert_close(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    got.backward(go)
    want.backward(go)
    torch.cuda.synchronize()
    errs = []
    for name, a, w in zip("qkv", kern, plain):
        torch.testing.assert_close(a.grad, w.grad, rtol=1e-4, atol=1e-5)
        errs.append(f"d{name} {float((a.grad - w.grad).abs().max()):.3e}")
    err = float((got - want).detach().abs().max())
    log(f"  {label}: one launch of batch {c * b}, each client's slice "
        f"bitwise its own launch; max|err| {err:.3e} (rtol {ATTN_RTOL:g}, "
        f"atol {ATTN_ATOL:g}), grads " + ", ".join(errs)
        + " (rtol 1e-4, atol 1e-5)")
    return err


def check_flash_chunked(c, b, n, nkv, s, h, seed=0):
    """A folded batch past grid axis z (``MAX_GRID_YZ``): launched in
    chunks, each a launch, against the plain version."""
    import torch
    from torch.func import vmap
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, _ = attn_clients_inputs(c, b, n, nkv, s, h, seed)
    views = [t.transpose(2, 3) for t in (q, k, v)]
    before = ops.flash_attention_cuda.launches
    got = vmap(lambda a, bb, cc: ops.FlashAttentionFunction.apply(
        a, bb, cc, True))(*views)
    launched = ops.flash_attention_cuda.launches - before
    chunks = -(-c * b // ops.MAX_GRID_YZ)
    if c * b <= ops.MAX_GRID_YZ or launched != chunks:
        raise AssertionError(f"folded batch {c * b}: {launched} launches, "
                             f"not {chunks} chunks of <= {ops.MAX_GRID_YZ}")
    want = ref.attention_gqa(*(t.reshape(c * b, *t.shape[2:])
                               for t in views), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.reshape(want.shape), want,
                               rtol=ATTN_RTOL, atol=ATTN_ATOL)
    log(f"  flash_attention under vmap, C={c} ({b}, {n}, {s}, {h}) kv "
        f"{nkv}: folded batch {c * b} > {ops.MAX_GRID_YZ} launched in "
        f"{launched} chunks, max|err| "
        f"{float((got.reshape(want.shape) - want).abs().max()):.3e}")


# ---- the cohort engine's routes: every kernel over a client axis, each
# client's slice bit for bit its own launch's
def own(t):
    """A copy of ``t`` in an allocation of its own (a client's tensor)."""
    return t.clone().contiguous()


def check_lloyd_clients(n, d, k, c=10, seed=0):
    """B1 for c clients in one launch against c launches of one client
    each (``kmeans_fit_batched`` against ``kmeans_fit``): bitwise."""
    import torch
    from repro_torch.kernels.kmeans_dist import ops
    x, cents = lloyd_inputs(n, d, k, seed, c)
    got = ops.lloyd_step_cuda(x, cents)
    label = f"lloyd_step C={c} n={n} d={d} k={k}"
    for i in range(c):
        one = ops.lloyd_step_cuda(own(x[i:i + 1]), own(cents[i:i + 1]))
        if not all(torch.equal(bits(u[i]), bits(v[0]))
                   for u, v in zip(got, one)):
            raise AssertionError(f"{label}: client {i} differs from its own "
                                 "launch")
    log(f"  {label}: every client bitwise equal to its own C=1 launch "
        f"({'wide' if d > 64 else 'narrow'} route)")


def min_dist_clients_inputs(c, t, d, k, shared, seed, poison=None):
    """c clients' centroids (c, k, d) near their rows, thresholds (c,) at
    each client's median distance (its own rows, or the shared ones), and
    x (t, d) shared or (c, t, d); ``poison``: "rows" (x's rows 1-3
    non-finite) or "centroid" (client 1's centroid NaN)."""
    import torch
    from repro_torch.kernels.kmeans_dist import ref
    x, cents = lloyd_inputs(t, d, k, seed, c)
    if shared:
        x = x[0]
    if poison == "rows":
        x = (nonfinite_rows(x) if shared
             else torch.stack([nonfinite_rows(v) for v in x]))
    elif poison == "centroid":
        cents = cents.clone()
        cents[min(1, c - 1), min(1, k - 1), 4] = float("nan")
    d_all = ref.min_dist_and_mask(x, cents, float("inf"))[0]
    thr = torch.stack([torch.quantile(v[torch.isfinite(v)], 0.5)
                       if bool(torch.isfinite(v).any())
                       else torch.tensor(3.0, device="cuda") for v in d_all])
    return x, cents, thr.contiguous()


def check_min_dist_clients(c, t, d, k, shared, seed=0, poison=None):
    """B2 for c clients in one launch: against each client's own 2-D
    launch bitwise (its thresholds a device tensor, and an infinite float
    for all), against the plain version over clients within the
    min-distance tolerance (masks equal away from the threshold, NaN and
    inf at the same places), and two launches bitwise. Returns the max
    abs error of the finite distances."""
    import torch
    from repro_torch.kernels.kmeans_dist import ops, ref
    x, cents, thr = min_dist_clients_inputs(c, t, d, k, shared, seed, poison)
    label = (f"min_dist_and_mask clients C={c} t={t} d={d} k={k} "
             f"x {'shared' if shared else 'per client'}"
             + (f" non-finite {poison}" if poison else ""))
    before = ops.min_dist_and_mask_clients_cuda.launches
    got_d, got_m = ops.min_dist_and_mask(x, cents, thr)
    again = ops.min_dist_and_mask(x, cents, thr)
    inf_d, inf_m = ops.min_dist_and_mask(x, cents, float("inf"))
    if ops.min_dist_and_mask_clients_cuda.launches - before != 3:
        raise AssertionError(f"{label}: not one launch a call")
    if not (torch.equal(bits(got_d), bits(again[0]))
            and torch.equal(got_m, again[1])):
        raise AssertionError(f"{label}: two launches differ")
    for i in range(c):
        xi = own(x) if shared else own(x[i])
        one_d, one_m = ops.min_dist_and_mask_cuda(xi, own(cents[i]),
                                                  own(thr[i:i + 1]))
        inf1 = ops.min_dist_and_mask_cuda(xi, own(cents[i]), float("inf"))
        if not (torch.equal(bits(got_d[i]), bits(one_d))
                and torch.equal(got_m[i], one_m)
                and torch.equal(bits(inf_d[i]), bits(inf1[0]))
                and torch.equal(inf_m[i], inf1[1])):
            raise AssertionError(f"{label}: client {i} differs from its own "
                                 "launch")
    want_d, want_m = ref.min_dist_and_mask(x, cents, thr)
    torch.cuda.synchronize()
    if not same_nonfinite(got_d, want_d):
        raise AssertionError(f"{label}: distances not finite at other "
                             "places than the plain version's")
    if bool(got_m[torch.isnan(got_d)].any()):
        raise AssertionError(f"{label}: a NaN distance is ID")
    fin = torch.isfinite(want_d)
    x2 = torch.sum(x * x, -1)
    scale = x2 + torch.amax(torch.sum(cents * cents, -1), -1)[:, None]
    tol2 = DIST_ATOL + DIST_RTOL * scale
    err2 = (got_d * got_d - want_d * want_d).abs()
    if bool((err2[fin] > tol2[fin]).any()):
        raise AssertionError(f"{label}: d² off by {float(err2[fin].max())}")
    clear = ~fin | ((want_d * want_d - (thr * thr)[:, None]).abs() > tol2)
    if not torch.equal(got_m[clear], want_m[clear]):
        raise AssertionError(f"{label}: masks differ away from the "
                             "threshold")
    err = float((got_d - want_d).abs()[fin].max())
    log(f"  {label}: every client bitwise equal to its own launch (device "
        f"and infinite float thresholds); plain version max|dist err| "
        f"{err:.3e} (tol on d²: {DIST_ATOL:g} + {DIST_RTOL:g}*scale), "
        f"{int((~fin).sum())} non-finite at its places; deterministic=yes")
    return err


def check_rbf_clients(n, c, m, d, sentinel=0, seed=0):
    """B5 for one shared a against c clients' b in one launch: each
    client's slice bitwise its own 2-D launch, the plain version within
    the RBF tolerance, and ``sentinel`` rows of 1e6 at the end of each b
    (a padded private set) exactly 0. Returns the max abs error."""
    import torch
    from repro_torch.kernels.kulsif_rbf import ops, ref
    a, b0 = rbf_inputs(n, c * m, d, seed)
    b = b0.reshape(c, m, d).clone()
    if sentinel:
        b[:, m - sentinel:] = 1e6
    label = (f"rbf_matrix clients n={n} C={c} m={m} d={d}"
             + (f", {sentinel} sentinel rows a client" if sentinel else ""))
    before = ops.rbf_matrix_clients_cuda.launches
    got = ops.rbf_matrix(a, b, SIGMA)
    again = ops.rbf_matrix(a, b, SIGMA)
    if ops.rbf_matrix_clients_cuda.launches - before != 2:
        raise AssertionError(f"{label}: not one launch a call")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    for i in range(c):
        if not torch.equal(got[i], ops.rbf_matrix_cuda(a, own(b[i]), SIGMA)):
            raise AssertionError(f"{label}: client {i} differs from its own "
                                 "launch")
    want = ref.rbf_matrix(a, b, SIGMA)
    torch.cuda.synchronize()
    if sentinel and bool((got[:, :, m - sentinel:] != 0).any()):
        raise AssertionError(f"{label}: a sentinel row's kernel value is "
                             "not 0")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    scale = (torch.sum(a * a, -1)[None, :, None]
             + torch.sum(b * b, -1)[:, None, :])
    tol = want * RBF_RTOL * scale / (2 * SIGMA * SIGMA) + RBF_ATOL
    err = (got - want).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"{label}: off by {float(err.max())}")
    log(f"  {label}: every client bitwise equal to its own launch; plain "
        f"version max|err| {float(err.max()):.3e} (worst err/tol "
        f"{float((err / tol).max()):.3f}); deterministic=yes")
    return float(err.max())


def kl_clients_weights(c, n, seed):
    """Each lane's distill-step weights: a ragged count of valid rows
    (the rest 0, a short last batch padded), a teacher-validity mask on
    those, lane 1 all zero (a lane with no valid step, as a dummy wave
    lane has)."""
    import torch
    g = torch.Generator().manual_seed(seed + 11)
    w = torch.rand((c, n), generator=g) * (torch.rand((c, n), generator=g)
                                           > 0.25)
    for i in range(c):
        w[i, n - (i * 7) % n:] = 0.0
    w[min(1, c - 1)] = 0.0
    return w.cuda()


def check_kl_loss_clients(c, n, k, seed=0):
    """The fused loss for c clients in one launch (``KdKlLossFunction`` on
    (C, n, K)): against its plain version over clients within the KL
    tolerance (loss, kl, the student's gradient through autograd), each
    client bitwise its own 2-D launch, the all-zero lane's loss and
    gradient exactly 0, two launches bitwise. Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.distill_kl import ops, ref
    g = torch.Generator().manual_seed(seed)
    s = (torch.randn((c, n, k), generator=g) * 3).cuda()
    t = (torch.randn((c, n, k), generator=g) * 3).cuda()
    w = kl_clients_weights(c, n, seed)
    label = f"kd_kl_loss clients C={c} n={n} K={k}"
    before = ops.kd_kl_loss_clients_cuda.launches
    got = ops.kd_kl_loss_clients_cuda(s, t, w, TEMPERATURE)
    again = ops.kd_kl_loss_clients_cuda(s, t, w, TEMPERATURE)
    s_k = s.clone().requires_grad_(True)
    loss_k = ops.kd_kl_loss(s_k, t, TEMPERATURE, w)
    cot = torch.randn((c,), generator=g).cuda()
    ds_k, = torch.autograd.grad(loss_k, s_k, cot)
    if ops.kd_kl_loss_clients_cuda.launches - before != 3:
        raise AssertionError(f"{label}: not one launch a call")
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"{label}: two launches differ")
    for i in range(c):
        one = ops.kd_kl_loss_cuda(own(s[i]), own(t[i]), own(w[i]),
                                  TEMPERATURE)
        if not all(torch.equal(u[i], v) for u, v in zip(got, one)):
            raise AssertionError(f"{label}: client {i} differs from its own "
                                 "launch")
    zero = min(1, c - 1)
    if not (float(got[0][zero]) == 0.0 and bool((got[2][zero] == 0).all())
            and bool((ds_k[zero] == 0).all())):
        raise AssertionError(f"{label}: the all-zero lane's loss or "
                             "gradient is not 0")
    s_r = s.clone().requires_grad_(True)
    kl_r = ref.kd_kl_per_sample(s_r, t, TEMPERATURE)
    loss_r = ref.kd_kl_loss(s_r, t, TEMPERATURE, w)
    ds_r, = torch.autograd.grad(loss_r, s_r, cot)
    torch.cuda.synchronize()
    errs = []
    for name, u, v in (("loss", loss_k.detach(), loss_r.detach()),
                       ("kl", got[1], kl_r.detach()), ("ds", ds_k, ds_r)):
        torch.testing.assert_close(
            u, v, rtol=KL_RTOL,
            atol=kl_ds_atol(k) if name == "ds" else KL_ATOL)
        errs.append(float((u - v).abs().max()))
    log(f"  {label}: every client bitwise equal to its own 2-D launch, the "
        f"all-zero lane 0 with a zero gradient; plain version max|err| loss "
        f"{errs[0]:.3e} kl {errs[1]:.3e} ds {errs[2]:.3e} (rtol {KL_RTOL:g}, "
        f"atol {KL_ATOL:g}, ds {kl_ds_atol(k):.3g}); deterministic=yes")
    return max(errs)


def check_kl_loss_zero_lane_phase(c=10, n=32, k=10, d=50, steps=16,
                                  seed=0):
    """A distill phase of ``steps`` SGD steps for c lanes of a linear
    student through the fused loss over clients, lane 3's weights zero at
    every step (a sampled-out lane): each step's loss, kl and gradient
    bitwise each lane's own 2-D launch, the zero lane's loss and its
    parameters' gradient exactly 0 at every step, and its parameters
    bitwise unchanged at the end of the phase."""
    import torch
    from repro_torch.kernels.distill_kl import ops
    g = torch.Generator().manual_seed(seed)
    zero = 3
    W = (torch.randn((c, d, k), generator=g) * 0.3).cuda()
    start = W.clone()
    label = (f"kd_kl_loss clients C={c} n={n} K={k}: a {steps}-step distill "
             f"phase, lane {zero} all-zero weights")
    before = ops.kd_kl_loss_clients_cuda.launches
    for _ in range(steps):
        x = torch.randn((c, n, d), generator=g).cuda()
        t = (torch.randn((c, n, k), generator=g) * 3).cuda()
        w = (torch.rand((c, n), generator=g) > 0.2).to(torch.float32).cuda()
        w[zero] = 0.0
        Wg = W.clone().requires_grad_(True)
        logits = torch.bmm(x, Wg)
        loss = ops.kd_kl_loss(logits, t, TEMPERATURE, w)
        grad, = torch.autograd.grad(loss.sum(), Wg)
        got = ops.kd_kl_loss_clients_cuda(logits.detach(), t, w,
                                          TEMPERATURE)
        if not torch.equal(got[0], loss.detach()):
            raise AssertionError(f"{label}: the autograd route's loss "
                                 "differs from a direct launch")
        for i in range(c):
            one = ops.kd_kl_loss_cuda(own(logits[i].detach()), own(t[i]),
                                      own(w[i]), TEMPERATURE)
            if not all(torch.equal(u[i], v) for u, v in zip(got, one)):
                raise AssertionError(f"{label}: lane {i} differs from its "
                                     "own launch")
        if not (float(got[0][zero]) == 0.0
                and bool((got[2][zero] == 0).all())
                and bool((grad[zero] == 0).all())):
            raise AssertionError(f"{label}: the zero lane's loss or "
                                 "gradient is not 0")
        W = W - 0.05 * grad
    if ops.kd_kl_loss_clients_cuda.launches - before != 2 * steps:
        raise AssertionError(f"{label}: not one launch a step and call")
    if not torch.equal(W[zero], start[zero]):
        raise AssertionError(f"{label}: the zero lane's parameters moved")
    moved = [i for i in range(c) if not torch.equal(W[i], start[i])]
    if len(moved) != c - 1:
        raise AssertionError(f"{label}: lanes {moved} moved")
    log(f"  {label}: every step each lane bitwise its own 2-D launch, the "
        f"zero lane's loss and gradient 0, its parameters bitwise unchanged "
        f"after the phase, the other {c - 1} lanes moved")


# the cohort's launch shapes: B2's report (10 clients, strong k = 1 and
# weak k = 3), a calibration of 10 uniform clients and of the 100-client
# run's cohorts (iid, k = 10), the image path's one-client cohorts
COHORT_DIST = ((10, 512, 50, 1, True), (10, 512, 50, 3, True),
               (10, 6000, 50, 1, False), (10, 6000, 50, 3, False),
               (34, 600, 50, 10, False), (34, 512, 50, 10, True),
               (1, 512, 784, 1, True), (1, 6000, 784, 1, False),
               (1, 512, 3072, 1, True), (1, 5000, 3072, 1, False),
               (3, 5999, 50, 3, False), (3, 777, 16, 1, False))
# B5's: a report's k_ta and k_tp (10 clients' aux sets, private sets of
# 6000 and the padded 100-client ones), the image path's (one client)
COHORT_RBF = ((512, 10, 256, 50, 0), (512, 10, 6000, 50, 0),
              (512, 10, 6001, 50, 7), (512, 100, 600, 50, 0),
              (512, 1, 6001, 784, 0), (512, 1, 5001, 3072, 3))
# the fused loss: 10 clients' and a 34-client cohort's distill step, and
# the wide-row route over clients (xlstm-350m's vocabulary)
COHORT_KL = ((10, 64, 10), (34, 64, 10), (1, 64, 10), (3, 300, 10),
             (3, 16, 50304))
# benchmarks/scale.py's fleet (16 samples a client, mnist_feat's 50
# features, iid: 10 centroids, proxy batch 64, batch 16) in waves of 1024:
# a wave's fit (B1), its report (B2 on the shared proxy batch) and
# calibration (B2 on each client's own rows), a distill step (the fused
# loss)
FLEET_C = 1024
FLEET_LLOYD = (16, 50, 10)
FLEET_REPORT, FLEET_CALIB = (64, 50, 10), (16, 50, 10)
FLEET_KL = (16, 10)
# CUDA's grid limits (compute capability 9.0): x up to 2^31 - 1 blocks, y
# and z up to 65535; every route puts the client axis on y or z
GRID_X_MAX, GRID_YZ_MAX = 2**31 - 1, 65535


def check_cohort_kernels():
    """The batched routes of phase 3; returns their max abs errors."""
    log("  the cohort engine's routes: each kernel over a client axis")
    for n, d, k in ((6000, 50, 1), (6000, 50, 3), (600, 50, 10),
                    (6000, 784, 1), (1001, 3072, 3)):
        check_lloyd_clients(n, d, k, c=10)
    check_lloyd_clients(600, 50, 10, c=34)
    errs = {"dist": {}, "rbf": {}, "kl": {},
            # the 100-client run's cohort against the plain version
            "lloyd": check_lloyd(600, 50, 10, c=34)}
    for c, t, d, k, shared in COHORT_DIST:
        errs["dist"][(c, t, d, k)] = check_min_dist_clients(c, t, d, k,
                                                            shared)
    for poison in ("rows", "centroid"):
        check_min_dist_clients(10, 512, 50, 3, True, poison=poison)
        check_min_dist_clients(3, 600, 50, 3, False, poison=poison)
        check_min_dist_clients(2, 300, 784, 3, False, poison=poison)
    for n, c, m, d, sentinel in COHORT_RBF:
        errs["rbf"][(n, c, m, d)] = check_rbf_clients(n, c, m, d, sentinel)
    for c, n, k in COHORT_KL:
        errs["kl"][(c, n, k)] = check_kl_loss_clients(c, n, k)
    check_kl_loss_zero_lane_phase()
    errs["flash"] = check_flash_clients(*COHORT_ATTN)
    check_flash_chunked(*CHUNKED_ATTN)
    errs["fleet"] = check_fleet_kernels()
    return errs


def check_fleet_kernels():
    """The fleet's launch shapes, 1024 clients in one launch, each against
    its plain version and each client bitwise its own launch; then a
    1024-lane grid on the client-axis routes the fleet's shapes do not
    take (B1 and B2 on their wide routes, B5 on a stacked b), within
    CUDA's grid limits. Returns the max abs errors by kernel."""
    c = FLEET_C
    log(f"  the fleet's launch shapes (benchmarks/scale.py, waves of {c})")
    check_lloyd_clients(*FLEET_LLOYD, c=c)
    errs = {"lloyd": check_lloyd(*FLEET_LLOYD, c=c),
            "report": check_min_dist_clients(c, *FLEET_REPORT, True),
            "calibration": check_min_dist_clients(c, *FLEET_CALIB, False),
            "kl": check_kl_loss_clients(c, *FLEET_KL)}
    if c > GRID_YZ_MAX:
        raise AssertionError(f"{c} lanes exceed grid y/z's {GRID_YZ_MAX}")
    # the other routes at 1024 lanes: B1 and B2 wide (d > 64; the client
    # on grid y, and on z for B1's sums), B5 on a shared a against 1024
    # clients' b, stacked on the grid's x axis
    check_lloyd(16, 784, 3, c=c)
    check_min_dist_clients(c, 16, 784, 3, False)
    check_rbf_clients(64, c, 16, 50)
    log(f"  a {c}-lane grid launched on every client-axis route (B1 and B2 "
        f"narrow and wide, the fused loss, B5 over {c * 16} stacked rows) "
        f"and agreed with the plain versions: the client axis on grid y or "
        f"z ({c} <= {GRID_YZ_MAX}), rows on x (<= {GRID_X_MAX})")
    return errs


def check_kernels():
    log("[3] kernels vs plain versions on the card")
    lloyd_err = {}
    for k in LLOYD_KS:
        lloyd_err[k] = check_lloyd(MAIN_LLOYD["n"], MAIN_LLOYD["d"], k)
    check_lloyd(5999, MAIN_LLOYD["d"], 3)      # ragged n
    check_lloyd(5999, MAIN_LLOYD["d"], 64)
    # several clients in one launch (the cohort engine's batched fit)
    check_lloyd(MAIN_LLOYD["n"], MAIN_LLOYD["d"], 3, c=3)
    check_lloyd(1001, MAIN_LLOYD["d"], 10, c=5)
    check_lloyd(777, 16, 32, c=2)              # lm_tokens' flattened samples
    kl_err = {}
    for n, k in ((64, 10), (512, 10), (4096, 1000)):
        kl_err[(n, k)] = check_kl(n, k)
    for n, k in KL_LOSS_SHAPES + KL_WIDE_SHAPES:
        for weights in KL_WEIGHTS:
            errs = check_kl_loss(n, k, weights)
            kl_err[(n, k, weights)] = max(errs.values())
    # flattened images (784, 3072 wide): the wide route, two launches
    for n, d, k in LLOYD_WIDE:
        check_lloyd(n, d, k)
    dist_err = {}
    # reports (strong k=1, weak k=3, iid k=10), a calibration, ragged t,
    # lm_tokens' report and calibration, flattened images
    for t, d, k in DIST_SHAPES + ((512, 50, 10), (5999, 50, 3), (300, 50, 64)):
        dist_err[(t, d, k)] = check_min_dist(t, d, k)
    for case in ("rows", "centroid"):
        for n, d, k in ((6000, 50, 3), (777, 16, 32), (1000, 784, 3)):
            check_nonfinite_lloyd(n, d, k, case)
        for t, d, k in ((512, 50, 3), (256, 16, 1), (300, 50, 64),
                        (512, 784, 10)):
            check_nonfinite_min_dist(t, d, k, case)
        for n, m, d in ((512, 6000, 50), (256, 256, 50)):
            check_nonfinite_rbf(n, m, d, case)
    rbf_err = {}
    # learn K11, K12; report k_ta, k_tp; ragged both ways
    for n, m, d in RBF_SHAPES + RBF_IMAGE_SHAPES + (
            (511, 5999, 50), (256, 256, 64), (512, 256, 7), (300, 700, 130),
            (512, 6000, 784)):
        rbf_err[(n, m, d)] = check_rbf(n, m, d)
    attn_err = {shape: check_flash(*shape) for shape in ATTN_SHAPES}
    check_flash(2, 4, 4, 20, 32, causal=False)
    check_flash(3, 32, 8, 300, 128, causal=False)
    for shape in ATTN_SHAPES:
        if shape[3] <= 32:                 # the short route, full attention
            check_flash(*shape, causal=False)
    check_flash_grads(*MAIN_ATTN)
    check_flash_grads(16, 4, 1, 16, 16)
    check_flash_grads(16, 16, 2, 16, 128)  # GQA 8
    check_long_route()
    cohort_err = check_cohort_kernels()
    return lloyd_err, kl_err, dist_err, rbf_err, attn_err, cohort_err


# ----------------------------------------------------------------- phase 4
def _trajectory(x, init, backend, max_iter=50, tol=1e-6):
    """``kmeans_fit``'s loop, keeping each iteration's assignment and
    centroids (before the update) so two routes can be compared step by
    step."""
    import torch
    from repro_torch.kernels import dispatch
    cents, steps = init, []
    for _ in range(max_iter):
        assign, _, sums, counts = dispatch.lloyd_step(x, cents,
                                                      backend=backend)
        steps.append((assign, cents))
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts[:, None], 1.0), cents)
        shift = torch.sum(torch.square(new - cents))
        cents = new
        if bool(shift < tol):
            break
    return steps


def _tie_gap(x, cents, a, b):
    """For rows assigned a by one route and b by the other: the plain
    matmul-form d² gap between the two centroids over the terms the form
    cancels (x² + c²) — a float tie when it is near fp32 epsilon."""
    from repro_torch.kernels.kmeans_dist import ref
    import torch
    d2 = ref.pairwise_sq_dists(x, cents)
    rows = torch.nonzero(a != b)[:, 0]
    if len(rows) == 0:
        return 0
    da = d2[rows, a[rows].long()]
    db = d2[rows, b[rows].long()]
    scale = torch.sum(x[rows] ** 2, -1) + torch.sum(
        cents[a[rows].long()] ** 2, -1)
    return float(((da - db).abs() / scale).max())


def compare_fits(label, x, init):
    """The k-means fit through the kernel on the card against the plain
    version on the card and on the CPU, from the same seeds: n_iter, final
    assignments and centroids, the iteration where the trajectories first
    part, and, fed the kernel trajectory's centroids at every step, the
    rows each plain route assigns differently and how near a tie they
    are. Returns {route: (fit, x on the route's device)}."""
    import torch
    from repro_torch.core.kmeans import kmeans_fit
    from repro_torch.kernels.kmeans_dist import ref
    kern = kmeans_fit(x, len(init), init=init, backend="cuda")
    t_k = _trajectory(x, init, "cuda")
    xh = x.cpu()
    fits = {"kernel": (kern, x)}
    parts = []
    for name, xo, io in (("card plain", x, init),
                         ("CPU plain", xh, init.cpu())):
        fit = kmeans_fit(xo, len(init), init=io, backend="torch")
        t_o = _trajectory(xo, io, "torch")
        first = next((i for i, (sk, so) in enumerate(zip(t_k, t_o))
                      if not torch.equal(sk[0].cpu(), so[0].cpu())), None)
        flips, gap = 0, 0.0
        for assign, cents in t_k:
            other = ref.lloyd_step(xo, cents.to(xo.device))[0].cpu()
            flips += int((assign.cpu() != other).sum())
            gap = max(gap, _tie_gap(xh, cents.cpu(), assign.cpu(), other))
        differ = int((fit.assignments.cpu() != kern.assignments.cpu()).sum())
        c_err = float((fit.centroids.cpu() - kern.centroids.cpu()).abs().max())
        parts.append(
            f"{name}: n_iter {fit.n_iter}, final assignments differ on "
            f"{differ}, max|centroid diff| {c_err:.3e}, inertia "
            f"{float(fit.inertia):.6e}, trajectories part at iteration "
            f"{first}, same-centroid flips {flips} (max tie gap {gap:.2e})")
        fits[name] = (fit, xo)
    log(f"  {label}: kernel n_iter {kern.n_iter} inertia "
        f"{float(kern.inertia):.6e}; " + "; ".join(parts))
    return fits


def check_kmeans_agreement():
    """Phase 4: the k-means fit through the kernel against the plain
    version on the card and on the CPU. Reported, not asserted: on an
    input without cluster structure, float summation orders may steer
    Lloyd to different local optima, which is not a fault of any route."""
    import torch
    from repro_torch.common.types import FedConfig
    from repro_torch.core.kmeans import kmeans_plus_plus, min_dist_to_centroids
    from repro_torch.core.protocol import client_generator
    from repro_torch.fed.simulator import build_experiment
    log("[4] k-means fits: kernel route on the card vs plain route on the "
        "card and on the CPU")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3000, 50), generator=g)
    init = kmeans_plus_plus(x, 3, generator=g)
    compare_fits("unclustered N(0,1) n=3000 d=50 k=3, k-means++ seeds",
                 x.cuda(), init.cuda())
    compare_fits("unclustered N(0,1) n=3000 d=50 k=3, seeds x[:3]+1",
                 x.cuda(), x[:3].cuda() + 1.0)
    for scenario in ("strong", "weak"):
        cfg = FedConfig(scenario=scenario, num_clients=10)
        clients, *_ = build_experiment(cfg, n_train=60000, n_test=10000,
                                       device="cuda")
        thr_err = {"card plain": 0.0, "CPU plain": 0.0}
        for i, c in enumerate(clients):
            k = c.dre.num_centroids
            init = kmeans_plus_plus(c._x, k,
                                    generator=client_generator(cfg.seed, i))
            fits = compare_fits(f"{scenario} client {i} n={len(c._x)} k={k}",
                                c._x, init)
            q = {name: float(torch.quantile(
                min_dist_to_centroids(xo, fit.centroids), 0.95))
                for name, (fit, xo) in fits.items()}
            for name in thr_err:
                thr_err[name] = max(thr_err[name], abs(q["kernel"] - q[name])
                                    / q[name])
        log(f"  {scenario}: max relative DRE threshold diff against the "
            "kernel fit: " + ", ".join(f"{n} {v:.3e}"
                                       for n, v in thr_err.items()))


def check_kmeans_batched():
    """Phase 4, the cohort's fit: ``learn_kmeans_batched`` (one Lloyd
    launch an iteration for every client, one estimation launch for every
    client's calibration) against each client's own ``KMeansDRE.learn``
    on the card, from the same seeds: n_iter, assignments, centroids and
    thresholds equal, bit for bit (asserted)."""
    import torch
    from repro_torch.core.dre import KMeansDRE, learn_kmeans_batched
    from repro_torch.core.kmeans import (kmeans_fit, kmeans_fit_batched,
                                         kmeans_plus_plus)
    from repro_torch.kernels.kmeans_dist import ops
    for c, n, d, k in ((10, 6000, 50, 1), (10, 6000, 50, 3),
                       (34, 600, 50, 10), (3, 6000, 784, 3)):
        g = torch.Generator().manual_seed(n + k)
        centers = torch.randn((c, k, d), generator=g) * 4
        x = (centers[:, torch.arange(n) % k]
             + torch.randn((c, n, d), generator=g)).cuda()
        inits = [kmeans_plus_plus(x[i].cpu(), k, generator=g).cuda()
                 for i in range(c)]
        before = ops.lloyd_step_cuda.launches
        res = kmeans_fit_batched(x, k, inits=inits, backend="cuda")
        batched_launches = ops.lloyd_step_cuda.launches - before
        label = f"kmeans_fit_batched C={c} n={n} d={d} k={k}"
        if batched_launches != (max(res.n_iter) + 1) * ops.lloyd_launches(d):
            raise AssertionError(f"{label}: {batched_launches} Lloyd launches "
                                 f"for {max(res.n_iter)} iterations")
        dre = KMeansDRE(num_centroids=k, kernel_backend="cuda")
        b_before = ops.min_dist_and_mask_clients_cuda.launches
        cents, thrs = learn_kmeans_batched(dre, x, inits=inits)
        if ops.min_dist_and_mask_clients_cuda.launches - b_before != 1:
            raise AssertionError(f"{label}: not one calibration launch")
        for i in range(c):
            one = kmeans_fit(own(x[i]), k, init=inits[i], backend="cuda")
            own_dre = dre.learn(own(x[i]), init=inits[i])
            if not (one.n_iter == res.n_iter[i]
                    and torch.equal(one.assignments, res.assignments[i])
                    and torch.equal(one.centroids, res.centroids[i])
                    and torch.equal(own_dre.centroids, cents[i])
                    and torch.equal(own_dre.threshold.reshape(()),
                                    thrs[i])):
                raise AssertionError(f"{label}: client {i} differs from its "
                                     "own fit")
        log(f"  {label}: n_iter {res.n_iter}, {batched_launches} Lloyd "
            f"launches (one an iteration for all {c}); every client's "
            "n_iter, assignments, centroids and calibrated threshold "
            "bitwise equal to its own fit's")


# --------------------------------------------------------------- phase 5/6
def fed_train(args):
    from repro_torch.launch import fed_train as ft
    return ft.main(args)


def compare_runs(label, gpu, cpu, n_test, names=("card", "CPU"),
                 diverged=(None, None)):
    """Round logs of two runs held to each other: losses within rtol 1e-3,
    accuracies within a test sample. A non-finite loss fails, except
    where both runs' ``DivergenceWatch`` showed a divergence (``diverged``,
    each run's ``(where, round)`` from ``run_one``): from the later of the
    two rounds on, two NaNs, or two infinities of one sign, agree."""
    a_name, b_name = names
    since = max(d[1] for d in diverged) if all(diverged) else None
    held = 0
    for p, q in zip(gpu.rounds, cpu.rounds):
        for f in ("local_loss", "distill_loss"):
            a, b = getattr(p, f), getattr(q, f)
            gone = since is not None and p.round >= since and (
                a == b or (a != a and b != b))
            # finite first: |a - inf| <= 1e-3 * inf would hold
            if not (finite(a) and finite(b) and abs(a - b) <= 1e-3 * abs(b)
                    or gone):
                raise AssertionError(f"{label} round {p.round} {f}: "
                                     f"{a_name} {a} vs {b_name} {b}")
        for a, b in zip(p.accs, q.accs):
            if abs(a - b) > 1.5 / n_test:
                raise AssertionError(f"{label} round {p.round} accs: "
                                     f"{a_name} {p.accs} vs {b_name} "
                                     f"{q.accs}")
        held += 1
    same = all((p.local_loss, p.distill_loss, p.accs, p.id_fraction)
               == (q.local_loss, q.distill_loss, q.accs, q.id_fraction)
               for p, q in zip(gpu.rounds, cpu.rounds))
    log(f"  {label}: {a_name} and {b_name} agree (losses rtol 1e-3, "
        f"accuracies within a test sample) over {held} rounds; last round "
        f"{a_name} {gpu.rounds[-1].local_loss:.6f}/"
        f"{gpu.rounds[-1].distill_loss:.6f} {b_name} "
        f"{cpu.rounds[-1].local_loss:.6f}/{cpu.rounds[-1].distill_loss:.6f}"
        f" (local/distill loss), id fraction {a_name} "
        f"{gpu.rounds[-1].id_fraction:.4f} {b_name} "
        f"{cpu.rounds[-1].id_fraction:.4f}; round logs bitwise equal: "
        f"{same}")


def check_small_run():
    """The port on the card (kernels) against the port on the CPU (plain
    versions), same seed, small size: float32 matmuls differ between the
    two devices, so losses hold to rtol 1e-3 and accuracies to a sample.
    The MLP and CNN clients draw their weights on the CPU, so both devices
    start from the same ones, and the CNNs' convolutions run in fp32 on
    both (fed_train pins cuDNN's TF32 off; the smoke turns it on before
    each card run to check that). The transformer clients draw their
    weights on their device, so the card's lm_tokens run loads the CPU
    run's initial weights."""
    from repro_torch.common.types import FedConfig
    from repro_torch.core.protocol import run_experiment
    from repro_torch.fed.simulator import build_experiment
    from repro_torch.kernels.flash_attention import ops as fa_ops
    import torch
    log("[5] small fed_train: card vs CPU")
    for method, scenario, dataset in (("edgefd", "weak", "mnist_feat"),
                                      ("selective-fd", "weak", "mnist_feat"),
                                      ("edgefd", "strong", "mnist_like"),
                                      ("edgefd", "strong", "cifar_like")):
        base = ["--method", method, "--scenario", scenario, "--dataset",
                dataset, "--clients", "4", "--rounds", "2", "--n-train",
                "800", "--n-test", "200"]
        # the entry point must turn cuDNN's TF32 off again
        torch.backends.cudnn.allow_tf32 = True
        gpu = fed_train(base + ["--device", "cuda"])
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError("fed_train left cuDNN's TF32 on")
        cpu = fed_train(base + ["--device", "cpu"])
        compare_runs(f"{method} {scenario} {dataset}", gpu, cpu, 200)
        if dataset.endswith("_like"):
            # reported, not asserted: cuDNN's backward may sum in an order
            # that changes from run to run
            again = fed_train(base + ["--device", "cuda"])
            same = [(p.local_loss, p.distill_loss, p.accs)
                    == (q.local_loss, q.distill_loss, q.accs)
                    for p, q in zip(gpu.rounds, again.rounds)]
            log(f"  {method} {scenario} {dataset}: a second card run's "
                f"round logs bitwise equal to the first's, by round: {same}")
    # the cohort engine: one cohort of 4, and the mixed zoo's three (6
    # clients; 9 in waves of 2, the last wave of each padded)
    small = ["--clients", "4", "--rounds", "2", "--n-train", "800",
             "--n-test", "200", "--engine", "cohort"]
    for label, flags in (
            ("edgefd strong", ["--method", "edgefd"]),
            ("selective-fd strong", ["--method", "selective-fd"]),
            ("fkd strong", ["--method", "fkd"]),
            ("edgefd strong mixed zoo, 6 clients",
             ["--zoo", "mixed", "--clients", "6"]),
            ("edgefd strong mixed zoo, 9 clients, waves of 2",
             ["--zoo", "mixed", "--clients", "9", "--wave-size", "2"])):
        base = small + flags
        gpu = fed_train(base + ["--device", "cuda"])
        cpu = fed_train(base + ["--device", "cpu"])
        compare_runs(f"cohort engine {label}", gpu, cpu, 200)
    cfg = FedConfig(method="edgefd", scenario="weak", num_clients=4,
                    rounds=2, proxy_batch=64, batch_size=16, seed=0)
    sizes = dict(n_train=800, n_test=200)
    cpu_exp = build_experiment(cfg, "lm_tokens", device="cpu", **sizes)
    init = [c.model.jax_params() for c in cpu_exp[0]]
    gpu_exp = build_experiment(cfg, "lm_tokens", device="cuda",
                               init_params=init, **sizes)
    before = fa_ops.flash_attention_cuda.launches
    gpu = run_experiment(*gpu_exp[:2], cfg.method, cfg, *gpu_exp[2:])
    launched = fa_ops.flash_attention_cuda.launches - before
    if launched == 0:
        raise AssertionError("the small lm_tokens run never launched "
                             "flash_attention")
    cpu = run_experiment(*cpu_exp[:2], cfg.method, cfg, *cpu_exp[2:])
    compare_runs(f"lm_tokens edgefd weak, reduced backbone ({launched} "
                 "flash_attention launches on the card)", gpu, cpu, 200)
    check_small_token_cohort(cfg, sizes)


def check_small_token_cohort(cfg, sizes):
    """Phase 5's token cohort: lm_tokens edgefd weak, the reduced backbone,
    on the cohort engine (4 clients, 2 rounds), the card's run from the
    CPU run's initial weights held to the CPU's; B6 launched, every
    launch's folded batch a multiple of the cohort's 4 lanes; a second
    card run bitwise equal to the first (``wall_s`` and ``phase_s``
    apart): the embedding's gradient sums in a fixed order."""
    import dataclasses
    from repro_torch.core.protocol import run_experiment
    from repro_torch.fed.simulator import build_experiment
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg = dataclasses.replace(cfg, engine="cohort")
    cpu_exp = build_experiment(cfg, "lm_tokens", device="cpu", **sizes)
    init = [c.model.jax_params() for c in cpu_exp[0]]

    def on_card():
        exp = build_experiment(cfg, "lm_tokens", device="cuda",
                               init_params=init, **sizes)
        with attn_launches(fa_ops) as attn:
            # fixed phase costs: the simulated timeline is then
            # deterministic too
            res = run_experiment(*exp[:2], cfg.method, cfg, *exp[2:],
                                 sim_phase_costs=ASYNC_COSTS)
        return res, dict(sorted(attn.by_key.items()))
    gpu, batches = on_card()
    lanes = cfg.num_clients
    if not batches or any(b % lanes for b in batches):
        raise AssertionError(f"token cohort: flash_attention launches by "
                             f"batch {batches}, not multiples of {lanes}")
    cpu = run_experiment(*cpu_exp[:2], cfg.method, cfg, *cpu_exp[2:])
    compare_runs(f"lm_tokens edgefd weak, reduced backbone, cohort engine "
                 f"({sum(batches.values())} flash_attention launches on "
                 f"the card by folded batch {batches})", gpu, cpu, 200)
    again, _ = on_card()
    a, b = strip_measured(gpu), strip_measured(again)
    if a != b:
        raise AssertionError("token cohort: two card runs differ: "
                             f"{first_difference(a, b)}")
    log(f"  lm_tokens edgefd weak cohort: a second card run's round logs "
        f"bitwise equal to the first's over {len(a)} rounds (wall_s and "
        "phase_s apart)")


def strip_measured(res):
    """A run's round logs without the host-measured fields."""
    import dataclasses
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in MEASURED} for r in res.rounds]


def launch_counts():
    from repro_torch.kernels.distill_kl import ops as kl
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.kmeans_dist import ops as kd
    from repro_torch.kernels.kulsif_rbf import ops as rbf
    return {"lloyd_step": kd.lloyd_step_cuda,
            "min_dist_and_mask": kd.min_dist_and_mask_cuda,
            "min_dist_and_mask_clients": kd.min_dist_and_mask_clients_cuda,
            "kd_kl_loss": kl.kd_kl_loss_cuda,
            "kd_kl_loss_clients": kl.kd_kl_loss_clients_cuda,
            "rbf_matrix_clients": rbf.rbf_matrix_clients_cuda,
            "kd_kl_fwd": kl.kd_kl_fwd_cuda,
            "kd_kl_bwd_ds": kl.kd_kl_bwd_ds_cuda,
            "kd_kl_bwd_dt": kl.kd_kl_bwd_dt_cuda,
            "rbf_matrix": rbf.rbf_matrix_cuda,
            "flash_attention": fa.flash_attention_cuda}


def finite(v):
    return v == v and abs(v) < float("inf")


def check_finite(label, res, diverged=None):
    """Every round's accuracies, ID fraction and losses finite. A
    non-finite loss passes only in a run whose first non-finite step loss
    ``DivergenceWatch.check`` showed to be a divergence (``diverged``):
    the same phase from the same state leaves float32's range in float64
    too."""
    for r in res.rounds:
        vals = (r.mean_acc, r.id_fraction)
        if r.server_student_acc is not None:
            vals += (r.server_student_acc,)
        loss = (r.local_loss, r.distill_loss, r.server_distill_loss)
        if not all(map(finite, vals + (() if diverged else loss))):
            raise AssertionError(f"{label} round {r.round}: non-finite "
                                 f"metrics {vals + loss}")
        if not all(map(finite, loss)):
            log(f"  {label} round {r.round}: non-finite losses (local, "
                f"distill, server distill) {loss}, after the divergence "
                f"in {diverged}")


class DivergenceWatch:
    """While in effect, saves each learner's state (parameters, momentum,
    batch-order stream) at the start of every local-training and
    distillation phase, and keeps the phase of the first step whose loss
    is not finite. ``check`` runs that phase again in float64 from the
    saved state: a divergence under plain SGD leaves float32's range
    there too (PERF.md §6), a fault of the float32 path does not. On the
    cohort engine it saves every lane's state at a cohort phase's start
    and reads the step losses the phase reads back once. It counts the
    rounds the scheduler finishes, so the first non-finite step's round
    is known."""

    def __init__(self):
        self.cur, self.first, self.rounds = None, None, 0

    def __enter__(self):
        from repro_torch.fed.client import Client, Learner
        from repro_torch.fed.scheduler import RoundScheduler
        self.orig = (Client.local_train, Learner.distill, Learner._step)
        self.orig_finish = RoundScheduler._finish_round
        local, distill, step = self.orig
        watch = self

        def finish(self, st):
            watch.rounds += 1
            return watch.orig_finish(self, st)

        def save(learner, phase, inputs, epochs, bs):
            # the loop engine runs one phase at a time: only the running
            # phase's start (and the first non-finite one's) stays alive
            watch.cur = {
                "learner": learner, "phase": phase, "inputs": inputs,
                "epochs": epochs, "bs": bs, "steps": [],
                "params": [p.detach().clone() for p in learner.params],
                "mu": [m.clone() for m in learner.opt_state["mu"]],
                "rng": learner.rng.bit_generator.state}

        def local_train(self, epochs, bs):
            save(self, "local", (self._x, self._y), epochs, bs)
            return local(self, epochs, bs)

        def distill_(self, x, teacher, weight, epochs, bs):
            save(self, "distill", (x, teacher, weight), epochs, bs)
            return distill(self, x, teacher, weight, epochs, bs)

        def step_(self, loss):
            v = step(self, loss)
            s = watch.cur
            s["steps"].append(v)
            if watch.first is None and not finite(v):
                watch.first, watch.first_step = s, len(s["steps"]) - 1
                watch.first_round = watch.rounds
            return v
        Client.local_train, Learner.distill, Learner._step = (
            local_train, distill_, step_)
        RoundScheduler._finish_round = finish
        self._watch_cohorts()
        return self

    def _watch_cohorts(self):
        import torch
        from repro_torch.fed.cohort import _Cohort
        self.orig_cohort = (_Cohort.local_train, _Cohort.distill,
                            _Cohort.distill_private, _Cohort._mean_losses)
        local, distill, private, mean = self.orig_cohort
        watch = self

        def lanes(cohort, phase, inputs_of, epochs, bs):
            # every lane's start: its client (model, optimizer, rng), its
            # slice of the stacked state, its inputs
            watch.cur = [{
                "learner": c, "phase": phase, "inputs": inputs_of(c),
                "epochs": epochs, "bs": bs,
                "params": [torch.as_tensor(p[i]).detach().clone()
                           for p in cohort.params],
                "mu": [torch.as_tensor(m[i]).clone()
                       for m in cohort.opt_state["mu"]],
                "rng": c.rng.bit_generator.state}
                for i, c in enumerate(cohort.members)]

        def local_train(self, epochs, bs, part=None):
            lanes(self, "local", lambda c: (c._x, c._y), epochs, bs)
            return local(self, epochs, bs, part=part)

        def distill_(self, px, teacher, weight, epochs, bs, part=None):
            lanes(self, "distill", lambda c: (px, teacher, weight), epochs,
                  bs)
            return distill(self, px, teacher, weight, epochs, bs, part=part)

        def private_(self, tbc, vbc, epochs, bs, part=None):
            lanes(self, "distill", lambda c: (c._x, tbc[c._y],
                                              vbc[c._y].float()), epochs, bs)
            return private(self, tbc, vbc, epochs, bs, part=part)

        def mean_(losses, valid):
            for lane, (ls, vs) in enumerate(zip(losses, valid)):
                steps = [float(v) for v, ok in zip(ls, vs) if ok]
                bad = [i for i, v in enumerate(steps) if not finite(v)]
                if watch.first is None and bad and watch.cur:
                    watch.first = dict(watch.cur[lane], steps=steps)
                    watch.first_step = bad[0]
                    watch.first_round = watch.rounds
            return mean(losses, valid)
        _Cohort.local_train, _Cohort.distill = local_train, distill_
        _Cohort.distill_private = private_
        _Cohort._mean_losses = staticmethod(mean_)

    def __exit__(self, *exc):
        from repro_torch.fed.client import Client, Learner
        from repro_torch.fed.cohort import _Cohort
        from repro_torch.fed.scheduler import RoundScheduler
        Client.local_train, Learner.distill, Learner._step = self.orig
        RoundScheduler._finish_round = self.orig_finish
        (_Cohort.local_train, _Cohort.distill, _Cohort.distill_private,
         mean) = self.orig_cohort
        _Cohort._mean_losses = staticmethod(mean)
        self.cur = None

    def check(self, label):
        """None without a non-finite step loss; else the phase's name, once
        float64 from the same state left float32's range in it. The round
        of that step is ``first_round``."""
        import copy

        import numpy as np
        import torch
        from repro_torch.fed.batching import epoch_batches
        from repro_torch.optim.optimizers import apply_updates
        s = self.first
        if s is None:
            return None
        learner = s["learner"]
        model = copy.deepcopy(learner.model).double().train(True)
        params = list(model.parameters())
        with torch.no_grad():
            for p, v in zip(params, s["params"]):
                p.copy_(v)
        state = {"mu": [m.double() for m in s["mu"]], "step": 0}
        rng = np.random.default_rng()
        rng.bit_generator.state = s["rng"]
        x = s["inputs"][0]
        T = learner.temperature
        top, losses = 0.0, []
        for _ in range(s["epochs"]):
            for idx in epoch_batches(rng.permutation(len(x)), s["bs"]):
                idx = torch.as_tensor(np.asarray(idx), device=x.device)
                z = model(x[idx].double())
                if s["phase"] == "local":
                    logp = torch.log_softmax(z, -1)
                    loss = -torch.mean(torch.take_along_dim(
                        logp, s["inputs"][1][idx, None], -1))
                else:
                    t, w = (v[idx].double() for v in s["inputs"][1:])
                    if learner.distill_loss == "mse":
                        per = torch.mean(torch.square(z - t), -1)
                    else:
                        sp = torch.log_softmax(z / T, -1)
                        tl = torch.log_softmax(t / T, -1)
                        per = torch.sum(torch.exp(tl) * (tl - sp), -1) * T * T
                    loss = torch.sum(per * w) / torch.clamp_min(w.sum(), 1.0)
                grads = torch.autograd.grad(loss, params)
                upd, state = learner.opt.update(grads, state, params)
                apply_updates(params, upd)
                top = max(top, max(float(p.detach().abs().max())
                                   for p in params))
                losses.append(float(loss.detach()))
        who = getattr(learner, "cid", "the server student")
        where = f"client {who}'s {s['phase']} phase, step {self.first_step}"
        f32_max = float(np.finfo(np.float32).max)
        log(f"  {label}: first non-finite step loss in {where}; float32 "
            "step losses " + " ".join(f"{v:.6g}" for v in s["steps"])
            + "; the phase again in float64 from the saved state: step "
            "losses " + " ".join(f"{v:.6g}" for v in losses)
            + f", largest |parameter| {top:.6g}")
        if not (max(map(abs, losses)) > f32_max or top > f32_max
                or not all(map(finite, losses + [top]))):
            raise AssertionError(f"{label}: a non-finite loss in {where} "
                                 "that float64 from the same state keeps "
                                 "inside float32's range: a fault, not a "
                                 "divergence")
        return where


def phase_seconds(res):
    phases = {}
    for r in res.rounds:
        for ph, sec in r.phase_s.items():
            phases[ph] = phases.get(ph, 0.0) + sec
    return " ".join(f"{k}={v:.3f}" for k, v in phases.items())


def lm_full_width_arch():
    """granite-8b at its published widths, depth cut to 2 layers (the
    reference token mode's depth; 36 would need 31 GB of f32 weights per
    client) and vocab to the dataset's 32 labels (the last-position sample
    logit of the reference's FD convention)."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("granite-8b"), num_layers=2,
                               vocab_size=32)


def run_lm_full_width(engine="loop"):
    """lm_tokens edgefd strong at granite-8b's widths through
    ``simulator.run`` (``fed_train`` builds the reduced backbone; the
    width is the ``transformer_cfg`` keyword), on ``engine`` (the cohort
    engine: the 10 clients stacked, unwaved). The learning rate is 5e-4,
    not the default 1e-2, which suits the reduced backbone's d_model 64:
    under plain SGD the change one step makes to a layer's output grows
    with the width of its input."""
    import torch
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    from repro_torch.launch.fed_train import print_round
    arch = lm_full_width_arch()
    cfg = FedConfig(method="edgefd", scenario="strong", num_clients=10,
                    rounds=LM_ROUNDS, batch_size=64, proxy_batch=256,
                    lr=LM_LR, seed=0, engine=engine)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = simulator.run(cfg, "lm_tokens", n_train=6000, n_test=1000,
                        device="cuda", transformer_cfg=arch,
                        progress=lambda lg: print_round(lg, cfg.num_clients))
    peak = torch.cuda.max_memory_allocated()
    log(f"  lm_tokens edgefd strong at granite-8b widths ({engine} "
        f"engine): d_model "
        f"{arch.d_model}, heads {arch.num_heads}/{arch.num_kv_heads} of "
        f"{arch.resolved_head_dim}, d_ff {arch.d_ff}, {arch.num_layers} "
        f"layers, vocab {arch.vocab_size}: {arch.param_count() / 1e6:.1f} M "
        f"parameters per client, lr {cfg.lr:g}; peak device memory "
        f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    return res


class CountedCalls:
    """Counts the calls of ``module.name`` while in effect (the distill
    steps, through the loss every client and the FedDF student call), and
    with ``key`` the calls by ``key(*args)`` in ``by_key``, each call
    weighing ``weight(*args)`` there (default 1: its kernels' launches)."""

    def __init__(self, module, name, key=None, weight=None):
        self.module, self.name, self.calls = module, name, 0
        self.orig = getattr(module, name)
        self.key, self.weight, self.by_key = key, weight, {}

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.key is not None:
            kk = self.key(*args)
            w = 1 if self.weight is None else self.weight(*args)
            self.by_key[kk] = self.by_key.get(kk, 0) + w
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def attn_launches(fa_ops):
    """B6's launches by the batch its autograd function hands the launch
    (a cohort's folded batch), each call weighing its chunks' launches."""
    return CountedCalls(fa_ops, "_launch", key=lambda q, *_: q.shape[0],
                        weight=lambda q, *_: -(-q.shape[0]
                                               // fa_ops.MAX_GRID_YZ))


def dist_class(x, cents, threshold):
    """B2's launch shapes by class: ("calibration", d, k) for the fit's
    calibration over a private set (``KMeansDRE.learn`` passes the infinite
    float threshold), ("report", d, k) for a report's proxy batch (the
    calibrated device threshold)."""
    kind = "calibration" if isinstance(threshold, float) else "report"
    return (kind, x.shape[1], cents.shape[0])


def rbf_class(n, m, d):
    """B5's launch shapes by class: (n, m, d) with m the KuLSIF aux set's
    256, else (n, "m%8=0", d) or (n, "m%8!=0", d) for a private set, whose
    rows start on a 32-byte sector or inside one."""
    return (n, m if m == 256 else "m%8=0" if m % 8 == 0 else "m%8!=0", d)


def lloyd_by_route(by_dk):
    """B1's launches by (d, k) summed by (route, k): narrow for d <= 64
    (one launch a call), wide beyond (two)."""
    out = {}
    for (d, k), v in by_dk.items():
        key = ("narrow" if d <= 64 else "wide", k)
        out[key] = out.get(key, 0) + v
    return dict(sorted(out.items()))


def run_main_path():
    """Phase 6. Returns the launch counts of the whole phase, the
    transformer run's attention launches by query batch size, B1's
    launches by (d, k), B5's by shape class (``rbf_class``) and B2's by
    class (``dist_class``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kulsif_rbf import ops as rbf_ops
    mlp_runs = ([("edgefd", sc) for sc in ("strong", "weak")]
                + [("selective-fd", sc) for sc in ("strong", "weak")]
                + [(m, "strong") for m in METHODS_WITHOUT_KERNELS])
    common = ["--clients", "10", "--rounds", str(MAIN_ROUNDS), "--n-test",
              "10000", "--proxy-batch", "512", "--device", "cuda"]
    runs = [(f"{m} {sc}", lambda m=m, sc=sc: fed_train(
        ["--method", m, "--scenario", sc, "--n-train", "60000"] + common))
        for m, sc in mlp_runs]
    runs += [(f"{ds} {m} {sc}", lambda ds=ds, m=m, sc=sc, n=n: fed_train(
        ["--method", m, "--scenario", sc, "--dataset", ds, "--n-train", n]
        + common)) for ds, m, sc, n in IMAGE_RUNS]
    runs.append(("lm_tokens edgefd strong", run_lm_full_width))
    log("[6] main path: fed_train, 10 clients, n_train 60000, n_test 10000, "
        f"{MAIN_ROUNDS} rounds, proxy batch 512: "
        + ", ".join(f"{m} {sc}" for m, sc in mlp_runs)
        + "; the image path (the Tables I/II CNN zoo) at the same sizes "
        "(cifar_like n_train 50000): "
        + ", ".join(f"{ds} {m} {sc}" for ds, m, sc, _ in IMAGE_RUNS)
        + f"; then lm_tokens edgefd strong at granite-8b's widths, 10 "
        f"clients, n_train 6000, n_test 1000, {LM_ROUNDS} rounds, batch 64, "
        "proxy batch 256")
    if dispatch.resolve() != "cuda":
        raise AssertionError("the kernel backend does not resolve to cuda")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    results, per_run, steps, attn_batches = {}, {}, {}, {}
    # B1's calls by (d, k) (centroids (k, d) or (C, k, d)), B5's by (n, m,
    # d), at the public ops, which dispatch looks up at call time (B1's
    # calls weighed by their launches, each B5 call on a CUDA tensor one
    # launch; checked against the launch counts below)
    lloyd_by_k = CountedCalls(
        kd_ops, "lloyd_step", key=lambda x, c: (x.shape[-1], c.shape[-2]),
        weight=lambda x, c: kd_ops.lloyd_launches(x.shape[-1]))
    rbf_by_shape = CountedCalls(
        rbf_ops, "rbf_matrix",
        key=lambda a, b, s: (a.shape[0], b.shape[0], a.shape[1]))
    rows_by_class = {}   # B2's row counts t by class: (least, most)

    def dist_key(x, cents, threshold):
        kk = dist_class(x, cents, threshold)
        lo, hi = rows_by_class.get(kk, (x.shape[0], x.shape[0]))
        rows_by_class[kk] = (min(lo, x.shape[0]), max(hi, x.shape[0]))
        return kk
    dist_by_class = CountedCalls(kd_ops, "min_dist_and_mask", key=dist_key)
    with lloyd_by_k, rbf_by_shape, dist_by_class:
        for label, drive in runs:
            run_one(label, drive, wrappers, results, per_run, steps,
                    attn_batches)
    counts = {n: w.launches for n, w in wrappers.items()}
    by_k = dict(sorted(lloyd_by_k.by_key.items()))
    by_shape = {}
    for (n, m, d), v in rbf_by_shape.by_key.items():
        cls = rbf_class(n, m, d)
        by_shape[cls] = by_shape.get(cls, 0) + v
    if sum(by_k.values()) != counts["lloyd_step"]:
        raise AssertionError(f"lloyd_step: {sum(by_k.values())} launches "
                             f"by (d, k) for {counts['lloyd_step']} "
                             "counted")
    if sum(by_shape.values()) != counts["rbf_matrix"]:
        raise AssertionError(f"rbf_matrix: {sum(by_shape.values())} calls "
                             f"for {counts['rbf_matrix']} launches")
    by_class = dict(sorted(dist_by_class.by_key.items()))
    if sum(by_class.values()) != counts["min_dist_and_mask"]:
        raise AssertionError(f"min_dist_and_mask: {sum(by_class.values())} "
                             f"calls for {counts['min_dist_and_mask']} "
                             "launches")
    for what, hits in (
            ("lloyd_step's wide route", [dk for dk in by_k if dk[0] > 64]),
            ("min_dist_and_mask at image widths",
             [c for c in by_class if c[1] in WIDE_DS]),
            ("rbf_matrix at image widths",
             [c for c in by_shape if c[2] in WIDE_DS])):
        if not hits:
            raise AssertionError(f"the image path never launched {what}")
    log("  min_dist_and_mask launches by (class, d, k): "
        + ", ".join(f"{kk}: {v} (t {rows_by_class[kk][0]}.."
                    f"{rows_by_class[kk][1]})" for kk, v in by_class.items()))
    log(f"  lloyd_step launches by (d, k): {by_k}, by (route, k): "
        f"{lloyd_by_route(by_k)}; rbf_matrix launches by (n, m, d) class: "
        f"{by_shape} (private sizes: "
        + ", ".join(f"{k}: {v}" for k, v in
                    sorted(rbf_by_shape.by_key.items()) if k[1] != 256)
        + ")")
    return finish_main_path(runs, mlp_runs, counts, results, per_run, steps,
                            attn_batches) + (by_k, by_shape, by_class,
                                             results)


def run_one(label, drive, wrappers, results, per_run, steps, attn_batches,
            kl_name="kd_kl_loss"):
    """One run of phase 6, its launches counted into per_run[label], its
    distill steps (calls of ``core.distill.<kl_name>``) into
    steps[label]."""
    import torch
    from repro_torch.core import distill
    from repro_torch.kernels import dispatch
    before = {n: w.launches for n, w in wrappers.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # attention calls by query batch size: q is (B, S, N, h)
    # an image run's phases are saved as they start (a few MB a client),
    # so that a non-finite loss can be held to float64 after the run
    watch = DivergenceWatch() if "_like" in label else None
    with CountedCalls(distill, kl_name) as kl_steps, \
            CountedCalls(dispatch, "flash_attention",
                         key=lambda q, *_: q.shape[0]) as attn, \
            watch or contextlib.nullcontext():
        res = drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {n: w.launches - before[n] for n, w in wrappers.items()}
    steps[label] = kl_steps.calls
    attn_batches[label] = dict(sorted(attn.by_key.items()))
    diverged = watch.check(label) if watch else None
    check_finite(label, res, diverged)
    # (where, round) of a shown divergence, for compare_runs
    res.divergence = diverged and (diverged, watch.first_round)
    last = res.rounds[-1]
    student = ("" if last.server_student_acc is None
               else f", student acc {last.server_student_acc:.4f}")
    log(f"  {label}: final acc {res.final_acc:.4f}{student}, id "
        f"fraction {last.id_fraction:.4f}, MB up "
        f"{last.bytes_up / 1e6:.3f}, last losses local "
        f"{last.local_loss:.4f} distill {last.distill_loss:.4f}, wall "
        f"{wall:.3f} s (set-up + {len(res.rounds)} rounds), phase "
        f"seconds over {len(res.rounds)} rounds {phase_seconds(res)}, peak "
        f"device memory {peak / 2**30:.3f} GiB")
    log(f"  {label}: launches "
        + str({n: v for n, v in launches.items() if v}))
    results[label] = res
    per_run[label] = launches


def finish_main_path(runs, mlp_runs, counts, results, per_run, steps,
                     attn_batches):
    """Phase 6's checks over all runs; returns (counts, the transformer
    run's attention launches by query batch size)."""
    for name in ("lloyd_step", "min_dist_and_mask", "kd_kl_loss",
                 "rbf_matrix", "flash_attention"):
        if counts[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    # one launch of the fused loss per distill step, in every run that
    # distills (all but indlearn), and none of the per-sample KL kernels
    for label, launches in per_run.items():
        if launches["kd_kl_loss"] != steps[label]:
            raise AssertionError(f"{label}: {launches['kd_kl_loss']} "
                                 f"kd_kl_loss launches for {steps[label]} "
                                 "distill steps")
        if (steps[label] == 0) != label.startswith("indlearn"):
            raise AssertionError(f"{label}: {steps[label]} distill steps")
        for name in ("kd_kl_fwd", "kd_kl_bwd_ds", "kd_kl_bwd_dt"):
            if launches[name]:
                raise AssertionError(f"{label} launched {name} "
                                     f"{launches[name]} times")
    for scenario in ("strong", "weak"):
        if per_run[f"edgefd {scenario}"]["min_dist_and_mask"] == 0:
            raise AssertionError(f"edgefd {scenario} never launched "
                                 "min_dist_and_mask")
        if per_run[f"selective-fd {scenario}"]["rbf_matrix"] == 0:
            raise AssertionError(f"selective-fd {scenario} never launched "
                                 "rbf_matrix")
    lm = per_run["lm_tokens edgefd strong"]
    for name in ("lloyd_step", "min_dist_and_mask", "kd_kl_loss",
                 "flash_attention"):
        if lm[name] == 0:
            raise AssertionError(f"lm_tokens edgefd never launched {name}")
    layers = lm_full_width_arch().num_layers
    if lm["flash_attention"] % layers:
        raise AssertionError(f"lm_tokens edgefd: {lm['flash_attention']} "
                             f"flash_attention launches, not {layers} per "
                             "forward")
    by_batch = attn_batches["lm_tokens edgefd strong"]
    if sum(by_batch.values()) != lm["flash_attention"]:
        raise AssertionError(f"lm_tokens edgefd: {sum(by_batch.values())} "
                             "attention calls for "
                             f"{lm['flash_attention']} kernel launches")
    if any(per_run[f"{m} {sc}"]["flash_attention"] for m, sc in mlp_runs):
        raise AssertionError("a feature-path run launched flash_attention")
    # the image path: the KMeans-DRE fit on the Lloyd kernel's wide route
    # and its estimation step at image widths, KuLSIF's Gram matrices at
    # image widths
    for ds, m, sc, _ in IMAGE_RUNS:
        launches = per_run[f"{ds} {m} {sc}"]
        need = (("lloyd_step", "min_dist_and_mask") if m == "edgefd"
                else ("rbf_matrix",))
        for name in need:
            if launches[name] == 0:
                raise AssertionError(f"{ds} {m} {sc} never launched {name}")
        if launches["flash_attention"]:
            raise AssertionError(f"{ds} {m} {sc} launched flash_attention")
    # server_distill's clients distill exactly as fedmd's do; the rest of
    # its KL launches are the server student's
    student_kl = (per_run["server_distill strong"]["kd_kl_loss"]
                  - per_run["fedmd strong"]["kd_kl_loss"])
    if student_kl <= 0:
        raise AssertionError("the server_distill student never launched "
                             "kd_kl_loss")
    log(f"  launches on the main path (all {len(runs)} runs): {counts}; "
        f"distill steps {sum(steps.values())}, one kd_kl_loss launch each; "
        f"the server_distill student's kd_kl_loss: {student_kl}; "
        f"lm_tokens: {lm['flash_attention'] // layers} forwards of "
        f"{layers} layers, flash_attention launches by query batch size "
        f"{by_batch}; the per-sample KL kernels are off the main path "
        "(the fused loss replaces them; the teacher is a constant)")
    for ds, m, sc, _ in IMAGE_RUNS:
        log(f"  {ds} {m} {sc}: final accuracy "
            f"{results[f'{ds} {m} {sc}'].final_acc:.4f} (printed, not "
            "limited)")
    final = results["edgefd strong"].final_acc
    if not final > 0.7:
        raise AssertionError(f"edgefd strong final mean accuracy {final} "
                             "<= 0.7")
    return counts, by_batch


# ------------------------------------------------------- phase 6, cohort
# the cohort engine's feature runs at the main path's sizes, each held to
# phase 6's loop run of the same configuration
COHORT_RUNS = (("edgefd", "strong"), ("edgefd", "weak"),
               ("selective-fd", "strong"), ("fkd", "strong"))
# the scale run: the mixed zoo over 100 clients (cohorts of 34, 33, 33 at
# hidden widths (256, 128), (128, 64), (512, 256)), 600 samples each (the
# iid split; the strong one gives each client a class of its own and so
# takes at most 10 clients), unwaved, in waves of 16, and on the loop
# engine
SCALE_CLIENTS, SCALE_WAVE = 100, 16


# the token cohort at full width: phase 6's lm_tokens run on the cohort
# engine, its 10 clients stacked on the card, unwaved
LM_COHORT = "cohort lm_tokens edgefd strong, granite-8b widths"


def check_lm_cohort(launches, steps, by_c, attn_by_batch):
    """The full-width token cohort's launches: B6 a whole number of
    forwards of the backbone's layers, every launch's folded batch a
    multiple of the 10 lanes; the per-client KMeans-DRE fits (the strong
    split's private sets are ragged) on B1, B2 over the cohort, one fused
    loss launch a distill step and no 2-D or per-sample KL launch."""
    layers, lanes = lm_full_width_arch().num_layers, 10
    n = launches["flash_attention"]
    if not n or n % layers or sum(attn_by_batch.values()) != n:
        raise AssertionError(f"{LM_COHORT}: {n} flash_attention launches "
                             f"({attn_by_batch} by batch), not a multiple "
                             f"of {layers} layers")
    if any(b % lanes for b in attn_by_batch):
        raise AssertionError(f"{LM_COHORT}: flash_attention batches "
                             f"{attn_by_batch}, not multiples of {lanes}")
    for name in ("lloyd_step", "min_dist_and_mask_clients",
                 "kd_kl_loss_clients"):
        if not launches[name]:
            raise AssertionError(f"{LM_COHORT} never launched {name}")
    if launches["kd_kl_loss_clients"] != steps:
        raise AssertionError(f"{LM_COHORT}: {launches['kd_kl_loss_clients']}"
                             f" batched KL launches for {steps} cohort "
                             "distill steps")
    for name in ("kd_kl_loss", "kd_kl_fwd", "kd_kl_bwd_ds", "kd_kl_bwd_dt"):
        if launches[name]:
            raise AssertionError(f"{LM_COHORT} launched {name} "
                                 f"{launches[name]} times")
    log(f"  {LM_COHORT}: flash_attention {n} launches ({n // layers} "
        f"forwards of {layers} layers) by folded batch {attn_by_batch}; "
        f"Lloyd launches by C {by_c[0]}, B2 calls by (class, C) {by_c[1]}, "
        f"fused loss {launches['kd_kl_loss_clients']} launches for {steps} "
        "distill steps")


def deterministic(drive):
    """``drive()`` with cuDNN's deterministic algorithms (restored after)."""
    import torch
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return drive()
    finally:
        torch.backends.cudnn.deterministic = was


def run_cohort_path(loop_results):
    """Phase 6 for the cohort engine, its launches counted from 0: the
    feature runs against ``loop_results`` (phase 6's loop runs), the
    100-client scale run three ways, and mnist_like edgefd strong and weak
    (ten one-client cohorts) against loop runs, each pair with cuDNN's
    deterministic algorithms, and the token cohort at granite-8b's widths
    against ``loop_results``' lm_tokens run (``check_lm_cohort``). Asserts that each cohort's
    Lloyd launches go one an iteration for the cohort (C > 1 in a uniform
    cohort), B2 one launch a cohort a report and a calibration, B5 one
    launch a Gram matrix a cohort a report, the fused loss one launch a
    cohort a distill step. Returns (the path's counts, the launches by
    client count C of B1, B2 and B5's batched routes)."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed.batching import steps_per_epoch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kulsif_rbf import ops as rbf_ops
    cfg0 = FedConfig()
    common = ["--rounds", str(MAIN_ROUNDS), "--n-test", "10000",
              "--proxy-batch", "512", "--device", "cuda"]
    feat = ["--clients", "10", "--n-train", "60000"] + common
    scale = ["--method", "edgefd", "--scenario", "iid", "--zoo", "mixed",
             "--clients", str(SCALE_CLIENTS), "--n-train", "60000"] + common
    runs = [(f"cohort {m} {sc}", 1, lambda m=m, sc=sc: fed_train(
        ["--method", m, "--scenario", sc, "--engine", "cohort"] + feat))
        for m, sc in COHORT_RUNS]
    runs += [
        ("cohort scale, unwaved", 3, lambda: fed_train(
            scale + ["--engine", "cohort"])),
        ("cohort scale, waves of 16", 9, lambda: fed_train(
            scale + ["--engine", "cohort", "--wave-size", str(SCALE_WAVE)])),
        ("loop scale", 0, lambda: fed_train(scale)),
    ]
    # the image path, engine against engine, both with cuDNN's
    # deterministic algorithms: its defaults add the convolutions' weight
    # gradients in an order that changes from run to run, and over
    # full-size rounds (the strong split's through its divergence, ROADMAP
    # C8) two runs of one engine part by more than the tolerances
    for sc in ("strong", "weak"):
        flags = ["--method", "edgefd", "--scenario", sc, "--dataset",
                 "mnist_like"] + feat
        runs += [(f"loop mnist_like edgefd {sc}, deterministic cuDNN", 0,
                  lambda flags=flags: deterministic(lambda: fed_train(
                      flags))),
                 (f"cohort mnist_like edgefd {sc}, deterministic cuDNN", 10,
                  lambda flags=flags: deterministic(lambda: fed_train(
                      flags + ["--engine", "cohort"])))]
    runs.append((LM_COHORT, 1, lambda: run_lm_full_width("cohort")))
    log("[6] the cohort engine's path: " + ", ".join(r[0] for r in runs)
        + f" (scale: the mixed zoo, {SCALE_CLIENTS} clients, iid, n_train "
        "60000; the rest 10 clients at the main path's sizes)")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    results, per_run, steps, attn = {}, {}, {}, {}
    # each batched route's calls by client count C (B2 also by class)
    lloyd = CountedCalls(kd_ops, "lloyd_step",
                         key=lambda x, c: x.shape[0] if x.ndim == 3 else 1,
                         weight=lambda x, c: kd_ops.lloyd_launches(
                             x.shape[-1]))
    dist = CountedCalls(kd_ops, "min_dist_and_mask",
                        key=lambda x, c, thr: (
                            "calibration" if isinstance(thr, float)
                            else "report", c.shape[0] if c.ndim == 3 else 1))
    rbf = CountedCalls(rbf_ops, "rbf_matrix",
                       key=lambda a, b, s: b.shape[0] if b.ndim == 3 else 1)
    # B6's launches by (folded) batch
    flash = attn_launches(fa_ops)
    by_run = {}
    for label, cohorts, drive in runs:
        for cc in (lloyd, dist, rbf, flash):
            cc.by_key = {}
        with lloyd, dist, rbf, flash:
            run_one(label, drive, wrappers, results, per_run, steps, attn,
                    kl_name="kd_kl_loss" if label.startswith("loop")
                    else "kd_kl_loss_clients")
        by_run[label] = (dict(lloyd.by_key), dict(dist.by_key),
                         dict(rbf.by_key))
        log(f"  {label}: Lloyd launches by C {by_run[label][0]}, B2 calls "
            f"by (class, C) {by_run[label][1]}, B5 calls by C "
            f"{by_run[label][2]}")
        if label == LM_COHORT:
            check_lm_cohort(per_run[label], steps[label], by_run[label],
                            dict(flash.by_key))
            continue
        if label.startswith("loop"):
            continue
        launches = per_run[label]
        # the fused loss: one launch a cohort a distill step, and no 2-D
        # or per-sample KL launch
        if launches["kd_kl_loss_clients"] != steps[label] or not steps[label]:
            raise AssertionError(f"{label}: {launches['kd_kl_loss_clients']}"
                                 f" batched KL launches for {steps[label]} "
                                 "cohort distill steps")
        for name in ("kd_kl_loss", "kd_kl_fwd", "kd_kl_bwd_ds",
                     "kd_kl_bwd_dt", "flash_attention"):
            if launches[name]:
                raise AssertionError(f"{label} launched {name} "
                                     f"{launches[name]} times")
        if "fkd" not in label:   # distill on the proxy batch: per cohort
            waves = cohorts
            want = (waves * MAIN_ROUNDS * cfg0.distill_epochs
                    * steps_per_epoch(512, cfg0.batch_size))
            if steps[label] != want:
                raise AssertionError(f"{label}: {steps[label]} distill "
                                     f"steps, not {want} ({waves} cohort "
                                     "waves a round)")
        l_by_c, d_by_c, r_by_c = by_run[label]
        reports = sum(v for (kind, _), v in d_by_c.items()
                      if kind == "report")
        if "selective-fd" in label:
            if r_by_c.get(10, 0) != 2 * MAIN_ROUNDS:
                raise AssertionError(f"{label}: B5 over clients {r_by_c}, "
                                     "not two Gram matrices a report")
        elif "fkd" not in label and reports != MAIN_ROUNDS * cohorts:
            raise AssertionError(f"{label}: {reports} B2 report launches, "
                                 f"not one a cohort wave a round")
        if "scale" in label:
            # uniform cohorts: the fit and the calibration batched
            calib = {c: v for (kind, c), v in d_by_c.items()
                     if kind == "calibration"}
            if set(l_by_c) & {1} or set(calib) & {1} or \
                    sum(calib.values()) != cohorts:
                raise AssertionError(f"{label}: a per-client fit (Lloyd "
                                     f"by C {l_by_c}, calibrations {calib})")
    for name in ("lloyd_step", "min_dist_and_mask_clients",
                 "kd_kl_loss_clients", "rbf_matrix_clients",
                 "flash_attention"):
        if sum(per_run[r[0]][name] for r in runs) == 0:
            raise AssertionError(f"the cohort path never launched {name}")
    counts = {n: w.launches for n, w in wrappers.items()}
    for m, sc in COHORT_RUNS:
        compare_runs(f"cohort {m} {sc} against the loop engine",
                     results[f"cohort {m} {sc}"], loop_results[f"{m} {sc}"],
                     10000, names=("cohort", "loop"))
    lm_c, lm_l = results[LM_COHORT], loop_results["lm_tokens edgefd strong"]
    compare_runs(f"{LM_COHORT} against the loop engine", lm_c, lm_l, 1000,
                 names=("cohort", "loop"))
    for name, res in (("cohort", lm_c), ("loop", lm_l)):
        log(f"  lm_tokens edgefd strong at granite-8b widths, {name} "
            f"engine: round wall seconds "
            + " ".join(f"{r.wall_s:.3f}" for r in res.rounds)
            + f" (sum {sum(r.wall_s for r in res.rounds):.3f}); phase "
            f"seconds {phase_seconds(res)}")
    un, wv = (results["cohort scale, unwaved"],
              results["cohort scale, waves of 16"])
    compare_runs("scale: waves of 16 against unwaved", wv, un, 10000,
                 names=("waved", "unwaved"))
    compare_runs("scale: cohort against the loop engine", un,
                 results["loop scale"], 10000, names=("cohort", "loop"))
    for sc in ("strong", "weak"):
        det = f"mnist_like edgefd {sc}, deterministic cuDNN"
        a, b = results[f"cohort {det}"], results[f"loop {det}"]
        compare_runs(f"{det}: cohort against the loop engine", a, b, 10000,
                     names=("cohort", "loop"),
                     diverged=(a.divergence, b.divergence))
    final = results["cohort edgefd strong"].final_acc
    if not final > 0.7:
        raise AssertionError(f"cohort edgefd strong final mean accuracy "
                             f"{final} <= 0.7")
    for label, _, _ in runs:
        ph = {}
        for r in results[label].rounds:
            for k, v in r.phase_s.items():
                ph[k] = ph.get(k, 0.0) + v
        log(f"  {label}: round seconds "
            + " ".join(f"{sum(r.phase_s.values()):.3f}"
                       for r in results[label].rounds))
    log(f"  launches on the cohort path: {counts}")
    lloyd_c = sum(v for lb in by_run.values() for c, v in lb[0].items()
                  if c > 1)
    return counts, lloyd_c, by_run


# ----------------------------------------------------- phase 5/6, scheduler
# benchmarks/async_rounds.py's fixed per-phase costs and
# benchmarks/hetero_zoo.py's per-cohort ones (simulated seconds): under
# either the simulated timeline is deterministic
ASYNC_COSTS = {"local_train": 1.0, "report": 0.1, "aggregate": 0.3,
               "distill": 1.0, "eval": 0.0}
HETERO_COSTS = {"local_train@0": 3.0, "local_train@1": 1.0,
                "local_train@2": 0.5, "report@0": 0.1, "report@1": 0.1,
                "report@2": 0.1, "aggregate": 0.3, "distill@0": 0.5,
                "distill@1": 1.0, "distill@2": 3.0, "eval": 0.0}


def sched_fields(res):
    """The round logs' scheduler fields, which two devices must share."""
    return [(r.participants, r.mean_staleness, r.bytes_up, r.bytes_down,
             r.sim_finish_s, r.served_model_age_s) for r in res.rounds]


def check_small_scheduler_runs():
    """Phase 5 for the full scheduler: a partial-participation overlap run
    (edgefd strong, 8 clients, fraction 0.5 uniform, staleness decay 0.5,
    3 rounds, max_inflight 2, fixed phase costs) on each engine, card
    against CPU: round logs by ``compare_runs``, and participants, mean
    staleness, bytes, ``sim_finish_s`` and ``served_model_age_s``
    equal."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    log("[5] small partial-participation overlap runs: card vs CPU")
    t0 = time.perf_counter()
    for engine in ("loop", "cohort"):
        cfg = FedConfig(method="edgefd", scenario="strong", num_clients=8,
                        rounds=3, engine=engine, participation_fraction=0.5,
                        participation_policy="uniform", staleness_decay=0.5,
                        round_mode="overlap", max_inflight=2, seed=0)
        gpu, cpu = (simulator.run(cfg, n_train=800, n_test=200, device=dev,
                                  sim_phase_costs=ASYNC_COSTS)
                    for dev in ("cuda", "cpu"))
        label = f"{engine} edgefd strong, fraction 0.5, overlap"
        compare_runs(label, gpu, cpu, 200)
        if sched_fields(gpu) != sched_fields(cpu):
            raise AssertionError(f"{label}: scheduler fields differ: card "
                                 f"{sched_fields(gpu)} CPU "
                                 f"{sched_fields(cpu)}")
        log(f"  {label}: participants, staleness, bytes, sim_finish_s and "
            "served_model_age_s equal: "
            + "; ".join(f"r{r.round} {r.participants} stale "
                        f"{r.mean_staleness:.3f} sim {r.sim_finish_s:.3f}"
                        for r in gpu.rounds))
    log(f"  phase 5's scheduler runs took {time.perf_counter() - t0:.1f} s")


# phase 5's robustness runs: tests/test_faults.py's scenarios (edgefd
# strong, 5 clients, 2 rounds, proxy batch 96, batch 32, n_train 500,
# n_test 200): each fault mode, the robust reducers under a colluding flip,
# 3 edge aggregators (subset rounds; Selective-FD's filter at the edges),
# and quarantine (4 clients, 3 rounds)
SMALL_ROBUST = dict(method="edgefd", scenario="strong", num_clients=5,
                    rounds=2, proxy_batch=96, batch_size=32, lr=1e-2, seed=0)
ROBUST_CASES = (
    [(f"fault {m}", dict(fault_mode=m, byzantine_frac=0.4, fault_prob=0.2))
     for m in ("nan", "random_logits", "scaled", "colluding_flip",
               "stale_replay")]
    + [(f"{red} under a colluding flip",
        dict(fault_mode="colluding_flip", byzantine_frac=0.3,
             robust_aggregation=red,
             trim_frac=0.45 if red == "trimmed_mean" else 0.2))
       for red in ("trimmed_mean", "median", "krum_row")]
    + [("3 edges, fraction 0.6, decay 0.5",
        dict(num_edge_aggregators=3, participation_fraction=0.6,
             staleness_decay=0.5)),
       ("selective-fd on 3 edges",
        dict(method="selective-fd", num_edge_aggregators=3)),
       ("quarantine", dict(fault_mode="scaled", byzantine_frac=0.25,
                           robust_aggregation="trimmed_mean", trim_frac=0.3,
                           quarantine_threshold=2.0, quarantine_rounds=2,
                           num_clients=4, rounds=3))])


def robust_fields(res):
    """The round fields the defense stack decides, which two devices must
    share."""
    return [(r.scrubbed_rows, r.quarantined, r.participants, r.bytes_up)
            for r in res.rounds]


def check_small_robust_runs():
    """Phase 5 for the robustness layer: every ROBUST_CASES run on both
    engines, card against CPU: round logs by ``compare_runs``, and
    scrubbed rows, quarantined clients, participants and bytes equal."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    log("[5] small robustness runs (faults, robust reducers, edges, "
        "quarantine): card vs CPU")
    t0 = time.perf_counter()
    for label, knobs in ROBUST_CASES:
        for engine in ("loop", "cohort"):
            cfg = FedConfig(**dict(SMALL_ROBUST, **knobs, engine=engine))
            gpu, cpu = (simulator.run(cfg, n_train=500, n_test=200,
                                      device=dev) for dev in ("cuda", "cpu"))
            name = f"{engine} {label}"
            compare_runs(name, gpu, cpu, 200)
            if robust_fields(gpu) != robust_fields(cpu):
                raise AssertionError(f"{name}: card {robust_fields(gpu)} "
                                     f"CPU {robust_fields(cpu)}")
            log(f"  {name}: scrubbed rows, quarantined, participants and "
                f"bytes equal: " + "; ".join(
                    f"r{r.round} scrubbed {r.scrubbed_rows} quarantined "
                    f"{r.quarantined} part {r.participants}"
                    for r in gpu.rounds))
    log(f"  phase 5's robustness runs took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------- phase 5, resume
# tests/test_faults.py's watchdog scenario: a nan burst in round 2 from a
# third of the clients, with the sanitize pass off
WATCHDOG = dict(method="edgefd", scenario="strong", num_clients=6, rounds=4,
                proxy_batch=96, batch_size=32, sanitize_reports=False,
                fault_mode="nan", byzantine_frac=0.34, fault_start=2,
                fault_duration=1, seed=0)


def drain_resumed(snapshot, config, device, n_train, n_test):
    """A fresh experiment of ``config`` on ``device`` (the service's
    ``build_scheduler``, fixed phase costs), ``snapshot`` (a state tree as
    ``restore_state`` returns it) restored into it and drained."""
    from repro_torch.launch.fed_serve import build_scheduler
    sched = build_scheduler(config, "mnist_feat", n_train, n_test, True,
                            device)
    sched.restore(snapshot)
    sched.drain()
    return sched


def uninterrupted(config, device, n_train, n_test, crash_round=1):
    """``config`` run to its end on ``device`` with fixed phase costs, and
    its snapshot trees at the phase boundaries of ``crash_round``."""
    from repro_torch.launch.fed_serve import build_scheduler
    sched = build_scheduler(config, "mnist_feat", n_train, n_test, True,
                            device)
    sched.begin(0, config.rounds)
    snaps = []
    while sched.has_pending():
        phase, r, _ = sched.step()
        if r == crash_round:
            snaps.append((phase, sched.snapshot().to_tree()))
    return sched, snaps


def check_resume_across(label, config, src, dst, boundaries=None,
                        n_train=800, n_test=200):
    """Snapshots of a run on ``src`` at the boundaries of round 1 (or
    ``boundaries``), each written with ``save_state``, read back with
    ``restore_state``, restored into a fresh experiment on ``dst`` and
    drained, held to ``src``'s uninterrupted run: ``compare_runs``'s
    tolerance (losses rtol 1e-3, accuracies within a test sample), and
    participants, staleness, bytes and the simulated timeline equal."""
    import tempfile
    from repro_torch.checkpoint import restore_state, save_state
    live, snaps = uninterrupted(config, src, n_train, n_test)
    live_res = types.SimpleNamespace(rounds=live.logs)
    held = []
    with tempfile.TemporaryDirectory() as tmp:
        for step, (phase, tree) in enumerate(snaps):
            if boundaries is not None and phase not in boundaries:
                continue
            save_state(tmp, step, tree)
            got = drain_resumed(restore_state(tmp, step), config, dst,
                                n_train, n_test)
            res = types.SimpleNamespace(rounds=got.logs)
            name = f"{label}, {src} snapshot after ({phase}, 1) on {dst}"
            compare_runs(name, res, live_res, n_test, names=(dst, src))
            if sched_fields(res) != sched_fields(live_res):
                raise AssertionError(f"{name}: scheduler fields differ: "
                                     f"{sched_fields(res)} vs "
                                     f"{sched_fields(live_res)}")
            held.append(phase)
    log(f"  {label}: {src} -> {dst} restores at {held} held; "
        "participants, staleness, bytes and sim times equal")


def check_small_resume_runs():
    """Phase 5 for the state layer: card snapshots at every boundary of
    round 1 restored on the CPU, on each engine (overlap, fraction 0.75,
    staleness decay 0.5, fixed costs), one CPU snapshot restored on the
    card, a selective-fd run's (B5 on the path) card snapshots on the
    CPU, and the divergence watchdog card against CPU: rollbacks,
    quarantined clients and the finiteness of every retired log equal."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    log("[5] small resume runs: snapshots moved between card and CPU, and "
        "the watchdog")
    t0 = time.perf_counter()
    base = dict(method="edgefd", scenario="strong", num_clients=4, rounds=3,
                round_mode="overlap", max_inflight=2,
                participation_fraction=0.75, staleness_decay=0.5, seed=0)
    for engine in ("loop", "cohort"):
        check_resume_across(f"{engine} edgefd overlap",
                            FedConfig(**base, engine=engine), "cuda", "cpu")
    check_resume_across("cohort edgefd overlap",
                        FedConfig(**base, engine="cohort"), "cpu", "cuda",
                        boundaries=("aggregate",))
    check_resume_across("loop selective-fd overlap",
                        FedConfig(**dict(base, method="selective-fd")),
                        "cuda", "cpu")
    cfg = FedConfig(**WATCHDOG, engine="cohort", watchdog=True)
    gpu, cpu = (simulator.run(cfg, n_train=500, n_test=200, device=dev)
                for dev in ("cuda", "cpu"))
    compare_runs("cohort watchdog, nan burst", gpu, cpu, 200)
    fields = [[(r.rollbacks, r.quarantined, finite(r.mean_acc)
                and finite(r.distill_loss)) for r in res.rounds]
              for res in (gpu, cpu)]
    if fields[0] != fields[1] or not all(f[2] for f in fields[0]) \
            or not fields[0][-1][0]:
        raise AssertionError(f"watchdog card vs CPU (rollbacks, "
                             f"quarantined, finite): {fields}")
    log(f"  cohort watchdog: (rollbacks, quarantined, finite) by round equal "
        f"on card and CPU: {fields[0]}")
    log(f"  phase 5's resume runs took {time.perf_counter() - t0:.1f} s")


# phase 6's edge-fleet runs: BENCH_async's deployment at MNIST's split
# sizes (128 iid clients, 468-469 samples each), the mixed zoo over 30
# clients priced with hetero_zoo's costs, heavy traffic, and the class-wise
# and KuLSIF methods under round-robin participation. The heavy traffic is
# benchmarks/scale.py's traffic rows' (traffic_c1k, quick_traffic_c256:
# uniform fraction 0.5, decay 0.5, bursty arrivals over 60 s, churn and
# dropout 0.05, sync rounds, waves of a quarter of the fleet, 4 edge
# aggregators) on BENCH_async's 128 clients, held to a flat server's run
# depth cut for time: 2 rounds, was 10, then 3; the zoo and round robin
# 2, were 3; the heavy traffic 3, was 5
FLEET = dict(method="edgefd", scenario="iid", num_clients=128, rounds=2,
             proxy_batch=256, batch_size=32, lr=1e-2, seed=0,
             participation_fraction=0.5, participation_policy="uniform",
             staleness_decay=0.5, straggler_factor=4.0, max_inflight=2)
ZOO = dict(method="edgefd", scenario="iid", num_clients=30, rounds=2,
           proxy_batch=256, batch_size=32, lr=1e-2, seed=0, engine="cohort",
           zoo="mixed", round_mode="overlap", straggler_factor=1.0)
HEAVY = dict(method="edgefd", scenario="iid", num_clients=128, rounds=3,
             proxy_batch=256, batch_size=32, lr=1e-2, seed=0,
             engine="cohort", participation_fraction=0.5,
             participation_policy="uniform", staleness_decay=0.5,
             arrival_process="bursty", arrival_spread=60.0,
             churn_prob=0.05, dropout_prob=0.05, wave_size=32,
             round_mode="sync", num_edge_aggregators=4)
ROBIN = dict(scenario="strong", num_clients=10, rounds=2, proxy_batch=512,
             seed=0, participation_fraction=0.5,
             participation_policy="roundrobin", staleness_decay=0.0,
             round_mode="overlap", max_inflight=2)


def run_scheduler_path():
    """Phase 6 for the full scheduler, its launches counted from 0: (a)
    BENCH_async's deployment, sync and overlap on the cohort engine and
    sync on the loop engine, the loop held to the cohort run; (b) the mixed
    zoo over 30 clients, overlap, concurrent cohorts off and on, priced
    with hetero_zoo's costs, each run's simulated timeline equal to the
    CPU's for the same trace (a CPU run of the same schedule at 1200
    samples: under fixed costs and full participation the timeline
    depends on the graph alone); (c) benchmarks/scale.py's heavy traffic
    on the cohort engine in waves of 32 with its 4 edge aggregators, held
    to a flat server's run (losses rtol 1e-3, accuracies within a test
    sample, participants, staleness and bytes equal: a two-tier mean is a
    regrouped sum); (d) selective-fd and fkd strong, round robin, decay 0,
    overlap, each cohort run held to its loop run. Asserts one fused-loss
    launch a cohort a distill step, one B2 launch a cohort (wave) a
    report, on the loop engine one B2 report launch a reporting client,
    and two B5 launches a cohort a report. Returns the path's counts."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    from repro_torch.fed.participation import cohort_size
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kulsif_rbf import ops as rbf_ops

    def drive(cfg, n_train=60000, n_test=10000, device="cuda", costs=None):
        return lambda: simulator.run(FedConfig(**cfg), n_train=n_train,
                                     n_test=n_test, device=device,
                                     sim_phase_costs=costs)

    # (label, config, report launches a round: cohort waves, or 0 for the
    # loop engine, fixed costs)
    runs = [("(a) cohort sync", dict(FLEET, engine="cohort",
                                     round_mode="sync"), 1, None),
            ("(a) cohort overlap", dict(FLEET, engine="cohort",
                                        round_mode="overlap"), 1, None),
            ("(a) loop sync", dict(FLEET, engine="loop", round_mode="sync"),
             0, None),
            ("(b) mixed zoo, serial cohorts", dict(ZOO), 3, HETERO_COSTS),
            ("(b) mixed zoo, concurrent cohorts",
             dict(ZOO, concurrent_cohorts=True), 3, HETERO_COSTS),
            ("(c) heavy traffic, waves of 32, 4 edges", dict(HEAVY), 4,
             None),
            ("(c) heavy traffic, waves of 32, flat server",
             dict(HEAVY, num_edge_aggregators=1), 4, None)]
    for m in ("selective-fd", "fkd"):
        for engine in ("cohort", "loop"):
            runs.append((f"(d) {engine} {m} strong, round robin",
                         dict(ROBIN, method=m, engine=engine),
                         1 if engine == "cohort" else 0, None))
    log("[6] the full scheduler's path: " + "; ".join(r[0] for r in runs))
    t0 = time.perf_counter()
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    results, per_run, steps, attn = {}, {}, {}, {}
    dist = CountedCalls(kd_ops, "min_dist_and_mask",
                        key=lambda x, c, thr: (
                            "calibration" if isinstance(thr, float)
                            else "report", c.shape[0] if c.ndim == 3 else 1))
    rbf = CountedCalls(rbf_ops, "rbf_matrix",
                       key=lambda a, b, s: b.shape[0] if b.ndim == 3 else 1)
    for label, cfg, waves, costs in runs:
        cohort = cfg.get("engine") == "cohort"
        dist.by_key, rbf.by_key = {}, {}
        with dist, rbf:
            run_one(label, drive(cfg, costs=costs), wrappers, results,
                    per_run, steps, attn,
                    kl_name="kd_kl_loss_clients" if cohort else "kd_kl_loss")
        res, launches = results[label], per_run[label]
        total = max(r.sim_finish_s for r in res.rounds)
        parts = [cfg["num_clients"] if r.participants is None
                 else len(r.participants) for r in res.rounds]
        log(f"  {label}: sim_total_s {total!r}, {len(res.rounds) / total!r} "
            f"simulated rounds a second, last-round mean staleness "
            f"{res.rounds[-1].mean_staleness!r}, participants a round "
            f"{parts}; B2 calls "
            f"by (class, C) {dist.by_key}, B5 calls by C {rbf.by_key}")
        kl = "kd_kl_loss_clients" if cohort else "kd_kl_loss"
        if launches[kl] != steps[label] or not steps[label]:
            raise AssertionError(f"{label}: {launches[kl]} {kl} launches "
                                 f"for {steps[label]} distill steps")
        reports = sum(v for (kind, _), v in dist.by_key.items()
                      if kind == "report")
        if cfg["method"] == "edgefd":
            want = (waves * len(res.rounds) if cohort else
                    sum(len(r.participants) for r in res.rounds))
            if reports != want:
                raise AssertionError(f"{label}: {reports} B2 report "
                                     f"launches, not {want}")
        if cfg["method"] == "selective-fd" and cohort and \
                rbf.by_key.get(cfg["num_clients"], 0) != 2 * len(res.rounds):
            raise AssertionError(f"{label}: B5 over clients {rbf.by_key}, "
                                 "not two Gram matrices a report")
    counts = {n: w.launches for n, w in wrappers.items()}
    for name in ("lloyd_step", "min_dist_and_mask",
                 "min_dist_and_mask_clients", "kd_kl_loss",
                 "kd_kl_loss_clients", "rbf_matrix", "rbf_matrix_clients"):
        if counts[name] == 0:
            raise AssertionError(f"the scheduler's path never launched "
                                 f"{name}")
    pairs = [("(a) cohort sync", "(a) loop sync")]
    pairs += [(f"(d) cohort {m} strong, round robin",
               f"(d) loop {m} strong, round robin")
              for m in ("selective-fd", "fkd")]
    for a, b in pairs:
        ra, rb = results[a], results[b]
        compare_runs(f"{a} against the loop engine", ra, rb, 10000,
                     names=("cohort", "loop"))
        for p, q in zip(ra.rounds, rb.rounds):
            if (p.participants, p.mean_staleness) != (q.participants,
                                                      q.mean_staleness):
                raise AssertionError(f"{a}: round {p.round} participants or "
                                     "staleness differ from the loop's")
    # (b): the card's timeline against the CPU's for the same schedule
    for label, cfg, _, costs in runs[3:5]:
        cpu = drive(cfg, n_train=1200, n_test=100, device="cpu",
                    costs=costs)()
        got = [(r.sim_finish_s, r.served_model_age_s)
               for r in results[label].rounds]
        want = [(r.sim_finish_s, r.served_model_age_s) for r in cpu.rounds]
        if got != want:
            raise AssertionError(f"{label}: the card's timeline {got} is not "
                                 f"the CPU's {want}")
        log(f"  {label}: simulated finishes equal to the CPU's for the same "
            f"schedule, sim_total_s {max(g for g, _ in got)!r}")
    heavy = results["(c) heavy traffic, waves of 32, 4 edges"]
    flat = results["(c) heavy traffic, waves of 32, flat server"]
    compare_runs("(c) 4 edges against the flat server", heavy, flat, 10000,
                 names=("4 edges", "flat"))
    fields = [(r.participants, r.mean_staleness, r.bytes_up, r.bytes_down)
              for r in heavy.rounds]
    if fields != [(r.participants, r.mean_staleness, r.bytes_up,
                   r.bytes_down) for r in flat.rounds]:
        raise AssertionError("(c): participants, staleness or bytes of the "
                             "4-edge run differ from the flat run's")
    log("  (c) 4 edges: participants, staleness and bytes equal to the "
        "flat server's: " + "; ".join(
            f"r{r.round} {len(r.participants)} participants, stale "
            f"{r.mean_staleness!r}, MB up {r.bytes_up / 1e6:.6f}"
            for r in heavy.rounds))
    sampled = cohort_size(HEAVY["num_clients"],
                          HEAVY["participation_fraction"])
    if not all(0 < len(r.participants) <= sampled for r in heavy.rounds):
        raise AssertionError(f"(c): participants outside the {sampled} "
                             "sampled a round")
    log(f"  launches on the scheduler's path: "
        f"{ {n: v for n, v in counts.items() if v} }; the path took "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


# ----------------------------------------------------- phase 6, robustness
# (e) benchmarks/robust_agg.py's accuracy knobs at the main path's split:
# edgefd iid, 10 clients, 2 rounds (was 6, then 3: depth cuts for
# time), proxy batch 96, batch 32, lr 1e-2, mnist_feat with n_train 60000
# and n_test 10000, cohort engine
ROBUST_ACC = dict(method="edgefd", scenario="iid", num_clients=10, rounds=2,
                  proxy_batch=96, batch_size=32, lr=1e-2, seed=0,
                  engine="cohort")
FLIP = dict(fault_mode="colluding_flip", byzantine_frac=0.3)
# (f) phase 5's quarantine knobs and (g) a nan attack under the sanitize
# pass, at 10 clients, n_train 60000, 4 rounds, cohort engine. (f) takes
# the iid split: in the strong one at 10 clients each client holds one
# class and alone claims its proxy rows, so each row has one voter, the
# attacker is its own robust center and scores no distance (in both
# packages: nobody is quarantined)
FULL_STRONG = dict(method="edgefd", scenario="strong", num_clients=10,
                   rounds=4, proxy_batch=96, batch_size=32, lr=1e-2, seed=0,
                   engine="cohort")
QUARANTINE = dict(fault_mode="scaled", byzantine_frac=0.25,
                  robust_aggregation="trimmed_mean", trim_frac=0.3,
                  quarantine_threshold=2.0, quarantine_rounds=2)


def run_robust_path():
    """Phase 6 for the robustness layer, its launches counted from 0: (e)
    the fault-free mean, then a colluding flip at 0.3 under the mean,
    trimmed_mean (0.45), median and krum_row, each final accuracy printed
    (the shape, not asserted), and the trimmed_mean run on the loop engine
    held to its cohort run; (f) quarantine: every Byzantine client
    quarantined and absent from the next round's participants; (g) nan
    under the sanitize pass: rows scrubbed every round, finite losses.
    Asserts one fused-loss launch a cohort a distill step (a loop client's
    step on the loop engine). Returns the path's counts."""
    import numpy as np
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    from repro_torch.fed.faults import byzantine_ids

    def drive(cfg):
        return lambda: simulator.run(FedConfig(**cfg), n_train=60000,
                                     n_test=10000, device="cuda")

    tm = dict(robust_aggregation="trimmed_mean", trim_frac=0.45)
    runs = [("(e) fault-free, mean", dict(ROBUST_ACC)),
            ("(e) colluding flip 0.3, mean", dict(ROBUST_ACC, **FLIP))]
    runs += [(f"(e) colluding flip 0.3, {red}",
              dict(ROBUST_ACC, **FLIP, robust_aggregation=red,
                   trim_frac=0.45 if red == "trimmed_mean" else 0.2))
             for red in ("trimmed_mean", "median", "krum_row")]
    runs += [("(e) colluding flip 0.3, trimmed_mean, loop engine",
              dict(ROBUST_ACC, **FLIP, **tm, engine="loop")),
             ("(f) quarantine, iid",
              dict(FULL_STRONG, **QUARANTINE, scenario="iid")),
             ("(g) nan, sanitized",
              dict(FULL_STRONG, fault_mode="nan", byzantine_frac=0.34))]
    log("[6] the robustness path: " + "; ".join(r[0] for r in runs))
    t0 = time.perf_counter()
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    results, per_run, steps, attn = {}, {}, {}, {}
    for label, cfg in runs:
        cohort = cfg["engine"] == "cohort"
        kl = "kd_kl_loss_clients" if cohort else "kd_kl_loss"
        run_one(label, drive(cfg), wrappers, results, per_run, steps, attn,
                kl_name=kl)
        if per_run[label][kl] != steps[label] or not steps[label]:
            raise AssertionError(f"{label}: {per_run[label][kl]} {kl} "
                                 f"launches for {steps[label]} distill steps")
        res = results[label]
        log(f"  {label}: accuracy by round "
            + " ".join(f"{r.mean_acc:.4f}" for r in res.rounds)
            + "; scrubbed " + str([r.scrubbed_rows for r in res.rounds])
            + ", quarantined " + str([r.quarantined for r in res.rounds]))
    compare_runs("(e) trimmed_mean: loop against cohort",
                 results["(e) colluding flip 0.3, trimmed_mean, loop engine"],
                 results["(e) colluding flip 0.3, trimmed_mean"], 10000,
                 names=("loop", "cohort"))
    base = results["(e) fault-free, mean"].final_acc
    log("  (e) final accuracies beside the fault-free mean's "
        f"{base:.4f}: " + "; ".join(
            f"{lb[4:]} {results[lb].final_acc:.4f} "
            f"({results[lb].final_acc - base:+.4f})"
            for lb, _ in runs[1:6]))
    q = results["(f) quarantine, iid"].rounds
    byz = np.flatnonzero(byzantine_ids(FULL_STRONG["num_clients"], seed=0,
                                       byzantine_frac=0.25))
    for cid in byz:
        ev = [r.round for r in q if r.quarantined and cid in r.quarantined]
        if not ev:
            raise AssertionError(f"(f): Byzantine client {cid} was never "
                                 f"quarantined: {[r.quarantined for r in q]}")
        nxt = next((r for r in q if r.round == ev[0] + 1), None)
        if nxt is not None and (nxt.participants is None
                                or cid in nxt.participants):
            raise AssertionError(f"(f): client {cid}, quarantined in round "
                                 f"{ev[0]}, takes part in round "
                                 f"{nxt.round}: {nxt.participants}")
        log(f"  (f) Byzantine client {cid} quarantined on round {ev[0]}'s "
            f"evidence; round {ev[0] + 1}'s participants "
            f"{nxt.participants if nxt else None}")
    g = results["(g) nan, sanitized"].rounds
    if not all(r.scrubbed_rows > 0 for r in g):
        raise AssertionError(f"(g): a round scrubbed nothing: "
                             f"{[r.scrubbed_rows for r in g]}")
    if not all(finite(r.local_loss) and finite(r.distill_loss) for r in g):
        raise AssertionError("(g): a non-finite loss under the sanitize "
                             "pass")
    counts = {n: w.launches for n, w in wrappers.items()}
    for name in ("lloyd_step", "min_dist_and_mask_clients",
                 "kd_kl_loss_clients", "kd_kl_loss"):
        if counts[name] == 0:
            raise AssertionError(f"the robustness path never launched "
                                 f"{name}")
    log(f"  launches on the robustness path: "
        f"{ {n: v for n, v in counts.items() if v} }; the path took "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


# (h) benchmarks/scale.py's fleet rows (scale.py:54-61, run as its
# run_row does: edgefd iid on the cohort engine, mnist_feat with 16
# samples a client, MLP hidden (16,), n_test 256, proxy batch 64, batch
# 16, lr 1e-2); the headline row runs 2 rounds (the row's 1, then a warm
# one)
FLEET_ROWS = (
    dict(name="headline_c16k_w1k", clients=16384, wave=1024, edges=8,
         rounds=2, row_rounds=1),
    dict(name="traffic_c1k", clients=1024, wave=256, edges=4, rounds=2,
         row_rounds=2, fraction=0.5, decay=0.5, arrival="bursty",
         spread=60.0, churn=0.05, dropout=0.05))


class FitIterations:
    """While in effect, records each batched k-means fit's Lloyd launches
    (its longest lane's iterations, then the assignment step)."""

    def __enter__(self):
        from repro_torch.core import dre
        self.module, self.orig, self.launches = dre, dre.kmeans_fit_batched, []

        def fit(*args, **kwargs):
            res = self.orig(*args, **kwargs)
            self.launches.append(max(res.n_iter) + 1)
            return res

        dre.kmeans_fit_batched = fit
        return self

    def __exit__(self, *exc):
        self.module.kmeans_fit_batched = self.orig


def run_fleet_path():
    """Phase 6 for the fleet, its launches counted from 0: each FLEET_ROWS
    row built by ``build_experiment(..., mlp_hidden=(16,))`` and run by
    ``run_experiment``. Asserts one B1 launch a wave an iteration of its
    fit, one B2 launch a wave a calibration and a report, one fused-loss
    launch a wave a distill step. Prints set-up seconds (the build, then
    the DRE fits and engine), round seconds by phase, peak device memory
    and bytes_up beside BENCH_scale.json's (a CPU record of the
    reference, not asserted). Returns (the path's counts, launches by
    kernel at the 1024-client wave)."""
    from repro_torch.common.types import FedConfig
    from repro_torch.core.protocol import run_experiment
    from repro_torch.fed import simulator
    from repro_torch.fed.batching import steps_per_epoch
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    bench = {r["name"]: r for r in json.loads(
        (ROOT / "BENCH_scale.json").read_text())["rows"]}
    log("[6] the fleet path: benchmarks/scale.py's rows "
        + ", ".join(f"{r['name']} ({r['clients']} clients, waves of "
                    f"{r['wave']}, {r['edges']} edges)" for r in FLEET_ROWS))
    t0 = time.perf_counter()
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    results, per_run, steps, attn = {}, {}, {}, {}
    at_fleet_wave = {}
    for row in FLEET_ROWS:
        cfg = FedConfig(
            num_clients=row["clients"], rounds=row["rounds"],
            method="edgefd", scenario="iid", proxy_batch=64, batch_size=16,
            lr=1e-2, seed=0, engine="cohort", wave_size=row["wave"],
            num_edge_aggregators=row["edges"],
            participation_fraction=row.get("fraction", 1.0),
            staleness_decay=row.get("decay", 0.0),
            arrival_process=row.get("arrival", "static"),
            arrival_spread=row.get("spread", 0.0),
            churn_prob=row.get("churn", 0.0),
            dropout_prob=row.get("dropout", 0.0))
        waves = -(-cfg.num_clients // cfg.wave_size)
        timing = {}

        def drive(cfg=cfg, timing=timing):
            t = time.perf_counter()
            exp = simulator.build_experiment(
                cfg, "mnist_feat", n_train=16 * cfg.num_clients, n_test=256,
                mlp_hidden=(16,), device="cuda")
            timing["build"] = time.perf_counter() - t
            t = time.perf_counter()
            res = run_experiment(*exp[:2], cfg.method, cfg, *exp[2:])
            timing["run"] = time.perf_counter() - t
            return res

        label = f"(h) {row['name']}"
        lloyd = CountedCalls(kd_ops, "lloyd_step",
                             key=lambda x, c: x.shape[0] if x.ndim == 3
                             else 1)
        dist = CountedCalls(kd_ops, "min_dist_and_mask",
                            key=lambda x, c, thr: (
                                "calibration" if isinstance(thr, float)
                                else "report",
                                c.shape[0] if c.ndim == 3 else 1))
        with lloyd, dist, FitIterations() as fits:
            run_one(label, drive, wrappers, results, per_run, steps, attn,
                    kl_name="kd_kl_loss_clients")
        res, launches = results[label], per_run[label]
        rounds_s = sum(r.wall_s for r in res.rounds)
        fit_s = timing["run"] - rounds_s
        log(f"  {label}: set-up {timing['build'] + fit_s:.3f} s (build "
            f"{timing['build']:.3f} s, DRE fits and engine {fit_s:.3f} s); "
            + "; ".join(f"round {r.round} {r.wall_s:.3f} s ["
                        + " ".join(f"{k}={v:.3f}"
                                   for k, v in r.phase_s.items()) + "]"
                        for r in res.rounds)
            + f"; mean staleness {[r.mean_staleness for r in res.rounds]}, "
            "participants a round "
            + str([cfg.num_clients if r.participants is None
                   else len(r.participants) for r in res.rounds]))
        ref_row = bench.get(row["name"], {})
        log(f"  {label}: bytes_up by round "
            f"{[r.bytes_up for r in res.rounds]}, bytes_down "
            f"{[r.bytes_down for r in res.rounds]}; BENCH_scale.json "
            f"(the reference on a CPU host, after the row's "
            f"{row['row_rounds']} round(s)): bytes_up "
            f"{ref_row.get('bytes_up')}, final acc {ref_row.get('final_acc')}"
            f"; here after round {row['row_rounds'] - 1}: bytes_up "
            f"{res.rounds[row['row_rounds'] - 1].bytes_up}, acc "
            f"{res.rounds[row['row_rounds'] - 1].mean_acc:.4f}")
        # one launch a wave: B1 an iteration of each wave's fit, B2 a
        # calibration and a report, the fused loss a distill step
        if set(lloyd.by_key) != {cfg.wave_size} or \
                len(fits.launches) != waves or \
                lloyd.by_key[cfg.wave_size] != sum(fits.launches):
            raise AssertionError(
                f"{label}: B1 calls by C {lloyd.by_key} for {waves} waves' "
                f"fits of {fits.launches} Lloyd steps")
        want = {("calibration", cfg.wave_size): waves,
                ("report", cfg.wave_size): waves * cfg.rounds}
        if dist.by_key != want:
            raise AssertionError(f"{label}: B2 calls by (class, C) "
                                 f"{dist.by_key}, not {want}")
        want_steps = (waves * cfg.rounds * cfg.distill_epochs
                      * steps_per_epoch(cfg.proxy_batch, cfg.batch_size))
        if not (launches["kd_kl_loss_clients"] == steps[label]
                == want_steps):
            raise AssertionError(
                f"{label}: {launches['kd_kl_loss_clients']} fused-loss "
                f"launches for {steps[label]} distill steps, not "
                f"{want_steps} ({waves} waves a round)")
        log(f"  {label}: B1 {sum(fits.launches)} launches over {waves} "
            f"wave fits (each wave's Lloyd steps {sorted(set(fits.launches))}"
            f"), B2 {waves} calibrations and {waves * cfg.rounds} reports, "
            f"the fused loss {want_steps} launches: one a wave a step")
        if cfg.wave_size == FLEET_C:
            at_fleet_wave = {"lloyd_step": sum(fits.launches),
                             "min_dist_and_mask_clients":
                                 waves * (cfg.rounds + 1),
                             "kd_kl_loss_clients": want_steps}
    counts = {n: w.launches for n, w in wrappers.items()}
    for name in ("lloyd_step", "min_dist_and_mask_clients",
                 "kd_kl_loss_clients"):
        if counts[name] == 0:
            raise AssertionError(f"the fleet path never launched {name}")
    log(f"  launches on the fleet path: "
        f"{ {n: v for n, v in counts.items() if v} }; the path took "
        f"{time.perf_counter() - t0:.1f} s")
    return counts, at_fleet_wave


# -------------------------------------------------- phase 6, the service
# the service at the main path's width: edgefd strong, mnist_feat, 10
# clients with MNIST's split sizes, 3 rounds, proxy batch 512
SERVE = ["--method", "edgefd", "--scenario", "strong", "--dataset",
         "mnist_feat", "--clients", "10", "--n-train", "60000", "--n-test",
         "10000", "--rounds", "3", "--proxy-batch", "512",
         "--fixed-phase-costs", "--device", "cuda"]
SERVE_CASES = (
    ("(i) loop, sync", ["--engine", "loop", "--round-mode", "sync"],
     "distill:1"),
    ("(ii) cohort, overlap", ["--engine", "cohort", "--round-mode",
                              "overlap", "--max-inflight", "2",
                              "--participation", "0.75",
                              "--staleness-decay", "0.5"], "aggregate:1"))
# (iii) the watchdog: tests/test_faults.py's knobs at the same width
SERVE_WATCHDOG = ["--engine", "cohort", "--rounds", "4", "--proxy-batch",
                  "96", "--round-mode", "sync"]
NAN_BURST = ["--fault-mode", "nan", "--byzantine-frac", "0.34",
             "--fault-start", "2", "--fault-duration", "1", "--no-sanitize"]
MEASURED = ("wall_s", "phase_s")


def serve_child(args) -> int:
    """``python3 chip_smoke.py --serve ARGS``: run
    ``python -m repro_torch.launch.fed_serve ARGS`` in this process
    (``runpy``), with the kernels' launch counters and timers around the
    build, the checkpoint writes, the restore and every snapshot. After
    every node, write and restore it prints one ``serve-stats {json}``
    line, so a run that SIGKILLs itself leaves its figures up to the kill.
    ``--deterministic`` first (with CUBLAS_WORKSPACE_CONFIG set by the
    caller) turns on ``torch.use_deterministic_algorithms``."""
    import runpy
    import torch
    if args[:1] == ["--deterministic"]:
        torch.use_deterministic_algorithms(True)
        args = args[1:]
    sys.path.insert(0, str(SRC))
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.zeros(1, device="cuda")    # the context, outside the build
        sync()
    import repro_torch.checkpoint as ck
    from repro_torch.fed.scheduler import RoundScheduler
    wrappers = launch_counts()
    stats = {"build_s": None, "restore_read_s": [], "restore_s": [],
             "snapshot_s": [], "snapshot_bytes": [], "save": []}
    t0 = time.perf_counter()

    def emit():
        stats["launches"] = {n: w.launches for n, w in wrappers.items()}
        print("serve-stats " + json.dumps(stats), flush=True)

    def timed(fn, record):
        def wrapped(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            record(time.perf_counter() - t, a, out)
            emit()
            return out
        return wrapped

    def tree_bytes(obj):
        if isinstance(obj, dict):
            return sum(tree_bytes(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(tree_bytes(v) for v in obj)
        return getattr(obj, "nbytes", 0)

    init, step = RoundScheduler.__init__, RoundScheduler.step

    def built(self, *a, **kw):
        init(self, *a, **kw)
        sync()
        if stats["build_s"] is None:
            stats["build_s"] = time.perf_counter() - t0
        emit()

    def stepped(self):
        out = step(self)
        emit()
        return out

    RoundScheduler.__init__ = built
    RoundScheduler.step = stepped
    RoundScheduler.restore = timed(
        RoundScheduler.restore,
        lambda dt, a, out: stats["restore_s"].append(dt))
    RoundScheduler.snapshot = timed(
        RoundScheduler.snapshot,
        lambda dt, a, out: (stats["snapshot_s"].append(dt),
                            stats["snapshot_bytes"].append(
                                tree_bytes(vars(out)))))
    ck.restore_state = timed(
        ck.restore_state,
        lambda dt, a, out: stats["restore_read_s"].append(dt))
    ck.save_state = timed(
        ck.save_state,
        lambda dt, a, out: stats["save"].append(
            [dt, os.path.getsize(out), os.path.basename(out)]))
    sys.argv = ["fed_serve"] + list(args)
    runpy.run_module("repro_torch.launch.fed_serve", run_name="__main__",
                     alter_sys=True)
    emit()
    return 0


def serve(args, deterministic=False):
    """One service process (``serve_child``): (return code, stdout, its
    last ``serve-stats``)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    pre = []
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        pre = ["--deterministic"]
    t = time.perf_counter()
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--serve"] + pre + list(args), env=env,
                       capture_output=True, text=True, timeout=600)
    stats = [json.loads(ln[len("serve-stats "):])
             for ln in p.stdout.splitlines()
             if ln.startswith("serve-stats ")]
    stats = stats[-1] if stats else {}
    stats["process_s"] = time.perf_counter() - t
    return p.returncode, p.stdout + p.stderr, stats


def history(path):
    with open(path) as f:
        return [{k: v for k, v in d.items() if k not in MEASURED}
                for d in json.load(f)]


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x:
            if x[k] != y.get(k):
                return f"round {i} {k}: {x[k]} vs {y.get(k)}"
    return f"{len(a)} vs {len(b)} rounds"


def run_service_path():
    """Phase 6 for the resumable service, as subprocesses (the crash hook
    SIGKILLs its own process): (i) and (ii) each crash at a phase
    boundary of round 1, resume, and run once more uninterrupted; the
    crashed run must die by SIGKILL with ``ckpt_00000001.npz`` and the
    sidecar left, the resumed one print ``resumed from checkpoint step
    1``, and its ``--json`` history, apart from ``wall_s`` and
    ``phase_s``, equal the uninterrupted run's bit for bit. (iii) the
    watchdog: clean, broken and guarded runs; the guarded one retires four
    finite rounds, rolls back, quarantines, and equals the clean run
    before the burst, as tests/test_faults.py asserts (its accuracy bound
    is printed). Returns the launches over every service run."""
    import tempfile
    log("[6] the resumable service (launch/fed_serve.py) at the main "
        "path's width, as subprocesses: " + ", ".join(
            c[0] for c in SERVE_CASES) + ", (iii) the watchdog")
    t0 = time.perf_counter()
    total = {}

    def add(stats):
        for n, v in stats.get("launches", {}).items():
            total[n] = total.get(n, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        for label, flags, crash in SERVE_CASES:
            d = os.path.join(tmp, label[1:label.index(")")])
            ck = ["--ckpt-dir", d, "--ckpt-every", "1"]
            killed, out, crashed = serve(SERVE + flags + ck
                                         + ["--crash-after-phase", crash])
            add(crashed)
            left = sorted(os.listdir(d)) if os.path.isdir(d) else []
            if killed != -9 or "ckpt_00000001.npz" not in left \
                    or "logs.jsonl" not in left:
                raise AssertionError(f"{label}: the crashed run returned "
                                     f"{killed}, left {left}:\n"
                                     f"{out[-3000:]}")
            rc, out, resumed = serve(SERVE + flags + ck + [
                "--resume", "--json", os.path.join(tmp, "resumed.json")])
            add(resumed)
            if rc != 0 or "resumed from checkpoint step 1" not in out:
                raise AssertionError(f"{label}: the resumed run returned "
                                     f"{rc}:\n{out[-3000:]}")
            rc, out, fresh = serve(SERVE + flags + [
                "--json", os.path.join(tmp, "fresh.json")])
            add(fresh)
            if rc != 0:
                raise AssertionError(f"{label}: the uninterrupted run "
                                     f"returned {rc}:\n{out[-3000:]}")
            got = history(os.path.join(tmp, "resumed.json"))
            want = history(os.path.join(tmp, "fresh.json"))
            if got != want:
                why = first_difference(got, want)
                rc, out, _ = serve(SERVE + flags + ["--json", os.path.join(
                    tmp, "det.json")], deterministic=True)
                raise AssertionError(
                    f"{label}: the resumed history differs from the "
                    f"uninterrupted run's ({why}); the same run under "
                    f"torch.use_deterministic_algorithms returned {rc}:\n"
                    f"{out[-3000:]}")
            saves = "; ".join(f"{n} {b} bytes in {s:.4f} s" for s, b, n
                              in crashed["save"])
            log(f"  {label}: crashed by SIGKILL after {crash} (rc "
                f"{killed}), left {left}; resumed history bit for bit the "
                f"uninterrupted run's over {len(got)} rounds (wall_s and "
                f"phase_s apart), final acc {want[-1]['mean_acc']:.4f}")
            log(f"  {label}: checkpoints {saves} (snapshot "
                + ", ".join(f"{v:.4f}" for v in crashed["snapshot_s"])
                + " s of each); a fresh start builds in "
                f"{fresh['build_s']:.3f} s (data, engine, DRE fits; process "
                f"{fresh['process_s']:.1f} s); the resume rebuilds in "
                f"{resumed['build_s']:.3f} s and overlays in "
                f"{sum(resumed['restore_read_s']):.4f} s read + "
                f"{sum(resumed['restore_s']):.4f} s restore")
        runs = {}
        for name, extra in (("clean", []), ("broken", NAN_BURST),
                            ("guarded", NAN_BURST + ["--watchdog"])):
            path = os.path.join(tmp, f"{name}.json")
            rc, out, stats = serve(SERVE + SERVE_WATCHDOG + extra
                                   + ["--json", path])
            add(stats)
            if rc != 0:
                raise AssertionError(f"(iii) {name}: returned {rc}:\n"
                                     f"{out[-3000:]}")
            with open(path) as f:
                runs[name] = (json.load(f), stats)
        clean, broken, guarded = (runs[n][0] for n in
                                  ("clean", "broken", "guarded"))
        # the broken run's NaN is the point of the run: no check_finite or
        # DivergenceWatch here, only that it did not recover
        if finite(broken[-1]["distill_loss"]):
            raise AssertionError(f"(iii) the broken run recovered: "
                                 f"{[r['distill_loss'] for r in broken]}")
        pinned = ("accs", "mean_acc", "local_loss", "distill_loss",
                  "id_fraction", "bytes_up", "bytes_down")
        checks = {
            "four rounds": len(guarded) == 4,
            "all finite": all(finite(r["mean_acc"])
                              and finite(r["distill_loss"])
                              for r in guarded),
            "rolled back": guarded[-1]["rollbacks"] >= 1,
            "quarantined": any(r["quarantined"] for r in guarded),
            "pre-burst equal": all(
                [c[k] for k in pinned] == [g[k] for k in pinned]
                for c, g in zip(clean[:2], guarded[:2]))}
        if not all(checks.values()):
            rows = [(r["mean_acc"], r["distill_loss"], r["rollbacks"],
                     r["quarantined"]) for r in guarded]
            raise AssertionError(f"(iii) watchdog checks {checks}; guarded "
                                 f"(acc, distill, rollbacks, quarantined) "
                                 f"{rows}")
        # tests/test_faults.py also bounds the guarded final accuracy at the
        # clean one less 0.15, at 6 clients; at 10 clients in the strong
        # split the quarantined third of the fleet holds its classes
        # alone, so the gap is a property of the draw here: printed
        gap = clean[-1]["mean_acc"] - guarded[-1]["mean_acc"]
        wd = runs["guarded"][1]
        snap = wd["snapshot_s"]
        log(f"  (iii) watchdog: broken run's distill losses "
            f"{[r['distill_loss'] for r in broken]} (its NaN is the "
            f"attack, left unchecked); guarded accuracies "
            f"{[round(r['mean_acc'], 4) for r in guarded]} against clean "
            f"{[round(r['mean_acc'], 4) for r in clean]}, rollbacks "
            f"{[r['rollbacks'] for r in guarded]}, quarantined "
            f"{[r['quarantined'] for r in guarded]}, final accuracy gap "
            f"{gap:.4f} (the 6-client test's bound: 0.15); its {len(snap)} "
            f"restore-point snapshots took {min(snap):.4f}–{max(snap):.4f} "
            f"s (mean {sum(snap) / len(snap):.4f} s), "
            f"{max(wd['snapshot_bytes'])} bytes each at most")
    for name in ("lloyd_step", "min_dist_and_mask_clients",
                 "min_dist_and_mask", "kd_kl_loss", "kd_kl_loss_clients"):
        if not total.get(name):
            raise AssertionError(f"the service path never launched {name}")
    log(f"  launches over the service runs: "
        f"{ {n: v for n, v in total.items() if v} }; the path took "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------- phase 6, the mesh
# the device mesh (ROADMAP A10): chip_smoke.py --mesh-child processes, each
# a rank of a torch.distributed group over a file store. (b) and (c) put
# two ranks on the one card, which NCCL refuses, so they take gloo
# (REPRO_DIST_BACKEND=gloo: every collective staged through host memory)
MESH_CLIENTS, MESH_ROUNDS = 4, 1
# depth cut for time: a third of the transformer path's private set a
# client (its 6000 over 10), a quarter of its test set, one round (was 2)
MESH_N_TRAIN, MESH_N_TEST = 800, 256
# (c)'s training step on a rank: 4 clients' batches of 64 folded, 16 of
# granite-8b's 32 query heads and 4 of its 8 kv heads
MESH_LOCAL_ATTN = (4 * 64, 16, 4, 16, 128)
MESH_STATE_MAX, MESH_PEAK_MAX = 0.55, 0.77
HOST_SAMPLE_S = 0.005       # a rank's resident set, sampled this often


class HostPeak:
    """This process's own resident-set peak over a block (ROADMAP C12: an
    exec'd child's ``ru_maxrss`` starts at its parent's peak, so a rank's
    ``ru_maxrss`` can carry the smoke's earlier phases). The resident set
    (``/proc/self/statm``) is sampled every ``every`` seconds by a thread
    and at the block's start and end; ``vmhwm`` is the kernel's own
    lifetime peak (``VmHWM``) where /proc/self/status has it, else None
    (the card hosts' kernels need not)."""

    def __init__(self, every=HOST_SAMPLE_S):
        import threading
        self.every, self.peak = every, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    @staticmethod
    def vmhwm():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
        return None

    def _sample(self):
        while not self._stop.wait(self.every):
            self.peak = max(self.peak, self.rss())

    def __enter__(self):
        self.peak = self.rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())


def mesh_kw(devices, shards, dataset="lm_tokens"):
    if dataset == "lm_tokens":
        return dict(method="edgefd", scenario="strong",
                    num_clients=MESH_CLIENTS, rounds=MESH_ROUNDS,
                    batch_size=64, proxy_batch=256, lr=LM_LR, seed=0,
                    engine="cohort", num_devices=devices,
                    model_shards=shards)
    return dict(method="edgefd", scenario="strong", num_clients=4, rounds=2,
                proxy_batch=256, seed=0, engine="cohort",
                num_devices=devices, model_shards=shards)


def mesh_run(spec):
    """One ``simulator.run`` of ``spec`` on this process's card (a rank's
    under a mesh; ``costs``: fixed phase costs, else measured): its round
    logs without the measured fields, the
    stacked state's bytes on this rank (parameters and momentum, from the
    engine's tensors), the allocator's peak, the process's host peak
    (``HostPeak``: its resident set sampled over the run and the gather,
    beside ``VmHWM`` where the kernel has it and ``ru_maxrss``), the wall
    seconds and the kernels' launches (B6's by
    query and kv heads), counts from 0. With ``sync``, then the engine's
    ``sync_to_clients`` (over a mesh, the gather of every rank's rows and
    slices to the host), timed, and every client's leaves' norms after
    it."""
    import dataclasses
    import gc
    import resource
    import torch
    from repro_torch.common.types import FedConfig
    from repro_torch.core import protocol
    from repro_torch.fed import simulator
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg = FedConfig(**spec["kw"])
    lm = spec["dataset"] == "lm_tokens"
    engines, marks = [], {}
    build, make = protocol.engine_from_config, protocol.make_scheduler

    def keep(*a, **kw):
        engines.append(build(*a, **kw))
        return engines[-1]

    def keep_sched(*a, **kw):
        # set-up ends here (experiment, engine, DRE fits); the rounds'
        # seconds are timed around run_rounds, the rest is what follows
        marks["setup_s"] = time.perf_counter() - t0
        sched = make(*a, **kw)
        run = sched.run_rounds

        def timed(*a2, **kw2):
            t = time.perf_counter()
            out = run(*a2, **kw2)
            torch.cuda.synchronize()
            marks["rounds_s"] = time.perf_counter() - t
            return out
        sched.run_rounds = timed
        return sched
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    # an earlier run's engine and clients hold one another: collect them,
    # so that this run's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    protocol.engine_from_config = keep
    protocol.make_scheduler = keep_sched
    t0 = time.perf_counter()
    host = HostPeak()
    try:
        with host, CountedCalls(
                fa_ops, "_launch",
                key=lambda q, k, *_: f"{q.shape[1]}/{k.shape[1]}") as heads:
            arch = (axis_token_arch(spec["arch"]) if spec.get("arch")
                    else lm_full_width_arch() if lm else None)
            res = simulator.run(
                cfg, spec["dataset"], n_train=spec["n_train"],
                n_test=spec["n_test"], device="cuda",
                transformer_cfg=arch, sim_phase_costs=spec.get("costs"))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            eng = engines[0]
            synced = {}
            if spec.get("sync"):
                t = time.perf_counter()
                norms = state_norms(eng)
                torch.cuda.synchronize()
                synced = {"sync_s": time.perf_counter() - t,
                          "sync_peak_bytes": torch.cuda.max_memory_allocated(),
                          "norms": norms}
    finally:
        protocol.engine_from_config = build
        protocol.make_scheduler = make
    state = sum(t.numel() * t.element_size() for c in eng.cohorts
                for t in list(c.params) + list(c.opt_state["mu"]))
    mesh = getattr(eng, "mesh", None)
    phases = {}
    for r in res.rounds:
        for ph, sec in r.phase_s.items():
            phases[ph] = phases.get(ph, 0.0) + sec
    return {"logs": [{k: v for k, v in dataclasses.asdict(r).items()
                      if k not in MEASURED} for r in res.rounds],
            "wall_s": wall, "phase_s": phases,
            "rest_s": wall - marks["setup_s"] - marks["rounds_s"],
            **marks, **synced, "state_bytes": state, "peak_bytes": peak,
            "host_peak_bytes": host.peak, "vmhwm_bytes": host.vmhwm(),
            "ru_maxrss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "launches": {n: w.launches for n, w in wrappers.items()},
            "attn_heads": heads.by_key,
            "mesh": None if mesh is None else dict(mesh.shape)}


def state_norms(eng):
    """Every client's leaves' norms (float64), in client order. Over a
    mesh the state is gathered to rank 0 a lane row of a leaf at a time
    (``_Cohort.gathered``), each row's norm taken and the row dropped, so
    no host holds the fleet; None on the other ranks."""
    if eng.mesh is None:
        eng.sync_to_clients()
        return [[float(p.detach().double().norm()) for p in c.params]
                for c in eng.clients]
    got = {}
    for cohort in eng.cohorts:
        for lo, hi, j, p, _, _ in cohort.gathered(root=True):
            if p is None:
                continue
            for r in range(hi - lo):
                got.setdefault(cohort.positions[lo + r], {})[j] = float(
                    p[r].double().norm())
    if eng.mesh.rank != 0:
        return None
    return [[got[i][j] for j in sorted(got[i])]
            for i in range(len(eng.clients))]


def mesh_child(args) -> int:
    """``python3 chip_smoke.py --mesh-child OUT SPEC``: one rank (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and REPRO_DIST_BACKEND from
    the environment) of a process group that the port's
    ``fed.mesh.init_distributed`` opens over the file store SPEC names
    (its backend resolution, NCCL check, card and timeout); every run of
    SPEC through ``mesh_run``, the results written to OUT as JSON. The
    kernels are built by the parent: this process loads them."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.fed import mesh as fed_mesh
    out, spec = args
    with open(spec) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    fed_mesh.init_distributed("cuda", init_method=f"file://{spec['store']}")
    backend = dist.get_backend()
    if (backend, world, dist.get_rank()) != (
            os.environ["REPRO_DIST_BACKEND"], dist.get_world_size(), rank):
        raise AssertionError(f"rank {rank}: group {backend}, world "
                             f"{dist.get_world_size()}, rank "
                             f"{dist.get_rank()}")
    try:
        if backend == "nccl":
            one = torch.ones(4, device="cuda") * (rank + 1)
            dist.all_reduce(one)
            assert float(one.sum()) == 4 * world * (world + 1) / 2
        kinds = {"fd_step": fd_step_child, "axis": axis_child}
        results = [kinds.get(run.get("kind"), mesh_run)(run)
                   for run in spec["runs"]]
        if world > 1 and "allreduce" in spec:
            # the port's all-reduce of a 64 MB card tensor (a rank's
            # folded training batch of activations at granite-8b's width)
            mesh = fed_mesh.build_client_mesh(world, device="cuda")
            t = torch.ones(MESH_LOCAL_ATTN[0] * 16 * 4096, device="cuda")
            mesh.all_reduce(t)
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mesh.all_reduce(t)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            results[-1]["allreduce_64mb_ms"] = ms
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(results, f)
    return 0


def mesh_world(world, backend, runs, tmp, timeout=600, allreduce=False):
    """Spawn ``world`` ``--mesh-child`` ranks; every rank's results, in
    rank order (``allreduce``: the last run's then carry the timing of a
    64 MB all-reduce). A rank that fails or outlives ``timeout`` fails
    the phase, and every rank is stopped."""
    import torch
    torch.cuda.empty_cache()
    tag = f"w{world}-{backend}-{time.monotonic_ns()}"
    spec = os.path.join(tmp, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump({"store": os.path.join(tmp, f"{tag}.store"),
                   "runs": runs, **({"allreduce": True} if allreduce
                                    else {})}, f)
    procs, outs = [], []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(SRC), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), REPRO_DIST_BACKEND=backend)
        outs.append(os.path.join(tmp, f"{tag}.{r}.out"))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child",
             outs[-1], spec], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if len(texts) < world or any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} rc={p.returncode}\n"
                          f"{(texts[r] if r < len(texts) else '')[-3000:]}"
                          for r, p in enumerate(procs))
        raise AssertionError(f"mesh world of {world} ({backend}) failed:\n"
                             f"{tails}")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    return res


def as_run(logs):
    return types.SimpleNamespace(
        rounds=[types.SimpleNamespace(**d) for d in logs])


def max_loss_gap(a, b):
    return max(abs(p[f] - q[f]) / max(abs(q[f]), 1e-30)
               for p, q in zip(a, b) for f in ("local_loss", "distill_loss"))


def run_mesh_path(smi):
    """Phase 6's mesh: (a) a world of one over NCCL, mnist_feat edgefd on
    the cohort engine unsharded, on num_devices=1 and on (1, 1), bitwise
    equal; lm_tokens edgefd strong at granite-8b's widths, 4 clients, 2
    rounds, unsharded in that process, then (b) on two ranks of the one
    card over gloo, the 1-D client mesh, 2 clients a rank, and (c) on the
    (1, 2) mesh, each client's model split over the two ranks: each held
    to the unsharded run (losses rtol 1e-3, accuracies within a test
    sample), every rank's logs equal, per-rank state bytes and allocator
    peak beside the unsharded run's. Returns (c)'s B6 launches at its
    local heads."""
    import tempfile
    t0 = time.perf_counter()
    log(f"[6] the device mesh (ROADMAP A10), {smi}")
    lm = dict(dataset="lm_tokens", n_train=MESH_N_TRAIN, n_test=MESH_N_TEST)
    # fixed costs: the simulated timeline is compared too
    feat = dict(dataset="mnist_feat", n_train=4000, n_test=1000,
                costs=ASYNC_COSTS)
    with tempfile.TemporaryDirectory() as tmp:
        (a_none, a_again, a_one, a_11, unsharded), = mesh_world(
            1, "nccl", [dict(kw=mesh_kw(0, 0, "mnist_feat"), **feat),
                        dict(kw=mesh_kw(0, 0, "mnist_feat"), **feat),
                        dict(kw=mesh_kw(1, 0, "mnist_feat"), **feat),
                        dict(kw=mesh_kw(1, 1, "mnist_feat"), **feat),
                        dict(kw=mesh_kw(0, 0), sync=True, **lm)], tmp)
        for name, got in (("unsharded again", a_again),
                          ("num_devices=1", a_one), ("(1, 1)", a_11)):
            if got["logs"] != a_none["logs"]:
                raise AssertionError(
                    f"(a) {name}: round logs differ from the unsharded "
                    f"cohort engine's: "
                    f"{first_difference(got['logs'], a_none['logs'])}")
        if (a_one["mesh"], a_11["mesh"]) != ({"clients": 1},) * 2:
            raise AssertionError(f"(a) meshes {a_one['mesh']}, "
                                 f"{a_11['mesh']}")
        log(f"  (a) a world of one over NCCL ({smi}): mnist_feat edgefd "
            f"strong, 4 clients, 2 rounds, on num_devices=1 and (1, 1) "
            f"bitwise the unsharded cohort engine's (wall "
            f"{a_none['wall_s']:.3f} / {a_one['wall_s']:.3f} / "
            f"{a_11['wall_s']:.3f} s)")
        log(f"  unsharded: lm_tokens edgefd strong at granite-8b's widths, "
            f"{MESH_CLIENTS} clients stacked, {MESH_ROUNDS} rounds, n_train "
            f"{MESH_N_TRAIN}, n_test {MESH_N_TEST} ({smi}): set-up "
            f"{unsharded['setup_s']:.3f} s, rounds "
            f"{unsharded['rounds_s']:.3f} s ("
            + " ".join(f"{k}={v:.3f}" for k, v in
                       unsharded["phase_s"].items())
            + f"), wall {unsharded['wall_s']:.3f} s, state "
            f"{unsharded['state_bytes']} B, peak "
            f"{unsharded['peak_bytes'] / 2**30:.3f} GiB, final acc "
            f"{unsharded['logs'][-1]['mean_acc']:.4f}")
        out = {}
        # (b) and (c) each in a world of two fresh ranks, so that no run's
        # host memory carries into another's (ROADMAP C12); (c) then
        # gathers every client's state to rank 0's host
        b_ranks = mesh_world(2, "gloo", [dict(kw=mesh_kw(2, 0), **lm)], tmp)
        c_ranks = mesh_world(2, "gloo", [dict(kw=mesh_kw(2, 2), sync=True,
                                              **lm)], tmp, allreduce=True)
        for name, world in (("(b)", b_ranks), ("(c)", c_ranks)):
            ranks = [r[0] for r in world]
            for r in ranks[1:]:
                if r["logs"] != ranks[0]["logs"]:
                    raise AssertionError(f"{name}: the ranks' round logs "
                                         "differ")
            compare_runs(f"{name} {ranks[0]['mesh']} vs unsharded",
                         as_run(ranks[0]["logs"]),
                         as_run(unsharded["logs"]), MESH_N_TEST,
                         names=("mesh", "unsharded"))
            gap = max_loss_gap(ranks[0]["logs"], unsharded["logs"])
            acc_gap = max(abs(a - b) for p, q in zip(ranks[0]["logs"],
                                                     unsharded["logs"])
                          for a, b in zip(p["accs"], q["accs"]))
            log(f"  {name} mesh {ranks[0]['mesh']} over gloo on one card "
                f"({smi}): largest loss gap {gap:.3e} (relative), accuracy "
                f"gap {acc_gap:.4f}; every rank's logs equal")
            for i, r in enumerate(ranks):
                log(f"    rank {i}: set-up {r['setup_s']:.3f} s, rounds "
                    f"{r['rounds_s']:.3f} s ("
                    + " ".join(f"{k}={v:.3f}" for k, v in
                               r["phase_s"].items())
                    + f"), after the rounds {r['rest_s']:.3f} s"
                    + ("" if "sync_s" not in r else
                       f", gather of the state to the host "
                       f"{r['sync_s']:.3f} s (card peak "
                       f"{r['sync_peak_bytes'] / 2**30:.3f} GiB)")
                    + f", host peak {r['host_peak_bytes'] / 2**30:.3f} GiB"
                    + ("" if "allreduce_64mb_ms" not in r else
                       ", all-reduce of 64 MB through gloo "
                       + " ".join(f"{v:.1f}" for v in r["allreduce_64mb_ms"])
                       + " ms"))
                log(f"    rank {i}: wall {r['wall_s']:.3f} s, state "
                    f"{r['state_bytes']} B "
                    f"({r['state_bytes'] / unsharded['state_bytes']:.3f} of "
                    f"the unsharded run's), peak "
                    f"{r['peak_bytes'] / 2**30:.3f} GiB "
                    f"({r['peak_bytes'] / unsharded['peak_bytes']:.3f}), "
                    f"B6 launches by heads {r['attn_heads']}, launches "
                    + json.dumps({k: v for k, v in r['launches'].items()
                                  if v}))
            out[name] = ranks
    c = out["(c)"]
    # the gathered state, on rank 0 alone: each leaf's norm within the
    # standing rtol of the unsharded run's
    if c[0]["norms"] is None or any(r["norms"] is not None for r in c[1:]):
        raise AssertionError("(c): the state was not gathered to rank 0 "
                             "alone")
    gap = max(abs(a - b) / max(b, 1e-30)
              for ca, cb in zip(c[0]["norms"], unsharded["norms"])
              for a, b in zip(ca, cb))
    log(f"  (c) the state gathered to rank 0 ({smi}): "
        f"{len(c[0]['norms'])} clients, largest relative gap of a leaf's "
        f"norm to the unsharded run's {gap:.3e}; gather {c[0]['sync_s']:.3f}"
        f" s (unsharded {unsharded['sync_s']:.3f} s)")
    # ROADMAP C11: a rank's host holds its own lanes alone. Each rank's
    # own peak (its resident set sampled in the rank), beside VmHWM where
    # the kernel has it and ru_maxrss, which an exec'd child inherits from
    # its parent (C12)
    def gib(v):
        return "n/a" if v is None else f"{v / 2**30:.3f}"
    for name in ("(b)", "(c)"):
        log(f"  {name} host peak (resident set sampled every "
            f"{HOST_SAMPLE_S * 1e3:g} ms in the rank), rank 0 / 1: "
            + " / ".join(gib(r["host_peak_bytes"]) for r in out[name])
            + " GiB; VmHWM "
            + " / ".join(gib(r["vmhwm_bytes"]) for r in out[name])
            + " GiB; ru_maxrss "
            + " / ".join(gib(r["ru_maxrss_bytes"]) for r in out[name])
            + " GiB")
    if not gap <= 1e-3:
        raise AssertionError(f"(c): a gathered leaf's norm is {gap:.3e} "
                             "(relative) from the unsharded run's")
    for r in c:
        if r["state_bytes"] > MESH_STATE_MAX * unsharded["state_bytes"] \
                or r["peak_bytes"] > MESH_PEAK_MAX * unsharded["peak_bytes"]:
            raise AssertionError(
                f"(c): a rank holds {r['state_bytes']} B of state and peaks "
                f"at {r['peak_bytes']} B against the unsharded "
                f"{unsharded['state_bytes']} and {unsharded['peak_bytes']}")
        for k in ("lloyd_step", "min_dist_and_mask_clients",
                  "kd_kl_loss_clients", "flash_attention"):
            if not r["launches"][k]:
                raise AssertionError(f"(c): {k} never launched on a rank")
        if not r["attn_heads"].get("16/4"):
            raise AssertionError("(c): B6 never launched at the local "
                                 "16/4 heads")
    run_token_families(smi)
    err = check_flash(*MESH_LOCAL_ATTN)
    log(f"  the mesh path took {time.perf_counter() - t0:.1f} s")
    return sum(r["attn_heads"]["16/4"] for r in c), err


# (d) token clients of the recurrent families on the (1, 2) mesh (ROADMAP
# A11.7): each family's published widths, depth cut to one group
# (xlstm-350m: d 1024, 4 heads, one mLSTM and one sLSTM block;
# recurrentgemma-2b: d 2560, 10/1 heads of 256, ff 7680, two RG-LRU blocks
# and one local-attention block), vocab cut to lm_tokens' 32 labels:
# (family, arch, layers)
AXIS_TOKEN_ARCHS = (("ssm", "xlstm-350m", 2), ("hybrid", "recurrentgemma-2b",
                                               3))


def axis_token_arch(family):
    """(d)'s token-client config of ``family``."""
    import dataclasses
    from repro_torch.configs import get_arch
    _, arch, layers = next(a for a in AXIS_TOKEN_ARCHS if a[0] == family)
    return dataclasses.replace(get_arch(arch), num_layers=layers,
                               vocab_size=32)


def run_token_families(smi):
    """(d): lm_tokens edgefd strong at (c)'s sizes with the ssm and hybrid
    families' token clients (``AXIS_TOKEN_ARCHS``), unsharded in this
    process, then on the (1, 2) mesh of two ranks of the card over gloo:
    held to the unsharded run (losses rtol 1e-3, accuracies within a test
    sample), every rank's logs equal, each rank's state bytes beside the
    unsharded run's; B1, B2 and the fused loss launched on every rank, B6
    on none (the hybrid's local attention takes the plain route, a window,
    as in the reference's dispatch)."""
    import tempfile
    lm = dict(dataset="lm_tokens", n_train=MESH_N_TRAIN, n_test=MESH_N_TEST)
    runs = [dict(kw=mesh_kw(2, 2), arch=fam, **lm)
            for fam, _, _ in AXIS_TOKEN_ARCHS]
    whole = [mesh_run(dict(kw=mesh_kw(0, 0), arch=fam, **lm))
             for fam, _, _ in AXIS_TOKEN_ARCHS]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mesh_world(2, "gloo", runs, tmp)
    for i, (fam, arch, layers) in enumerate(AXIS_TOKEN_ARCHS):
        got = [r[i] for r in ranks]
        for r in got[1:]:
            if r["logs"] != got[0]["logs"]:
                raise AssertionError(f"(d) {fam}: the ranks' logs differ")
        label = f"(d) {fam} ({arch}, {layers} layers) {got[0]['mesh']}"
        compare_runs(f"{label} vs unsharded", as_run(got[0]["logs"]),
                     as_run(whole[i]["logs"]), MESH_N_TEST,
                     names=("mesh", "unsharded"))
        for k, r in enumerate(got):
            for name in ("lloyd_step", "min_dist_and_mask_clients",
                         "kd_kl_loss_clients"):
                if not r["launches"][name]:
                    raise AssertionError(f"{label}: {name} never launched "
                                         f"on rank {k}")
            if r["launches"]["flash_attention"]:
                raise AssertionError(f"{label}: B6 launched")
            log(f"    rank {k}: rounds {r['rounds_s']:.3f} s (unsharded "
                f"{whole[i]['rounds_s']:.3f}), state {r['state_bytes']} B "
                f"({r['state_bytes'] / whole[i]['state_bytes']:.3f} of the "
                f"unsharded run's {whole[i]['state_bytes']}), card peak "
                f"{r['peak_bytes'] / 2**30:.3f} GiB (unsharded "
                f"{whole[i]['peak_bytes'] / 2**30:.3f}), host peak "
                f"{r['host_peak_bytes'] / 2**30:.3f} GiB; launches "
                + json.dumps({k2: v for k2, v in r["launches"].items()
                              if v}) + f" ({smi})")


# ------------------------------------------------- phase 6, the trainer path
# the LLM trainer, decode and the FD trainer (ROADMAP A11) on
# granite-moe-1b-a400m (hf:ibm-granite/granite-3.0-1b-a400m-base): 24
# layers, d 1024, 16/8 heads of 64, 32 experts, top 8, expert ff 512,
# vocab 49155, 1.385 B parameters. (a) trains the whole model at
# launch.train's defaults but its steps (``MOE_STEPS``); (c) cuts depth
# to 2 layers, widths as published
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 50, 8, 128, 3e-4
# (a)'s steps, cut from launch.train's 50 for time (to 25 for the encoder
# and vlm families' runs, to 12 for the model axis's), and (f)'s, to 25
MOE_STEPS = 12
ENC_STEPS = 25
TRAIN_PLAIN_STEPS = 3
TRAIN_ATTN = (TRAIN_BATCH, 16, 8, TRAIN_SEQ, 64)     # B6 on (a)'s path
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, DECODE_CACHE = 4, 16, 16, 64
# the reference's own tolerance for decode against the forward
# (tests/test_models.py::test_decode_matches_forward)
DECODE_RTOL = DECODE_ATOL = 2e-2
FD_LAYERS, FD_CLIENTS, FD_BATCH, FD_SEQ, FD_LR = 2, 2, 8, 128, 1e-2
FD_KL = (FD_CLIENTS * FD_BATCH, 49155)               # the fused loss's rows
# (d) xlstm-350m (arXiv:2405.04517: 24 layers = 12 mLSTM/sLSTM groups, d
# 1024, 4 heads, vocab 50304) and (e) recurrentgemma-2b (arXiv:2402.19427:
# 26 // 3 = 8 groups of two RG-LRU blocks and a local-attention block, d
# 2560, 10/1 heads of 256, ff 7680, window 2048, vocab 256000):
# launch.train at (a)'s settings (steps below), decode at
# (b)'s on the whole model, and the FD trainer at one group (a depth cut,
# widths as published): (label, arch, the FD trainer's layers, training
# steps, the trainer's layers or None for the whole model). Three cuts:
# (d)'s steps from 50 to 8 (4 left its first batch's loss risen) and
# (e)'s to 25, then 10, for time (the sLSTM's time loop is host-bound,
# 5-7 s a step on the card), and (e)'s training depth
# from 8 groups to 6 (18 layers; decode stays whole): the whole model's
# AdamW step ran out of the card's 79.18 GiB (parameters, gradients and
# both moments 50.2 GiB, then the update's temporaries of the 2.44 GiB
# embedding and head)
RECURRENT_RUNS = (("(d)", "xlstm-350m", 2, 8, None),
                  ("(e)", "recurrentgemma-2b", 3, 10, 18))
# the sLSTM's plain-autograd route, timed beside its custom backward
SLSTM_PLAIN_STEPS = 1
# xLSTM's replay against its prefill, as a relative Frobenius gap: in
# float64 the two agree to 8e-11 at full depth, while float32 alone puts
# the prefill 1.0e-3 (relative) from float64 there, through 12 groups'
# gating (tests/_torch_xlstm_float64.py); a wrong recurrence parts them
# by O(1)
DECODE_REL_SSM = 1e-2
# the FD trainer's B1 fits (a client's private batch, pooled, one
# centroid) and fused losses at the recurrent archs' widths
RECURRENT_LLOYD = {"xlstm-350m": (FD_BATCH, 1024, 1),
                   "recurrentgemma-2b": (FD_BATCH, 2560, 1)}
RECURRENT_KL = {"xlstm-350m": (FD_CLIENTS * FD_BATCH, 50304),
                "recurrentgemma-2b": (FD_CLIENTS * FD_BATCH, 256000)}


def fd_setup(cfg):
    """Each FD client's weights (drawn on the card from seed ``cid``), a
    private batch from its own vocab band (numpy, seed ``cid``), a proxy
    of every client's batch (owners recorded), and a one-centroid
    KMeans-DRE on pooled embeddings (threshold 1.5 times the largest
    private distance), the reference test's setup at these widths."""
    import numpy as np
    import torch
    from repro_torch.core import fd_trainer as FD
    from repro_torch.core.kmeans import kmeans_fit, min_dist_to_centroids
    from repro_torch.models.transformer import Transformer
    models, batches, cents, thrs = [], [], [], []
    v = cfg.vocab_size
    for c in range(FD_CLIENTS):
        models.append(Transformer(cfg, generator=torch.Generator(
            device="cuda").manual_seed(c), device="cuda"))
        lo, hi = c * v // FD_CLIENTS, (c + 1) * v // FD_CLIENTS
        toks = torch.as_tensor(np.random.default_rng(c).integers(
            lo, hi, (FD_BATCH, FD_SEQ)), device="cuda")
        batches.append({"tokens": toks, "labels": toks})
        with torch.no_grad():
            feats = FD.proxy_features(models[-1], toks)
        cents.append(kmeans_fit(feats, 1, generator=torch.Generator(
            ).manual_seed(c)).centroids)
        thrs.append(float(min_dist_to_centroids(feats, cents[-1]).max())
                    * 1.5)
    proxy = torch.cat([b["tokens"] for b in batches])
    owner = torch.arange(FD_CLIENTS, device="cuda").repeat_interleave(
        FD_BATCH)
    return models, batches, proxy, owner, cents, thrs


def leaf_norms(model):
    return [float(p.detach().double().norm()) for p in model.parameters()]


def fd_step_child(spec):
    """One rank's client of the trainer path's (c): ``make_fd_train_step``
    over the 1-D client mesh of the world (gloo on one card), its client
    ``rank`` rebuilt as ``fd_setup`` builds it (the centroids and
    thresholds from the spec): the step's metrics and its updated leaves'
    norms."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import fd_trainer as FD
    from repro_torch.fed import mesh as fed_mesh
    from repro_torch.optim.optimizers import sgd
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=FD_LAYERS)
    models, batches, proxy, owner, _, _ = fd_setup(cfg)
    r = dist.get_rank()
    opt = sgd(FD_LR)
    mesh = fed_mesh.build_client_mesh(-1, device="cuda")
    step = FD.make_fd_train_step(opt, axis_name="clients", mesh=mesh)
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    model = models[r]
    _, metrics = step(model, opt.init(list(model.parameters())), batches[r],
                      proxy, owner,
                      torch.tensor(spec["centroids"][r], device="cuda"),
                      spec["thresholds"][r], r)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "norms": leaf_norms(model),
            "launches": {n: w.launches for n, w in wrappers.items()}}


def profile_train_step(model, cfg, steps=2, top=14, label="(a)"):
    """Two more training steps of ``model`` under ``torch.profiler``
    (CUPTI): the ops with the most device time, each with its calls, and
    the steps' device total; "not measured" when the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import adamw
    opt = adamw(TRAIN_LR)
    state = opt.init(list(model.parameters()))
    step = train.make_train_step(model, opt)
    batch = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1,
                                device="cuda")()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(steps):
            state, loss = step(state, batch)
        float(loss)
        torch.cuda.synchronize()
    # the host-side ops, each charged the device time of the kernels it
    # launched (the kernels' own rows would count that time twice)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if not rows:
        log(f"  {label} profile of a training step: not measured (no "
            "device time in the trace)")
        return
    rows.sort(key=lambda e: -e.self_device_time_total)
    log(f"  {label} profile of a training step (torch.profiler, {steps} "
        "steps): "
        f"device time {total:.2f} ms a step, by op (ms a step, calls):")
    for e in rows[:top]:
        log(f"    {e.key[:60]}: {e.self_device_time_total / 1e3 / steps:.2f}"
            f" ms ({e.self_device_time_total / 1e3 / steps / total:.1%}), "
            f"{e.count // steps} calls")
    del state


# the dry run (launch/dryrun.py) held to the card: its meta count of (a)'s
# step, fp32, unsharded, on the plain attention, against the FLOPs
# FlopCounterMode counts in one real step of (a)'s model on the card (the
# plain attention too), equal; (a)'s measured seconds a step no faster
# than the count's roofline bound at the card's fp32 peak and HBM rate;
# its peak within DRYRUN_PEAK_RTOL of (a)'s allocator peak. (h)'s
# collectives against the recording mesh's, equal.
DRYRUN_PEAK_RTOL = 0.25


def check_dryrun_step(model, cfg, batch, step_s, peak, smi):
    """(a)'s step counted on the meta device (``dryrun.count_step``, at
    ``batch``'s distinct tokens) against one real AdamW step of ``model``
    on ``batch`` under ``FlopCounterMode`` (the plain attention), and
    against (a)'s seconds a step and allocator peak."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun, train
    from repro_torch.optim.optimizers import adamw
    t = time.perf_counter()
    distinct = int(torch.unique(batch["tokens"]).numel())
    meta = dryrun.count_step(cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
                             dtype=torch.float32, remat=False,
                             distinct=distinct)
    meta_s = time.perf_counter() - t
    opt = adamw(TRAIN_LR)
    params = list(model.parameters())
    step = train.make_train_step(model, opt)
    model.kernel_backend = "torch"
    try:
        counter = FlopCounterMode(display=False)
        with counter:
            step(opt.init(params), batch)
        torch.cuda.synchronize()
    finally:
        model.kernel_backend = None
    flops = int(counter.get_total_flops())
    t_compute = meta["flops"] / dryrun.PEAK_FLOPS_F32
    t_memory = meta["traffic_bytes"] / dryrun.HBM_BW
    bound = max(t_compute, t_memory)
    gap = (meta["peak_bytes"] - peak) / peak
    log(f"  (a) the dry run ({smi}): launch.dryrun.count_step on the meta "
        f"device ({meta_s:.1f} s on the host, {distinct} distinct tokens) "
        f"counts {meta['flops']} FLOPs a step, one real step on the card "
        f"(plain attention, FlopCounterMode) {flops}: equal "
        f"{flops == meta['flops']}; its roofline at the fp32 peak "
        f"{dryrun.PEAK_FLOPS_F32:.3g} FLOP/s and {dryrun.HBM_BW:.3g} B/s: "
        f"compute {t_compute:.4f} s, memory {t_memory:.4f} s "
        f"({meta['traffic_bytes']} B moved), bound {bound:.4f} s against "
        f"(a)'s {step_s:.4f} s a step: {bound / step_s:.1%} of it; peak "
        f"{meta['peak_bytes'] / 2**30:.3f} GiB against (a)'s "
        f"{peak / 2**30:.3f} GiB ({gap:+.1%}, within "
        f"{DRYRUN_PEAK_RTOL:.0%})")
    if flops != meta["flops"]:
        raise AssertionError(f"(a) the dry run counts {meta['flops']} "
                             f"FLOPs, the card's step {flops}")
    if not step_s >= bound:
        raise AssertionError(f"(a) {step_s} s a step beats the dry run's "
                             f"bound {bound} s")
    if not abs(gap) <= DRYRUN_PEAK_RTOL:
        raise AssertionError(f"(a) the dry run's peak {meta['peak_bytes']} "
                             f"B is {gap:+.1%} off the card's {peak} B")


def check_dryrun_collectives(ranks_h, smi):
    """(h)'s model-axis calls and bytes on each rank against the dry run's
    recording mesh at that rank (meta device), equal."""
    import torch
    from repro_torch.launch import dryrun, hlo_analysis
    cfg = axis_cfg("h")
    for r, got in enumerate(ranks_h):
        rec = dryrun.RecordingMesh((1, 2), ("data", "model"), rank=r)
        meta = dryrun.count_step(cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
                                 dtype=torch.float32, remat=False, mesh=rec)
        want = hlo_analysis.mesh_calls(meta["record"])
        log(f"  (h) the dry run's recording mesh, rank {r} ({smi}): "
            f"{json.dumps(want)}; the card's step {json.dumps(got)}: equal "
            f"{want == got}")
        if want != got:
            raise AssertionError(f"(h) rank {r}: the dry run records "
                                 f"{want}, the card's step made {got}")


# examples_torch/ on the card, each a subprocess: (script, arguments).
# The first four run at once (one process each, most of their time the
# host's start-up), then fed_shardmap alone (eight ranks of its own);
# train_100m's steps cut from its 300 for time
EXAMPLE_STEPS = 60
EXAMPLES_TOGETHER = (("quickstart.py", ()), ("edgefd_vs_baselines.py", ()),
                     ("fd_transformers.py", ()),
                     ("train_100m.py", ("--steps", str(EXAMPLE_STEPS))))
EXAMPLES_ALONE = (("fed_shardmap.py", ()),)


def run_examples(smi):
    """``EXAMPLES_TOGETHER`` at once, then ``EXAMPLES_ALONE``, each on the
    card in a process group of its own, each of which must exit 0; its
    seconds (from the start of its group to its exit) and last line."""
    import signal
    import tempfile
    log(f"[6] examples_torch/ on the card, each a subprocess, the first "
        f"{len(EXAMPLES_TOGETHER)} at once ({smi})")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for group in (EXAMPLES_TOGETHER, EXAMPLES_ALONE):
            t = time.perf_counter()
            procs = {}
            for name, args in group:
                if name == "train_100m.py":
                    args = (*args, "--ckpt-dir", os.path.join(tmp, "ckpt"))
                path = os.path.join(tmp, f"{name}.log")
                with open(path, "w") as f:
                    procs[name] = (args, path, subprocess.Popen(
                        [sys.executable, str(ROOT / "examples_torch" / name),
                         *args], env=dict(os.environ, PYTHONPATH=str(SRC)),
                        stdout=f, stderr=subprocess.STDOUT,
                        start_new_session=True))
            try:
                while any(n not in out for n in procs):
                    if time.perf_counter() - t > 600:
                        raise AssertionError(f"examples {sorted(procs)} ran "
                                             "past 600 s")
                    for name, (args, path, p) in procs.items():
                        if name in out or p.poll() is None:
                            continue
                        out[name] = time.perf_counter() - t
                        with open(path) as f:
                            text = f.read()
                        if p.returncode:
                            raise AssertionError(
                                f"examples_torch/{name} exited "
                                f"{p.returncode}:\n{text[-4000:]}")
                        lines = [ln for ln in text.splitlines() if ln.strip()]
                        log(f"  examples_torch/{' '.join((name, *args[:2]))}"
                            f": exit 0 in {out[name]:.1f} s ({smi}); "
                            f"{lines[-1][:160] if lines else ''}")
                    time.sleep(0.2)
            finally:
                for _, _, p in procs.values():
                    if p.poll() is None:
                        os.killpg(p.pid, signal.SIGKILL)
                        p.wait()


def run_trainer_path(smi):
    """Phase 6's trainer path, (a)-(c) (module docstring). Returns B6's
    and the fused loss's launches on it and the timings of (a) and (b)."""
    import dataclasses
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.common.types import MoEConfig
    from repro_torch.configs import get_arch
    from repro_torch.core import fd_trainer as FD
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import decode_demo, train
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.optimizers import adamw, sgd
    from repro_torch.optim.schedules import linear_warmup_cosine
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    log(f"[6] the trainer path (ROADMAP A11), {smi}: {cfg.name}, "
        f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts top {cfg.moe.top_k}, expert ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters")
    wrappers = launch_counts()
    out = {}

    # (a) launch.train, whole model, its losses on the first batch before
    # and after; the first steps again, each against the plain attention
    # on the same weights and batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def drawn():
        return Transformer(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
    model = drawn()
    first = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")()
    with torch.no_grad():
        before = float(T.train_loss(model, first)[0])
    for w in wrappers.values():
        w.launches = 0
    with CountedCalls(fa_ops, "_launch",
                      key=lambda q, *_: tuple(q.shape)) as by_shape:
        losses, secs, model = train.train(
            cfg, steps=MOE_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            lr=TRAIN_LR, device="cuda", log_every=10, model=model,
            say=lambda m: log("    " + m))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    with torch.no_grad():
        after = float(T.train_loss(model, first)[0])
    if not all(finite(v) for v in losses) or not after < before:
        raise AssertionError(f"(a) the first batch's loss did not fall: "
                             f"{before} -> {after}; steps {losses}")
    want = (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, cfg.resolved_head_dim)
    if not launches.get("flash_attention") or set(by_shape.by_key) != {want}:
        raise AssertionError(f"(a) B6 launches {by_shape.by_key}, not at "
                             f"the long route's {want}")
    step_s = sum(secs[1:]) / len(secs[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    log(f"  (a) launch.train {cfg.name}, {MOE_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr {TRAIN_LR:g} ({smi}): step "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, the first batch's "
        f"loss {before:.4f} -> {after:.4f}; first step {secs[0]:.3f} s, "
        f"then {step_s:.4f} s a step ({min(secs[1:]):.4f}-"
        f"{max(secs[1:]):.4f}), {tok_s:.1f} tokens/s; peak "
        f"{peak / 2**30:.3f} GiB; launches {json.dumps(launches)} (B6 by "
        f"(B, N, S, h): {by_shape.by_key})")
    profile_train_step(model, cfg)
    out["a"] = dict(step_s=step_s, tok_s=tok_s, peak=peak, losses=losses,
                    launches=launches)
    check_dryrun_step(model, cfg, first, step_s, peak, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = drawn()
    opt = adamw(linear_warmup_cosine(TRAIN_LR, 10, MOE_STEPS))
    opt_state = opt.init(list(model.parameters()))
    step = train.make_train_step(model, opt)
    next_batch = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     device="cuda")
    again, plain = [], []
    for _ in range(TRAIN_PLAIN_STEPS):
        batch = next_batch()
        model.kernel_backend = "torch"
        n0 = wrappers["flash_attention"].launches
        with torch.no_grad():
            plain.append(float(T.train_loss(model, batch)[0]))
        if wrappers["flash_attention"].launches != n0:
            raise AssertionError("(a) the plain route launched B6")
        model.kernel_backend = None
        opt_state, loss = step(opt_state, batch)
        again.append(float(loss))
    gap = max(abs(a - b) / abs(b) for a, b in zip(plain, again))
    log(f"  (a) the first {TRAIN_PLAIN_STEPS} steps again from the same "
        f"weights: the kernel route's losses {again} (bitwise (a)'s: "
        f"{again == losses[:TRAIN_PLAIN_STEPS]}); each step's loss on the "
        f"plain attention, same weights and batch, {plain}; largest "
        f"relative gap {gap:.3e} (rtol 1e-3)")
    if again != losses[:TRAIN_PLAIN_STEPS]:
        raise AssertionError("(a) two identical training runs differ")
    if not gap <= 1e-3:
        raise AssertionError(f"(a) plain and kernel losses part by {gap}")
    del model, opt_state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) decode at full size, no expert dropping for the check
    e = cfg.moe.num_experts
    dcfg = dataclasses.replace(cfg, moe=MoEConfig(e, cfg.moe.top_k,
                                                  float(e)))
    model = Transformer(dcfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT)), device="cuda")
    decode_demo.prefill_then_decode(model, prompt, DECODE_CACHE, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, prefill, replay = decode_demo.prefill_then_decode(
        model, prompt, DECODE_CACHE, DECODE_NEW, return_logits=True)
    toks = toks.cpu()
    dec_s = time.perf_counter() - t
    err = float((replay - prefill).abs().max())
    torch.testing.assert_close(replay, prefill, rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    if toks.shape != (DECODE_BATCH, DECODE_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"(b) generated {toks}")
    dec_tok_s = DECODE_BATCH * DECODE_NEW / dec_s
    log(f"  (b) prefill_then_decode, batch {DECODE_BATCH}, prompt "
        f"{DECODE_PROMPT}, {DECODE_NEW} new tokens, cache {DECODE_CACHE}, "
        f"capacity factor {e} ({smi}): {dec_s:.3f} s (the prompt's replay "
        f"included), {dec_tok_s:.1f} new tokens/s; the replay's logits "
        f"against the prefill's max|err| {err:.3e} (rtol, atol "
        f"{DECODE_RTOL:g}); tokens {toks[0, :8].tolist()}")
    out["b"] = dict(seconds=dec_s, tok_s=dec_tok_s, err=err)
    del model, prefill, replay
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the FD trainer at 2 layers: local, then one client a rank
    fcfg = dataclasses.replace(cfg, num_layers=FD_LAYERS)
    for w in wrappers.values():
        w.launches = 0
    models, batches, proxy, owner, cents, thrs = fd_setup(fcfg)
    opt = sgd(FD_LR)
    states = [(m, opt.init(list(m.parameters()))) for m in models]
    t = time.perf_counter()
    states, metrics, id_frac = FD.fd_round_local(
        opt, states, batches, proxy, owner, cents, thrs)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t
    fd_launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    norms = [leaf_norms(m) for m, _ in states]
    if fd_launches.get("kd_kl_loss") != FD_CLIENTS:
        raise AssertionError(f"(c) fused loss launches {fd_launches}")
    log(f"  (c) fd_round_local, {FD_CLIENTS} clients, {fcfg.num_layers} "
        f"layers at granite-moe's widths, private {FD_BATCH} x {FD_SEQ}, "
        f"proxy {FD_KL[0]} rows, SGD {FD_LR:g} ({smi}): {local_s:.3f} s, "
        f"ID fraction {id_frac:.4f}, losses "
        f"{[round(float(m['loss']), 6) for m in metrics]}, kl "
        f"{[round(float(m['kl']), 6) for m in metrics]}; launches "
        f"{json.dumps(fd_launches)}")
    spec = {"kind": "fd_step", "centroids": [c.tolist() for c in cents],
            "thresholds": thrs}
    del states, models
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mesh_world(FD_CLIENTS, "gloo", [spec], tmp, timeout=300)
    gaps = []
    for r, (res,) in enumerate(ranks):
        gaps.append(abs(res["metrics"]["loss"] - float(metrics[r]["loss"]))
                    / abs(float(metrics[r]["loss"])))
        n_gap = max(abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(res["norms"], norms[r]))
        if not gaps[-1] <= 1e-4 or not n_gap <= 1e-5:
            raise AssertionError(f"(c) rank {r}: loss gap {gaps[-1]}, "
                                 f"norm gap {n_gap}")
        if not res["launches"]["flash_attention"] \
                or res["launches"]["kd_kl_loss"] != 1:
            raise AssertionError(f"(c) rank {r} launches {res['launches']}")
        log(f"  (c) make_fd_train_step, rank {r} of {FD_CLIENTS} over gloo "
            f"on the one card: loss {res['metrics']['loss']:.6f} "
            f"(relative gap {gaps[-1]:.3e}, rtol 1e-4), updated leaves' "
            f"norms within {n_gap:.3e} (rtol 1e-5), ID fraction "
            f"{res['metrics']['id_fraction']:.4f}")
    out["c"] = dict(local_s=local_s, launches=fd_launches)
    for label, arch, fd_layers, steps, layers in RECURRENT_RUNS:
        out[arch] = run_recurrent(label, arch, fd_layers, steps, layers,
                                  smi, wrappers)
    log(f"  the trainer path took {time.perf_counter() - t0:.1f} s")
    return out


def run_recurrent(label, arch, fd_layers, steps, layers, smi, wrappers):
    """The trainer path's (d) or (e) on a recurrent arch: (a)'s
    ``launch.train`` for ``steps`` at ``layers`` (None: the whole model;
    else a depth cut, widths as published), the first batch's loss
    falling (no
    kernel launched: the recurrences are plain PyTorch as the reference's
    scans are plain JAX, and hybrid's windowed attention takes B6's plain
    route, as the reference's dispatch does; for ssm, then a few steps on
    the sLSTM's plain-autograd route, timed), then ``prefill_then_decode``
    at (b)'s sizes on the whole model (the trained weights, or after a
    depth cut a whole model drawn from seed 0; the replay held to the
    prefill: elementwise at (b)'s tolerance, for ssm by
    ``DECODE_REL_SSM``), then the FD trainer's ``fd_round_local`` at
    ``fd_layers`` (one group), B1 and the fused loss launched. Every
    model's built parameter count is logged beside
    ``cfg.param_count()``."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import fd_trainer as FD
    from repro_torch.launch import decode_demo, train
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.optimizers import sgd
    t0 = time.perf_counter()
    whole = get_arch(arch)
    cfg = whole if layers is None else dataclasses.replace(
        whole, num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def drawn(c):
        return Transformer(c, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
    model = drawn(cfg)

    def counted(m, c):
        return (f"{sum(p.numel() for p in m.parameters())} parameters "
                f"built, {len(m.blocks)} groups (cfg.param_count() "
                f"{c.param_count()} for {c.num_layers} layers)")
    log(f"  {label} {cfg.name} ({cfg.family}), d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}: {counted(model, cfg)} ({smi})")
    first = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")()
    with torch.no_grad():
        before = float(T.train_loss(model, first)[0])
    for w in wrappers.values():
        w.launches = 0
    losses, secs, model = train.train(
        cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=TRAIN_LR, device="cuda", log_every=10, model=model,
        say=lambda m: log("    " + m))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    with torch.no_grad():
        after = float(T.train_loss(model, first)[0])
    if not all(finite(v) for v in losses) or not after < before:
        raise AssertionError(f"{label} the first batch's loss did not "
                             f"fall: {before} -> {after}; steps {losses}")
    if launches:
        raise AssertionError(f"{label} training launched {launches}: no "
                             "kernel is on this path")
    step_s = sum(secs[1:]) / len(secs[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    log(f"  {label} launch.train {cfg.name}"
        + ("" if layers is None else f" at {layers} layers (a depth cut)")
        + f", {steps} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr {TRAIN_LR:g} ({smi}): step "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, the first batch's "
        f"loss {before:.4f} -> {after:.4f}; first step {secs[0]:.3f} s, "
        f"then {step_s:.4f} s a step ({min(secs[1:]):.4f}-"
        f"{max(secs[1:]):.4f}), {tok_s:.1f} tokens/s; peak "
        f"{peak / 2**30:.3f} GiB; no kernel launched")
    res = dict(step_s=step_s, tok_s=tok_s, peak=peak, losses=losses,
               before=before, after=after)
    if cfg.family == "ssm":
        from repro_torch.models import ssm
        ssm.set_slstm_custom_vjp(False)
        try:
            plain, plain_secs, model = train.train(
                cfg, steps=SLSTM_PLAIN_STEPS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, lr=TRAIN_LR, device="cuda", model=model,
                say=lambda m: None)
        finally:
            ssm.set_slstm_custom_vjp(True)
        res["plain_step_s"] = sum(plain_secs) / len(plain_secs)
        log(f"  {label} {SLSTM_PLAIN_STEPS} more steps on the sLSTM's "
            f"plain-autograd route ({smi}): {res['plain_step_s']:.4f} s a "
            f"step ({min(plain_secs):.4f}-{max(plain_secs):.4f}), losses "
            f"{[round(v, 4) for v in plain]} (custom backward: "
            f"{step_s:.4f} s a step)")
        if not all(finite(v) for v in plain):
            raise AssertionError(f"{label} plain-route losses {plain}")
    if layers is not None:
        del model
        gc.collect()
        torch.cuda.empty_cache()
        cfg = whole
        model = drawn(cfg)
    gc.collect()
    torch.cuda.empty_cache()

    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT)), device="cuda")
    decode_demo.prefill_then_decode(model, prompt, DECODE_CACHE, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, prefill, replay = decode_demo.prefill_then_decode(
        model, prompt, DECODE_CACHE, DECODE_NEW, return_logits=True)
    toks = toks.cpu()
    dec_s = time.perf_counter() - t
    err = float((replay - prefill).abs().max())
    rel = float((replay - prefill).norm() / prefill.norm())
    if not bool(torch.isfinite(replay).all() & torch.isfinite(prefill).all()):
        raise AssertionError(f"{label} non-finite decode logits")
    if cfg.family == "ssm":
        if not rel <= DECODE_REL_SSM:
            raise AssertionError(f"{label} the replay parts from the "
                                 f"prefill by {rel:.3e} (relative)")
    else:
        torch.testing.assert_close(replay, prefill, rtol=DECODE_RTOL,
                                   atol=DECODE_ATOL)
    if toks.shape != (DECODE_BATCH, DECODE_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{label} generated {toks}")
    res.update(dec_s=dec_s, dec_tok_s=DECODE_BATCH * DECODE_NEW / dec_s,
               dec_err=err, dec_rel=rel)
    log(f"  {label} prefill_then_decode on the "
        + ("trained weights" if layers is None else "whole model drawn "
           "from seed 0") + f", batch "
        f"{DECODE_BATCH}, prompt {DECODE_PROMPT}, {DECODE_NEW} new tokens, "
        f"cache {DECODE_CACHE} ({counted(model, cfg)}; {smi}): "
        f"{dec_s:.3f} s (the prompt's replay included), "
        f"{res['dec_tok_s']:.1f} new tokens/s; the replay's logits against "
        f"the prefill's max|err| {err:.3e}, relative gap {rel:.3e} ("
        + (f"relative bound {DECODE_REL_SSM:g}" if cfg.family == "ssm"
           else f"rtol, atol {DECODE_RTOL:g}")
        + f"); tokens {toks[0, :8].tolist()}")
    del model, prefill, replay
    gc.collect()
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(cfg, num_layers=fd_layers)
    for w in wrappers.values():
        w.launches = 0
    models, batches, proxy, owner, cents, thrs = fd_setup(fcfg)
    opt = sgd(FD_LR)
    states = [(m, opt.init(list(m.parameters()))) for m in models]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    states, metrics, id_frac = FD.fd_round_local(
        opt, states, batches, proxy, owner, cents, thrs)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t
    fd_launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    if fd_launches.get("kd_kl_loss") != FD_CLIENTS \
            or fd_launches.get("lloyd_step", 0) < FD_CLIENTS \
            or not all(finite(float(m["loss"])) for m in metrics):
        raise AssertionError(f"{label} FD round: launches {fd_launches}, "
                             f"losses {[float(m['loss']) for m in metrics]}")
    log(f"  {label} fd_round_local, {FD_CLIENTS} clients of "
        f"{counted(states[0][0], fcfg)} (a depth cut), private {FD_BATCH} x "
        f"{FD_SEQ}, proxy {FD_CLIENTS * FD_BATCH} rows, SGD {FD_LR:g} "
        f"({smi}): {local_s:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, ID fraction "
        f"{id_frac:.4f}, losses {[round(float(m['loss']), 6) for m in metrics]}"
        f", kl {[round(float(m['kl']), 6) for m in metrics]}; launches "
        f"{json.dumps(fd_launches)} (B1 at (n, d, k) = "
        f"{RECURRENT_LLOYD[arch]}, the fused loss at {RECURRENT_KL[arch]})")
    res.update(fd_s=local_s, fd_launches=fd_launches)
    del states, models
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {label} took {time.perf_counter() - t0:.1f} s")
    return res


def measure_trainer(out, attn_err, kl_err, rec_errs):
    """Phase 7's rows of the trainer path: B6 at (a)'s shape and the
    fused loss at (c)'s, (d)'s and (e)'s, and B1 at (d)'s and (e)'s FD
    fits, beside their plain versions and the library calls
    (scaled_dot_product_attention; F.kl_div, the weighted mean and
    autograd; none for B1), timed only."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kmeans_dist import ref as kd_ref
    b, n, nkv, s, h = TRAIN_ATTN
    q, k, v = map(model_layout, attn_inputs(b, n, nkv, s, h, seed=3))
    moved = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = attn_cost(b, n, s, h, s, True)
    ms, plain_ms, b_ms, b_by, dev = time_row(
        f"flash_attention at the trainer's ({b}, {n}, {s}, {h}) kv {nkv}, "
        "model layout (long route)",
        lambda: ops.flash_attention_cuda(q, k, v, True),
        lambda: ref.attention_gqa(q, k, v, causal=True), moved, flops)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    lib_ms = time_ms(sdpa)
    log(f"    library (scaled_dot_product_attention) {lib_ms:.5f}, device "
        f"only {fmt(device_ms(sdpa))}; share of the bound, device only: "
        + ("not measured" if dev is None else f"{b_ms / dev:.3f}")
        + "; launches x (device - bound) "
        + above_bound(out["a"]["launches"]["flash_attention"], dev, b_ms))
    rows = [{"name": "flash_attention_trainer", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
             "launches": out["a"]["launches"]["flash_attention"],
             "max_abs_err": attn_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}]
    rows.append(fd_kl_row("kd_kl_loss_wide_vocab", FD_KL,
                          out["c"]["launches"]["kd_kl_loss"], kl_err))
    for _, arch, *_ in RECURRENT_RUNS:
        fd = out[arch]["fd_launches"]
        lloyd_err, rec_kl_err = rec_errs[arch]
        rows.append(fd_kl_row(f"kd_kl_loss_vocab_{RECURRENT_KL[arch][1]}",
                              RECURRENT_KL[arch], fd["kd_kl_loss"],
                              rec_kl_err))
        n, d, k = RECURRENT_LLOYD[arch]
        x, cents = lloyd_inputs(n, d, k, seed=3)
        ms, plain_ms, b_ms, b_by, _ = time_row(
            f"lloyd_step at the FD trainer's fit, {arch}, n={n} d={d} "
            f"k={k}", lambda: kd_ops.lloyd_step_cuda(x, cents),
            lambda: kd_ref.lloyd_step(x, cents), *lloyd_cost(n, d, k))
        rows.append({"name": f"lloyd_step_fd_d{d}", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/lloyd_step.cu",
                     "replaces": "src/repro/kernels/kmeans_dist/"
                                 "kernel.py:113",
                     "launches": fd["lloyd_step"], "max_abs_err": lloyd_err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    return rows


def fd_kl_row(name, shape, launches, err):
    """The fused loss at an FD trainer's (rows, vocab), masked weights:
    kernel, plain version and library call (F.kl_div, the weighted mean
    and autograd), timed; its JSON row."""
    import torch
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.kernels.distill_kl import ref as kl_ref
    rows_k, kk = shape
    st, tt, _ = kl_inputs(rows_k, kk, seed=3)
    w = kl_weights(rows_k, "masked", seed=3)
    s_ = st.clone().requires_grad_(True)
    moved, flops = kl_loss_cost(rows_k, kk)
    # the plain and library routes' host work (~1 ms a call) outlasts the
    # sleep behind 50 calls: their device-only times take 10
    ms, plain_ms, b_ms, b_by, dev = time_row(
        f"kd_kl_loss at the FD trainer's n={rows_k} K={kk} (loss, kl, ds)",
        lambda: kl_ops.kd_kl_loss_cuda(st, tt, w, TEMPERATURE),
        lambda: torch.autograd.grad(
            kl_ref.kd_kl_loss(s_, tt, TEMPERATURE, w), s_), moved, flops,
        plain_iters=10)

    def library():
        return torch.autograd.grad(kl_library_loss(s_, tt, w, TEMPERATURE),
                                   s_)
    lib_ms = time_ms(library)
    log(f"    library (F.kl_div, weighted mean, autograd) {lib_ms:.5f}, "
        f"device only {fmt(device_ms(library, 10))}; share of the bound, "
        "device only: "
        + ("not measured" if dev is None else f"{b_ms / dev:.3f}")
        + f"; {kl_ops.wide_route(kk)[0]} blocks a row; launches x (device "
        f"- bound) {above_bound(launches, dev, b_ms)}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kd_kl.cu",
            "replaces": "src/repro/kernels/distill_kl/kernel.py:50",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def check_trainer_kernels():
    """B6 and the fused loss at the trainer path's shapes, and B1 and the
    fused loss at the recurrent archs' FD trainer's, against their plain
    versions (phase 3's checks): the max abs errors (the recurrent ones
    by arch)."""
    attn = check_flash(*TRAIN_ATTN)
    check_flash_grads(*TRAIN_ATTN)
    kl = check_kl_loss(*FD_KL, "masked")
    rec = {arch: (check_lloyd(*RECURRENT_LLOYD[arch]),
                  max(check_kl_loss(*RECURRENT_KL[arch], "masked").values()))
           for _, arch, *_ in RECURRENT_RUNS}
    return attn, max(kl.values()), rec


def measure_flash_local(launches, err):
    """Phase 7's B6 row at (c)'s local heads: a rank's training step, 4
    clients' batches of 64 folded, 16 query and 4 kv heads of 128, the
    model's layout: per call and device only, the plain version and
    scaled_dot_product_attention (timed only)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    b, n, nkv, s, h = MESH_LOCAL_ATTN
    q, k, v = map(model_layout, attn_inputs(b, n, nkv, s, h, seed=2))
    moved = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = attn_cost(b, n, s, h, s, True)
    ms, plain_ms, b_ms, b_by, dev = time_row(
        f"flash_attention at the (1, 2) mesh's local heads ({b}, {n}, {s}, "
        f"{h}) kv {nkv}, model layout",
        lambda: ops.flash_attention_cuda(q, k, v, True),
        lambda: ref.attention_gqa(q, k, v, causal=True), moved, flops)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    lib_ms = time_ms(library)
    log(f"    library (scaled_dot_product_attention) {lib_ms:.5f}, device "
        f"only {fmt(device_ms(library))}; share of the byte bound, device "
        "only: " + ("not measured" if dev is None else f"{b_ms / dev:.3f}"))
    return {"name": "flash_attention_local_heads", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# ------------------------------- phase 6, the encoder and cross-attention
# families (ROADMAP A11.2): (f) hubert-xlarge (arXiv:2106.07447; 48
# layers, d 1280, 16 heads of 80, ff 5120, 504 units, 1.26 B parameters)
# whole, 25 of launch.train's 50 steps of 8 x 128 frames; (g) llama-3.2-vision-90b
# (hf:meta-llama/Llama-3.2-11B-Vision; d 8192, 64/8 heads of 128, ff
# 28672, vocab 128256, 1601 vision tokens) at full widths, its depth cut:
# the whole model (90.7 B parameters) does not fit one card, so one group
# (4 self and 1 cross block) runs a train_loss forward and backward (no
# optimizer step: any optimizer state on top of 6.5 B parameters and their
# gradients needs at least ~78 GB more), two groups run prefill and decode
ENC_ARCH, VLM_ARCH = "hubert-xlarge", "llama-3.2-vision-90b"
VLM_GRAD_GROUPS, VLM_DECODE_GROUPS = 1, 2
VLM_GATE = 0.5                 # tanh(0) at init would hide the cross path
VISION_KEYS = 1601
# B6 on these paths (b, n, nkv, s, h, keys): hubert's heads of 80, full,
# on the short and the long route; the vlm's cross-attention over the
# vision keys on the long route (training) and the short route (decode's
# prefill of 16)
ENC_ATTN = ((TRAIN_BATCH, 16, 16, 16, 80, None),
            (TRAIN_BATCH, 16, 16, TRAIN_SEQ, 80, None))
CROSS_ATTN = ((TRAIN_BATCH, 64, 8, TRAIN_SEQ, 128, VISION_KEYS),
              (DECODE_BATCH, 64, 8, DECODE_PROMPT, 128, VISION_KEYS))


def check_family_kernels():
    """Phase 3 for the encoder and vlm families: B6 at h = 80 on both
    routes (full and causal; the short route also on a poisoned output,
    where a column left unwritten fails: chunks 16-19 of a row are lanes
    0-3's third chunk) and at the cross-attention shapes over 1601 keys,
    each against its plain version; the autograd function at hubert's and
    the cross block's training shapes. Returns the max abs errors by
    shape."""
    errs = {}
    for b, n, nkv, s, h, sk in ENC_ATTN + CROSS_ATTN:
        errs[(b, n, nkv, s, h, sk)] = check_flash(b, n, nkv, s, h,
                                                  causal=False, sk=sk)
    for b, n, nkv, s, h, _ in ENC_ATTN:
        check_flash(b, n, nkv, s, h, causal=True)
    check_flash(*ENC_ATTN[0][:5], causal=False, seed=1, poison=True)
    check_flash(3, 16, 16, 5, 80, causal=False, sk=37, poison=True)
    check_flash_grads(*ENC_ATTN[1][:5], causal=False)
    b, n, nkv, s, h, sk = CROSS_ATTN[0]
    check_flash_grads(2, n, nkv, s, h, causal=False, sk=sk)
    return errs


def check_privacy():
    """Phase 4: the proxy's Gaussian mechanism on the card (a CUDA
    generator): the main path's proxy set (mnist_feat, 10 clients strong,
    n_train 60000; its first 512 rows of 50) clipped, every row's norm at
    most clip_norm + 1e-4; the noise's std on 2000 x 8 zeros within 10% of
    sigma; then tests/test_privacy.py's trade-off from numpy seeds (300
    private rows N(0, 1) in 8 dimensions, 100 OOD rows shifted by 8): a
    KMeans-DRE fitted through B1 on the private rows, the privatized rows
    filtered through B2, the balanced accuracy above 0.8 at epsilon 100
    (clip 10), printed at 1 and 0.05 too."""
    import numpy as np
    import torch
    from repro_torch.core import privacy as P
    from repro_torch.core.dre import KMeansDRE
    from repro_torch.data.partition import partition
    from repro_torch.data.proxy import build_proxy
    from repro_torch.data.synthetic import make_dataset
    log("[4] the proxy's Gaussian mechanism on the card (core/privacy.py)")
    ds = make_dataset("mnist_feat", n_train=60000, n_test=10000, seed=0)
    parts = partition(ds.x, ds.y, num_clients=10, num_classes=ds.num_classes,
                      scenario="strong", seed=0)
    proxy = torch.as_tensor(build_proxy(parts, 0.1, seed=0).x[:512],
                            device="cuda")
    dp = P.make_dp(epsilon=1.0, clip_norm=1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = P.privatize_proxy(gen, proxy, dp)
    norms = P.clip_samples(proxy, dp.clip_norm).norm(dim=1)
    zeros = P.privatize_proxy(gen, torch.zeros((2000, 8), device="cuda"),
                              dp)
    std = float(zeros.std())
    if out.device.type != "cuda" or out.shape != proxy.shape \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"privatize_proxy gave {out.shape} on "
                             f"{out.device}")
    if not float(norms.max()) <= dp.clip_norm + 1e-4:
        raise AssertionError(f"clipped norms up to {float(norms.max())}")
    if not abs(std - dp.sigma) / dp.sigma < 0.1:
        raise AssertionError(f"noise std {std}, sigma {dp.sigma}")
    log(f"  proxy {tuple(proxy.shape)} (raw norms up to "
        f"{float(proxy.norm(dim=1).max()):.3f}): clipped norms up to "
        f"{float(norms.max()):.6f} (clip {dp.clip_norm:g} + 1e-4); noise "
        f"std on 2000 x 8 zeros {std:.4f} against sigma {dp.sigma:.4f} "
        f"({abs(std - dp.sigma) / dp.sigma:.2%}, within 10%)")
    rng = np.random.default_rng(5)
    private = torch.as_tensor(rng.standard_normal((300, 8)).astype(
        np.float32), device="cuda")
    ood = torch.as_tensor(rng.standard_normal((100, 8)).astype(
        np.float32) + 8.0, device="cuda")
    wrappers = launch_counts()
    before = {n: w.launches for n, w in wrappers.items()}
    dre = KMeansDRE(num_centroids=1).learn(
        private, generator=torch.Generator().manual_seed(2))
    accs = {}
    for i, eps in enumerate((100.0, 1.0, 0.05)):
        dpi = P.make_dp(epsilon=eps, clip_norm=10.0)
        noisy_id = P.privatize_proxy(torch.Generator(
            device="cuda").manual_seed(3 + i), private, dpi)
        noisy_ood = P.privatize_proxy(torch.Generator(
            device="cuda").manual_seed(13 + i), ood, dpi)
        accs[eps] = (float(dre.is_id(noisy_id).float().mean())
                     + 1 - float(dre.is_id(noisy_ood).float().mean())) / 2
    launched = {n: w.launches - before[n] for n, w in wrappers.items()
                if w.launches != before[n]}
    if not launched.get("lloyd_step") or not launched.get(
            "min_dist_and_mask"):
        raise AssertionError(f"the DRE did not run B1 and B2: {launched}")
    if not accs[100.0] > 0.8 or not accs[100.0] >= accs[0.05]:
        raise AssertionError(f"balanced accuracies {accs}")
    log("  KMeans-DRE (B1 fit, B2 filter) on privatized rows, balanced "
        "accuracy by epsilon (clip 10): "
        + ", ".join(f"{e:g}: {a:.4f}" for e, a in accs.items())
        + f" (> 0.8 at 100); launches {json.dumps(launched)}")


def set_gates(model, value=VLM_GATE):
    """Every vlm group's ``gate_attn`` and ``gate_mlp`` to ``value``."""
    import torch
    with torch.no_grad():
        for grp in model.blocks:
            grp["cross"]["gate_attn"].fill_(value)
            grp["cross"]["gate_mlp"].fill_(value)


def attn_by_shape(fa_ops):
    """B6's launches by (B, N, Sq, h, Sk) of the operands its autograd
    function hands the launch."""
    return CountedCalls(fa_ops, "_launch",
                        key=lambda q, k, *_: (*q.shape, k.shape[2]))


def run_encoder(smi, wrappers):
    """(f): ``launch.train`` on hubert-xlarge whole at (a)'s settings
    (``ENC_STEPS`` steps), the
    first batch's loss falling, B6 launched only on its long route at
    h = 80, full, 48 a step; the first 3 steps again from the same
    weights, each held to the plain attention's loss on the same weights
    and batch (rtol 1e-3); two more steps profiled."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine
    t0 = time.perf_counter()
    cfg = get_arch(ENC_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def drawn():
        return Transformer(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
    model = drawn()
    built = sum(p.numel() for p in model.parameters())
    log(f"  (f) {cfg.name} ({cfg.family}), {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim}, "
        f"ff {cfg.d_ff}, {cfg.vocab_size} units: {built} parameters built "
        f"(cfg.param_count() {cfg.param_count()}; {smi})")
    first = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")()
    with torch.no_grad():
        before = float(T.train_loss(model, first)[0])
    for w in wrappers.values():
        w.launches = 0
    with attn_by_shape(fa_ops) as by_shape:
        losses, secs, model = train.train(
            cfg, steps=ENC_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            lr=TRAIN_LR, device="cuda", log_every=10, model=model,
            say=lambda m: log("    " + m))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    with torch.no_grad():
        after = float(T.train_loss(model, first)[0])
    if not all(finite(v) for v in losses) or not after < before:
        raise AssertionError(f"(f) the first batch's loss did not fall: "
                             f"{before} -> {after}; steps {losses}")
    want = (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, 80, TRAIN_SEQ)
    if by_shape.by_key != {want: cfg.num_layers * ENC_STEPS}:
        raise AssertionError(f"(f) B6 launches {by_shape.by_key}, not "
                             f"{cfg.num_layers} a step at {want}")
    step_s = sum(secs[1:]) / len(secs[1:])
    log(f"  (f) launch.train {cfg.name}, {ENC_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} frames, lr {TRAIN_LR:g} ({smi}): step "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, the first batch's "
        f"loss {before:.4f} -> {after:.4f}; first step {secs[0]:.3f} s, "
        f"then {step_s:.4f} s a step ({min(secs[1:]):.4f}-"
        f"{max(secs[1:]):.4f}), {TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} "
        f"frames/s; peak {peak / 2**30:.3f} GiB; launches "
        f"{json.dumps(launches)} (B6 by (B, N, Sq, h, Sk), full: "
        f"{by_shape.by_key})")
    profile_train_step(model, cfg, label="(f)")
    res = dict(step_s=step_s, peak=peak, losses=losses,
               launches=dict(by_shape.by_key))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = drawn()
    opt = adamw(linear_warmup_cosine(TRAIN_LR, 10, ENC_STEPS))
    opt_state = opt.init(list(model.parameters()))
    step = train.make_train_step(model, opt)
    next_batch = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     device="cuda")
    again, plain = [], []
    n0 = wrappers["flash_attention"].launches
    for _ in range(TRAIN_PLAIN_STEPS):
        batch = next_batch()
        model.kernel_backend = "torch"
        with torch.no_grad():
            plain.append(float(T.train_loss(model, batch)[0]))
        model.kernel_backend = None
        opt_state, loss = step(opt_state, batch)
        again.append(float(loss))
    if wrappers["flash_attention"].launches - n0 != \
            cfg.num_layers * TRAIN_PLAIN_STEPS:
        raise AssertionError("(f) the plain route launched B6, or the "
                             "kernel route did not")
    gap = max(abs(a - b) / abs(b) for a, b in zip(plain, again))
    log(f"  (f) the first {TRAIN_PLAIN_STEPS} steps again from the same "
        f"weights: the kernel route's losses {again} (bitwise (f)'s: "
        f"{again == losses[:TRAIN_PLAIN_STEPS]}); the plain attention's on "
        f"the same weights and batch {plain}; largest relative gap "
        f"{gap:.3e} (rtol 1e-3)")
    if again != losses[:TRAIN_PLAIN_STEPS]:
        raise AssertionError("(f) two identical training runs differ")
    if not gap <= 1e-3:
        raise AssertionError(f"(f) plain and kernel losses part by {gap}")
    del model, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (f) took {time.perf_counter() - t0:.1f} s")
    return res


def run_vlm(smi, wrappers):
    """(g): llama-3.2-vision-90b at full widths, depth cut. One group
    (``VLM_GRAD_GROUPS``), gates at ``VLM_GATE``: ``train_loss`` forward
    and backward on one batch of 8 x 128 tokens with their 1601 vision
    embeddings (``make_batch_fn``'s), held to the plain attention on the
    same weights and batch (loss and every gradient leaf's norm, rtol
    1e-3), B6 on its long route for the self blocks (causal) and the cross
    block (full, over 1601 keys). Then two groups: a prefill of batch 4 x
    16 with vision, ``init_cache(vision=, params=)``, the prompt replayed
    through ``decode_step`` and held to the prefill's logits (2e-2
    elementwise, the reference's test tolerance), and 16 greedy new
    tokens. Then ``launch.train.main`` at ``--reduced`` for its 50 steps
    (the vision batches through main)."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Transformer
    t0 = time.perf_counter()
    whole = get_arch(VLM_ARCH)
    per = whole.cross_attn_every
    res = {}

    def drawn(groups):
        cfg = dataclasses.replace(whole, num_layers=groups * per)
        m = Transformer(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        set_gates(m)
        log(f"  (g) {cfg.name} ({cfg.family}) at {groups} of "
            f"{whole.num_layers // per} groups ({cfg.num_layers} layers, a "
            f"depth cut), d {cfg.d_model}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_vision_tokens} "
            f"vision tokens: {sum(p.numel() for p in m.parameters())} "
            f"parameters built (cfg.param_count() {cfg.param_count()}; "
            f"whole {whole.param_count()}), gates {VLM_GATE}")
        return cfg, m

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = drawn(VLM_GRAD_GROUPS)
    batch = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")()
    params = list(model.parameters())
    out = {}
    for w in wrappers.values():
        w.launches = 0
    for route in (None, "torch"):
        model.kernel_backend = route
        n0 = wrappers["flash_attention"].launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        with attn_by_shape(fa_ops) as by_shape:
            loss, _ = T.train_loss(model, batch)
            grads = torch.autograd.grad(loss, params)
        norms = [float(g.double().norm()) for g in grads]
        del grads
        torch.cuda.synchronize()
        out[route] = dict(loss=float(loss.detach()), norms=norms,
                          s=time.perf_counter() - t,
                          launches=wrappers["flash_attention"].launches - n0,
                          by_shape=dict(by_shape.by_key))
        del loss
    model.kernel_backend = None
    peak = torch.cuda.max_memory_allocated()
    k_run, p_run = out[None], out["torch"]
    loss_gap = abs(k_run["loss"] - p_run["loss"]) / abs(p_run["loss"])
    norm_gap = max(abs(a - b) / max(b, 1e-30)
                   for a, b in zip(k_run["norms"], p_run["norms"]))
    want = {(TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, 128, TRAIN_SEQ):
            VLM_GRAD_GROUPS * (per - 1),
            (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, 128, VISION_KEYS):
            VLM_GRAD_GROUPS}
    log(f"  (g) train_loss forward and backward, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens with {TRAIN_BATCH} x {VISION_KEYS} vision "
        f"embeddings ({smi}): loss {k_run['loss']:.6f} (plain attention "
        f"{p_run['loss']:.6f}, relative gap {loss_gap:.3e}, rtol 1e-3); "
        f"{len(k_run['norms'])} gradient leaves' norms within "
        f"{norm_gap:.3e} (rtol 1e-3); {k_run['s']:.3f} s (plain {p_run['s']:.3f}); peak "
        f"{peak / 2**30:.3f} GiB; B6 by (B, N, Sq, h, Sk) "
        f"{k_run['by_shape']} (plain route {p_run['launches']})")
    if not finite(k_run["loss"]) or not loss_gap <= 1e-3 \
            or not norm_gap <= 1e-3:
        raise AssertionError(f"(g) kernel and plain part: loss gap "
                             f"{loss_gap}, norm gap {norm_gap}")
    if k_run["by_shape"] != want or p_run["launches"]:
        raise AssertionError(f"(g) B6 launches {k_run['by_shape']} (want "
                             f"{want}), plain route {p_run['launches']}")
    res.update(grad_s=k_run["s"], grad_peak=peak,
               launches=dict(k_run["by_shape"]), grad_loss=k_run["loss"],
               grad_norms=k_run["norms"])
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cfg, model = drawn(VLM_DECODE_GROUPS)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT)), device="cuda")
    vision = torch.as_tensor(rng.standard_normal(
        (DECODE_BATCH, VISION_KEYS, cfg.d_model)).astype(np.float32),
        device="cuda")

    def prefill_then_decode(n_new):
        prefill = model(prompt, vision=vision)
        cache = T.init_cache(cfg, DECODE_BATCH, DECODE_CACHE, torch.float32,
                             device="cuda", vision=vision, params=model)
        replay = []
        for t in range(DECODE_PROMPT):
            lg, cache = T.decode_step(model, prompt[:, t:t + 1], cache, t)
            replay.append(lg[:, 0])
        toks = []
        tok = torch.argmax(lg[:, -1:], dim=-1)
        for i in range(n_new):
            toks.append(tok)
            lg, cache = T.decode_step(model, tok, cache, DECODE_PROMPT + i)
            tok = torch.argmax(lg[:, -1:], dim=-1)
        return torch.cat(toks, dim=1), prefill, torch.stack(replay, dim=1)

    with torch.no_grad():
        prefill_then_decode(1)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        with attn_by_shape(fa_ops) as by_shape:
            toks, prefill, replay = prefill_then_decode(DECODE_NEW)
        toks = toks.cpu()
        dec_s = time.perf_counter() - t
    err = float((replay - prefill).abs().max())
    if not bool(torch.isfinite(prefill).all()):
        raise AssertionError("(g) non-finite prefill logits")
    torch.testing.assert_close(replay, prefill, rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    if toks.shape != (DECODE_BATCH, DECODE_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"(g) generated {toks}")
    want = {(DECODE_BATCH, cfg.num_heads, DECODE_PROMPT, 128, DECODE_PROMPT):
            VLM_DECODE_GROUPS * (per - 1),
            (DECODE_BATCH, cfg.num_heads, DECODE_PROMPT, 128, VISION_KEYS):
            VLM_DECODE_GROUPS}
    if by_shape.by_key != want:
        raise AssertionError(f"(g) prefill B6 launches {by_shape.by_key}, "
                             f"not {want}")
    res.update(dec_s=dec_s, dec_tok_s=DECODE_BATCH * DECODE_NEW / dec_s,
               dec_err=err, prefill_launches=dict(by_shape.by_key),
               decoded=(toks, prefill.cpu(), replay.cpu()))
    log(f"  (g) prefill (vision {DECODE_BATCH} x {VISION_KEYS}), "
        f"init_cache(vision=, params=), the prompt's replay and "
        f"{DECODE_NEW} new tokens, batch {DECODE_BATCH}, prompt "
        f"{DECODE_PROMPT}, cache {DECODE_CACHE} ({smi}): {dec_s:.3f} s, "
        f"{res['dec_tok_s']:.1f} new tokens/s; the replay's logits against "
        f"the prefill's max|err| {err:.3e} (rtol, atol {DECODE_RTOL:g}); "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; B6 "
        f"by (B, N, Sq, h, Sk) {by_shape.by_key}; tokens "
        f"{toks[0, :8].tolist()}")
    del model, prefill, replay, vision
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    losses = train.main(["--arch", VLM_ARCH, "--reduced", "--log-every",
                         "25"])
    log(f"  (g) launch.train.main --arch {VLM_ARCH} --reduced: "
        f"{len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (g) took {time.perf_counter() - t0:.1f} s")
    return res


def run_family_paths(smi):
    """The trainer path's (f) and (g), their launches counted from 0."""
    wrappers = launch_counts()
    return {"f": run_encoder(smi, wrappers), "g": run_vlm(smi, wrappers)}


def measure_families(out, errs):
    """Phase 7's B6 rows at the encoder and vlm families' shapes (full
    attention): hubert's h = 80 on both routes, the cross-attention over
    1601 vision keys on both, per call and device only, beside the plain
    version and scaled_dot_product_attention (timed only). Launches: (f)'s
    training and (g)'s gradient pass and prefill."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    launches = {}
    for by_shape in (out["f"]["launches"], out["g"]["launches"],
                     out["g"]["prefill_launches"]):
        for key, n in by_shape.items():
            launches[key] = launches.get(key, 0) + n
    names = {ENC_ATTN[0]: "flash_attention_h80_short",
             ENC_ATTN[1]: "flash_attention_h80_long",
             CROSS_ATTN[0]: "flash_attention_cross_long",
             CROSS_ATTN[1]: "flash_attention_cross_short"}
    rows = []
    for shape, name in names.items():
        b, n, nkv, s, h, sk = shape
        sk = s if sk is None else sk
        q, k, v = map(model_layout, attn_inputs(b, n, nkv, s, h, seed=3,
                                                sk=sk))
        moved = 4 * (2 * q.numel() + k.numel() + v.numel())
        flops = attn_cost(b, n, s, h, sk, False)
        iters, warm = (50, 5) if sk > 1024 else (200, 20)

        def kern():
            return ops.flash_attention_cuda(q, k, v, False)

        def plain():
            return ref.attention_gqa(q, k, v, causal=False)

        def library():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        ms = time_ms(kern, iters, warm)
        plain_ms = time_ms(plain, iters, warm)
        lib_ms = time_ms(library, iters, warm)
        b_ms, b_by = bound(moved, flops)
        dev = device_ms(kern)
        n_launch = launches.get((b, n, s, h, sk), 0)
        log(f"  {name} ({b}, {n}, {s}, {h}) kv {nkv} over {sk} keys, full, "
            f"model layout: kernel {ms:.5f} plain {plain_ms:.5f} library "
            f"{lib_ms:.5f} bound {b_ms:.6f} ({b_by}: {moved / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP); device only: kernel {fmt(dev)} plain "
            f"{fmt(device_ms(plain))} library {fmt(device_ms(library))}; "
            "share of the bound, device only: "
            + ("not measured" if dev is None else f"{b_ms / dev:.3f}")
            + f"; launches x (device - bound) "
            f"{above_bound(n_launch, dev, b_ms)}")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "kernel.py:76",
                     "launches": n_launch,
                     "max_abs_err": errs[shape], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    return rows


# ------------------------------------ phase 6, the model axis (ROADMAP A11.7)
# (h)-(j): the trainer path's families on the (1, 2) mesh, two ranks of the
# card over gloo (NCCL refuses two ranks on one device), one world of
# --mesh-child ranks; each held to the unsharded run of the same weights
# (drawn from a CUDA generator seeded 0) and batch, run in this process
# first. (h) hubert-xlarge whole: one AdamW step, then one under
# bf16_psum; (i) llama-3.2-vision-90b at full widths: (g)'s one group's
# train_loss forward and backward at (g)'s batch (both ranks fit on the
# card together at 8 x 128), and (g)'s two groups' prefill and decode;
# (j) xlstm-350m, recurrentgemma-2b and granite-moe-1b-a400m (no expert
# dropping, as (b)) whole, prefill and decode at (b)'s sizes
AXIS_DECODE_ARCHS = ("xlstm-350m", "recurrentgemma-2b", TRAIN_ARCH)
AXIS_DECODE_ATOL = 1e-3
# xlstm-350m whole (12 groups): float32 through the groups' gating moves
# its logits past AXIS_DECODE_ATOL however the sums are ordered. Measured
# by run_ssm_witness (H100 80GB HBM3, 700 W): the unsharded weights
# decoded on the host's CPU part from the card's run by 1.906e-2 (1.030e-3
# relative), the (1, 2) mesh by 1.469e-2 (6.195e-4), and both gaps grow
# alike with depth (3.1e-5 / 3.6e-5 at 1 group). Its decode is held to
# the reference's decode tolerance (DECODE_ATOL), to twice the CPU run's
# relative gap, to equal new tokens up to AXIS_DECODE_PREFIX_SSM (the
# mesh's 15th flips, a near-tie) and to the replay's greedy choices
# wherever the unsharded margin clears twice the gap.
AXIS_DECODE_REL_SSM = 2e-3
AXIS_DECODE_PREFIX_SSM = 12
# B6 at the (1, 2) mesh's local heads: (b, n, nkv, s, h, keys, causal) and
# the key of its launches (B, N, Sq, h, Sk)
LOCAL_ATTN = {
    "flash_attention_h80_local": (TRAIN_BATCH, 8, 8, TRAIN_SEQ, 80, None,
                                  False),
    "flash_attention_vlm_self_local": (TRAIN_BATCH, 32, 4, TRAIN_SEQ, 128,
                                       None, True),
    "flash_attention_cross_local": (TRAIN_BATCH, 32, 4, TRAIN_SEQ, 128,
                                    VISION_KEYS, False),
    "flash_attention_cross_prefill_local": (DECODE_BATCH, 32, 4,
                                            DECODE_PROMPT, 128, VISION_KEYS,
                                            False)}


def local_key(shape):
    b, n, _, s, h, sk, _ = shape
    return (b, n, s, h, s if sk is None else sk)


def check_local_head_kernels():
    """Phase 3: B6 at the (1, 2) mesh's local heads (``LOCAL_ATTN``)
    against its plain version. Returns the max abs errors by name."""
    return {name: check_flash(b, n, nkv, s, h, causal=causal, sk=sk)
            for name, (b, n, nkv, s, h, sk, causal) in LOCAL_ATTN.items()}


class Collectives:
    """Counts a mesh's ``all_reduce`` and ``gather`` calls and the bytes
    each hands its backend, while in effect."""

    def __init__(self, mesh):
        self.mesh, self.calls, self.bytes = mesh, {}, {}

    def __enter__(self):
        for name in ("all_reduce", "gather"):
            orig = getattr(self.mesh, name)

            def counted(t, *a, _orig=orig, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                self.bytes[_name] = (self.bytes.get(_name, 0)
                                     + t.numel() * t.element_size())
                return _orig(t, *a, **kw)
            setattr(self.mesh, name, counted)
        return self

    def __exit__(self, *exc):
        for name in ("all_reduce", "gather"):
            delattr(self.mesh, name)


def draw_model(cfg, mesh=None):
    """``cfg``'s weights as every run here draws them (a CUDA generator
    seeded 0) on the card, or with ``mesh`` this rank's slices of them
    (``Transformer.shard``): the ranks draw in turn, so the card holds one
    whole model at a time beside the other ranks' slices (the vlm's two
    groups: 42.7 GB whole beside 21.3)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.transformer import Transformer

    def draw():
        return Transformer(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
    if mesh is None:
        return draw()
    model = None
    for r in range(mesh.size):
        if mesh.rank == r:
            model = draw().shard(mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    return model


def whole_norms(model, tensors):
    """Each tensor's norm as a whole leaf (float64): a split leaf's squared
    norm summed over the model axis."""
    import torch
    sq = torch.stack([t.detach().double().square().sum() for t in tensors])
    split = torch.tensor([model._splits.get(id(p)) is not None
                          for p in model.parameters()], device=sq.device)
    if model.mesh is not None:
        from repro_torch.fed.mesh import model_axis_name
        sq = torch.where(split, model.mesh.all_reduce(
            torch.where(split, sq, 0.0), model_axis_name(model.mesh)), sq)
    return [float(v) for v in sq.sqrt()]


def hubert_steps(model):
    """(h)'s three AdamW steps on ``model`` (under the installed model
    axis, if any): the first step's loss, gradient norms (whole), B6's
    launches by shape and the collectives; the second step's seconds;
    the third step's loss, under bf16_psum."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, apply_updates
    from repro_torch.optim.schedules import linear_warmup_cosine
    cfg = model.cfg
    params = list(model.parameters())
    opt = adamw(linear_warmup_cosine(TRAIN_LR, 10, TRAIN_STEPS))
    opt_state = opt.init(params)
    next_batch = train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     device="cuda")
    batch = next_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = model.mesh
    coll = Collectives(mesh) if mesh is not None else None
    t = time.perf_counter()
    with attn_by_shape(fa_ops) as by_shape, \
            (coll if coll is not None else contextlib.nullcontext()):
        loss, _ = T.train_loss(model, batch)
        grads = torch.autograd.grad(loss, params)
        upd, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, upd)
        loss = float(loss.detach())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    norms = whole_norms(model, grads)
    del grads, upd
    step = train.make_train_step(model, opt)
    batch = next_batch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    opt_state, _ = step(opt_state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    L.set_attention_options(bf16_psum=True)
    try:
        _, loss2 = step(opt_state, next_batch())
    finally:
        L.set_attention_options()
    return {"loss": loss, "first_s": first_s, "step_s": step_s,
            "peak": peak, "norms": norms,
            "launches": {str(k): v for k, v in by_shape.by_key.items()},
            "collectives": None if coll is None else
            {"calls": coll.calls, "bytes": coll.bytes},
            "bf16_loss": float(loss2)}


def vlm_grad_pass(model):
    """(i)'s train_loss forward and backward at (g)'s batch: loss, norms
    (whole), peak and B6's launches by shape of the first pass, the
    seconds of a second."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    batch = train.make_batch_fn(model.cfg, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")()
    params = list(model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with attn_by_shape(fa_ops) as by_shape:
        loss, _ = T.train_loss(model, batch)
        grads = torch.autograd.grad(loss, params)
    out = {"loss": float(loss.detach()),
           "peak": torch.cuda.max_memory_allocated(),
           "launches": {str(k): v for k, v in by_shape.by_key.items()},
           "norms": whole_norms(model, grads)}
    del loss, grads
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, _ = T.train_loss(model, batch)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t
    return out


def decode_inputs(cfg, vision=False, device="cuda"):
    """(b)'s and (g)'s prompt (and vision embeddings) from numpy's seed 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT)), device=device)
    if not vision:
        return prompt, None
    return prompt, torch.as_tensor(rng.standard_normal(
        (DECODE_BATCH, VISION_KEYS, cfg.d_model)).astype(np.float32),
        device=device)


def decode_run(model):
    """A warm-up (a prefill and one decode step), then the timed
    prefill-then-decode at (b)'s sizes (the vlm's through
    ``init_cache(vision=, params=)``, as (g)): (tokens, prefill logits,
    the replay's logits, seconds, B6's launches by shape), on the
    model's device."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import decode_demo
    from repro_torch.models import transformer as T
    cfg = model.cfg
    device = next(model.parameters()).device
    prompt, vision = decode_inputs(cfg, cfg.family == "vlm", device)

    def run(n_new, replay=DECODE_PROMPT):
        if vision is None and replay == DECODE_PROMPT:
            return decode_demo.prefill_then_decode(
                model, prompt, DECODE_CACHE, n_new, return_logits=True)
        prefill = model(prompt, vision=vision)
        cache = T.init_cache(cfg, DECODE_BATCH, DECODE_CACHE, torch.float32,
                             device=device, vision=vision, params=model)
        logits = []
        for t in range(replay):
            lg, cache = T.decode_step(model, prompt[:, t:t + 1], cache, t)
            logits.append(lg[:, 0])
        toks = []
        tok = torch.argmax(lg[:, -1:], dim=-1)
        for i in range(n_new):
            toks.append(tok)
            lg, cache = T.decode_step(model, tok, cache, replay + i)
            tok = torch.argmax(lg[:, -1:], dim=-1)
        return torch.cat(toks, dim=1), prefill, torch.stack(logits, dim=1)
    with torch.no_grad():
        run(1, replay=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with attn_by_shape(fa_ops) as by_shape:
            toks, prefill, replay = run(DECODE_NEW)
        toks = toks.cpu()
        secs = time.perf_counter() - t
    return (toks, prefill.cpu(), replay.cpu(), secs,
            {str(k): v for k, v in by_shape.by_key.items()})


def decode_gap(got, want):
    """Two ``decode_run`` results against each other: whether the tokens
    are equal, the new tokens equal from the first on (the least over the
    rows), the largest abs gap of the prefill's and the replay's logits,
    their relative Frobenius gap, and whether the replay's greedy choices
    agree wherever ``want``'s top-2 margin exceeds twice the abs gap (and
    at how many of its steps)."""
    import torch
    gaps = [a - b for a, b in zip(got[1:3], want[1:3])]
    gap = max(float(g.abs().max()) for g in gaps)
    top2 = want[2].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * gap
    return {"tokens_equal": bool(torch.equal(got[0], want[0])),
            "prefix": int((got[0] == want[0]).int().cumprod(dim=1)
                          .sum(dim=1).min()),
            "gap": gap,
            "rel": max(float(g.norm() / w.norm())
                       for g, w in zip(gaps, want[1:3])),
            "clear_agree": bool((got[2].argmax(-1) == want[2].argmax(-1))
                                [clear].all()),
            "clear": int(clear.sum()), "steps": int(clear.numel())}


def axis_cfg(what):
    """The model-axis runs' configs: (h) hubert whole, (i) one or two vlm
    groups, (j) a decode arch whole (granite-moe without expert
    dropping)."""
    import dataclasses
    from repro_torch.common.types import MoEConfig
    from repro_torch.configs import get_arch
    if what == "h":
        return get_arch(ENC_ARCH)
    if what in ("i_grad", "i_decode"):
        whole = get_arch(VLM_ARCH)
        groups = VLM_GRAD_GROUPS if what == "i_grad" else VLM_DECODE_GROUPS
        return dataclasses.replace(
            whole, num_layers=groups * whole.cross_attn_every)
    if "@" in what:
        # the xLSTM witness: xlstm-350m cut to this many groups
        arch, groups = what.split("@")
        return dataclasses.replace(get_arch(arch), num_layers=2 * int(groups))
    cfg = get_arch(what)
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        cfg = dataclasses.replace(cfg, moe=MoEConfig(e, cfg.moe.top_k,
                                                     float(e)))
    return cfg


def axis_child(run):
    """A ``--mesh-child`` rank's model-axis run (``run["what"]``: "h",
    "i_grad", "i_decode", a (j) arch or a witness's cut one) on the (1, 2)
    mesh of the world,
    held to the unsharded results in ``run["want"]`` (a file) where they
    are tensors."""
    import gc
    import torch
    from repro_torch.fed import mesh as fed_mesh
    from repro_torch.models import sharding
    mesh = fed_mesh.build_mesh((1, 2), ("data", "model"), device="cuda")
    what = run["what"]
    cfg = axis_cfg(what)
    model = draw_model(cfg, mesh)
    if cfg.family == "vlm":
        set_gates(model)
    out = {"state_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}
    with sharding.model_parallel(mesh):
        if what == "h":
            out.update(hubert_steps(model))
        elif what == "i_grad":
            out.update(vlm_grad_pass(model))
        else:
            torch.cuda.reset_peak_memory_stats()
            got = decode_run(model)
            out.update(decode_gap(got, torch.load(run["want"])), s=got[3],
                       launches=got[4], tokens=got[0][0, :8].tolist(),
                       peak=torch.cuda.max_memory_allocated())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_model_axis_path(smi, families):
    """(h), (i) and (j) (above): the unsharded runs here, then one world of
    two ranks over gloo, every run held to its unsharded one, every
    rank's results equal. Returns B6's launches by shape over the ranks
    and the runs."""
    import gc
    import tempfile
    import torch
    from repro_torch.models import sharding
    t0 = time.perf_counter()
    log(f"[6] the model axis (ROADMAP A11.7): the (1, 2) mesh on two ranks "
        f"of the card over gloo, {smi}")
    want = {}
    model = draw_model(axis_cfg("h"))
    want["h"] = hubert_steps(model)
    want["h"]["state_bytes"] = sum(p.numel() * p.element_size()
                                   for p in model.parameters())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    g = families["g"]
    want["i_grad"] = {"loss": g["grad_loss"], "norms": g["grad_norms"],
                      "s": g["grad_s"], "peak": g["grad_peak"]}
    with tempfile.TemporaryDirectory() as tmp:
        files = {"i_decode": os.path.join(tmp, "i_decode.pt")}
        toks, prefill, replay = g["decoded"]
        torch.save((toks, prefill, replay), files["i_decode"])
        want["i_decode"] = {"s": g["dec_s"]}
        for arch in AXIS_DECODE_ARCHS:
            model = draw_model(axis_cfg(arch))
            torch.cuda.reset_peak_memory_stats()
            with sharding.model_parallel(None):
                got = decode_run(model)
            files[arch] = os.path.join(tmp, f"{arch}.pt")
            torch.save(got[:3], files[arch])
            want[arch] = {"s": got[3],
                          "peak": torch.cuda.max_memory_allocated()}
            del model, got
            gc.collect()
            torch.cuda.empty_cache()
        runs = [dict(kind="axis", what=w, want=files.get(w))
                for w in ("h", "i_grad", "i_decode") + AXIS_DECODE_ARCHS]
        ranks = mesh_world(2, "gloo", runs, tmp, timeout=900)
    launches = {}
    for rank in ranks:
        for res in rank:
            for key, n in res.get("launches", {}).items():
                launches[key] = launches.get(key, 0) + n
    # (h)
    h = [r[0] for r in ranks]
    for r in h:
        gap = abs(r["loss"] - want["h"]["loss"]) / abs(want["h"]["loss"])
        n_gap = max(abs(a - b) / max(b, 1e-30)
                    for a, b in zip(r["norms"], want["h"]["norms"]))
        b_gap = abs(r["bf16_loss"] - want["h"]["bf16_loss"]) / abs(
            want["h"]["bf16_loss"])
        if not gap <= 1e-3 or not n_gap <= 1e-3 or not b_gap <= 1e-2:
            raise AssertionError(f"(h) loss gap {gap}, norm gap {n_gap}, "
                                 f"bf16_psum loss gap {b_gap}")
    key = str(local_key(LOCAL_ATTN["flash_attention_h80_local"]))
    for r in h:
        if r["launches"] != {key: axis_cfg("h").num_layers}:
            raise AssertionError(f"(h) B6 launches {r['launches']}, not "
                                 f"48 at {key}")
    log(f"  (h) {ENC_ARCH} whole, one AdamW step of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} frames on (1, 2) ({smi}): loss {h[0]['loss']:.6f} "
        f"(unsharded {want['h']['loss']:.6f}, relative gap "
        f"{abs(h[0]['loss'] - want['h']['loss']) / want['h']['loss']:.3e}, "
        f"rtol 1e-3), every gradient leaf's norm within "
        f"{max(abs(a - b) / max(b, 1e-30) for a, b in zip(h[0]['norms'], want['h']['norms'])):.3e}"
        f" (rtol 1e-3); the first step {h[0]['first_s']:.3f} / "
        f"{h[1]['first_s']:.3f} s a rank (unsharded "
        f"{want['h']['first_s']:.3f}), the second "
        f"{h[0]['step_s']:.3f} / {h[1]['step_s']:.3f} s (unsharded "
        f"{want['h']['step_s']:.3f}); card peak "
        + " / ".join(f"{r['peak'] / 2**30:.3f}" for r in h)
        + f" GiB (unsharded {want['h']['peak'] / 2**30:.3f}); state "
        + " / ".join(str(r["state_bytes"]) for r in h)
        + f" B (unsharded {want['h']['state_bytes']}); collectives a step "
        f"{json.dumps(h[0]['collectives'])}; then under bf16_psum loss "
        f"{h[0]['bf16_loss']:.6f} (unsharded {want['h']['bf16_loss']:.6f}, "
        f"rtol 1e-2); B6 a rank {h[0]['launches']}")
    check_dryrun_collectives([r["collectives"] for r in h], smi)
    # (i)
    ig = [r[1] for r in ranks]
    for r in ig:
        gap = abs(r["loss"] - want["i_grad"]["loss"]) / abs(
            want["i_grad"]["loss"])
        n_gap = max(abs(a - b) / max(b, 1e-30)
                    for a, b in zip(r["norms"], want["i_grad"]["norms"]))
        if not gap <= 1e-3 or not n_gap <= 1e-3:
            raise AssertionError(f"(i) loss gap {gap}, norm gap {n_gap}")
    per = axis_cfg("i_grad").cross_attn_every
    wants = {str(local_key(LOCAL_ATTN["flash_attention_vlm_self_local"])):
             VLM_GRAD_GROUPS * (per - 1),
             str(local_key(LOCAL_ATTN["flash_attention_cross_local"])):
             VLM_GRAD_GROUPS}
    if any(r["launches"] != wants for r in ig):
        raise AssertionError(f"(i) B6 launches {ig[0]['launches']}, not "
                             f"{wants}")
    self_key = (DECODE_BATCH, 32, DECODE_PROMPT, 128, DECODE_PROMPT)
    wants = {str(self_key): VLM_DECODE_GROUPS * (per - 1), str(local_key(
        LOCAL_ATTN["flash_attention_cross_prefill_local"])):
        VLM_DECODE_GROUPS}
    if any(r[2]["launches"] != wants for r in ranks):
        raise AssertionError(f"(i) prefill's B6 launches "
                             f"{ranks[0][2]['launches']}, not {wants}")
    log(f"  (i) {VLM_ARCH}, {VLM_GRAD_GROUPS} group at full widths, "
        f"train_loss forward and backward, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens with {VISION_KEYS} vision keys, on (1, 2) ({smi}): loss "
        f"{ig[0]['loss']:.6f} (unsharded {want['i_grad']['loss']:.6f}), "
        f"every gradient leaf's norm within "
        f"{max(abs(a - b) / max(b, 1e-30) for a, b in zip(ig[0]['norms'], want['i_grad']['norms'])):.3e}"
        f" (rtol 1e-3); a second pass {ig[0]['s']:.3f} / {ig[1]['s']:.3f} "
        f"s a rank (unsharded, (g)'s first {want['i_grad']['s']:.3f}); "
        f"card peak "
        + " / ".join(f"{r['peak'] / 2**30:.3f}" for r in ig)
        + f" GiB (unsharded {want['i_grad']['peak'] / 2**30:.3f}); B6 a "
        f"rank {ig[0]['launches']}")
    # (i) decode and (j)
    for j, what in enumerate(("i_decode",) + AXIS_DECODE_ARCHS):
        got = [r[2 + j] for r in ranks]
        ssm = what != "i_decode" and axis_cfg(what).family == "ssm"
        tol = DECODE_ATOL if what == "i_decode" or ssm else AXIS_DECODE_ATOL
        for r in got:
            # xLSTM: AXIS_DECODE_REL_SSM above
            held = r["gap"] <= tol and (
                r["rel"] <= AXIS_DECODE_REL_SSM and r["clear_agree"]
                and r["prefix"] >= AXIS_DECODE_PREFIX_SSM
                if ssm else r["tokens_equal"])
            if not held:
                raise AssertionError(f"{what} on (1, 2): {r}")
        if got[0]["tokens"] != got[1]["tokens"]:
            raise AssertionError(f"{what}: the ranks' tokens differ")
        name = VLM_ARCH + f", {VLM_DECODE_GROUPS} groups" \
            if what == "i_decode" else what
        rate = DECODE_BATCH * DECODE_NEW
        log(f"  ({'i' if what == 'i_decode' else 'j'}) {name} prefill and "
            f"decode, batch {DECODE_BATCH}, prompt {DECODE_PROMPT}, "
            f"{DECODE_NEW} new tokens on (1, 2) ({smi}): tokens equal the "
            f"unsharded run's: {got[0]['tokens_equal']} (the first "
            f"{got[0]['prefix']} of each row), prefill and replay logits "
            f"within {max(r['gap'] for r in got):.3e} "
            + f"(atol {tol:g}"
            + (f", relative {max(r['rel'] for r in got):.3e} of rtol "
               f"{AXIS_DECODE_REL_SSM:g}, equal tokens held to the first "
               f"{AXIS_DECODE_PREFIX_SSM}; the replay's greedy choices agree "
               f"at the {got[0]['clear']} of {got[0]['steps']} steps whose "
               f"unsharded margin clears twice the gap" if ssm else "")
            + "); "
            f"{rate / got[0]['s']:.1f} new tokens/s (unsharded "
            f"{rate / want[what]['s']:.1f}); state "
            + " / ".join(str(r["state_bytes"]) for r in got)
            + " B a rank; decode's card peak "
            + " / ".join(f"{r['peak'] / 2**30:.3f}" for r in got)
            + " GiB a rank"
            + (f" (unsharded {want[what]['peak'] / 2**30:.3f})"
               if "peak" in want[what] else "")
            + f"; B6 a rank {got[0]['launches']}")
    log(f"  the model axis took {time.perf_counter() - t0:.1f} s")
    return launches


# The xLSTM decode's witness (chip_smoke.py --ssm-witness): xlstm-350m's
# widths at 1, 3, 6 and 12 groups (12: the whole model), prefill and
# decode at (b)'s sizes, from the same weights and prompt. The (1, 2)
# mesh's gap to the unsharded run on the card, beside the gap of the same
# unsharded weights decoded on the host's CPU (the same algorithm, its
# float32 sums in another order) to the card's.
SSM_WITNESS_GROUPS = (1, 3, 6, 12)


def run_ssm_witness(smi):
    """The witness above; logs each depth's two gaps (``decode_gap``)."""
    import gc
    import tempfile
    import torch
    from repro_torch.models import sharding
    log(f"the xLSTM decode's witness: xlstm-350m's widths at "
        f"{SSM_WITNESS_GROUPS} groups, batch {DECODE_BATCH}, prompt "
        f"{DECODE_PROMPT}, {DECODE_NEW} new tokens ({smi})")
    cpu = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for g in SSM_WITNESS_GROUPS:
            what = f"xlstm-350m@{g}"
            model = draw_model(axis_cfg(what))
            with sharding.model_parallel(None):
                card = decode_run(model)
                cpu[g] = decode_gap(decode_run(model.to("cpu")), card)
            files[what] = os.path.join(tmp, f"{g}.pt")
            torch.save(card[:3], files[what])
            del model, card
            gc.collect()
            torch.cuda.empty_cache()
        ranks = mesh_world(2, "gloo", [dict(kind="axis", what=w, want=f)
                                       for w, f in files.items()], tmp,
                           timeout=600)
    for i, g in enumerate(SSM_WITNESS_GROUPS):
        if ranks[0][i]["tokens"] != ranks[1][i]["tokens"]:
            raise AssertionError(f"{g} groups: the ranks' tokens differ")
        for name, r in (("(1, 2) mesh", ranks[0][i]), ("CPU", cpu[g])):
            log(f"  {g} groups, {name} against the card's unsharded run: "
                f"logits within {r['gap']:.4e} (relative {r['rel']:.4e}), "
                f"new tokens equal from the first on: {r['prefix']} of "
                f"{DECODE_NEW} (least over the rows), the replay's choices "
                f"agree where the margin clears twice the gap: "
                f"{r['clear_agree']} ({r['clear']} of {r['steps']})")
        log("  " + json.dumps({"groups": g, "mesh": ranks[0][i],
                               "cpu": cpu[g]}))


def measure_local_heads(launches, errs):
    """Phase 7's B6 rows at the (1, 2) mesh's local heads (``LOCAL_ATTN``),
    the model's layout: per call and device only, the plain version and
    scaled_dot_product_attention (timed only); launches over the ranks of
    (h) and (i)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    rows = []
    for name, shape in LOCAL_ATTN.items():
        b, n, nkv, s, h, sk, causal = shape
        sk = s if sk is None else sk
        q, k, v = map(model_layout, attn_inputs(b, n, nkv, s, h, seed=4,
                                                sk=sk))
        moved = 4 * (2 * q.numel() + k.numel() + v.numel())
        flops = attn_cost(b, n, s, h, sk, causal)
        ms, plain_ms, b_ms, b_by, dev = time_row(
            f"{name} ({b}, {n}, {s}, {h}) kv {nkv} over {sk} keys, causal="
            f"{causal}, model layout",
            lambda: ops.flash_attention_cuda(q, k, v, causal),
            lambda: ref.attention_gqa(q, k, v, causal=causal), moved, flops)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        lib_ms = time_ms(library)
        n_launch = launches.get(str(local_key(shape)), 0)
        log(f"    library (scaled_dot_product_attention) {lib_ms:.5f}, "
            f"device only {fmt(device_ms(library))}; {flops / 1e9:.3f} "
            f"GFLOP, {moved / 1e6:.1f} MB; share of the bound, device only: "
            + ("not measured" if dev is None else f"{b_ms / dev:.3f}")
            + f"; launches x (device - bound) "
            f"{above_bound(n_launch, dev, b_ms)}")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "kernel.py:76",
                     "launches": n_launch,
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    return rows


# ----------------------------------------------------------------- phase 7
def time_row(label, kern, plain, moved, ops, plain_iters=50):
    """Time a kernel and its plain version (per call, and device only, the
    plain version over ``plain_iters`` calls) and log them beside the
    bound; returns (ms, plain ms, bound ms, bound_by, the kernel's
    device-only ms or None)."""
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    b_ms, b_by = bound(moved, ops)
    dev = device_ms(kern)
    log(f"  {label}: kernel {ms:.5f} plain {plain_ms:.5f} bound {b_ms:.6f} "
        f"({b_by}); device only: kernel {fmt(dev)} plain "
        f"{fmt(device_ms(plain, plain_iters))}")
    return ms, plain_ms, b_ms, b_by, dev


def above_bound(launches, dev, b_ms) -> str:
    """launches x (device - bound): the device time a row's launches on
    its path spend above the bound, in ms."""
    return ("not measured" if dev is None
            else f"{launches} x ({dev:.5f} - {b_ms:.6f}) = "
                 f"{launches * (dev - b_ms):.4f} ms")


def kl_library_loss(s, t, w, T):
    """One PyTorch call for the per-sample KL (``F.kl_div`` on two
    log-softmaxes), then the weighted mean: the library route (timed
    only; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.distill_kl import ref
    kl = F.kl_div(F.log_softmax(s / T, -1), F.log_softmax(t / T, -1),
                  reduction="none", log_target=True).sum(-1) * (T * T)
    return ref.weighted_mean(kl, w)


def measure_kl_loss(counts, kl_err):
    """The fused loss alone at its shapes (masked weights), beside its
    plain version and the library route (loss and the student's gradient
    each); then one distill step's loss plus gradient at the main shape by
    four routes in turns, beside an empty kernel's launch and the autograd
    engine's floor (the gradient of a one-op graph). Returns the JSON row
    of the main shape."""
    import torch
    from repro_torch.core import distill
    from repro_torch.kernels.distill_kl import ops, ref
    T = TEMPERATURE
    row = None
    for n, k in ((64, 10), (64, 32), (256, 32), (4096, 1000)):
        s, t, _ = kl_inputs(n, k, seed=1)
        w = kl_weights(n, "masked", seed=1)
        s_ = s.clone().requires_grad_(True)
        # read s, t and w once; write kl, the loss and ds. Per element:
        # s/T and t/T at each of three passes, two maxes, four exps, and
        # the subtractions, sums and products of the lse, KL and gradient
        moved = 4 * (3 * n * k + 2 * n + 1)
        flops = 28 * n * k + 4 * n
        ms, plain_ms, b_ms, b_by, _ = time_row(
            f"kd_kl_loss n={n} K={k} (loss, kl and ds)",
            lambda: ops.kd_kl_loss_cuda(s, t, w, T),
            lambda: torch.autograd.grad(ref.kd_kl_loss(s_, t, T, w), s_),
            moved, flops)

        def library():
            return torch.autograd.grad(kl_library_loss(s_, t, w, T), s_)
        lib_ms = time_ms(library)
        log(f"    library (F.kl_div, weighted mean, autograd) {lib_ms:.5f}, "
            f"device only {fmt(device_ms(library))}; bound from "
            f"{moved / 1e6:.4f} MB")
        if (n, k) == MAIN_KL:
            row = {"name": "kd_kl_loss", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/kd_kl.cu",
                   "replaces": "src/repro/kernels/distill_kl/kernel.py:50",
                   "launches": counts["kd_kl_loss"],
                   "max_abs_err": kl_err[MAIN_KL + ("masked",)], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
    # one distill step at the main shape: the loss as the client computes
    # it and the student's gradient, by each route, in turns
    s, t, _ = kl_inputs(*MAIN_KL, seed=2)
    w = kl_weights(MAIN_KL[0], "masked", seed=2)
    s_ = s.clone().requires_grad_(True)
    routes = {
        "fused": lambda: distill.kd_kl_loss(s_, t, T, w, backend="cuda"),
        "per-sample kernels": lambda: ref.weighted_mean(
            ops.kd_kl_per_sample(s_, t, T), w),
        "plain": lambda: distill.kd_kl_loss(s_, t, T, w, backend="torch"),
        "library": lambda: kl_library_loss(s_, t, w, T),
        # the autograd engine's own floor: a one-op graph on the student
        "autograd floor (sum)": lambda: torch.sum(s_),
    }
    steps = {name: (lambda f=f: torch.autograd.grad(f(), s_))
             for name, f in routes.items()}

    def noop():
        ops.noop_cuda(s.device)
    times = {name: [] for name in ("empty kernel", *steps)}
    order = list(steps)
    for turn in (order, order[::-1]):
        times["empty kernel"].append((time_ms(noop), device_ms(noop)))
        for name in turn:
            times[name].append((time_ms(steps[name]),
                                device_ms(steps[name])))
    log(f"  one distill step's loss + gradient at {MAIN_KL}, masked "
        "weights, two turns (forward order, then reversed; ms per call / "
        "device only):")
    for name, pairs in times.items():
        log(f"    {name}: " + "; ".join(f"{a:.5f} / {fmt(b)}"
                                         for a, b in pairs))
    return row


def dist_cost(t, d, k):
    """B2's bytes (x, the centroids and the threshold read once; f32
    distances and a one-byte mask written) and ops (the matmul form, the
    min, sqrt and compare)."""
    return (4 * (t * d + k * d + 1) + 5 * t,
            2 * t * k * d + 2 * t * d + 2 * k * d + 4 * t * k + 2 * t)


# B2's timed shapes -> their main-path class (dist_class): the feature,
# image and lm_tokens paths' reports and calibrations; the shapes at 10
# centroids (iid) have none
DIST_CLASSES = {(512, 50, 1): ("report", 50, 1),
                (512, 50, 3): ("report", 50, 3),
                (6000, 50, 1): ("calibration", 50, 1),
                (6000, 50, 3): ("calibration", 50, 3),
                (256, 16, 1): ("report", 16, 1),
                (600, 16, 1): ("calibration", 16, 1),
                (512, 784, 1): ("report", 784, 1),
                (512, 784, 3): ("report", 784, 3),
                (6000, 784, 1): ("calibration", 784, 1),
                (6000, 784, 3): ("calibration", 784, 3),
                (512, 3072, 1): ("report", 3072, 1),
                (5000, 3072, 1): ("calibration", 3072, 1)}


def dist_threshold(t, d, k):
    """The threshold a shape's class passes: a calibration the infinite
    float, a report (and a wide shape) a device scalar."""
    import torch
    cls = DIST_CLASSES.get((t, d, k))
    if cls is not None and cls[0] == "calibration":
        return float("inf")
    return torch.full((1,), 3.0, device="cuda")


def empty_kernel_ms():
    """An empty kernel's launch, per call and device only (the floor a
    latency-bound kernel is held to)."""
    import torch
    from repro_torch.kernels.distill_kl import ops

    def noop():
        ops.noop_cuda(torch.device("cuda", torch.cuda.current_device()))
    return time_ms(noop), device_ms(noop)


def measure_min_dist(counts, dist_err, by_class):
    """B2 at each class of the main path and at the wide shapes, with the
    threshold its class passes: per call and device only, its plain
    version, the bound, the share of the bound, the device time over an
    empty kernel's, and the main path's launches of the class times
    (device - bound)."""
    from repro_torch.kernels.kmeans_dist import ops, ref
    row = None
    gap_ms = 0.0
    empty_ms, empty_dev = empty_kernel_ms()
    log(f"  empty kernel: {empty_ms:.5f} per call, device only "
        f"{fmt(empty_dev)}")
    for t, d, k in DIST_SHAPES:
        x, cents = (v[0] for v in lloyd_inputs(t, d, k, seed=1))
        thr = dist_threshold(t, d, k)
        moved, flops = dist_cost(t, d, k)
        ms, plain_ms, b_ms, b_by, dev = time_row(
            f"min_dist_and_mask t={t} d={d} k={k} (threshold "
            f"{'float' if isinstance(thr, float) else 'on the device'})",
            lambda: ops.min_dist_and_mask_cuda(x, cents, thr),
            lambda: ref.min_dist_and_mask(x, cents, thr), moved, flops)
        cls = DIST_CLASSES.get((t, d, k))
        launches = by_class.get(cls, 0)
        if dev is not None:
            gap = launches * (dev - b_ms)
            gap_ms += gap
            over = ("" if empty_dev is None
                    else f", device - empty kernel {dev - empty_dev:.5f}")
            log(f"    share of the bound {b_ms / dev:.4f}{over}; main-path "
                f"launches of class {cls}: {launches}, x (device - bound) "
                f"{gap:.4f} ms")
        if (t, d, k) == MAIN_DIST:
            log("    per call: " + per_call_readings(
                lambda: ops.min_dist_and_mask_cuda(x, cents, thr)))
            row = {"name": "min_dist_and_mask", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/kmeans_dist.cu",
                   "replaces": "src/repro/kernels/kmeans_dist/kernel.py:48",
                   "launches": counts["min_dist_and_mask"],
                   "max_abs_err": dist_err[MAIN_DIST], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
    log(f"  min_dist_and_mask: launches x (device - bound) over its classes "
        f"{gap_ms:.4f} ms (launches by class {by_class})")
    return row


def rbf_cost(n, m, d):
    """B5's bytes (a and b read once, the Gram matrix written) and ops
    (the cross term's multiply-adds, both squared norms, and 5 per output:
    combine, clamp, scale, exp)."""
    return (4 * (n * d + m * d + n * m),
            2 * n * m * d + 2 * (n + m) * d + 5 * n * m)


def lloyd_cost(n, d, k):
    """B1's bytes (x and the centroids read once; assignments, min d², sums
    and counts written) and ops (the matmul-form distances, the argmin, the
    sums)."""
    return (4 * (n * d + k * d) + 4 * (2 * n + k * d + k),
            2 * n * k * d + 3 * n * d + 2 * k * d + 3 * n * k)


def attn_cost(b, n, s, h, sk, causal):
    """B6's ops at one launch: per unmasked (query, key) pair 2h for q·k,
    2h for p·v and ~5 for scale, mask, max, exp and sum. (Its bytes: q, k
    and v read once, kv heads unexpanded, and o written.)"""
    pairs = s * (s + 1) // 2 if causal else s * sk
    return b * n * pairs * (4 * h + 5)


def kl_loss_cost(n, k):
    """The fused loss's bytes (s and t read once, ds written; w read, kl
    written; the loss) and ops (~28 an element: two log-softmaxes, the KL
    term and ds)."""
    return 4 * (3 * n * k + 2 * n + 1), 28 * n * k + 4 * n


def measure_rbf(counts, rbf_err, by_shape):
    """B5 at each of its shapes: per call and device only, its plain
    version, the bound, the share of the bound, and the main path's
    launches of that shape class times (device - bound)."""
    from repro_torch.kernels.kulsif_rbf import ops, ref
    row = None
    gap_ms = 0.0
    for n, m, d in RBF_SHAPES + RBF_IMAGE_SHAPES:
        a, b = rbf_inputs(n, m, d, seed=1)
        moved, flops = rbf_cost(n, m, d)
        ms, plain_ms, b_ms, b_by, dev = time_row(
            f"rbf_matrix n={n} m={m} d={d}",
            lambda: ops.rbf_matrix_cuda(a, b, SIGMA),
            lambda: ref.rbf_matrix(a, b, SIGMA), moved, flops)
        launches = by_shape.get(rbf_class(n, m, d), 0)
        if dev is not None:
            gap = launches * (dev - b_ms)
            gap_ms += gap
            log(f"    share of the bound {b_ms / dev:.3f}; main-path "
                f"launches of class {rbf_class(n, m, d)}: {launches}, "
                f"x (device - bound) {gap:.4f} ms")
        if (n, m, d) == MAIN_RBF:
            row = {"name": "rbf_matrix", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/rbf_matrix.cu",
                   "replaces": "src/repro/kernels/kulsif_rbf/kernel.py:32",
                   "launches": counts["rbf_matrix"],
                   "max_abs_err": rbf_err[MAIN_RBF], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
    log(f"  rbf_matrix: launches x (device - bound) over its shape classes "
        f"{gap_ms:.4f} ms (launches by class {by_shape})")
    return row


def measure_lloyd(counts, lloyd_err, by_dk):
    """B1 at each centroid count, C = 1, n = 6000, d = 50 (a strong
    client's private set), and on its wide route at the image path's
    shapes: as ``measure_rbf``, by (route, k) on the narrow route (the
    main path's launches at d <= 64) and by (d, k) on the wide one (two
    launches a call)."""
    from repro_torch.kernels.kmeans_dist import ops, ref
    n, d = MAIN_LLOYD["n"], MAIN_LLOYD["d"]
    by_k = {k: v for (route, k), v in lloyd_by_route(by_dk).items()
            if route == "narrow"}
    row = None
    gap_ms = 0.0
    for k in LLOYD_KS:
        x, cents = lloyd_inputs(n, d, k, seed=1)
        moved, flops = lloyd_cost(n, d, k)
        ms, plain_ms, b_ms, b_by, dev = time_row(
            f"lloyd_step C=1 n={n} d={d} k={k}",
            lambda: ops.lloyd_step_cuda(x, cents),
            lambda: ref.lloyd_step(x, cents), moved, flops)
        if dev is not None:
            gap = by_k.get(k, 0) * (dev - b_ms)
            gap_ms += gap
            log(f"    share of the bound {b_ms / dev:.4f}; main-path "
                f"launches at k={k}: {by_k.get(k, 0)}, x (device - bound) "
                f"{gap:.4f} ms")
        if k == 1:   # the strong scenario's shape heads the JSON line
            row = {"name": "lloyd_step", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/lloyd_step.cu",
                   "replaces": "src/repro/kernels/kmeans_dist/kernel.py:113",
                   "launches": counts["lloyd_step"],
                   "max_abs_err": lloyd_err[1], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
    log(f"  lloyd_step: launches x (device - bound) over the timed k "
        f"{gap_ms:.4f} ms (narrow launches by k {by_k})")
    gap_ms = 0.0
    for n, d, k in LLOYD_WIDE:   # two launches a call
        x, cents = lloyd_inputs(n, d, k, seed=1)
        _, _, b_ms, _, dev = time_row(
            f"lloyd_step C=1 n={n} d={d} k={k} (wide route)",
            lambda: ops.lloyd_step_cuda(x, cents),
            lambda: ref.lloyd_step(x, cents), *lloyd_cost(n, d, k))
        calls = by_dk.get((d, k), 0) // ops.lloyd_launches(d)
        if dev is not None:
            gap = calls * (dev - b_ms)
            gap_ms += gap
            log(f"    share of the bound {b_ms / dev:.4f}; main-path calls "
                f"at (d, k) = ({d}, {k}): {calls} ({2 * calls} launches), "
                f"x (device - bound) {gap:.4f} ms")
    log(f"  lloyd_step wide route: calls x (device - bound) over the timed "
        f"shapes {gap_ms:.4f} ms")
    return row


def measure_cohort(counts, lloyd_c, cohort_err):
    """Phase 7 for the batched routes at the cohort's shapes: each per
    call and device only, beside C launches of its 2-D route (one a
    client, the loop engine's), its plain version over clients and, for
    the fused loss, the library route; the bound of the whole launch.
    Returns their JSON rows."""
    import torch
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.kernels.distill_kl import ref as kl_ref
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kmeans_dist import ref as kd_ref
    from repro_torch.kernels.kulsif_rbf import ops as rbf_ops
    from repro_torch.kernels.kulsif_rbf import ref as rbf_ref
    log("  the cohort engine's routes, one launch for C clients, beside C "
        "launches of the 2-D route")
    rows = {}

    def beside(label, per_client):
        ms, dev = time_ms(per_client), device_ms(per_client)
        log(f"    {label}: the 2-D route C times {ms:.5f}, device only "
            f"{fmt(dev)}")

    for c, n, d, k in ((34, 600, 50, 10), (10, 6000, 50, 1),
                       (10, 6000, 50, 3)):
        x, cents = lloyd_inputs(n, d, k, seed=1, c=c)
        xs = [own(x[i:i + 1]) for i in range(c)]
        cs = [own(cents[i:i + 1]) for i in range(c)]
        moved, flops = lloyd_cost(n, d, k)
        ms, plain_ms, b_ms, b_by, _ = time_row(
            f"lloyd_step C={c} n={n} d={d} k={k} (one launch)",
            lambda: kd_ops.lloyd_step_cuda(x, cents),
            lambda: kd_ref.lloyd_step(x, cents), c * moved, c * flops)
        beside(f"lloyd_step C={c}", lambda: [kd_ops.lloyd_step_cuda(a, b)
                                              for a, b in zip(xs, cs)])
        rows.setdefault("lloyd_step_clients", {
            "name": "lloyd_step_clients", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lloyd_step.cu",
            "replaces": "src/repro/kernels/kmeans_dist/kernel.py:113",
            "launches": lloyd_c, "max_abs_err": cohort_err["lloyd"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    for c, t, d, k, shared in ((10, 512, 50, 1, True), (10, 512, 50, 3, True),
                               (34, 512, 50, 10, True),
                               (10, 6000, 50, 1, False),
                               (34, 600, 50, 10, False)):
        x, cents, thr = min_dist_clients_inputs(c, t, d, k, shared, seed=1)
        moved, flops = dist_cost(t, d, k)
        moved = c * moved - (c - 1) * 4 * t * d if shared else c * moved
        kind = "report" if shared else "calibration"
        ms, plain_ms, b_ms, b_by, _ = time_row(
            f"min_dist_and_mask clients C={c} t={t} d={d} k={k} ({kind})",
            lambda: kd_ops.min_dist_and_mask(x, cents, thr),
            lambda: kd_ref.min_dist_and_mask(x, cents, thr), moved,
            c * flops)
        parts = [(own(x) if shared else own(x[i]), own(cents[i]),
                  own(thr[i:i + 1])) for i in range(c)]
        beside(f"min_dist_and_mask C={c} ({kind})",
               lambda: [kd_ops.min_dist_and_mask_cuda(*p) for p in parts])
        rows.setdefault("min_dist_and_mask_clients", {
            "name": "min_dist_and_mask_clients", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kmeans_dist.cu",
            "replaces": "src/repro/kernels/kmeans_dist/kernel.py:48",
            "launches": counts["min_dist_and_mask_clients"],
            "max_abs_err": max(cohort_err["dist"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    for n, c, m, d in ((512, 10, 6000, 50), (512, 10, 256, 50),
                       (512, 100, 600, 50)):
        a, b0 = rbf_inputs(n, c * m, d, seed=1)
        b = b0.reshape(c, m, d)
        ms, plain_ms, b_ms, b_by, _ = time_row(
            f"rbf_matrix clients n={n} C={c} m={m} d={d}",
            lambda: rbf_ops.rbf_matrix(a, b, SIGMA),
            lambda: rbf_ref.rbf_matrix(a, b, SIGMA), *rbf_cost(n, c * m, d))
        bs = [own(b[i]) for i in range(c)]
        beside(f"rbf_matrix C={c}",
               lambda: [rbf_ops.rbf_matrix_cuda(a, v, SIGMA) for v in bs])
        rows.setdefault("rbf_matrix_clients", {
            "name": "rbf_matrix_clients", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rbf_matrix.cu",
            "replaces": "src/repro/kernels/kulsif_rbf/kernel.py:32",
            "launches": counts["rbf_matrix_clients"],
            "max_abs_err": max(cohort_err["rbf"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    T = TEMPERATURE
    for c, n, k in ((10, 64, 10), (34, 64, 10)):
        g = torch.Generator().manual_seed(c)
        s = (torch.randn((c, n, k), generator=g) * 3).cuda()
        t = (torch.randn((c, n, k), generator=g) * 3).cuda()
        w = kl_clients_weights(c, n, seed=1)
        s_ = s.clone().requires_grad_(True)
        moved = 4 * c * (3 * n * k + 2 * n + 1)
        ms, plain_ms, b_ms, b_by, _ = time_row(
            f"kd_kl_loss clients C={c} n={n} K={k} (loss, kl and ds)",
            lambda: kl_ops.kd_kl_loss_clients_cuda(s, t, w, T),
            lambda: torch.autograd.grad(kl_ref.kd_kl_loss(s_, t, T, w).sum(),
                                        s_),
            moved, c * (28 * n * k + 4 * n))

        def library():
            kl = torch.nn.functional.kl_div(
                torch.log_softmax(s_ / T, -1), torch.log_softmax(t / T, -1),
                reduction="none", log_target=True).sum(-1) * (T * T)
            return torch.autograd.grad(kl_ref.weighted_mean(kl, w).sum(), s_)
        lib_ms = time_ms(library)
        log(f"    library (F.kl_div over clients, weighted means, autograd) "
            f"{lib_ms:.5f}, device only {fmt(device_ms(library))}")
        parts = [(own(s[i]), own(t[i]), own(w[i])) for i in range(c)]
        beside(f"kd_kl_loss C={c}",
               lambda: [kl_ops.kd_kl_loss_cuda(a, b, v, T)
                        for a, b, v in parts])
        rows.setdefault("kd_kl_loss_clients", {
            "name": "kd_kl_loss_clients", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kd_kl.cu",
            "replaces": "src/repro/kernels/distill_kl/kernel.py:50",
            "launches": counts["kd_kl_loss_clients"],
            "max_abs_err": max(cohort_err["kl"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    rows["flash_attention_clients"] = measure_flash_clients(
        counts, cohort_err["flash"])
    return list(rows.values())


def measure_flash_clients(counts, err):
    """B6 over a cohort at the full-width cohort run's training step (10
    clients' batches of 64 folded into 640, the model's layout): the
    kernel per call and device only, the call through the ``vmap`` rule
    (the cohort's route), the plain version, PyTorch's
    scaled_dot_product_attention on the folded batch (timed only; the
    port never calls it) and 10 launches of one client's batch."""
    import torch.nn.functional as F
    from torch.func import vmap
    from repro_torch.kernels.flash_attention import ops, ref
    c, b, n, nkv, s, h = COHORT_ATTN
    q5, k5, v5, _ = attn_clients_inputs(c, b, n, nkv, s, h, seed=1)
    views = [t.transpose(2, 3) for t in (q5, k5, v5)]
    q, k, v = (t.reshape(c * b, *t.shape[2:]) for t in views)
    moved = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = attn_cost(c * b, n, s, h, s, True)
    ms, plain_ms, b_ms, b_by, dev = time_row(
        f"flash_attention clients C={c} ({b}, {n}, {s}, {h}) kv {nkv}, "
        f"folded batch {c * b}, model layout (one launch)",
        lambda: ops.flash_attention_cuda(q, k, v, True),
        lambda: ref.attention_gqa(q, k, v, causal=True), moved, flops)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    lib_ms = time_ms(library)
    rule = vmap(lambda a, bb, cc: ops.FlashAttentionFunction.apply(
        a, bb, cc, True))
    log(f"    library (scaled_dot_product_attention, folded batch) "
        f"{lib_ms:.5f}, device only {fmt(device_ms(library))}; through the "
        f"vmap rule {time_ms(lambda: rule(*views)):.5f}, device only "
        f"{fmt(device_ms(lambda: rule(*views)))}; share of the byte bound, "
        f"device only: "
        + ("not measured" if dev is None else f"{b_ms / dev:.3f}"))
    parts = [[own(t[i]).transpose(1, 2) for t in (q5, k5, v5)]
             for i in range(c)]

    def per_client():
        return [ops.flash_attention_cuda(*p, True) for p in parts]
    log(f"    flash_attention C={c}: the 2-D route C times "
        f"{time_ms(per_client):.5f}, device only "
        f"{fmt(device_ms(per_client))}")
    return {"name": "flash_attention_clients", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
            "launches": counts["flash_attention"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def measure_fleet(at_wave, fleet_err):
    """Phase 7 at the fleet's launch shapes (1024 clients a launch): B1,
    B2's report and the fused loss, each per call and device only beside
    its plain version and its bound (the fused loss also beside the
    library route). Returns their JSON rows, ``launches`` the fleet path's
    at this shape."""
    import torch
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.kernels.distill_kl import ref as kl_ref
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kmeans_dist import ref as kd_ref
    c, T = FLEET_C, TEMPERATURE
    log(f"  the fleet's launch shapes, {c} clients a launch")
    rows = []
    x, cents = lloyd_inputs(*FLEET_LLOYD, seed=1, c=c)
    moved, flops = lloyd_cost(*FLEET_LLOYD)
    ms, plain_ms, b_ms, b_by, _ = time_row(
        f"lloyd_step C={c} n, d, k={FLEET_LLOYD}",
        lambda: kd_ops.lloyd_step_cuda(x, cents),
        lambda: kd_ref.lloyd_step(x, cents), c * moved, c * flops)
    rows.append({"name": f"lloyd_step_clients_c{c}", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/lloyd_step.cu",
                 "replaces": "src/repro/kernels/kmeans_dist/kernel.py:113",
                 "launches": at_wave["lloyd_step"],
                 "max_abs_err": fleet_err["lloyd"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None})
    t, d, k = FLEET_REPORT
    x, cents, thr = min_dist_clients_inputs(c, t, d, k, True, seed=1)
    moved, flops = dist_cost(t, d, k)
    ms, plain_ms, b_ms, b_by, _ = time_row(
        f"min_dist_and_mask clients C={c} t={t} d={d} k={k} (report)",
        lambda: kd_ops.min_dist_and_mask(x, cents, thr),
        lambda: kd_ref.min_dist_and_mask(x, cents, thr),
        c * moved - (c - 1) * 4 * t * d, c * flops)
    rows.append({"name": f"min_dist_and_mask_clients_c{c}", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/kmeans_dist.cu",
                 "replaces": "src/repro/kernels/kmeans_dist/kernel.py:48",
                 "launches": at_wave["min_dist_and_mask_clients"],
                 "max_abs_err": max(fleet_err["report"],
                                    fleet_err["calibration"]),
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None})
    n, kk = FLEET_KL
    g = torch.Generator().manual_seed(c)
    s = (torch.randn((c, n, kk), generator=g) * 3).cuda()
    tt = (torch.randn((c, n, kk), generator=g) * 3).cuda()
    w = kl_clients_weights(c, n, seed=1)
    s_ = s.clone().requires_grad_(True)
    ms, plain_ms, b_ms, b_by, _ = time_row(
        f"kd_kl_loss clients C={c} n={n} K={kk} (loss, kl and ds)",
        lambda: kl_ops.kd_kl_loss_clients_cuda(s, tt, w, T),
        lambda: torch.autograd.grad(kl_ref.kd_kl_loss(s_, tt, T, w).sum(),
                                    s_),
        4 * c * (3 * n * kk + 2 * n + 1), c * (28 * n * kk + 4 * n))

    def library():
        kl = torch.nn.functional.kl_div(
            torch.log_softmax(s_ / T, -1), torch.log_softmax(tt / T, -1),
            reduction="none", log_target=True).sum(-1) * (T * T)
        return torch.autograd.grad(kl_ref.weighted_mean(kl, w).sum(), s_)
    lib_ms = time_ms(library)
    log(f"    library (F.kl_div over clients, weighted means, autograd) "
        f"{lib_ms:.5f}, device only {fmt(device_ms(library))}")
    rows.append({"name": f"kd_kl_loss_clients_c{c}", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/kd_kl.cu",
                 "replaces": "src/repro/kernels/distill_kl/kernel.py:50",
                 "launches": at_wave["kd_kl_loss_clients"],
                 "max_abs_err": fleet_err["kl"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_ms})
    return rows


def time_kernels(label):
    """``--time-kernels``: B1 at each k and on its wide route, B2 at each of
    its shapes (a device threshold, which every tree's wrapper takes; at
    the main shape several per-call readings), B5 at each shape and an
    empty kernel, per call and device only, from the package under
    ``label``. Only another tree than this checkout's may refuse B1's
    wide route (an older one, without it)."""
    import torch
    from repro_torch.kernels.kmeans_dist import ops as kd
    from repro_torch.kernels.kulsif_rbf import ops as rbf
    empty_ms, empty_dev = empty_kernel_ms()
    log(f"  {label}: empty kernel, ms per call / device only: "
        f"{empty_ms:.5f} / {fmt(empty_dev)}")
    n, d = MAIN_LLOYD["n"], MAIN_LLOYD["d"]
    for n, dd, k in [(n, d, k) for k in LLOYD_KS] + list(LLOYD_WIDE):
        x, cents = lloyd_inputs(n, dd, k, seed=1)

        def kern():
            return kd.lloyd_step_cuda(x, cents)
        head = f"  {label}: lloyd_step C=1 n={n} d={dd} k={k}"
        try:
            kern()
        except ValueError as e:   # a tree without the wide route
            if Path(label) == SRC:
                raise
            log(f"{head}: refused ({e})")
            continue
        log(f"{head}, ms per call / device only: {time_ms(kern):.5f} / "
            f"{fmt(device_ms(kern))}; bound {bound(*lloyd_cost(n, dd, k))[0]:.6f}")
    thr = torch.full((1,), 3.0, device="cuda")
    for t, dd, k in DIST_SHAPES:
        x, cents = (v[0] for v in lloyd_inputs(t, dd, k, seed=1))

        def kern():
            return kd.min_dist_and_mask_cuda(x, cents, thr)
        log(f"  {label}: min_dist_and_mask t={t} d={dd} k={k}, ms per call "
            f"/ device only: {time_ms(kern):.5f} / {fmt(device_ms(kern))}; "
            f"bound {bound(*dist_cost(t, dd, k))[0]:.6f}")
        if (t, dd, k) == MAIN_DIST:
            log(f"  {label}: min_dist_and_mask t={t} d={dd} k={k}, per call: "
                + per_call_readings(kern))
    for n, m, dd in RBF_SHAPES + RBF_IMAGE_SHAPES:
        a, b = rbf_inputs(n, m, dd, seed=1)

        def kern():
            return rbf.rbf_matrix_cuda(a, b, SIGMA)
        log(f"  {label}: rbf_matrix n={n} m={m} d={dd}, ms per call / "
            f"device only: {time_ms(kern):.5f} / {fmt(device_ms(kern))}; "
            f"bound {bound(*rbf_cost(n, m, dd))[0]:.6f}")
    time_loss_and_attention(label)


# --time-kernels' rows of the fused loss and B6: the loss at the main
# path's (64, 10) and the FD trainers' wide rows (masked weights); B6's
# long route at the trainer, encoder, vlm and model-axis shapes, and its
# short route at the transformer path's and those families' shapes: (b,
# n, nkv, s, h, keys, causal), the model's layout
TIMED_KL = (MAIN_KL, (16, 49155), (16, 50304), (16, 256000))
TIMED_ATTN = (
    (8, 8, 8, 128, 80, 128, False),       # (h)'s hubert local heads
    (8, 16, 16, 128, 80, 128, False),     # (f)'s hubert step
    (8, 32, 4, 128, 128, 1601, False),    # (i)'s local cross block
    (8, 64, 8, 128, 128, 1601, False),    # (g)'s cross block
    (8, 16, 8, 128, 64, 128, True),       # (a)'s granite-moe step
    (8, 32, 4, 128, 128, 128, True),      # (i)'s local vlm self blocks
    (64, 32, 8, 16, 128, 16, True),       # short route: the main path's
    (256, 32, 8, 16, 128, 16, True),      # report and eval batches
    (512, 32, 8, 16, 128, 16, True),
    (256, 16, 4, 16, 128, 16, True),      # (c)'s mesh local heads
    (8, 16, 16, 16, 80, 16, False),       # hubert at S 16
    (4, 64, 8, 16, 128, 1601, False),     # (g)'s prefill cross
    (4, 32, 4, 16, 128, 1601, False))     # (i)'s prefill cross


def time_loss_and_attention(label):
    """The fused loss's and B6's rows of ``--time-kernels`` (``TIMED_KL``,
    ``TIMED_ATTN``): per call and device only beside the bound and its
    share; for this checkout's tree through ``time_row``, with the plain
    version and the library call (the same for any tree)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.kernels.distill_kl import ref as kl_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    T = TEMPERATURE
    # (text, kernel, plain, library, bytes, ops, device-only iterations of
    # the plain and library calls: ~1 ms of host work a loss call)
    rows = []
    for n, kk in TIMED_KL:
        st, tt, _ = kl_inputs(n, kk, seed=3)
        w = kl_weights(n, "masked", seed=3)
        s_ = st.clone().requires_grad_(True)
        rows.append((
            f"kd_kl_loss n={n} K={kk} masked",
            lambda st=st, tt=tt, w=w: kl_ops.kd_kl_loss_cuda(st, tt, w, T),
            lambda s_=s_, tt=tt, w=w: torch.autograd.grad(
                kl_ref.kd_kl_loss(s_, tt, T, w), s_),
            lambda s_=s_, tt=tt, w=w: torch.autograd.grad(
                kl_library_loss(s_, tt, w, T), s_),
            *kl_loss_cost(n, kk), 10))
    for b, n, nkv, s, h, sk, causal in TIMED_ATTN:
        q, k, v = map(model_layout, attn_inputs(b, n, nkv, s, h, seed=3,
                                                sk=sk))
        rows.append((
            f"flash_attention ({b}, {n}, {s}, {h}) kv {nkv} over {sk} keys, "
            f"causal={causal}, {'long' if s > 32 else 'short'} route, model "
            "layout",
            lambda q=q, k=k, v=v, c=causal: fa_ops.flash_attention_cuda(
                q, k, v, c),
            lambda q=q, k=k, v=v, c=causal: fa_ref.attention_gqa(
                q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(
                q, k, v, is_causal=c, enable_gqa=True),
            4 * (2 * q.numel() + k.numel() + v.numel()),
            attn_cost(b, n, s, h, sk, causal), 50))
    for text, kern, plain, library, moved, ops, iters in rows:
        if Path(label) == SRC:
            _, _, b_ms, _, dev = time_row(f"{label}: {text}", kern, plain,
                                          moved, ops, plain_iters=iters)
            log(f"    library device only {fmt(device_ms(library, iters))}")
        else:
            b_ms, b_by = bound(moved, ops)
            dev = device_ms(kern)
            log(f"  {label}: {text}: kernel {time_ms(kern, 50, 5):.5f} "
                f"bound {b_ms:.6f} ({b_by}); device only: kernel {fmt(dev)}")
        log("    share of the bound, device only: "
            + ("not measured" if dev is None else f"{b_ms / dev:.4f}"))


def measure_flash(counts, attn_err, by_batch):
    """B6 at the transformer path's shapes (a training step, a report's
    proxy batch, an eval batch), also on the model's layout, and on one
    long causal sequence, beside the plain version and PyTorch's
    scaled_dot_product_attention (timed only; the port never calls it).
    ``by_batch``: the main path's launches by query batch size, for the
    launches x (device time - bound) sum."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    row = None
    gap_ms = 0.0
    for b, n, nkv, s, h in PATH_ATTN + ((1, 32, 8, 4096, 128),):
        q, k, v = attn_inputs(b, n, nkv, s, h, seed=1)
        moved = 4 * (2 * q.numel() + k.numel() + v.numel())
        flops = attn_cost(b, n, s, h, s, True)
        iters, warm = (20, 3) if s > 1024 else (200, 20)

        def kern():
            return ops.flash_attention_cuda(q, k, v, True)

        def plain():
            return ref.attention_gqa(q, k, v, causal=True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        ms = time_ms(kern, iters, warm)
        plain_ms = time_ms(plain, iters, warm)
        lib_ms = time_ms(library, iters, warm)
        dev_ms = device_ms(kern)
        b_ms, b_by = bound(moved, flops)
        log(f"  flash_attention ({b}, {n}, {s}, {h}) kv {nkv} causal: "
            f"kernel {ms:.5f} plain {plain_ms:.5f} library {lib_ms:.5f} "
            f"bound {b_ms:.6f} ({b_by}: {moved / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP); device only: kernel {fmt(dev_ms)} "
            f"plain {fmt(device_ms(plain))} library "
            f"{fmt(device_ms(library))}")
        if s <= 32:
            views = [model_layout(t) for t in (q, k, v)]

            def kern_model():
                return ops.flash_attention_cuda(*views, True)
            model_ms = time_ms(kern_model, iters, warm)
            model_dev = device_ms(kern_model)
            share = ", ".join(f"{lay} {b_ms / d:.3f}" for lay, d in
                              (("(B, N, S, h)", dev_ms),
                               ("model", model_dev)) if d is not None)
            log(f"    model layout (views of (B, S, N, h)): kernel "
                f"{model_ms:.5f}, device only {fmt(model_dev)}; share of "
                f"the byte bound, device only: {share}")
            if b in by_batch and dev_ms is not None:
                gap = by_batch[b] * (max(dev_ms, model_dev or dev_ms) - b_ms)
                gap_ms += gap
                log(f"    {by_batch[b]} main-path launches at B = {b}: "
                    f"launches x (device - bound) {gap:.4f} ms")
        if (b, n, nkv, s, h) == MAIN_ATTN:
            row = {"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/"
                             "flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention/"
                               "kernel.py:76",
                   "launches": counts["flash_attention"],
                   "max_abs_err": attn_err[MAIN_ATTN], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
    log(f"  flash_attention: launches x (device - bound) over the timed "
        f"batch sizes {gap_ms:.4f} ms (main-path launches by batch size "
        f"{by_batch})")
    return row


def time_flash(label):
    """``--time-flash``: B6 at PATH_ATTN, per call and device only, on
    (B, N, S, h) tensors and on the model layout's views."""
    from repro_torch.kernels.flash_attention import ops
    for b, n, nkv, s, h in PATH_ATTN:
        q, k, v = attn_inputs(b, n, nkv, s, h, seed=1)
        b_ms, _ = bound(4 * (2 * q.numel() + k.numel() + v.numel()), 0)
        res = []
        for lay, args in (("(B, N, S, h)", (q, k, v)),
                          ("model", [model_layout(t) for t in (q, k, v)])):
            def kern(args=args):
                return ops.flash_attention_cuda(*args, True)
            res.append(f"{lay} {time_ms(kern):.5f} / {fmt(device_ms(kern))}")
        log(f"  {label}: flash_attention ({b}, {n}, {s}, {h}) kv {nkv} "
            "causal, ms per call / device only: " + "; ".join(res)
            + f"; bound {b_ms:.6f}")


def measure(counts, lloyd_err, kl_err, dist_err, rbf_err, attn_err,
            attn_batches, by_k, by_shape, by_class):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.kernels.distill_kl import ref as kl_ref
    log("[7] timings (CUDA events, ms per call)")
    rows = [measure_lloyd(counts, lloyd_err, by_k)]
    rows.append(measure_min_dist(counts, dist_err, by_class))
    for n, k in ((64, 10), (512, 10), (4096, 1000)):
        s, t, g = kl_inputs(n, k, seed=1)
        T = TEMPERATURE
        s_ = s.clone().requires_grad_(True)
        t_ = t.clone().requires_grad_(True)

        def plain_ds():
            torch.autograd.grad(kl_ref.kd_kl_per_sample(s_, t, T), s_, g)

        def plain_dt():
            torch.autograd.grad(kl_ref.kd_kl_per_sample(s, t_, T), t_, g)

        def library():
            return F.kl_div(F.log_softmax(s / T, -1), F.log_softmax(t / T, -1),
                            reduction="none", log_target=True).sum(-1) * (T * T)

        timed = {
            "kd_kl_fwd": (lambda: kl_ops.kd_kl_fwd_cuda(s, t, T),
                          lambda: kl_ref.kd_kl_per_sample(s, t, T),
                          library, 4 * (2 * n * k + n), 20 * n * k, "fwd",
                          "src/repro/kernels/distill_kl/kernel.py:50"),
            "kd_kl_bwd_ds": (lambda: kl_ops.kd_kl_bwd_ds_cuda(s, t, g, T),
                             plain_ds, None, 4 * (3 * n * k + n), 16 * n * k,
                             "ds", "src/repro/kernels/distill_kl/"
                                   "kernel.py:114"),
            "kd_kl_bwd_dt": (lambda: kl_ops.kd_kl_bwd_dt_cuda(s, t, g, T),
                             plain_dt, None, 4 * (3 * n * k + n), 26 * n * k,
                             "dt", "src/repro/kernels/distill_kl/"
                                   "kernel.py:114"),
        }
        for name, (kern, plain, lib, moved, ops, part, rep) in timed.items():
            ms = time_ms(kern)
            plain_ms = time_ms(plain)
            lib_ms = time_ms(lib) if lib is not None else None
            b_ms, b_by = bound(moved, ops)
            log(f"  {name} n={n} K={k}: kernel {ms:.5f} plain {plain_ms:.5f}"
                + (f" library {lib_ms:.5f}" if lib_ms is not None else "")
                + f" bound {b_ms:.6f} ({b_by}); device only: kernel "
                f"{fmt(device_ms(kern))} plain {fmt(device_ms(plain))}"
                + (f" library {fmt(device_ms(lib))}" if lib is not None
                   else ""))
            if (n, k) == MAIN_KL:
                rows.append({"name": name, "route": "cuda",
                             "source": "src/repro_torch/kernels/csrc/"
                                       "kd_kl.cu",
                             "replaces": rep, "launches": counts[name],
                             "max_abs_err": kl_err[MAIN_KL][part],
                             "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": lib_ms})
    rows.append(measure_kl_loss(counts, kl_err))
    rows.append(measure_rbf(counts, rbf_err, by_shape))
    rows.append(measure_flash(counts, attn_err, attn_batches))
    return rows


def main(argv) -> int:
    if argv[:1] == ["--serve"]:
        return serve_child(argv[1:])
    if argv[:1] == ["--mesh-child"] and len(argv) == 3:
        return mesh_child(argv[1:])
    timers = {"--time-flash": time_flash, "--time-kernels": time_kernels}
    src, timer = SRC, timers.get(argv[0]) if argv else None
    mesh_only = argv == ["--mesh"]
    trainer_only = argv == ["--trainer"]
    witness_only = argv == ["--ssm-witness"]
    examples_only = argv == ["--examples"]
    if timer and argv[1:2] == ["--src"] and len(argv) == 3:
        src = Path(argv[2]).resolve()
    elif argv and not (timer and len(argv) == 1) and not mesh_only \
            and not trainer_only and not witness_only and not examples_only:
        print("usage: chip_smoke.py [--mesh | --trainer | --ssm-witness | "
              "--examples | --time-flash | --time-kernels [--src DIR]]",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    if timer:
        log(smi)
        timer(str(src))
        return 0
    log(f"[1] {smi}")
    log(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    from repro_torch.kernels import build
    secs = build.build_all()
    log(f"[2] kernel build: {secs:.1f} s for {', '.join(build.SOURCES)}")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"    {name}: {line.strip()}")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    log("    flash_attention short route: resident blocks an SM at h = "
        + ", ".join(f"{h}: {fa_ops.short_route_occupancy(h)}"
                    for h in fa_ops.HEAD_DIMS))
    from repro_torch.kernels.distill_kl import ops as kl_ops
    log("    kd_kl_loss wide-row route: (blocks a row, clusters resident "
        "at once) at K = "
        + ", ".join(f"{k}: {kl_ops.wide_route(k)}"
                    for k in (1025, 8193, 65537, 49155, 256000, 500000)))

    if witness_only:
        run_ssm_witness(smi)
        log(smi)
        return 0
    if examples_only:
        run_examples(smi)
        log(smi)
        return 0
    if mesh_only:
        row = measure_flash_local(*run_mesh_path(smi))
        log(smi)
        print(json.dumps({"kernels": [row]}))
        return 0
    if trainer_only:
        errs = check_trainer_kernels()
        family_errs = check_family_kernels()
        local_errs = check_local_head_kernels()
        rows = measure_trainer(run_trainer_path(smi), *errs)
        families = run_family_paths(smi)
        rows += measure_families(families, family_errs)
        rows += measure_local_heads(run_model_axis_path(smi, families),
                                    local_errs)
        log(smi)
        print(json.dumps({"kernels": rows}))
        return 0
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        log(f"  [{laps[-1] - laps[0]:.1f} s] {what} took "
            f"{laps[-1] - laps[-2]:.1f} s")
    (lloyd_err, kl_err, dist_err, rbf_err, attn_err,
     cohort_err) = check_kernels()
    family_errs = check_family_kernels()
    local_errs = check_local_head_kernels()
    lap("phase 3")
    check_kmeans_agreement()
    check_kmeans_batched()
    check_privacy()
    lap("phase 4")
    check_small_run()
    check_small_scheduler_runs()
    check_small_robust_runs()
    check_small_resume_runs()
    lap("phase 5")
    (counts, attn_batches, by_k, by_shape, by_class,
     loop_results) = run_main_path()
    lap("phase 6, the main path")
    cohort_counts, lloyd_c, _ = run_cohort_path(loop_results)
    lap("phase 6, the cohort path")
    run_scheduler_path()
    run_robust_path()
    lap("phase 6, the scheduler and robustness paths")
    _, at_fleet_wave = run_fleet_path()
    lap("phase 6, the fleet path")
    run_service_path()
    lap("phase 6, the service path")
    local_launches, local_err = run_mesh_path(smi)
    lap("phase 6, the mesh path")
    trainer_errs = check_trainer_kernels()
    trainer = run_trainer_path(smi)
    families = run_family_paths(smi)
    lap("phase 6, the trainer path")
    axis_launches = run_model_axis_path(smi, families)
    lap("phase 6, the model axis")
    run_examples(smi)
    lap("phase 6, the examples")
    rows = measure(counts, lloyd_err, kl_err, dist_err, rbf_err, attn_err,
                   attn_batches, by_k, by_shape, by_class)
    rows += measure_cohort(cohort_counts, lloyd_c, cohort_err)
    rows += measure_fleet(at_fleet_wave, cohort_err["fleet"])
    rows.append(measure_flash_local(local_launches, local_err))
    rows += measure_trainer(trainer, *trainer_errs)
    rows += measure_families(families, family_errs)
    rows += measure_local_heads(axis_launches, local_errs)
    lap("phase 7")

    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
