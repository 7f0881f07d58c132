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
     lane: its loss and gradient 0, its weights bitwise unchanged); and
     benchmarks/scale.py's fleet shapes, 1024 clients a launch: B1 at
     (16, 50, 10), B2's report at (64, 50, 10) and calibration at (16, 50,
     10), the fused loss at (16, 10), then a 1024-lane grid on every
     client-axis route (B1 and B2 wide, B5 over a stacked b) within CUDA's
     grid limits;
  4. k-means fits through the kernel on the card against fits through
     the plain version on the card and on the CPU, from the same seeds (an
     unclustered input and every client of the main path's strong and
     weak runs): n_iter, assignments, centroids, DRE thresholds, reported;
     the cohort's batched fit and calibration against each client's own
     fit on the card: n_iter, assignments, centroids, thresholds, bitwise
     (asserted);
  5. small fed_train runs (edgefd and selective-fd on features, edgefd on
     mnist_like and cifar_like images, cuDNN's TF32 turned on first to
     check that the entry point pins fp32) on the card against the same
     runs on the CPU (which takes the plain versions), and a small
     lm_tokens edgefd run (the reduced granite backbone) on the card
     against the CPU from the same initial weights; small cohort-engine
     runs card vs CPU (edgefd, selective-fd and fkd strong, the mixed zoo
     over 6 clients, and over 9 in waves of 2); partial-participation
     overlap runs on both engines (fraction 0.5, fixed phase costs) card
     vs CPU, participants, staleness, bytes and the simulated timeline
     equal; robustness runs on both engines (tests/test_faults.py's
     scenarios: each fault mode, trimmed_mean, median and krum_row under a
     colluding flip, 3 edge aggregators with a subset and with
     Selective-FD, quarantine) card vs CPU, scrubbed rows, quarantined
     clients, participants and bytes equal;
  6. the main path: fed_train, 10 clients with MNIST's split sizes
     (n_train 60000, n_test 10000), 3 rounds, proxy batch 512 — edgefd and
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
     n_train 6000, n_test 1000, 3 rounds, batch 64, proxy batch 256, with
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
     BENCH_scale.json's;
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
     shapes, beside C launches of its 2-D route; B1, B2's report and the
     fused loss at the fleet's shapes (1024 clients a launch).
The next-to-last line is the kernels JSON, the last line the ok JSON.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.

    python3 chip_smoke.py --time-flash [--src DIR]
    python3 chip_smoke.py --time-kernels [--src DIR]

time only B6 at the transformer path's shapes, per call and device only,
in both layouts, or only B1 (k = 1, 2, 3, 10, 64, and its wide route at
the image path's shapes), B2 (every main-path class and the image widths)
and B5 (its fit's and a report's shapes, private sizes even and odd, and
at the image widths), beside an empty kernel, from the package under DIR
(default: this checkout's src/); run one for two trees in turns to compare
them on one card.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
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
# the last part-full), a wide row, and one past 1024 classes (the row
# re-read from memory)
KL_LOSS_SHAPES = (MAIN_KL, (64, 32), (256, 32), (300, 10), (4096, 1000),
                  (5, 1500))
KL_WEIGHTS = ("masked", "none", "zero")
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
LM_ROUNDS = 3
LM_LR = 5e-4          # see run_lm_full_width
METHODS_WITHOUT_KERNELS = ("fedmd", "feded", "dsfl", "fkd", "pls",
                           "indlearn", "server_distill")
# the image path at the paper's split sizes: (dataset, method, scenario,
# n_train), 10 clients, n_test 10000, 3 rounds, proxy batch 512
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
        torch.testing.assert_close(g, want, rtol=KL_RTOL, atol=KL_ATOL)
        errs[name] = float((g - want).abs().max())
    log(f"  {label}: max|err| loss={errs['loss']:.3e} kl={errs['kl']:.3e} "
        f"ds={errs['ds']:.3e} (rtol {KL_RTOL:g}, atol {KL_ATOL:g}) "
        f"loss {float(got[0]):.6e}, deterministic=yes")
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


def attn_inputs(b, n, nkv, s, h, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g) for shape in
               ((b, n, s, h), (b, nkv, s, h), (b, nkv, s, h)))
    return q.cuda(), k.cuda(), v.cuda()


def model_layout(t):
    """A (B, N, S, h) view of a (B, S, N, h) copy of ``t``: what the model
    hands the kernel (``dispatch.flash_attention``)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def check_flash(b, n, nkv, s, h, causal=True, seed=0):
    """Flash-attention kernel vs plain version; also on strided (B, N, S,
    h) views of (B, S, N, h) tensors (the model's layout), which must give
    the same bits. Returns the max abs error."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = attn_inputs(b, n, nkv, s, h, seed)
    got = ops.flash_attention_cuda(q, k, v, causal)
    again = ops.flash_attention_cuda(q, k, v, causal)
    strided = ops.flash_attention_cuda(*map(model_layout, (q, k, v)), causal)
    want = ref.attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    label = f"flash_attention ({b}, {n}, {s}, {h}) kv {nkv} causal={causal}"
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs differ")
    if not torch.equal(got, strided):
        raise AssertionError(f"{label}: strided views give other bits")
    torch.testing.assert_close(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    err = float((got - want).abs().max())
    log(f"  {label}: max|err|={err:.3e} (rtol {ATTN_RTOL:g}, atol "
        f"{ATTN_ATOL:g}) deterministic=yes, strided views bitwise equal")
    return err


def check_flash_grads(b, n, nkv, s, h, seed=0):
    """The autograd function (kernel forward, recompute backward) against
    autograd of the plain version: one launch, gradients to q, k, v."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = attn_inputs(b, n, nkv, s, h, seed)
    g = attn_inputs(b, n, n, s, h, seed + 1)[0]
    kern = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.flash_attention_cuda.launches
    ops.flash_attention(*kern, causal=True).backward(g)
    if ops.flash_attention_cuda.launches - before != 1:
        raise AssertionError("the autograd function did not launch the "
                             "kernel exactly once")
    ref.attention_gqa(*plain, causal=True).backward(g)
    torch.cuda.synchronize()
    errs = []
    for name, a, w in zip("qkv", kern, plain):
        torch.testing.assert_close(a.grad, w.grad, rtol=1e-4, atol=1e-5)
        errs.append(f"d{name} {float((a.grad - w.grad).abs().max()):.3e}")
    log(f"  flash_attention grads ({b}, {n}, {s}, {h}) kv {nkv}: max|err| "
        + ", ".join(errs) + " (rtol 1e-4, atol 1e-5)")


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
        torch.testing.assert_close(u, v, rtol=KL_RTOL, atol=KL_ATOL)
        errs.append(float((u - v).abs().max()))
    log(f"  {label}: every client bitwise equal to its own 2-D launch, the "
        f"all-zero lane 0 with a zero gradient; plain version max|err| loss "
        f"{errs[0]:.3e} kl {errs[1]:.3e} ds {errs[2]:.3e} (rtol {KL_RTOL:g}, "
        f"atol {KL_ATOL:g}); deterministic=yes")
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
# the fused loss: 10 clients' and a 34-client cohort's distill step
COHORT_KL = ((10, 64, 10), (34, 64, 10), (1, 64, 10), (3, 300, 10))
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
    for n, k in KL_LOSS_SHAPES:
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
    init = [c.model.export_params() for c in cpu_exp[0]]
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


def run_lm_full_width():
    """lm_tokens edgefd strong at granite-8b's widths through
    ``simulator.run`` (``fed_train`` builds the reduced backbone; the
    width is the ``transformer_cfg`` keyword). The learning rate is 5e-4,
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
                    lr=LM_LR, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = simulator.run(cfg, "lm_tokens", n_train=6000, n_test=1000,
                        device="cuda", transformer_cfg=arch,
                        progress=lambda lg: print_round(lg, cfg.num_clients))
    peak = torch.cuda.max_memory_allocated()
    log(f"  lm_tokens edgefd strong at granite-8b widths: d_model "
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
    common = ["--clients", "10", "--rounds", "3", "--n-test", "10000",
              "--proxy-batch", "512", "--device", "cuda"]
    runs = [(f"{m} {sc}", lambda m=m, sc=sc: fed_train(
        ["--method", m, "--scenario", sc, "--n-train", "60000"] + common))
        for m, sc in mlp_runs]
    runs += [(f"{ds} {m} {sc}", lambda ds=ds, m=m, sc=sc, n=n: fed_train(
        ["--method", m, "--scenario", sc, "--dataset", ds, "--n-train", n]
        + common)) for ds, m, sc, n in IMAGE_RUNS]
    runs.append(("lm_tokens edgefd strong", run_lm_full_width))
    log("[6] main path: fed_train, 10 clients, n_train 60000, n_test 10000, "
        "3 rounds, proxy batch 512: "
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
    deterministic algorithms. Asserts that each cohort's
    Lloyd launches go one an iteration for the cohort (C > 1 in a uniform
    cohort), B2 one launch a cohort a report and a calibration, B5 one
    launch a Gram matrix a cohort a report, the fused loss one launch a
    cohort a distill step. Returns (the path's counts, the launches by
    client count C of B1, B2 and B5's batched routes)."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed.batching import steps_per_epoch
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kulsif_rbf import ops as rbf_ops
    cfg0 = FedConfig()
    common = ["--rounds", "3", "--n-test", "10000", "--proxy-batch", "512",
              "--device", "cuda"]
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
    # gradients in an order that changes from run to run, and over three
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
    by_run = {}
    for label, cohorts, drive in runs:
        for cc in (lloyd, dist, rbf):
            cc.by_key = {}
        with lloyd, dist, rbf:
            run_one(label, drive, wrappers, results, per_run, steps, attn,
                    kl_name="kd_kl_loss" if label.startswith("loop")
                    else "kd_kl_loss_clients")
        by_run[label] = (dict(lloyd.by_key), dict(dist.by_key),
                         dict(rbf.by_key))
        log(f"  {label}: Lloyd launches by C {by_run[label][0]}, B2 calls "
            f"by (class, C) {by_run[label][1]}, B5 calls by C "
            f"{by_run[label][2]}")
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
            want = (waves * 3 * cfg0.distill_epochs
                    * steps_per_epoch(512, cfg0.batch_size))
            if steps[label] != want:
                raise AssertionError(f"{label}: {steps[label]} distill "
                                     f"steps, not {want} ({waves} cohort "
                                     "waves a round)")
        l_by_c, d_by_c, r_by_c = by_run[label]
        reports = sum(v for (kind, _), v in d_by_c.items()
                      if kind == "report")
        if "selective-fd" in label:
            if r_by_c.get(10, 0) != 2 * 3:
                raise AssertionError(f"{label}: B5 over clients {r_by_c}, "
                                     "not two Gram matrices a report")
        elif "fkd" not in label and reports != 3 * cohorts:
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
                 "kd_kl_loss_clients", "rbf_matrix_clients"):
        if sum(per_run[r[0]][name] for r in runs) == 0:
            raise AssertionError(f"the cohort path never launched {name}")
    counts = {n: w.launches for n, w in wrappers.items()}
    for m, sc in COHORT_RUNS:
        compare_runs(f"cohort {m} {sc} against the loop engine",
                     results[f"cohort {m} {sc}"], loop_results[f"{m} {sc}"],
                     10000, names=("cohort", "loop"))
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


# phase 6's edge-fleet runs: BENCH_async's deployment at MNIST's split
# sizes (128 iid clients, 468-469 samples each), the mixed zoo over 30
# clients priced with hetero_zoo's costs, heavy traffic, and the class-wise
# and KuLSIF methods under round-robin participation. The heavy traffic is
# benchmarks/scale.py's traffic rows' (traffic_c1k, quick_traffic_c256:
# uniform fraction 0.5, decay 0.5, bursty arrivals over 60 s, churn and
# dropout 0.05, sync rounds, waves of a quarter of the fleet, 4 edge
# aggregators) on BENCH_async's 128 clients, held to a flat server's run
FLEET = dict(method="edgefd", scenario="iid", num_clients=128, rounds=10,
             proxy_batch=256, batch_size=32, lr=1e-2, seed=0,
             participation_fraction=0.5, participation_policy="uniform",
             staleness_decay=0.5, straggler_factor=4.0, max_inflight=2)
ZOO = dict(method="edgefd", scenario="iid", num_clients=30, rounds=10,
           proxy_batch=256, batch_size=32, lr=1e-2, seed=0, engine="cohort",
           zoo="mixed", round_mode="overlap", straggler_factor=1.0)
HEAVY = dict(method="edgefd", scenario="iid", num_clients=128, rounds=5,
             proxy_batch=256, batch_size=32, lr=1e-2, seed=0,
             engine="cohort", participation_fraction=0.5,
             participation_policy="uniform", staleness_decay=0.5,
             arrival_process="bursty", arrival_spread=60.0,
             churn_prob=0.05, dropout_prob=0.05, wave_size=32,
             round_mode="sync", num_edge_aggregators=4)
ROBIN = dict(scenario="strong", num_clients=10, rounds=3, proxy_batch=512,
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
# edgefd iid, 10 clients, 6 rounds, proxy batch 96, batch 32, lr 1e-2,
# mnist_feat with n_train 60000 and n_test 10000, cohort engine
ROBUST_ACC = dict(method="edgefd", scenario="iid", num_clients=10, rounds=6,
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


# ----------------------------------------------------------------- phase 7
def time_row(label, kern, plain, moved, ops):
    """Time a kernel and its plain version (per call, and device only) and
    log them beside the bound; returns (ms, plain ms, bound ms, bound_by,
    the kernel's device-only ms or None)."""
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    b_ms, b_by = bound(moved, ops)
    dev = device_ms(kern)
    log(f"  {label}: kernel {ms:.5f} plain {plain_ms:.5f} bound {b_ms:.6f} "
        f"({b_by}); device only: kernel {fmt(dev)} plain "
        f"{fmt(device_ms(plain))}")
    return ms, plain_ms, b_ms, b_by, dev


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
    return list(rows.values())


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
        # read q, k, v once (kv heads unexpanded), write o; per unmasked
        # (query, key) pair 2h ops for q·k, 2h for p·v and ~5 for scale,
        # mask, max, exp and sum
        moved = 4 * (2 * q.numel() + k.numel() + v.numel())
        pairs = s * (s + 1) // 2
        flops = b * n * pairs * (4 * h + 5)
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
    timers = {"--time-flash": time_flash, "--time-kernels": time_kernels}
    src, timer = SRC, timers.get(argv[0]) if argv else None
    if timer and argv[1:2] == ["--src"] and len(argv) == 3:
        src = Path(argv[2]).resolve()
    elif argv and not (timer and len(argv) == 1):
        print("usage: chip_smoke.py [--time-flash | --time-kernels "
              "[--src DIR]]", file=sys.stderr)
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

    (lloyd_err, kl_err, dist_err, rbf_err, attn_err,
     cohort_err) = check_kernels()
    check_kmeans_agreement()
    check_kmeans_batched()
    check_small_run()
    check_small_scheduler_runs()
    check_small_robust_runs()
    (counts, attn_batches, by_k, by_shape, by_class,
     loop_results) = run_main_path()
    cohort_counts, lloyd_c, _ = run_cohort_path(loop_results)
    run_scheduler_path()
    run_robust_path()
    _, at_fleet_wave = run_fleet_path()
    rows = measure(counts, lloyd_err, kl_err, dist_err, rbf_err, attn_err,
                   attn_batches, by_k, by_shape, by_class)
    rows += measure_cohort(cohort_counts, lloyd_c, cohort_err)
    rows += measure_fleet(at_fleet_wave, cohort_err["fleet"])

    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
