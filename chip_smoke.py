#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi), library versions;
  2. the build of every CUDA kernel from src/repro_torch/kernels/csrc
     (one nvcc per source, all started together);
  3. every kernel against its plain PyTorch version on the card at the
     main path's shapes, with the stated tolerances, and the Lloyd
     kernel's bitwise determinism across two runs;
  4. k-means fits through the kernel on the card against fits through
     the plain version on the card and on the CPU, from the same seeds (an
     unclustered input and every client of the main path's strong and
     weak runs): n_iter, assignments, centroids, DRE thresholds, reported;
  5. a small fed_train on the card against the same run on the CPU (which
     takes the plain versions);
  6. the main path: fed_train edgefd, strong and weak, 10 clients with
     MNIST's split sizes (n_train 60000, n_test 10000), 3 rounds, proxy
     batch 512, with each kernel's launch count (counts set to 0 just
     before and read just after);
  7. each kernel's time (CUDA events around many calls, the host's
     per-call work included), its plain version's time, a PyTorch library
     call's time where one call computes the same function, its bound
     from the shapes, and the device-only times of each with the host's
     per-call work taken out.
The next-to-last line is the kernels JSON, the last line the ok JSON.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

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
MAIN_LLOYD = dict(n=6000, d=50)      # one strong client's private set
MAIN_KL = (64, 10)                   # one distill step: batch x classes


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
def lloyd_inputs(n, d, k, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    # clustered, off-centre rows like a client's feature set; centroids
    # near data rows but never on one
    x = torch.randn((1, n, d), generator=g) + 3.0
    pick = torch.randint(n, (k,), generator=g)
    cents = x[:, pick] + 0.5 * torch.randn((1, k, d), generator=g)
    return x.cuda(), cents.cuda()


def check_lloyd(n, d, k, seed=0):
    """Kernel vs plain version; returns the max abs error of min_d2 and
    sums. Distances carry an error that scales with the terms the matmul
    form cancels (x2 + c2), sums one that scales with the summed
    magnitudes, so each tolerance is rtol·scale + atol."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.kmeans_dist import ops, ref
    x, cents = lloyd_inputs(n, d, k, seed)
    a_k, m_k, s_k, c_k = ops.lloyd_step_cuda(x, cents)
    a_r, m_r, s_r, c_r = ref.lloyd_step(x, cents)
    again = ops.lloyd_step_cuda(x, cents)
    torch.cuda.synchronize()
    for u, v in zip((a_k, m_k, s_k, c_k), again):
        if not torch.equal(u, v):
            raise AssertionError(f"lloyd_step n={n} k={k}: two runs differ")
    d2 = ref.pairwise_sq_dists(x, cents)[0]                  # (n, k)
    x2 = torch.sum(x[0] * x[0], -1)
    c2 = torch.sum(cents[0] * cents[0], -1)
    scale = x2 + c2[a_k[0].long()]
    chosen = torch.gather(d2, 1, a_k[0].long()[:, None])[:, 0]
    # an argmin may differ from the plain one only on a tie within error
    gap = chosen - m_r[0]
    if bool((gap > LLOYD_ATOL + LLOYD_RTOL * scale).any()):
        raise AssertionError(f"lloyd_step n={n} k={k}: assignment is not "
                             "an argmin within tolerance")
    m_err = (m_k - m_r).abs()[0]
    if bool((m_err > LLOYD_ATOL + LLOYD_RTOL * scale).any()):
        raise AssertionError(f"lloyd_step n={n} k={k}: min_d2 off by "
                             f"{float(m_err.max())}")
    oh = F.one_hot(a_k[0].long(), k).float()
    s_own = oh.T @ x[0]
    s_mag = oh.T @ x[0].abs()
    s_err = (s_k[0] - s_own).abs()
    if bool((s_err > LLOYD_ATOL + LLOYD_RTOL * s_mag).any()):
        raise AssertionError(f"lloyd_step n={n} k={k}: sums off by "
                             f"{float(s_err.max())}")
    if not torch.equal(c_k[0], oh.sum(0)):
        raise AssertionError(f"lloyd_step n={n} k={k}: counts differ")
    flips = int((a_k != a_r).sum())
    err = max(float(m_err.max()), float(s_err.max()))
    log(f"  lloyd_step C=1 n={n} d={d} k={k}: max|min_d2 err|="
        f"{float(m_err.max()):.3e} max|sums err|={float(s_err.max()):.3e} "
        f"(tol {LLOYD_ATOL:g} + {LLOYD_RTOL:g}*scale) argmin ties={flips} "
        "deterministic=yes")
    return err


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


def check_kernels():
    log("[3] kernels vs plain versions on the card")
    lloyd_err = {}
    for k in (1, 3, 10, 64):
        lloyd_err[k] = check_lloyd(MAIN_LLOYD["n"], MAIN_LLOYD["d"], k)
    check_lloyd(5999, MAIN_LLOYD["d"], 3)      # ragged n
    kl_err = {}
    for n, k in ((64, 10), (512, 10), (4096, 1000)):
        kl_err[(n, k)] = check_kl(n, k)
    return lloyd_err, kl_err


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


# --------------------------------------------------------------- phase 5/6
def fed_train(args):
    from repro_torch.launch import fed_train as ft
    return ft.main(args)


def check_small_run():
    """The port on the card (kernels) against the port on the CPU (plain
    versions), same seed, small size: float32 matmuls differ between the
    two devices, so losses hold to rtol 1e-3 and accuracies to a sample."""
    log("[5] small fed_train: card vs CPU")
    base = ["--method", "edgefd", "--scenario", "weak", "--clients", "4",
            "--rounds", "2", "--n-train", "800", "--n-test", "200"]
    gpu = fed_train(base + ["--device", "cuda"])
    cpu = fed_train(base + ["--device", "cpu"])
    for p, q in zip(gpu.rounds, cpu.rounds):
        for f in ("local_loss", "distill_loss"):
            a, b = getattr(p, f), getattr(q, f)
            if not abs(a - b) <= 1e-3 * abs(b):
                raise AssertionError(f"round {p.round} {f}: card {a} vs "
                                     f"CPU {b}")
        for a, b in zip(p.accs, q.accs):
            if abs(a - b) > 1.5 / 200:
                raise AssertionError(f"round {p.round} accs: card {p.accs}"
                                     f" vs CPU {q.accs}")
    log("  card and CPU agree")


def launch_counts():
    from repro_torch.kernels.distill_kl import ops as kl
    from repro_torch.kernels.kmeans_dist import ops as kd
    return {"lloyd_step": kd.lloyd_step_cuda,
            "kd_kl_fwd": kl.kd_kl_fwd_cuda,
            "kd_kl_bwd_ds": kl.kd_kl_bwd_ds_cuda,
            "kd_kl_bwd_dt": kl.kd_kl_bwd_dt_cuda}


def run_main_path():
    import torch
    log("[6] main path: fed_train edgefd, 10 clients, n_train 60000, "
        "n_test 10000, 3 rounds, proxy batch 512")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    results = {}
    for scenario in ("strong", "weak"):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fed_train(["--method", "edgefd", "--scenario", scenario,
                         "--clients", "10", "--rounds", "3",
                         "--n-train", "60000", "--n-test", "10000",
                         "--proxy-batch", "512", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: w.launches - before[n] for n, w in wrappers.items()}
        phases = {}
        for r in res.rounds:
            for ph, s in r.phase_s.items():
                phases[ph] = phases.get(ph, 0.0) + s
            vals = (r.mean_acc, r.local_loss, r.distill_loss)
            if not all(v == v and abs(v) < float("inf") for v in vals):
                raise AssertionError(f"{scenario} round {r.round}: "
                                     f"non-finite metrics {vals}")
        log(f"  {scenario}: final acc {res.final_acc:.4f}, wall "
            f"{wall:.3f} s (DRE fit + 3 rounds), phase seconds over 3 "
            "rounds " + " ".join(f"{k}={v:.3f}" for k, v in phases.items()))
        log(f"  {scenario}: launches {launches}")
        results[scenario] = res
    counts = {n: w.launches for n, w in wrappers.items()}
    for name in ("lloyd_step", "kd_kl_fwd", "kd_kl_bwd_ds"):
        if counts[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    log(f"  launches on the main path (strong + weak): {counts}; "
        "kd_kl_bwd_dt is dead there (the teacher is a constant)")
    final = results["strong"].final_acc
    if not final > 0.7:
        raise AssertionError(f"strong final mean accuracy {final} <= 0.7")
    return counts


# ----------------------------------------------------------------- phase 7
def measure(counts, lloyd_err, kl_err):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.kernels.distill_kl import ref as kl_ref
    from repro_torch.kernels.kmeans_dist import ops as kd_ops
    from repro_torch.kernels.kmeans_dist import ref as kd_ref
    log("[7] timings (CUDA events, ms per call)")
    rows = []
    n, d = MAIN_LLOYD["n"], MAIN_LLOYD["d"]
    for k in (1, 3, 10, 64):
        x, cents = lloyd_inputs(n, d, k, seed=1)
        kern = lambda: kd_ops.lloyd_step_cuda(x, cents)  # noqa: E731
        ms = time_ms(kern)
        plain = time_ms(lambda: kd_ref.lloyd_step(x, cents))
        moved = 4 * (n * d + k * d) + 4 * (2 * n + k * d + k)
        ops = 2 * n * k * d + 3 * n * d + 2 * k * d + 3 * n * k
        b_ms, b_by = bound(moved, ops)
        log(f"  lloyd_step C=1 n={n} d={d} k={k}: kernel {ms:.5f} plain "
            f"{plain:.5f} bound {b_ms:.6f} ({b_by}); device only: kernel "
            f"{fmt(device_ms(kern))} plain "
            f"{fmt(device_ms(lambda: kd_ref.lloyd_step(x, cents)))}")
        if k == 1:   # the strong scenario's shape heads the JSON line
            rows.append({"name": "lloyd_step", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "lloyd_step.cu",
                         "replaces": "src/repro/kernels/kmeans_dist/"
                                     "kernel.py:113",
                         "launches": counts["lloyd_step"],
                         "max_abs_err": lloyd_err[1], "ms": ms,
                         "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None})
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
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
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
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    lloyd_err, kl_err = check_kernels()
    check_kmeans_agreement()
    check_small_run()
    counts = run_main_path()
    rows = measure(counts, lloyd_err, kl_err)

    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
