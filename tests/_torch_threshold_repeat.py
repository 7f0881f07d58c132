"""The CPU half of the card test
``test_kmeans_dre_filter_on_the_card_reads_its_threshold_there``, run
many times to count how often its KMeans-DRE threshold differs (ROADMAP
C7).

    python tests/_torch_threshold_repeat.py
    python tests/_torch_threshold_repeat.py --child CARD THREADS
    python tests/_torch_threshold_repeat.py --count N JOBS

The first form needs a CUDA device: it runs the test's CPU half in 204
processes (100 one after another at the default thread count, 80 four at
a time over a sweep of thread counts, 24 two at a time after the card
half), then both halves 200 times in this process, logs every run's
record as a JSON line after "record ", and then each distinct CPU
threshold with its count and the runs' thread counts. The second form is
one such run (the card half first when CARD is 1; THREADS 0 keeps
torch's default), its record printed as JSON; with CARD 0 it runs on a
host without a card. The third form runs ``--child 0 0`` in N processes,
JOBS at a time, on a host with or without a card, and prints each
distinct CPU threshold with its count, then the count that differs from
the most common one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"


def log(msg: str) -> None:
    print(msg, flush=True)


def threshold_inputs():
    """The input of the card test
    ``test_kmeans_dre_filter_on_the_card_reads_its_threshold_there``:
    three separated blobs, 3000 x 50, seeds x[:3] + 1."""
    import torch
    g = torch.Generator().manual_seed(7)
    centers = torch.randn((3, 50), generator=g) * 4
    x = (centers[torch.arange(3000) % 3]
         + torch.randn((3000, 50), generator=g))
    return x, x[:3] + 1.0


def threshold_child(card: bool, threads: int) -> dict:
    """One run of the card test's two halves in this process: the card's
    fit first when ``card`` (its threshold read only after the CPU's fit,
    as the test reads it), then ``KMeansDRE(3).learn`` on the CPU. Beside
    the CPU threshold: float64 recomputations from the CPU fit's own
    centroids (the quantile by a sort, and the means of its assignment by
    ``index_add_``, which avoids the one-hot matmul), the calibration's
    steps once more with each one's error, the error of the calibration
    distances learn itself computed, and the host's thread and CPU
    facts."""
    import math
    import os

    import numpy as np
    import torch
    from repro_torch.core.dre import KMeansDRE
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.kmeans_dist import ref as kd_ref
    if threads:
        torch.set_num_threads(threads)
    x, init = threshold_inputs()
    gpu = (KMeansDRE(num_centroids=3).learn(x.cuda(), init=init.cuda())
           if card else None)
    # the CPU fit's calibration distances, as learn computes them
    orig, seen = dispatch.min_dist_and_mask, []

    def keep(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[0])
        return out
    dispatch.min_dist_and_mask = keep
    try:
        cpu = KMeansDRE(num_centroids=3).learn(x, init=init)
    finally:
        dispatch.min_dist_and_mask = orig
    c = cpu.centroids
    learn_err = (seen[0].double() - torch.cdist(
        x.double(), c.double()).amin(-1)).abs()
    # the calibration's steps again, one by one, from the same centroids:
    # the f32 cross term x @ c.T, the distances and torch.quantile, each
    # beside a float64 or numpy counterpart
    cross = x @ c.T
    d32 = kd_ref.min_dist_and_mask(x, c, math.inf)[0]
    t32 = float(torch.quantile(d32, cpu.calibration_q))
    t_np = float(np.quantile(d32.numpy(), cpu.calibration_q))
    cross_err = (cross.double() - x.double() @ c.double().T).abs()
    d_err = (d32.double() - torch.cdist(x.double(), c.double()).amin(-1)
             ).abs()
    x64, c64 = x.double(), c.double()
    d2 = torch.cdist(x64, c64) ** 2
    assign = torch.argmin(d2, -1)
    counts = torch.bincount(assign, minlength=3)
    means = torch.zeros_like(c64).index_add_(0, assign, x64) / counts[:, None]
    dist = torch.sqrt(torch.amin(d2, -1)).sort().values
    pos = 0.95 * (len(dist) - 1)
    lo = int(pos)
    q64 = float(dist[lo] + (pos - lo) * (dist[lo + 1] - dist[lo]))
    return {"cpu": float(cpu.threshold), "card": None if gpu is None
            else float(gpu.threshold), "q64_from_fit": q64,
            "again_torch_quantile": t32, "again_numpy_quantile": t_np,
            "learn_dist_err": float(learn_err.max()),
            "learn_rows_off_1e-3": int((learn_err > 1e-3).sum()),
            "cross_err": float(cross_err.max()),
            "dist_err": float(d_err.max()),
            "dist_rows_off_1e-3": int((d_err > 1e-3).sum()),
            "centroid_vs_f64_means": float((c64 - means).abs().max()),
            "counts": counts.tolist(), "centroids": c.tolist(),
            "threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "capability": torch.backends.cpu.get_cpu_capability(),
            "x_align": x.data_ptr() % 64}


def threshold_repeat():
    """The card test's CPU half in many processes
    (one after another at the default thread count; four at a time over a
    sweep of thread counts; the card half first, two at a time), then both
    halves 200 times in this process. Every run's record is logged as a
    JSON line after "record "; then each distinct CPU threshold, its
    count and the runs' thread counts."""
    import concurrent.futures as cf
    import os
    from repro_torch.kernels import build
    build.build_all()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    me = str(Path(__file__).resolve())

    def child(card, threads):
        argv = [sys.executable, me, "--child", str(int(card)), str(threads)]
        res = subprocess.run(argv, env=env, capture_output=True, text=True,
                             timeout=300)
        if res.returncode:
            raise AssertionError(f"{argv}: {res.stderr[-2000:]}")
        rec = json.loads(res.stdout.splitlines()[-1])
        rec["kind"] = ("card then CPU" if card else "CPU") + (
            f", {threads} threads" if threads else ", default threads")
        return rec
    t0 = time.perf_counter()
    recs = [child(False, 0) for _ in range(100)]
    sweep = [(False, t) for t in (1, 2, 4, 8, 12, 16, 32, 64)
             for _ in range(10)]
    with cf.ThreadPoolExecutor(4) as pool:
        recs += list(pool.map(lambda a: child(*a), sweep))
    with cf.ThreadPoolExecutor(2) as pool:
        recs += list(pool.map(lambda a: child(*a), [(True, 0)] * 24))
    log(f"  {len(recs)} processes in {time.perf_counter() - t0:.1f} s")
    for i in range(200):
        rec = threshold_child(True, 0)
        rec["kind"] = "card then CPU, in one process"
        recs.append(rec)
    for rec in recs:
        log("record " + json.dumps(rec))
    first = recs[0]
    log(f"  host: os.cpu_count {first['cpu_count']}, affinity "
        f"{first['affinity']}, torch threads by default {first['threads']}, "
        f"CPU capability {first['capability']}")
    values = {}
    for rec in recs:
        values.setdefault(f"{rec['cpu']:.7f}", []).append(rec)
    for v, group in sorted(values.items(), key=lambda kv: -len(kv[1])):
        kinds = {}
        for rec in group:
            kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
        cards = sorted({f"{r['card']:.7f}" for r in group if r["card"]})
        again = sorted({(f"{r['again_torch_quantile']:.7f}",
                         f"{r['again_numpy_quantile']:.7f}") for r in group})
        log(f"  CPU threshold {v}: {len(group)} runs ({kinds}); float64 "
            f"quantile from the fit's centroids {group[0]['q64_from_fit']:.7f}"
            f"; max |centroid - f64 mean of its assignment| "
            f"{max(r['centroid_vs_f64_means'] for r in group):.3e}; counts "
            f"{group[0]['counts']}; card thresholds {cards}; the "
            f"calibration again (torch.quantile, numpy quantile): {again}, "
            f"max |x @ c.T - f64| {max(r['cross_err'] for r in group):.3e}, "
            f"max |distance - f64| {max(r['dist_err'] for r in group):.3e}, "
            f"rows off by > 1e-3: "
            f"{sorted({r['dist_rows_off_1e-3'] for r in group})}; in learn's "
            f"own calibration: max |distance - f64| "
            f"{max(r['learn_dist_err'] for r in group):.3e}, rows off by > "
            f"1e-3: {sorted({r['learn_rows_off_1e-3'] for r in group})}")


def threshold_count(n: int, jobs: int) -> None:
    """``--child 0 0`` in ``n`` processes, ``jobs`` at a time: the CPU
    thresholds at torch's default thread count, counted."""
    import concurrent.futures as cf
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    argv = [sys.executable, str(Path(__file__).resolve()), "--child", "0",
            "0"]

    def child(_):
        res = subprocess.run(argv, env=env, capture_output=True, text=True,
                             timeout=300)
        if res.returncode:
            raise AssertionError(f"{argv}: {res.stderr[-2000:]}")
        return json.loads(res.stdout.splitlines()[-1])
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(jobs) as pool:
        recs = list(pool.map(child, range(n)))
    values = {}
    for rec in recs:
        values.setdefault(f"{rec['cpu']:.7f}", []).append(rec)
    for v, group in sorted(values.items(), key=lambda kv: -len(kv[1])):
        log(f"  CPU threshold {v}: {len(group)} of {n} processes; rows off "
            f"by > 1e-3 in learn's calibration: "
            f"{sorted({r['learn_rows_off_1e-3'] for r in group})}")
    common = max(len(g) for g in values.values())
    log(f"{n - common} of {n} processes differ from the most common "
        f"threshold ({jobs} at a time, {recs[0]['threads']} threads each, "
        f"{time.perf_counter() - t0:.0f} s)")


def main(argv) -> int:
    sys.path.insert(0, str(SRC))
    if argv[:1] == ["--child"] and len(argv) == 3:
        print(json.dumps(threshold_child(bool(int(argv[1])), int(argv[2]))))
        return 0
    if argv[:1] == ["--count"] and len(argv) == 3:
        threshold_count(int(argv[1]), int(argv[2]))
        return 0
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    threshold_repeat()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
