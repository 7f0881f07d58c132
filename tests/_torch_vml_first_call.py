"""The first parallel call of MKL's vector math (VML) in a process, counted
over fresh processes (ROADMAP C7).

    python tests/_torch_vml_first_call.py --count N JOBS [SIZE] [WARM]
    python tests/_torch_vml_first_call.py --ops N JOBS [SRC]

torch's CPU ``sqrt`` (and ``exp``, ``log``, ``tanh``, ...) of a float
tensor cuts more than 2048 elements into chunks over the intra-op threads,
each chunk one VML call. The first form runs N processes, JOBS at a time;
each takes ``torch.sqrt`` of SIZE float32s (default 16384: eight chunks
of 2048) as its first VML call and holds every element to float64's
square root within 1e-6 relative. WARM is what the process does first:
``none`` (nothing), ``sqrt`` or ``exp`` (a serial one-element call of that
op) or ``import`` (``import repro_torch``, which makes such a call). It
prints the processes with an element off, and their count.

The second form runs N processes of the KMeans-DRE calibration in the
threshold test of ``tests/_torch_threshold_repeat.py``
(``KMeansDRE(3).learn`` on its 3000 x 50 input) from SRC (a tree's
``src``, default this checkout's), with ``min_dist_and_mask`` replaced by
the same ops, each op's result kept. After learn, each op runs again on
one thread from its own kept inputs; an op whose first result differs is
printed with the number of rows that moved and their range, beside the
threshold and the rows more than 1e-3 away from float64's distances.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"


def first_call(size: int, warm: str) -> dict:
    """This process's first parallel ``torch.sqrt``: elements off float64's
    square root by more than 1e-6 relative, their range."""
    import torch
    if warm == "import":
        import repro_torch  # noqa: F401
    elif warm in ("sqrt", "exp"):
        getattr(torch, warm)(torch.ones(1))
    g = torch.Generator().manual_seed(0)
    x = torch.rand(size, generator=g) * 100 + 1
    y = torch.sqrt(x)
    want = torch.sqrt(x.double())
    rel = (y.double() - want).abs() / want
    off = (rel > 1e-6).nonzero().flatten()
    return {"off": int(off.numel()), "max_rel": float(rel.max()),
            "first": int(off.min()) if off.numel() else -1,
            "last": int(off.max()) if off.numel() else -1,
            "threads": torch.get_num_threads()}


def calibration_ops() -> dict:
    """KMeansDRE(3).learn with its calibration's ops kept, then each op
    again on one thread from its own kept inputs."""
    import torch
    from repro_torch.core.dre import KMeansDRE
    from repro_torch.kernels.kmeans_dist import ref as kd_ref
    g = torch.Generator().manual_seed(7)
    centers = torch.randn((3, 50), generator=g) * 4
    x = (centers[torch.arange(3000) % 3]
         + torch.randn((3000, 50), generator=g))
    kept = []

    def min_dist_and_mask(x, c, thr):
        # kmeans_dist/ref.py's route, op by op
        x, c = x.to(torch.float32), c.to(torch.float32)
        s = {"x": x.clone(), "c": c.clone()}
        s["sq"] = torch.square(x)
        s["x2"] = torch.sum(s["sq"], dim=-1, keepdim=True)
        s["sqc"] = torch.square(c)
        s["c2"] = torch.sum(s["sqc"], dim=-1)
        s["cross"] = x @ c.transpose(-1, -2)
        s["t1"] = 2.0 * s["cross"]
        s["t2"] = s["x2"] - s["t1"]
        s["t3"] = s["t2"] + s["c2"][..., None, :]
        s["d2"] = torch.clamp_min(s["t3"], 0.0)
        s["amin"] = torch.amin(s["d2"], dim=-1)
        s["sqrt"] = torch.sqrt(s["amin"])
        kept.append(s)
        return s["sqrt"], s["sqrt"] <= thr
    kd_ref.min_dist_and_mask = min_dist_and_mask
    dre = KMeansDRE(num_centroids=3).learn(x, init=x[:3] + 1.0)
    s = kept[0]
    torch.set_num_threads(1)
    again = {
        "sq": lambda: torch.square(s["x"]),
        "x2": lambda: torch.sum(s["sq"], dim=-1, keepdim=True),
        "sqc": lambda: torch.square(s["c"]),
        "c2": lambda: torch.sum(s["sqc"], dim=-1),
        "cross": lambda: s["x"] @ s["c"].transpose(-1, -2),
        "t1": lambda: 2.0 * s["cross"],
        "t2": lambda: s["x2"] - s["t1"],
        "t3": lambda: s["t2"] + s["c2"][..., None, :],
        "d2": lambda: torch.clamp_min(s["t3"], 0.0),
        "amin": lambda: torch.amin(s["d2"], dim=-1),
        "sqrt": lambda: torch.sqrt(s["amin"]),
    }
    moved = {}
    for name, f in again.items():
        err = (f().double() - s[name].double()).abs()
        if err.max() > 0:
            rows = (err.reshape(err.shape[0], -1).amax(-1) > 1e-5).nonzero()
            moved[name] = {"max": float(err.max()), "rows": rows.numel(),
                           "first": int(rows.min()) if rows.numel() else -1,
                           "last": int(rows.max()) if rows.numel() else -1}
    err = (s["sqrt"].double()
           - torch.cdist(s["x"].double(), s["c"].double()).amin(-1)).abs()
    return {"threshold": float(dre.threshold),
            "rows_off_1e-3": int((err > 1e-3).sum()), "moved": moved}


def in_processes(n: int, jobs: int, argv, src: str) -> list:
    env = dict(os.environ, PYTHONPATH=src)
    cmd = [sys.executable, str(Path(__file__).resolve())] + argv

    def one(_):
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
        if res.returncode:
            raise AssertionError(f"{cmd}: {res.stderr[-2000:]}")
        return json.loads(res.stdout.splitlines()[-1])
    with cf.ThreadPoolExecutor(jobs) as pool:
        return list(pool.map(one, range(n)))


def count_first_calls(n: int, jobs: int, size: int = 16384,
                      warm: str = "none", src: str = str(SRC)) -> list:
    """``first_call`` in n fresh processes, jobs at a time."""
    return in_processes(n, jobs, ["--first-call", str(size), warm], src)


def main(argv) -> int:
    t0 = time.perf_counter()
    if argv[:1] == ["--first-call"] and len(argv) == 3:
        print(json.dumps(first_call(int(argv[1]), argv[2])))
    elif argv[:1] == ["--calibration"]:
        print(json.dumps(calibration_ops()))
    elif argv[:1] == ["--count"] and 3 <= len(argv) <= 5:
        size = int(argv[3]) if len(argv) > 3 else 16384
        warm = argv[4] if len(argv) > 4 else "none"
        n, jobs = int(argv[1]), int(argv[2])
        recs = count_first_calls(n, jobs, size, warm)
        bad = [r for r in recs if r["off"]]
        for r in bad:
            print(json.dumps(r))
        print(f"{len(bad)} of {n} processes with a sqrt element off by "
              f"> 1e-6 relative (size {size}, warm-up {warm}, {jobs} at a "
              f"time, {recs[0]['threads']} threads each, "
              f"{time.perf_counter() - t0:.0f} s)")
    elif argv[:1] == ["--ops"] and 3 <= len(argv) <= 4:
        n, jobs = int(argv[1]), int(argv[2])
        src = argv[3] if len(argv) > 3 else str(SRC)
        recs = in_processes(n, jobs, ["--calibration"], src)
        thresholds = {}
        for r in recs:
            key = f"{r['threshold']:.7f}"
            thresholds[key] = thresholds.get(key, 0) + 1
        for r in recs:
            if r["moved"] or r["rows_off_1e-3"]:
                print(json.dumps(r))
        print(f"thresholds {thresholds}; "
              f"{sum(1 for r in recs if r['moved'])} of {n} processes with "
              f"an op whose first result differs from its rerun "
              f"({jobs} at a time, {time.perf_counter() - t0:.0f} s)")
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
