"""Scenario: the MESH-COLLECTIVE federated-distillation round on the
PyTorch port.

On a real deployment each client is a rank of a process group and the
server's masked-mean aggregation is one all-reduce, with no hub. Eight
ranks of a gloo group stand in for eight clients here (NCCL refuses two
ranks on one card): every rank fits its private KMeans-DRE (the Lloyd-step
kernel on the card), filters the shared proxy batch with it (the
min-distance kernel), and ``core.aggregation.masked_mean_logits_psum``
fuses every rank's logits in one all-reduce of the masked sums and one of
the counts. Each rank then checks that teacher against the hub's
``masked_mean_logits`` over every rank's logits and masks. Run:

    PYTHONPATH=src python examples_torch/fed_shardmap.py [--device cpu]

(the script starts its eight ranks itself, each a process; ``--rank`` is
one of them).
"""
import argparse
import os
import subprocess
import sys
import tempfile

import torch

C, T, K, DIM = 8, 64, 10, 16
N_PRIVATE = 256           # each client's private rows
THRESHOLD = 4.0


def client_round(rank: int, device) -> dict:
    """One rank's round: fit, filter, psum, and the hub's check."""
    from repro_torch.core.aggregation import (masked_mean_logits,
                                              masked_mean_logits_psum)
    from repro_torch.core.kmeans import kmeans_fit
    from repro_torch.fed.mesh import build_mesh
    from repro_torch.kernels import dispatch
    mesh = build_mesh((C,), ("clients",), device=device)
    # every rank draws the shared tensors alike, then its own private rows
    gen = torch.Generator().manual_seed(0)
    class_means = torch.randn((C, DIM), generator=gen) * 6.0
    proxy = torch.cat([class_means[i] + torch.randn((T // C, DIM),
                                                    generator=gen)
                       for i in range(C)]).to(device)
    logits = torch.randn((C, T, K), generator=gen)
    private = (class_means[rank] + torch.randn(
        (N_PRIVATE, DIM), generator=torch.Generator().manual_seed(
            1 + rank))).to(device)
    fit = kmeans_fit(private, 1,
                     generator=torch.Generator().manual_seed(rank))
    _, mask = dispatch.min_dist_and_mask(proxy, fit.centroids, THRESHOLD)
    mine = logits[rank].to(device)
    teacher, valid = masked_mean_logits_psum(mine, mask, "clients", mesh)
    # the hub: every rank's logits and mask, reduced in one place
    masks = mesh.gather(mask[None], "clients")
    hub, hub_valid = masked_mean_logits(logits.to(device), masks)
    torch.testing.assert_close(teacher, hub, rtol=1e-5, atol=1e-6)
    assert torch.equal(valid, hub_valid)
    return {"id_fraction": masks.float().mean(dim=1).cpu(),
            "valid": int(hub_valid.sum())}


def rank_main(args) -> None:
    from repro_torch.fed import mesh as M
    os.environ.update(RANK=str(args.rank), WORLD_SIZE=str(C),
                      REPRO_DIST_BACKEND="gloo")
    torch.set_num_threads(1)
    M.init_distributed(args.device, init_method=f"file://{args.init}")
    try:
        out = client_round(args.rank, M.rank_device(args.device))
    finally:
        torch.distributed.destroy_process_group()
    if args.rank == 0:
        print(f"ranks: {C} (one per client), device {args.device}")
        print(f"ID fraction per client: {out['id_fraction'].numpy().round(2)}")
        print(f"psum teacher == hub teacher ✓  (valid samples: "
              f"{out['valid']}/{T})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default="")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but this host has no "
                           "CUDA device (use --device cpu)")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--init", init, "--device", args.device])
            for r in range(C)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    if any(codes):
        raise SystemExit(f"rank exit codes {codes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
