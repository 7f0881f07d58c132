"""End-to-end driver on the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on synthetic Markov data, with a checkpoint.

Full run (on a CUDA card by default):
    PYTHONPATH=src python examples_torch/train_100m.py
Demo (CPU):
    PYTHONPATH=src python examples_torch/train_100m.py --steps 30 --tiny \\
        --device cpu

The checkpoint holds the reference's parameter tree
(``Transformer.jax_params``), which ``repro.checkpoint`` reads too.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.types import ArchConfig, AttentionKind
from repro_torch.fed.simulator import pin_fp32, resolve_device
from repro_torch.launch.train import make_batch_fn, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import linear_warmup_cosine

CONFIG_100M = ArchConfig(
    name="repro-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=16384,
    attention=AttentionKind.FULL,
    source="this repo (quickstart-scale dense config)",
)
TINY = dict(num_layers=4, d_model=256, d_ff=1024, num_heads=4,
            num_kv_heads=2, head_dim=64, vocab_size=4096, name="repro-10m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tiny", action="store_true",
                    help="10M-param variant for CPU demos")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_100m_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where training runs; cuda raises on a host "
                         "without a CUDA device")
    args = ap.parse_args(argv)

    cfg = CONFIG_100M
    if args.tiny:
        cfg = dataclasses.replace(cfg, **TINY)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.0f}M params")
    device = resolve_device(args.device)
    pin_fp32()
    model = T.Transformer(cfg, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    params = list(model.parameters())
    opt = adamw(linear_warmup_cosine(args.lr, 20, args.steps))
    opt_state = opt.init(params)
    next_batch = make_batch_fn(cfg, args.batch, args.seq, device=device)
    train_step = make_train_step(model, opt)

    t0 = time.perf_counter()
    first = loss = None
    for step in range(args.steps):
        opt_state, loss = train_step(opt_state, next_batch())
        if first is None:
            first = float(loss)
        if step % 20 == 0 or step == args.steps - 1:
            tok_s = (step + 1) * args.batch * args.seq \
                / (time.perf_counter() - t0)
            print(f"step {step:4d} loss {float(loss):.4f} "
                  f"({tok_s:.0f} tok/s)")
    path = save_checkpoint(args.ckpt_dir, args.steps, model.jax_params())
    print(f"loss {first:.3f} -> {float(loss):.3f}; ckpt {path}")
    assert float(loss) < first, "training did not reduce loss"
    return first, float(loss), path


if __name__ == "__main__":
    main()
