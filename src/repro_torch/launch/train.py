"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--reduced] [--device cuda|cpu]``.

The reference's ``repro.launch.train`` (its flags and defaults), one
process on one device, end to end: config → model → data → optimizer →
checkpoint. The model is ``models.transformer.Transformer`` (every
family), its weights drawn on the device from a ``torch.Generator``
seeded 0; the data are ``make_batch_fn``'s batches (numpy, the
reference's bit for bit: Markov-stream tokens, the vlm's with
``synth_vision`` patch embeddings, audio's ``synth_frames`` and random
unit labels); the optimizer is ``adamw`` on
``linear_warmup_cosine(lr, 10, steps)``; ``--ckpt-dir`` writes the
weights as the reference's pytree (``jax_params``) through
``checkpoint.save_checkpoint``, which the reference's
``repro.checkpoint`` reads. ``--device`` defaults to ``cuda`` and raises
on a host without a CUDA device; ``--device cpu`` asks for the CPU
(there, ``--reduced``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.types import ArchConfig
from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.data.tokens import (MarkovTokenStream, synth_frames,
                                     synth_vision)
from repro_torch.fed.simulator import pin_fp32, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates
from repro_torch.optim.schedules import linear_warmup_cosine


def make_batch_fn(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                  device="cpu") -> Callable[[], Dict[str, torch.Tensor]]:
    """The reference's batches, drawn in its order, on ``device``:
    {tokens, labels} (B, S) int64, labels the next tokens; the vlm's
    also ``vision`` (B, num_vision_tokens, d) f32 from ``synth_vision``
    (its own rng, seeded ``seed``, drawn after the tokens); audio's
    {frames (B, S, stub_dim) f32, labels (B, S) int64 units}, frames
    then labels from that rng."""
    T.refuse_family(cfg)
    stream = MarkovTokenStream(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed)

    def tensor(a):
        a = a.astype(np.int64) if a.dtype.kind == "i" else a
        return torch.as_tensor(a, device=device)

    def next_batch():
        if cfg.family == "audio":
            frames = synth_frames(rng, batch, seq, cfg.frontend_stub_dim)
            labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
                np.int32)
            return {"frames": tensor(frames), "labels": tensor(labels)}
        out = {k: tensor(v) for k, v in stream.batch(batch, seq).items()}
        if cfg.family == "vlm":
            out["vision"] = tensor(synth_vision(
                rng, batch, cfg.num_vision_tokens, cfg.d_model))
        return out

    return next_batch


def make_train_step(model: T.Transformer, opt: Optimizer, *,
                    remat: bool = False):
    """``step(opt_state, batch) -> (opt_state, loss)``: one ``train_loss``
    gradient step on ``model``'s parameters, in place."""
    params = list(model.parameters())

    def train_step(opt_state, batch):
        loss, _ = T.train_loss(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, params)
        upd, opt_state = opt.update(grads, opt_state, params)
        del grads
        apply_updates(params, upd)
        return opt_state, loss.detach()

    return train_step


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int, lr: float,
          device, remat: bool = False, log_every: int = 10,
          model: Optional[T.Transformer] = None,
          kernel_backend: Optional[str] = None, say=print):
    """``steps`` AdamW steps of ``cfg`` (``model``: these weights, else
    drawn on ``device`` from seed 0). Returns (losses, each step's
    seconds, the model)."""
    device = resolve_device(device)
    pin_fp32()
    if model is None:
        gen = torch.Generator(device=device).manual_seed(0)
        model = T.Transformer(cfg, generator=gen, device=device,
                              kernel_backend=kernel_backend)
    opt = adamw(linear_warmup_cosine(lr, 10, steps))
    opt_state = opt.init(list(model.parameters()))
    next_batch = make_batch_fn(cfg, batch, seq, device=device)
    step_fn = make_train_step(model, opt, remat=remat)
    t0 = time.perf_counter()
    losses: List[float] = []
    seconds: List[float] = []
    for step in range(steps):
        t = time.perf_counter()
        opt_state, loss = step_fn(opt_state, next_batch())
        losses.append(float(loss))           # one host read a step
        seconds.append(time.perf_counter() - t)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            say(f"step {step:5d} loss {losses[-1]:.4f} ({dt:.1f}s)")
    return losses, seconds, model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where training runs; cuda raises on a host "
                         "without a CUDA device")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    T.refuse_family(cfg)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"active≈{cfg.active_param_count()/1e6:.1f}M")
    losses, _, model = train(cfg, steps=args.steps, batch=args.batch,
                             seq=args.seq, lr=args.lr, device=args.device,
                             remat=args.remat, log_every=args.log_every)
    if args.ckpt_dir:
        p = save_checkpoint(args.ckpt_dir, args.steps, model.jax_params())
        print("saved", p)
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps")
    return losses


if __name__ == "__main__":
    main()
