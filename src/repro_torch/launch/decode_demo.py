"""Token-decode demo: batched prefill + decode with a KV cache.

``python -m repro_torch.launch.decode_demo --arch granite-moe --reduced
--tokens 32 [--device cuda|cpu]``

The reference's ``repro.launch.decode_demo`` (its flags and defaults; the
old name ``launch.serve`` shims here). Runs the dense, moe, ssm (the
default arch ``xlstm-350m``: a recurrent state in place of a KV cache)
and hybrid families (``models.transformer``). An encoder-only (audio)
arch has no decode path (``SystemExit``), and the vlm family fails as
the reference's does: ``prefill_then_decode`` takes no vision input, so
its prefill raises a ``ValueError`` naming the missing ``vision``.
``--device`` defaults to ``cuda`` and raises on a host without a CUDA
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.fed.simulator import pin_fp32, resolve_device
from repro_torch.models import transformer as T


@torch.no_grad()
def prefill_then_decode(model: T.Transformer, prompt: torch.Tensor,
                        cache_len: int, n_new: int, *,
                        window: Optional[int] = None,
                        return_logits: bool = False):
    """prompt (B, S0) int -> the greedily generated tokens (B, n_new).

    As the reference: a full-sequence prefill forward, then the prompt
    replayed through decode steps to fill the cache or the recurrent
    state (one code path), then ``n_new`` greedy steps. ``return_logits``:
    also the prefill's logits and the replay's, (B, S0, V) each, which
    agree where no expert drops a token (and, for hybrid, while the
    prompt fits the cache's ring)."""
    b, s0 = prompt.shape
    prefill = model.forward_aux(prompt)[0]
    cache = T.init_cache(model.cfg, b, cache_len, torch.float32,
                         window_override=window, device=prompt.device)
    replay = []
    for t in range(s0):
        lg, cache = T.decode_step(model, prompt[:, t:t + 1], cache, t,
                                  window_override=window)
        replay.append(lg[:, 0])
    out = []
    tok = torch.argmax(lg[:, -1:], dim=-1)
    for i in range(n_new):
        out.append(tok)
        lg, cache = T.decode_step(model, tok, cache, s0 + i,
                                  window_override=window)
        tok = torch.argmax(lg[:, -1:], dim=-1)
    toks = torch.cat(out, dim=1)
    if return_logits:
        return toks, prefill, torch.stack(replay, dim=1)
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where decoding runs; cuda raises on a host "
                         "without a CUDA device")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.family == "audio":
        raise SystemExit("encoder-only architecture: no decode path")
    T.refuse_family(cfg)
    device = resolve_device(args.device)
    pin_fp32()
    model = T.Transformer(cfg, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (args.batch, args.prompt_len)),
                             dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    toks = prefill_then_decode(model, prompt, args.cache_len, args.tokens)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    n = args.batch * args.tokens
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({n/dt:.1f} tok/s batch-aggregate)")
    print(toks.numpy()[:, :12])
    return toks


if __name__ == "__main__":
    main()
