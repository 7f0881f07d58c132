"""The port's KV-cache decode and chunked attention against the JAX
package (``repro.models.transformer.decode_step``,
``repro.launch.decode_demo``, ``repro.models.layers.chunked_attention``).

Reduced registry configs (2 layers, d_model 64, vocab 64) with the
reference's ``init_params`` weights. Token by token, decode reproduces
the port's own full-sequence forward within rtol 1e-4, atol 1e-5 (dense;
moe with the capacity factor raised to the expert count, so no token is
dropped, as the reference's ``test_decode_matches_forward`` does; a
sliding window through the ring buffer). ``decode_step``'s logits hold
to the reference's within rtol 1e-5, atol 1e-5, ``prefill_then_decode``
gives the reference's tokens exactly, and ``chunked_attention`` (causal,
windowed and full, a padded last tile) holds within atol 1e-5.
``decode_demo.main`` runs at its default arch (xlstm-350m, reduced),
refuses audio (encoder-only) and fails on the vlm as the reference's does
(its prefill has no vision input); the recurrent families' decode is held
to the reference in ``tests/test_torch_recurrent_lm.py``, the vlm's in
``tests/test_torch_vlm_audio.py``. Under ``bf16_psum`` the model's
logits hold to the reference's within one bf16 ulp at their scale (that
file's docstring says why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro import configs as RC
from repro.common.types import MoEConfig as RMoE
from repro.launch import decode_demo as RD
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs as C
from repro_torch.common.types import MoEConfig
from repro_torch.launch import decode_demo as D
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SELF = dict(rtol=1e-4, atol=1e-5)
REF = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, no_drop=False):
    cfg_r = RC.reduced(RC.get_arch(arch), d_model=64, vocab=64)
    cfg = C.reduced(C.get_arch(arch), d_model=64, vocab=64)
    if no_drop and cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        cfg_r = dataclasses.replace(cfg_r, moe=RMoE(e, k, float(e)))
        cfg = dataclasses.replace(cfg, moe=MoEConfig(e, k, float(e)))
    return cfg_r, cfg


def _model(cfg_r, cfg, seed=2):
    params = RT.init_params(cfg_r, jax.random.PRNGKey(seed))
    return params, T.Transformer(cfg).load_jax_params(
        jax.tree.map(np.asarray, params))


def _decode_all(model, tokens, cache_len, window=None):
    cache = T.init_cache(model.cfg, tokens.shape[0], cache_len,
                         torch.float32, window_override=window)
    outs = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, cache = T.decode_step(model, tokens[:, t:t + 1], cache, t,
                                      window_override=window)
            outs.append(lg[:, 0])
    return torch.stack(outs, 1), cache


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-1b-a400m"])
def test_decode_matches_forward(arch):
    cfg_r, cfg = _cfgs(arch, no_drop=True)
    _, model = _model(cfg_r, cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 64, (2, 12)))
    with torch.no_grad():
        ref = model.forward_aux(tokens)[0]
    dec, cache = _decode_all(model, tokens, 16)
    assert cache["k"].shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), **SELF)


def test_sliding_window_decode_matches_forward():
    cfg_r, cfg = _cfgs("granite-8b")
    _, model = _model(cfg_r, cfg, seed=3)
    w = 8
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, 64, (1, 20)))
    with torch.no_grad():
        ref = model.forward_aux(tokens, window_override=w)[0]
    dec, cache = _decode_all(model, tokens, 20, window=w)
    assert cache["k"].shape[2] == w          # the ring buffer is the window
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), **SELF)


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-1b-a400m"])
def test_decode_step_and_generation_match_the_reference(arch):
    cfg_r, cfg = _cfgs(arch)
    params, model = _model(cfg_r, cfg, seed=4)
    prompt = np.random.default_rng(0).integers(0, 64, (3, 6)).astype(
        np.int32)
    # decode_step against the reference's, step by step, moe at its
    # default capacity as both decodes use it
    cache_r = RT.init_cache(cfg_r, 3, 10, jnp.float32)
    cache = T.init_cache(cfg, 3, 10, torch.float32)
    ref_step = jax.jit(RT.decode_step, static_argnums=1)
    for t in range(6):
        lr, cache_r = ref_step(params, cfg_r,
                               jnp.asarray(prompt[:, t:t + 1]), cache_r,
                               jnp.int32(t))
        with torch.no_grad():
            lg, cache = T.decode_step(
                model, torch.as_tensor(prompt[:, t:t + 1]).long(), cache, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lr), **REF)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(cache_r[key]), **REF)
    want = RD.prefill_then_decode(cfg_r, params, jnp.asarray(prompt), 16, 8)
    got = D.prefill_then_decode(model, torch.as_tensor(prompt).long(), 16, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert serve.prefill_then_decode is D.prefill_then_decode


def test_prefill_logits_agree_with_the_replay():
    cfg_r, cfg = _cfgs("granite-moe-1b-a400m", no_drop=True)
    _, model = _model(cfg_r, cfg, seed=5)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, 64, (2, 5)))
    toks, prefill, replay = D.prefill_then_decode(model, prompt, 12, 3,
                                                  return_logits=True)
    assert toks.shape == (2, 3) and prefill.shape == replay.shape
    np.testing.assert_allclose(replay.numpy(), prefill.numpy(), **SELF)


def test_decode_demo_main_and_its_refusals(capsys):
    toks = D.main(["--device", "cpu", "--arch", "granite-moe", "--reduced",
                   "--batch", "2", "--prompt-len", "4", "--tokens", "3"])
    assert toks.shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out
    # the default arch, xlstm-350m (ssm), at its defaults: batch 4, 16 new
    toks = D.main(["--device", "cpu", "--reduced"])
    assert toks.shape == (4, 16)
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="vision"):
        D.main(["--device", "cpu", "--arch", "llama32-vision", "--reduced"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--device", "cpu", "--arch", "hubert-xlarge",
                    "--reduced"])


@pytest.mark.parametrize("causal,window,sq,chunk", [
    (True, 0, 20, 8), (True, 5, 20, 8), (False, 0, 13, 4), (True, 0, 7, 16)])
def test_chunked_attention_matches_the_reference(causal, window, sq, chunk):
    rng = np.random.default_rng(sq + chunk)
    q, k, v = (rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
               for _ in range(3))
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                chunk_q=chunk)
    got = L.chunked_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, window=window,
                              chunk_q=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_attention_options_route_through_chunks():
    cfg_r, cfg = _cfgs("granite-8b")
    _, model = _model(cfg_r, cfg, seed=6)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, 64, (2, 24)))
    with torch.no_grad():
        whole = model(tokens)
        L.set_attention_options(chunk_q=8)
        try:
            assert L.get_chunk_q() == 8
            chunked = model(tokens)
        finally:
            L.set_attention_options(chunk_q=0)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)
    # bf16 partial sums, in both packages, on the chunked route
    params = jax.tree.map(jnp.asarray, model.jax_params())
    fwd = jax.jit(lambda p, t: RT.forward(p, cfg_r, t)[0])
    with torch.no_grad():
        L.set_attention_options(chunk_q=8, bf16_psum=True)
        RL.set_attention_options(chunk_q=8, bf16_psum=True)
        try:
            got = model(tokens).numpy()
            want = np.asarray(fwd(params, tokens.numpy().astype(np.int32)))
        finally:
            L.set_attention_options()
            RL.set_attention_options()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp + 1e-5
    assert np.abs(got - whole.numpy()).max() > 1e-4
