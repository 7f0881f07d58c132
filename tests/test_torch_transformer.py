"""The port's transformer against the JAX package: the flash-attention
plain version (kernel B6's), the layers, the dense backbone and the config
records.

Inputs come from numpy with a seed. The B6 plain version runs against the
reference's Pallas kernel in interpret mode (as the JAX tests run it on
the CPU) and its jnp oracle, forward within atol 1e-5 and gradients (the
reference's through its ``custom_vjp``) within rtol 1e-4, atol 1e-6; at
GQA 8, S = 300 the gradients within 4 times the reference's own error
against a float64 oracle. The
layers and the backbone, loaded with the reference's weights
(``load_jax_params``), hold to rtol 1e-5, atol 1e-5 against the
reference's ``forward`` under its jnp and its Pallas-interpret attention:
float32 matmuls in two libraries differ in the last bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.common import types as ref_types
from repro.core.fd_trainer import TransformerClientModel as RefClientModel
from repro.kernels import dispatch as ref_dispatch
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa_ref
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.common import types
from repro_torch.core.fd_trainer import TransformerClientModel
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as L
from repro_torch.models.transformer import Transformer

FWD_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
F32 = dict(rtol=1e-5, atol=1e-5)


def _reduced(pkg):
    return pkg.reduced(pkg.get_arch("granite-8b"), layers=2, d_model=64,
                       vocab=32)


def _gqa4(pkg):
    """d_model 128, 4 heads on 1 kv head of width 32, d_ff 384, vocab 32."""
    return dataclasses.replace(_reduced(pkg), d_model=128, num_heads=4,
                               num_kv_heads=1, head_dim=32, d_ff=384,
                               name="gqa4")


CONFIGS = {"reduced": _reduced, "gqa4": _gqa4}


def _attn_inputs(b, n, nkv, s, h, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, s, h)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s, h)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, h)).astype(np.float32)
    g = rng.standard_normal((b, n, s, h)).astype(np.float32)
    return q, k, v, g


# ------------------------------------------------------------------- B6

# (GQA ratio, S): S = 1 and 32 are the kernel's short route at its ends,
# ratio 8 a group of qwen2.5-3b's size (8 query heads on one kv head).
B6_CASES = [(ratio, s) for ratio in (1, 2, 4, 8)
            for s in (1, 16, 20, 32, 300)]
# At ratio 8, S = 300 each kv gradient sums 2400 terms, and the two
# libraries' fp32 sums part by up to 3.1e-6 on elements near zero, above
# GRAD_TOL's atol. There both packages' gradients are held to a float64
# oracle instead, and the port's largest error to at most GRAD_ERR_FACTOR
# times the reference's own (measured: up to 2.5 times, dk).
WIDE_SUMS = {(8, 300)}
GRAD_ERR_FACTOR = 4.0


def _grads_float64(q, k, v, g, ratio, causal):
    """Gradients of the attention (kv expanded by ``ratio``) in float64,
    folded back onto the unexpanded kv heads."""
    kk, vv = (np.repeat(a, ratio, axis=1) for a in (k, v))
    qd, kd, vd = (torch.from_numpy(a).double().requires_grad_(True)
                  for a in (q, kk, vv))
    b, n, s, h = q.shape
    logits = qd @ kd.transpose(-1, -2) / np.sqrt(h)
    if causal:
        logits = logits.masked_fill(
            torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    (torch.softmax(logits, -1) @ vd).backward(torch.from_numpy(g).double())

    def fold(t):
        return t.reshape(b, n // ratio, ratio, s, h).sum(2).numpy()
    return qd.grad.numpy(), fold(kd.grad), fold(vd.grad)


@pytest.mark.parametrize("ratio,s", B6_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_and_oracle(causal, ratio, s):
    """The plain version against the Pallas kernel (S = 300 pads to two
    256-row blocks there) and the jnp oracle, forward and gradients."""
    b, n, h = (1 if s == 300 else 2), max(4, ratio), 16
    q, k, v, g = _attn_inputs(b, n, n // ratio, s, h, seed=s + ratio)
    out_w, vjp = jax.vjp(
        lambda q_, k_, v_: ref_fa_ops.attention(q_, k_, v_, causal=causal,
                                                interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_w = vjp(jnp.asarray(g))
    kk, vv = (np.repeat(a, ratio, axis=1) for a in (k, v))
    oracle = ref_fa_ref.attention(jnp.asarray(q), jnp.asarray(kk),
                                  jnp.asarray(vv), causal=causal)

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_w),
                               rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oracle),
                               rtol=0, atol=FWD_ATOL)
    if (ratio, s) in WIDE_SUMS:
        oracle64 = _grads_float64(q, k, v, g, ratio, causal)
        for name, got, want, exact in zip("qkv", (qt.grad, kt.grad, vt.grad),
                                          grads_w, oracle64):
            err = np.abs(got.numpy() - exact).max()
            ref_err = np.abs(np.asarray(want) - exact).max()
            assert err <= GRAD_ERR_FACTOR * ref_err, (
                f"d{name}: port off the float64 oracle by {err:.3e}, the "
                f"reference by {ref_err:.3e}")
    else:
        for got, want in zip((qt.grad, kt.grad, vt.grad), grads_w):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **GRAD_TOL)
    # the expanded-kv oracle of the port is the reference's, op for op
    np.testing.assert_allclose(
        fa_ref.attention(qt.detach(), torch.from_numpy(kk),
                         torch.from_numpy(vv), causal=causal).numpy(),
        np.asarray(oracle), rtol=0, atol=FWD_ATOL)


def test_dispatch_flash_attention_routes_on_the_cpu():
    """Model layout (B, S, N, h) with unexpanded kv: the plain route is the
    reference's mask + scores sequence; a kernel request on CPU tensors
    takes the plain version and counts no launch; a sliding window is
    always plain."""
    q, k, v, _ = _attn_inputs(2, 4, 2, 12, 16, seed=5)
    qm, km, vm = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    kk, vv = (np.repeat(a, 2, axis=2) for a in (km, vm))
    want = RL.attention_scores(jnp.asarray(qm), jnp.asarray(kk),
                               jnp.asarray(vv),
                               RL.make_mask(12, 12, causal=True))
    before = fa_ops.flash_attention_cuda.launches
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (qm, km, vm))
    plain = dispatch.flash_attention(qt, kt, vt, causal=True,
                                     backend="torch")
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **F32)
    kernel_req = dispatch.flash_attention(qt, kt, vt, causal=True,
                                          backend="cuda")
    np.testing.assert_allclose(kernel_req.numpy(), plain.numpy(),
                               rtol=0, atol=FWD_ATOL)
    windowed = dispatch.flash_attention(qt, kt, vt, causal=True, window=4,
                                        backend="cuda")
    want_w = ref_dispatch.flash_attention(jnp.asarray(qm), jnp.asarray(kk),
                                          jnp.asarray(vv), causal=True,
                                          window=4, backend="jnp")
    np.testing.assert_allclose(windowed.numpy(), np.asarray(want_w), **F32)
    assert fa_ops.flash_attention_cuda.launches == before


def test_flash_attention_wrappers_refuse_what_has_no_kernel():
    x = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention_cuda(torch.zeros((1, 2, 4, 16)),
                                    torch.zeros((1, 2, 4, 16)),
                                    torch.zeros((1, 2, 4, 16)), True)


# ---------------------------------------------------------------- layers

def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("h", [16, 128])
def test_rope_matches_half_split(h):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 3, h)).astype(np.float32)
    cos_w, sin_w = RL.rope_angles(jnp.arange(16), h, 10000.0)
    cos, sin = L.rope_angles(torch.arange(16), h, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_w), **F32)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_w), **F32)
    want = RL.apply_rope(jnp.asarray(x), cos_w, sin_w)
    got = L.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # half-split: the first and second halves rotate as pairs (i, i + h/2)
    np.testing.assert_allclose(
        got[..., 0].numpy(),
        (x[..., 0] * cos.numpy()[None, :, None, 0]
         - x[..., h // 2] * sin.numpy()[None, :, None, 0]), **F32)


def _ref_backend(name):
    """The reference's attention route: jnp, or Pallas in interpret mode."""
    return ref_dispatch.kernel_backend("pallas" if name == "pallas" else "jnp")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_attention_forward_matches(arch, backend):
    cfg_w, cfg = CONFIGS[arch](ref_configs), CONFIGS[arch](configs)
    p_w = RL.init_attention(jax.random.PRNGKey(2), cfg_w)
    x = np.random.default_rng(2).standard_normal((3, 16, cfg.d_model)
                                                 ).astype(np.float32)
    with _ref_backend(backend):
        want = RL.attention_forward(p_w, jnp.asarray(x), cfg_w,
                                    positions=jnp.arange(16))
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_w.items()}
    got = L.attention_forward(p, torch.from_numpy(x), cfg,
                              positions=torch.arange(16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mlp_forward_matches():
    p_w = RL.init_mlp(jax.random.PRNGKey(4), 64, 192)
    x = np.random.default_rng(4).standard_normal((2, 5, 64)
                                                 ).astype(np.float32)
    want = RL.mlp_forward(p_w, jnp.asarray(x))
    got = L.mlp_forward({k: torch.from_numpy(np.array(v))
                         for k, v in p_w.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# -------------------------------------------------------------- backbone

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_transformer_forward_matches_after_loading_jax_params(arch, backend):
    cfg_w, cfg = CONFIGS[arch](ref_configs), CONFIGS[arch](configs)
    params = RT.init_params(cfg_w, jax.random.PRNGKey(7))
    tokens = np.random.default_rng(7).integers(0, 32, (4, 16)
                                               ).astype(np.int32)
    with _ref_backend(backend):
        want, _ = RT.forward(params, cfg_w, jnp.asarray(tokens))
    model = Transformer(cfg).load_jax_params(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        model.features(torch.from_numpy(tokens).long()).detach().numpy(),
        np.asarray(RT.features(params, cfg_w, jnp.asarray(tokens))), **F32)


def test_client_model_is_the_last_position_and_round_trips_weights():
    cfg_w, cfg = _reduced(ref_configs), _reduced(configs)
    ref = RefClientModel(cfg_w)
    params = ref.init(jax.random.PRNGKey(9))
    tokens = np.random.default_rng(9).integers(0, 32, (6, 16)
                                               ).astype(np.int32)
    model = TransformerClientModel(cfg).load_jax_params(
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.shape == (6, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.apply(params, tokens)), **F32)
    exported = model.export_params()
    assert (jax.tree.structure(exported)
            == jax.tree.structure(jax.tree.map(np.asarray, params)))
    for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_transformer_init_is_seeded_and_scaled():
    cfg = _reduced(configs)
    a = Transformer(cfg, generator=torch.Generator().manual_seed(1))
    b = Transformer(cfg, generator=torch.Generator().manual_seed(1))
    for u, v in zip(a.parameters(), b.parameters()):
        assert torch.equal(u, v)
    assert abs(float(a.embed.detach().std()) - 0.02) < 0.003
    wo = a.blocks[0]["attn"]["wo"].detach()
    assert abs(float(wo.std()) - (64 * cfg.num_layers) ** -0.5) < 0.01
    assert float(a.final_norm["scale"].detach().min()) == 1.0


@pytest.mark.parametrize("name", ["granite-moe", "xlstm-350m",
                                  "hubert-xlarge"])
def test_other_families_are_refused_naming_their_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 11"):
        Transformer(configs.reduced(configs.get_arch(name), d_model=32,
                                    vocab=16))


# --------------------------------------------------------------- configs

@pytest.mark.parametrize("cls", ["ArchConfig", "MoEConfig", "InputShape"])
def test_config_record_fields_match_reference(cls):
    got = [(f.name, f.default) for f in dataclasses.fields(getattr(types, cls))]
    want = [(f.name, f.default)
            for f in dataclasses.fields(getattr(ref_types, cls))]
    assert got == want
    assert ([(k.name, k.value) for k in types.AttentionKind]
            == [(k.name, k.value) for k in ref_types.AttentionKind])


def test_arch_registry_matches_reference():
    assert configs.ALIASES == ref_configs.ALIASES
    assert sorted(configs.ARCHS) == sorted(ref_configs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        want = ref_configs.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert cfg.param_count() == want.param_count()
        assert cfg.resolved_head_dim == want.resolved_head_dim
        assert (dataclasses.asdict(configs.reduced(cfg, d_model=64, vocab=32))
                == dataclasses.asdict(ref_configs.reduced(want, d_model=64,
                                                          vocab=32)))
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_configs.SHAPES.items()})
