"""The port's encoder and cross-attention families, audio (hubert) and vlm
(llama-3.2-vision), and the bf16 partial sums, against the JAX package's
``repro.models.transformer`` and ``repro.models.layers``.

Registry configs reduced to d_model 32, vocab 64 on both packages alike:
hubert-xlarge at 4 layers (4/4 heads of 8), llama-3.2-vision-90b at 6
layers with a cross block every 3rd (two groups of two self blocks and a
cross block; 4/1 heads of 8, 16 vision tokens). Weights come from the
reference's ``init_params`` through ``load_jax_params``; the vlm's gates
are set to 0.5 in both packages (at their init of 0, ``tanh(0)`` hides
the cross path). Inputs are numpy draws from seeds; the reference's
functions are compiled once per family.

Checked: the weights' round trip (the vlm's group and self axes, its (G,)
gates, audio's ``frame_proj``) bit for bit; ``forward``'s logits within
rtol 1e-5, atol 1e-5, ``train_loss`` within rtol 1e-4 and its gradients
within rtol 1e-5 and an atol of 1e-5 times the case's largest gradient
(float32 sums of cancelling terms), as PRs 25-26 held the other
families; ``features`` (audio: the pooled frames); ``remat`` the same
bits; the vlm's ``init_cache`` leaves (bf16 by default, zero cross keys
without vision) and its decode, step by step against the reference's and
against its own forward; cross-attention with Sk != Sq on the plain route
(and the chunked one); ``bf16_psum`` on dense, moe and vlm; ``make_batch_fn``
bit for bit; ``launch.train.main`` on both families and its checkpoint in
the reference's ``repro.checkpoint``; and the reference's failing paths
(the vlm through ``decode_demo``, the FD trainer on both families), which
fail in the port too.

``bf16_psum``: the partial-sum projections round an f32 product to bf16
once, in both packages (``jnp.einsum(..., preferred_element_type=bf16)``
on f32 operands computes in f32 and rounds; so does the port). Two f32
products that agree to float32 noise round to the same bf16 value unless
they straddle a rounding boundary, where they part by one bf16 ulp. So a
layer's bf16 outputs (attention, MLP, experts) are held to one bf16 ulp
of the reference's, elementwise (ulp at |x|: 2^(floor(log2|x|) - 7));
the model's f32 logits carry such a flip of an intermediate forward, at
the intermediate's scale rather than each logit's, and are held to one
bf16 ulp of their largest magnitude plus the f32 tolerance (atol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro import checkpoint as ref_ckpt
from repro import configs as RC
from repro.core import fd_trainer as RFD
from repro.launch import decode_demo as RD
from repro.launch.train import make_batch_fn as ref_batches
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import configs as C
from repro_torch.core import fd_trainer as FD
from repro_torch.launch import decode_demo as D
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import sgd

ARCHS = {"vlm": ("llama-3.2-vision-90b", dict(layers=6)),
         "audio": ("hubert-xlarge", dict(layers=4))}
FAMILIES = sorted(ARCHS)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL = 1e-5                      # times the case's largest gradient
SEQ = 12
GATE = 0.5


def _cfgs(family):
    arch, kw = ARCHS[family]
    cfg_r = RC.reduced(RC.get_arch(arch), d_model=32, vocab=64, **kw)
    cfg = C.reduced(C.get_arch(arch), d_model=32, vocab=64, **kw)
    if family == "vlm":
        cfg_r = dataclasses.replace(cfg_r, cross_attn_every=3)
        cfg = dataclasses.replace(cfg, cross_attn_every=3)
    return cfg_r, cfg


def _gated(params):
    """The reference's vlm weights with both gates of every group at
    ``GATE`` (a no-op for other families)."""
    if "cross" not in params.get("blocks", {}):
        return params
    cross = dict(params["blocks"]["cross"])
    for g in ("gate_attn", "gate_mlp"):
        cross[g] = jnp.full_like(cross[g], GATE)
    return {**params, "blocks": {**params["blocks"], "cross": cross}}


def _inputs(cfg, seed, b=2, s=SEQ):
    """The family's model inputs and labels, numpy: {tokens[, vision]}
    or {frames}, labels with masked positions."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab[0, :3] = -1
    if cfg.family == "audio":
        x = {"frames": rng.standard_normal(
            (b, s, cfg.frontend_stub_dim)).astype(np.float32)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32),
             "vision": rng.standard_normal(
                 (b, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)}
    return x, lab


def _t(a):
    t = torch.tensor(np.asarray(a))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t


def _ref_forward(cfg_r):
    def fwd(p, x):
        if cfg_r.family == "audio":
            return RT.forward(p, cfg_r, frames=x["frames"])[0]
        return RT.forward(p, cfg_r, x["tokens"], vision=x.get("vision"))[0]
    return jax.jit(fwd)


@pytest.fixture(scope="module")
def fam():
    """Per family: configs, the reference's (gated) weights, the port's
    model loaded with them, the reference's compiled forward."""
    out = {}
    init = jax.jit(RT.init_params, static_argnums=0)
    for family in FAMILIES:
        cfg_r, cfg = _cfgs(family)
        params = _gated(init(cfg_r, jax.random.PRNGKey(3)))
        model = T.Transformer(cfg).load_jax_params(
            jax.tree.map(np.asarray, params))
        out[family] = dict(cfg_r=cfg_r, cfg=cfg, params=params, model=model,
                           forward=_ref_forward(cfg_r))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_weights_round_trip_bit_for_bit(fam, family):
    f = fam[family]
    want = jax.tree.map(np.asarray, f["params"])
    got = f["model"].jax_params()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    m = f["model"]
    if family == "vlm":
        assert len(m.blocks) == 2 and len(m.blocks[1]["self"]) == 2
        assert want["blocks"]["cross"]["gate_attn"].shape == (2,)
        # group 1, its second self block: the nested axis split right
        np.testing.assert_array_equal(
            m.blocks[1]["self"][1]["attn"]["wq"].detach().numpy(),
            want["blocks"]["self"]["attn"]["wq"][1, 1])
        assert float(m.blocks[1]["cross"]["gate_mlp"].detach()) == GATE
    else:
        assert m.embed is None and "embed" not in want
        np.testing.assert_array_equal(m.frame_proj.detach().numpy(),
                                      want["frame_proj"])
    # a drawn model has the reference's leaves, shapes and gate init
    drawn = T.Transformer(f["cfg"], generator=torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: a.shape, drawn.jax_params())
    assert shapes == jax.tree.map(lambda a: a.shape, want)
    if family == "vlm":
        assert not drawn.jax_params()["blocks"]["cross"]["gate_attn"].any()


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_loss_and_grads_match_the_reference(fam, family):
    f = fam[family]
    cfg_r, params, model = f["cfg_r"], f["params"], f["model"]
    x, lab = _inputs(f["cfg"], 1)
    batch_r = {**{k: jnp.asarray(v) for k, v in x.items()},
               "labels": jnp.asarray(lab)}
    (lr, mr), gr = jax.jit(jax.value_and_grad(
        lambda p: RT.train_loss(p, cfg_r, batch_r), has_aux=True))(params)
    batch = {**{k: _t(v) for k, v in x.items()}, "labels": _t(lab)}
    loss, met = T.train_loss(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(lr), rtol=1e-4)
    np.testing.assert_allclose(float(met["ce"].detach()), float(mr["ce"]),
                               rtol=1e-4)
    assert float(met["aux"]) == float(mr["aux"]) == 0.0
    got, want = model.jax_params(grads), jax.tree.map(np.asarray, gr)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    atol = GRAD_ATOL * max(np.abs(w).max() for w in jax.tree.leaves(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    if family == "vlm":
        # the gates are live: both carry a gradient
        assert np.abs(got["blocks"]["cross"]["gate_attn"]).min() > 0
    with torch.no_grad():
        logits = model(**{k: _t(v) for k, v in x.items()}).numpy()
    np.testing.assert_allclose(logits, np.asarray(f["forward"](params, x)),
                               **TOL)
    # features: pooled embeddings, or (audio) the pooled frames
    if family == "audio":
        want_f = RT.features(params, cfg_r, frames=jnp.asarray(x["frames"]))
        got_f = model.features(frames=_t(x["frames"]))
    else:
        want_f = RT.features(params, cfg_r, jnp.asarray(x["tokens"]))
        got_f = model.features(_t(x["tokens"]))
    np.testing.assert_allclose(got_f.detach().numpy(), np.asarray(want_f),
                               **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_recomputes_each_group_to_the_same_bits(fam, family):
    f = fam[family]
    x, lab = _inputs(f["cfg"], 2)
    batch = {**{k: _t(v) for k, v in x.items()}, "labels": _t(lab)}
    out = []
    for remat in (False, True):
        loss, _ = T.train_loss(f["model"], batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(f["model"].parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_vlm_cache_and_decode_match_the_reference_and_the_forward(fam):
    """``init_cache``'s leaves (bf16 by default; zero cross keys without
    vision), then 8 decode steps from the cross keys of ``vision``: each
    step's logits against the reference's decode and against the port's
    own full-sequence forward (the reference's tolerance for decode
    against the forward, 2e-2, is not needed here: rtol 1e-4, atol
    1e-5)."""
    f = fam["vlm"]
    cfg_r, cfg, params, model = f["cfg_r"], f["cfg"], f["params"], \
        f["model"]
    want = RT.init_cache(cfg_r, 3, 8)
    got = T.init_cache(cfg, 3, 8)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16, path
        assert not g.any(), path
    x, _ = _inputs(cfg, 3, b=3, s=8)
    tok, vis = x["tokens"], x["vision"]
    cache_r = RT.init_cache(cfg_r, 3, 8, jnp.float32,
                            vision=jnp.asarray(vis), params=params)
    cache = T.init_cache(cfg, 3, 8, torch.float32, vision=_t(vis),
                         params=model)
    np.testing.assert_allclose(cache["cross"]["ck"].detach().numpy(),
                               np.asarray(cache_r["cross"]["ck"]), **TOL)
    step = jax.jit(RT.decode_step, static_argnums=1)
    with torch.no_grad():
        full = model(_t(tok), vision=_t(vis)).numpy()
        for t in range(8):
            lr, cache_r = step(params, cfg_r, jnp.asarray(tok[:, t:t + 1]),
                               cache_r, jnp.int32(t))
            lg, cache = T.decode_step(model, _t(tok[:, t:t + 1]), cache, t)
            np.testing.assert_allclose(lg.numpy(), np.asarray(lr), **TOL)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t],
                                       rtol=1e-4, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(cache_r[k]),
                                   err_msg=k, **TOL)
    with pytest.raises(ValueError, match="encoder-only"):
        T.init_cache(fam["audio"]["cfg"], 1, 4)
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step(fam["audio"]["model"], torch.zeros((1, 1)).long(),
                      {}, 0)


@pytest.mark.parametrize("sq,sk,chunk", [(12, 16, 0), (5, 23, 0),
                                         (12, 23, 4)])
def test_cross_attention_with_sk_ne_sq_on_the_plain_route(fam, sq, sk,
                                                          chunk):
    """``attention_forward(..., kv_override=(k, v))`` at Sq != Sk, the kv
    heads unexpanded (4 query heads over 1), full attention, with a bias
    on q (qkv_bias: the override's keys take none); ``chunk`` > 0 routes
    through the chunked attention, as the reference's does."""
    cfg_r = dataclasses.replace(fam["vlm"]["cfg_r"], qkv_bias=True)
    cfg = dataclasses.replace(fam["vlm"]["cfg"], qkv_bias=True)
    p = RL.init_attention(jax.random.PRNGKey(sq + sk), cfg_r)
    p["bq"] = jax.random.normal(jax.random.PRNGKey(1), p["bq"].shape)
    rng = np.random.default_rng(sq)
    x = rng.standard_normal((2, sq, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 1, 8)).astype(np.float32)
            for _ in range(2))
    RL.set_attention_options(chunk_q=chunk)
    L.set_attention_options(chunk_q=chunk)
    try:
        want = jax.jit(lambda p, x, k, v: RL.attention_forward(
            p, x, cfg_r, causal=False, kv_override=(k, v)))(p, x, k, v)
        got = L.attention_forward({n: _t(w) for n, w in
                                   p.items()}, _t(x), cfg, causal=False,
                                  kv_override=(_t(k), _t(v)),
                                  backend="torch")
    finally:
        RL.set_attention_options()
        L.set_attention_options()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bf16_ulp(w):
    """One bf16 ulp at each |w| (the spacing of bf16 values there)."""
    a = np.maximum(np.abs(np.asarray(w, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-1b-a400m",
                                  "vlm"])
def test_bf16_psum_matches_the_reference(fam, arch):
    """Both packages under ``bf16_psum``: the first block's attention
    and MLP (or experts) outputs, bf16, within one bf16 ulp of the
    reference's elementwise, the logits within one bf16 ulp at their
    scale (module docstring), and the option in effect (the logits move
    from the f32 run's)."""
    if arch == "vlm":
        cfg_r, cfg, params = (fam["vlm"][k] for k in ("cfg_r", "cfg",
                                                      "params"))
        model = fam["vlm"]["model"]
    else:
        cfg_r = RC.reduced(RC.get_arch(arch), d_model=32, vocab=64)
        cfg = C.reduced(C.get_arch(arch), d_model=32, vocab=64)
        params = jax.jit(RT.init_params, static_argnums=0)(
            cfg_r, jax.random.PRNGKey(5))
        model = T.Transformer(cfg).load_jax_params(
            jax.tree.map(np.asarray, params))
    x, _ = _inputs(cfg, 4)
    if cfg.family != "vlm":
        x = {"tokens": x["tokens"]}
    fwd = _ref_forward(cfg_r)
    blk = jax.tree.map(lambda a: a[0], params["blocks"])
    if cfg.family == "vlm":
        blk = jax.tree.map(lambda a: a[0], blk["self"])
    h = np.random.default_rng(6).standard_normal((2, SEQ, 32)).astype(
        np.float32)
    with torch.no_grad():
        f32 = model(**{k: _t(v) for k, v in x.items()}).numpy()
        RL.set_attention_options(bf16_psum=True)
        L.set_attention_options(bf16_psum=True)
        try:
            want = np.asarray(fwd(params, x))
            got = model(**{k: _t(v) for k, v in x.items()}).numpy()
            mine = model_block(model)
            ffn = "mlp" if "mlp" in blk else "moe"

            def ref_layers(blk, h):
                att = RL.attention_forward(blk["attn"], h, cfg_r,
                                           positions=jnp.arange(SEQ))
                if ffn == "mlp":
                    return att, RL.mlp_forward(blk["mlp"], h)
                return att, RM.moe_forward(blk["moe"], h,
                                           top_k=cfg.moe.top_k)[0]
            y = (MOE.moe_forward(mine["moe"], _t(h), top_k=cfg.moe.top_k)[0]
                 if ffn == "moe" else L.mlp_forward(mine["mlp"], _t(h)))
            layers = zip(jax.jit(ref_layers)(blk, h),
                         (L.attention_forward(mine["attn"], _t(h), cfg,
                                              positions=torch.arange(SEQ)),
                          y))
        finally:
            RL.set_attention_options()
            L.set_attention_options()
    for w, g in layers:
        assert w.dtype == jnp.bfloat16 and g.dtype == torch.bfloat16
        w, g = np.asarray(w, np.float32), g.float().numpy()
        assert (np.abs(g - w) <= _bf16_ulp(w)).all()
    assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max()) + 1e-5
    assert np.abs(got - f32).max() > 1e-4


def model_block(model):
    """The port's first self block (the vlm's first group's first)."""
    blk = model.blocks[0]
    return blk["self"][0] if "self" in blk else blk


@pytest.mark.parametrize("family", FAMILIES)
def test_make_batch_fn_is_the_references_bit_for_bit(fam, family):
    cfg_r, cfg = RC.reduced(RC.get_arch(ARCHS[family][0])), \
        C.reduced(C.get_arch(ARCHS[family][0]))
    ref, mine = ref_batches(cfg_r, 3, 10, seed=2), \
        TR.make_batch_fn(cfg, 3, 10, seed=2)
    for _ in range(2):
        want, got = ref(), mine()
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.shape == w.shape and (g.dtype.kind == "f") == (
                w.dtype.kind == "f"), k
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_main_trains_the_family_and_the_reference_reads_its_checkpoint(
        family, tmp_path, capsys):
    arch = ARCHS[family][0]
    d = str(tmp_path / "ck")
    losses = TR.main(["--device", "cpu", "--arch", arch, "--reduced",
                      "--steps", "20", "--batch", "4", "--seq", "32",
                      "--lr", "3e-3", "--ckpt-dir", d])
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert "saved" in capsys.readouterr().out
    cfg_r = RC.reduced(RC.get_arch(arch))
    like = jax.eval_shape(lambda k: RT.init_params(cfg_r, k),
                          jax.random.PRNGKey(0))
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), like)
    got = ref_ckpt.restore_checkpoint(d, 20, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    x, _ = _inputs(cfg_r, 7, b=1, s=4)
    logits = _ref_forward(cfg_r)(got, x)
    assert logits.shape == (1, 4, cfg_r.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()


def test_the_references_failing_paths_fail_in_the_port_too(fam):
    """The vlm through ``decode_demo`` (``prefill_then_decode`` passes no
    vision) and the FD trainer on either family fail in the reference,
    and raise a ``ValueError`` in the port."""
    f = fam["vlm"]
    with pytest.raises(ValueError):
        RD.prefill_then_decode(f["cfg_r"], f["params"],
                               jnp.zeros((1, 2), jnp.int32), 4, 1)
    with pytest.raises(ValueError, match="vision"):
        D.main(["--device", "cpu", "--arch", "llama32-vision", "--reduced",
                "--batch", "1", "--prompt-len", "2", "--tokens", "1"])
    f = fam["audio"]
    with pytest.raises(KeyError, match="embed"):
        RFD.proxy_features(f["params"], f["cfg_r"],
                           jnp.zeros((1, 4), jnp.int32))
    tokens = torch.zeros((2, 4)).long()
    batch = {"tokens": tokens, "labels": tokens}
    opt = sgd(1e-2)
    for family in FAMILIES:
        model = fam[family]["model"]
        with pytest.raises(ValueError, match="FD trainer"):
            FD.proxy_features(model, tokens)
        with pytest.raises(ValueError, match="FD trainer"):
            FD.fd_loss(model, batch, tokens, torch.zeros((2, 64)),
                       torch.ones(2))
        with pytest.raises(ValueError, match="FD trainer"):
            FD.fd_round_local(opt, [(model, None)], [batch], tokens,
                              torch.zeros(2).long(), [None], [0.0])
        with pytest.raises(ValueError, match="FD trainer"):
            FD.make_fd_train_step(opt)(model, None, batch, tokens,
                                       torch.zeros(2).long(), None, 0.0, 0)
        with pytest.raises(ValueError, match="FD trainer"):
            FD.TransformerClientModel(fam[family]["cfg"])
