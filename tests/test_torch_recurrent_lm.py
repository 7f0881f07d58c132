"""The port's recurrent LM families, ssm (xLSTM) and hybrid (Griffin),
against the JAX package's ``repro.models.transformer``.

Registry configs reduced to d_model 32, vocab 64: xlstm-350m at 4 layers
(two mLSTM/sLSTM groups) and recurrentgemma-2b at 6 layers (two groups of
two RG-LRU blocks and a local-attention block) with its window cut to 16,
so that S = 20 runs past it; the same edits on both packages' configs.
Weights come from the reference's ``init_params`` through
``load_jax_params``, tokens from numpy seeds; the reference's functions
are compiled once per family (and sLSTM route).

Checked: the weights' round trip (``load_jax_params``/``jax_params``,
the group axis and hybrid's nested ``(period - 1)`` axis) bit for bit;
``train_loss`` within rtol 1e-5, under both sLSTM routes; for hybrid
``forward``'s logits within rtol 1e-5, atol 1e-5 and the gradients
within rtol 1e-5 and an atol of 1e-5 times the largest gradient (float32
sums of cancelling terms). For ssm the logits' atol is 1e-4 and the
gradients' 3e-5 times the largest: that is the float32 error of either
package through two groups' exponential gating over 20 steps. Measured
against a float64 run of the port, the reference's logits lie up to
4.3e-5 from it and the port's 3.3e-5 (max |logit| 3.5), the embedding's
gradient 2.1e-5 and 1.8e-5 of the largest gradient, so the test holds
both packages to that float64 run within the same tolerances;
``remat`` the same bits; ``init_cache``'s leaves (names,
shapes, dtypes, fill); ``decode_step``'s logits and caches step by
step within the forward's tolerances against the reference's, hybrid at ``cache_len`` 8 over 12
steps so that its ring wraps at the cache's own length, and
``prefill_then_decode``'s tokens equal to the reference's greedy decode;
under a model axis both families refuse, naming ROADMAP queue A item 11.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro import configs as RC
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import configs as C
from repro_torch.launch import decode_demo as D
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

ARCHS = {"ssm": ("xlstm-350m", dict(layers=4)),
         "hybrid": ("recurrentgemma-2b", dict(layers=6))}
FAMILIES = sorted(ARCHS)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL = {"ssm": 3e-5, "hybrid": 1e-5}     # times the largest gradient
LOGIT_ATOL = {"ssm": 1e-4, "hybrid": 1e-5}
SEQ = 20


def _cfgs(family):
    arch, kw = ARCHS[family]
    cfg_r = RC.reduced(RC.get_arch(arch), d_model=32, vocab=64, **kw)
    cfg = C.reduced(C.get_arch(arch), d_model=32, vocab=64, **kw)
    if family == "hybrid":
        cfg_r = dataclasses.replace(cfg_r, local_window=16)
        cfg = dataclasses.replace(cfg, local_window=16)
    return cfg_r, cfg


@pytest.fixture(scope="module")
def fam():
    """Per family: configs, the reference's weights, the port's model
    loaded with them, and the reference's compiled functions."""
    out = {}
    init = jax.jit(RT.init_params, static_argnums=0)
    for family in FAMILIES:
        cfg_r, cfg = _cfgs(family)
        params = init(cfg_r, jax.random.PRNGKey(3))
        model = T.Transformer(cfg).load_jax_params(
            jax.tree.map(np.asarray, params))
        out[family] = dict(
            cfg_r=cfg_r, cfg=cfg, params=params, model=model,
            forward=jax.jit(lambda p, t, c=cfg_r: RT.forward(p, c, t)[0]),
            decode=jax.jit(RT.decode_step, static_argnums=1))
    return out


def _batch(seed, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 64, (b, s)).astype(np.int32)
    lab = rng.integers(0, 64, (b, s)).astype(np.int32)
    lab[0, :3] = -1
    return tok, lab


def _t(a):
    return torch.as_tensor(a).long()


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
    assert len(m.blocks) == 2
    if family == "hybrid":
        # group 1, its second RG-LRU block: the nested axis split right
        np.testing.assert_array_equal(
            m.blocks[1]["rec"][1]["rglru"]["lambda"].detach().numpy(),
            want["blocks"]["rec"]["rglru"]["lambda"][1, 1])
    else:
        np.testing.assert_array_equal(
            m.blocks[1]["slstm"]["ri"].detach().numpy(),
            want["blocks"]["slstm"]["ri"][1])
    # a tree the model does not have is refused, naming the path
    bad = jax.tree.map(lambda a: a, want)
    part, leaf = ("rec", "ln2") if family == "hybrid" else ("mlstm", "norm")
    bad["blocks"][part] = {k: v for k, v in bad["blocks"][part].items()
                           if k != leaf}
    with pytest.raises(ValueError, match="reference leaves"):
        T.Transformer(f["cfg"]).load_jax_params(bad)


@pytest.mark.parametrize("family,custom_vjp", [
    ("ssm", True), ("ssm", False), ("hybrid", True)])
def test_forward_loss_and_grads_match_the_reference(fam, family,
                                                    custom_vjp):
    f = fam[family]
    cfg_r, params, model = f["cfg_r"], f["params"], f["model"]
    tok, lab = _batch(1)
    was = (RS.USE_SLSTM_CUSTOM_VJP, S.USE_SLSTM_CUSTOM_VJP)
    RS.set_slstm_custom_vjp(custom_vjp)
    S.set_slstm_custom_vjp(custom_vjp)
    try:
        (lr, mr), gr = jax.jit(jax.value_and_grad(
            lambda p: RT.train_loss(p, cfg_r, {"tokens": jnp.asarray(tok),
                                               "labels": jnp.asarray(lab)}),
            has_aux=True))(params)
        loss, met = T.train_loss(model, {"tokens": _t(tok),
                                         "labels": _t(lab)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        RS.set_slstm_custom_vjp(was[0])
        S.set_slstm_custom_vjp(was[1])
    np.testing.assert_allclose(float(loss.detach()), float(lr), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"].detach()), float(mr["ce"]),
                               rtol=1e-5)
    assert float(met["aux"]) == float(mr["aux"]) == 0.0
    got, want = model.jax_params(grads), jax.tree.map(np.asarray, gr)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    scale = max(np.abs(w).max() for w in jax.tree.leaves(want))
    atol = GRAD_ATOL[family] * scale
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    with torch.no_grad():
        logits = model(_t(tok)).numpy()
    ref_logits = np.asarray(f["forward"](params, tok))
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-5,
                               atol=LOGIT_ATOL[family])
    if family == "ssm":
        # both packages' float32 results against a float64 run of the port
        m64 = T.Transformer(f["cfg"]).load_jax_params(
            jax.tree.map(np.asarray, params)).double()
        l64, _ = T.train_loss(m64, {"tokens": _t(tok), "labels": _t(lab)})
        g64 = m64.jax_params(torch.autograd.grad(l64,
                                                 list(m64.parameters())))
        for a, b, o in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(g64)):
            np.testing.assert_allclose(a, o, rtol=1e-5, atol=atol)
            np.testing.assert_allclose(b, o, rtol=1e-5, atol=atol)
        with torch.no_grad():
            o = m64(_t(tok)).numpy()
        for a in (logits, ref_logits):
            np.testing.assert_allclose(a, o, rtol=1e-5,
                                       atol=LOGIT_ATOL[family])


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_recomputes_each_group_to_the_same_bits(fam, family):
    model = fam[family]["model"]
    tok, lab = _batch(2)
    batch = {"tokens": _t(tok), "labels": _t(lab)}
    out = []
    for remat in (False, True):
        loss, _ = T.train_loss(model, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_init_cache_leaves_are_the_references(fam, family, dtype):
    f = fam[family]
    want = RT.init_cache(f["cfg_r"], 3, 8, getattr(jnp, dtype))
    got = T.init_cache(f["cfg"], 3, 8, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == getattr(torch, str(w.dtype)), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(w, np.float32), err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_matches_the_reference(fam, family):
    """12 steps against a cache of 8: hybrid's ring wraps at the cache's
    own length (8, below its window of 16), as the reference's does; the
    generated tokens are the reference's greedy decode's."""
    f = fam[family]
    params, cfg_r, model, step = f["params"], f["cfg_r"], f["model"], \
        f["decode"]
    tok, _ = _batch(3, b=3, s=12)
    cache_r = RT.init_cache(cfg_r, 3, 8, jnp.float32)
    cache = T.init_cache(f["cfg"], 3, 8, torch.float32)
    for t in range(12):
        lr, cache_r = step(params, cfg_r, jnp.asarray(tok[:, t:t + 1]),
                           cache_r, jnp.int32(t))
        with torch.no_grad():
            lg, cache = T.decode_step(model, _t(tok[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lr), rtol=1e-5,
                                   atol=LOGIT_ATOL[family])
    for k in cache_r:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(cache_r[k]),
                                   err_msg=k, rtol=1e-5,
                                   atol=LOGIT_ATOL[family])
    # prefill_then_decode against the reference's greedy loop (its
    # decode_demo's, on the compiled step): prompt 5, 7 new, cache 16
    prompt = tok[:, :5]
    cache_r = RT.init_cache(cfg_r, 3, 16, jnp.float32)
    for t in range(5):
        lr, cache_r = step(params, cfg_r, jnp.asarray(prompt[:, t:t + 1]),
                           cache_r, jnp.int32(t))
    want = []
    nxt = jnp.argmax(lr[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(7):
        want.append(np.asarray(nxt))
        lr, cache_r = step(params, cfg_r, nxt, cache_r, jnp.int32(5 + i))
        nxt = jnp.argmax(lr[:, -1:], axis=-1).astype(jnp.int32)
    toks, prefill, replay = D.prefill_then_decode(
        model, _t(prompt), 16, 7, return_logits=True)
    np.testing.assert_array_equal(toks.numpy(), np.concatenate(want, 1))
    np.testing.assert_allclose(replay.numpy(), prefill.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.fixture(scope="module")
def on_two_ranks(fam, tmp_path_factory):
    """Each family's model, the reference's weights loaded, on the
    ``(1, 2)`` model axis of two gloo ranks and unsharded
    (``tests/_torch_mesh_prog.py``): forward, loss, gradients and a
    decode of 6 new tokens after a prompt of 6 (hybrid's ring wrapping at
    ``cache_len`` 8)."""
    import _torch_mesh_prog as prog
    arch = {f: {"arch": ARCHS[f][0], "reduced": dict(
        d_model=32, vocab=64, **ARCHS[f][1]), "replace": dict(
        local_window=16) if f == "hybrid" else {}} for f in FAMILIES}
    cases = [{"cfg": arch[f], "decode": True, "cache_len": 8,
              "seq": SEQ, "params": jax.tree.map(np.asarray,
                                                 fam[f]["params"])}
             for f in FAMILIES]
    return prog.spawn(2, "families", {"cases": cases},
                      tmp_path_factory.mktemp("recurrent_mp"))


@pytest.mark.parametrize("family", FAMILIES)
def test_a_model_axis_matches_the_unsharded_model(fam, family,
                                                  on_two_ranks):
    """On the ``(1, 2)`` model axis the reference's weights give the port's
    unsharded logits, the reference's own forward's and the unsharded
    greedy decode's (tokens equal, every step's logits), each within the
    family's logit tolerance of this file (ssm's wider: float32 through
    the sLSTM's gating), the loss within 1e-5 and the gradients within
    rtol 1e-4 and the family's atol of the largest, on every rank."""
    f = fam[family]
    tok = _batch(0)[0]
    want = np.asarray(f["forward"](f["params"], jnp.asarray(tok)))
    tol = dict(rtol=1e-5, atol=LOGIT_ATOL[family])
    for rank in on_two_ranks:
        r = rank[FAMILIES.index(family)]
        mp, ref = r["mp"], r["ref"]
        np.testing.assert_allclose(mp["logits"], ref["logits"], **tol)
        np.testing.assert_allclose(mp["logits"], want, **tol)
        assert abs(mp["loss"] - ref["loss"]) <= 1e-5
        top = max(np.abs(g).max() for g in ref["grads"])
        for g, gr in zip(mp["grads"], ref["grads"]):
            np.testing.assert_allclose(g, gr, rtol=1e-4,
                                       atol=GRAD_ATOL[family] * top)
        np.testing.assert_array_equal(mp["tokens"], ref["tokens"])
        np.testing.assert_allclose(mp["decode_logits"],
                                   ref["decode_logits"], **tol)
