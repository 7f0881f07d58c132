"""The port's token streams, schedules and optimizers against the JAX
package (``repro.data.tokens``, ``repro.optim``).

Token, frame and patch streams are numpy in both packages and must match
bit for bit. The schedules are evaluated in float32 at steps 0…N and
held to the reference's within 2 float32 ulps (rtol 2.4e-7: ``cos`` of
one float32 argument in two libraries). ``adamw`` (float32 and bf16
moments, with weight decay, on a constant and a scheduled rate),
scheduled ``sgd`` and ``clip_by_global_norm`` run 5 steps on a small
pytree of numpy-seeded gradients, parameters and moments within rtol
1e-6, atol 1e-7 (bf16 moments: rtol 1e-2, atol 1e-3, one bf16 rounding
apart at most).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tokens
from repro.optim import optimizers as ref_opt
from repro.optim import schedules as ref_sched
from repro_torch.data import tokens
from repro_torch.optim import optimizers as opt
from repro_torch.optim import schedules as sched

F32 = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("vocab,branching,seed", [(100, 4, 0), (49155, 32, 3)])
def test_markov_stream_bit_for_bit(vocab, branching, seed):
    a = ref_tokens.MarkovTokenStream(vocab, branching=branching, seed=seed)
    b = tokens.MarkovTokenStream(vocab, branching=branching, seed=seed)
    np.testing.assert_array_equal(a.succ, b.succ)
    for bs, s in ((4, 16), (2, 33), (8, 1)):
        x, y = a.batch(bs, s), b.batch(bs, s)
        for key in ("tokens", "labels"):
            assert x[key].dtype == y[key].dtype
            np.testing.assert_array_equal(x[key], y[key])


def test_frames_and_patches_bit_for_bit():
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for args in ((2, 16, 8), (3, 7, 5)):
        np.testing.assert_array_equal(ref_tokens.synth_frames(ra, *args),
                                      tokens.synth_frames(rb, *args))
        np.testing.assert_array_equal(ref_tokens.synth_vision(ra, *args),
                                      tokens.synth_vision(rb, *args))


SCHEDULES = [
    ("constant", (3e-4,)),
    ("cosine_decay", (1e-3, 40)),
    ("cosine_decay", (0.5, 7, 0.25)),
    ("linear_warmup_cosine", (3e-4, 10, 50)),
    ("linear_warmup_cosine", (1e-2, 3, 4)),
    ("linear_warmup_cosine", (1.0, 0, 20)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_in_float32(name, args):
    f_ref, f = getattr(ref_sched, name)(*args), getattr(sched, name)(*args)
    for step in range(0, 61):
        want = np.asarray(f_ref(jnp.int32(step)))
        got = f(step)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.3
              for s in shapes] for _ in range(5)]
    return params, grads


def _run_ref(o, params, grads, clip=None):
    p = [jnp.asarray(x) for x in params]
    st = o.init(p)
    out = []
    for g in grads:
        g = [jnp.asarray(x) for x in g]
        if clip is not None:
            g, _ = ref_opt.clip_by_global_norm(g, clip)
        u, st = o.update(g, st, p)
        p = ref_opt.apply_updates(p, u)
        out.append(([np.asarray(x) for x in p], st))
    return out


def _run_port(o, params, grads, clip=None):
    p = [torch.tensor(x) for x in params]
    st = o.init(p)
    out = []
    for g in grads:
        g = [torch.tensor(x) for x in g]
        if clip is not None:
            g, _ = opt.clip_by_global_norm(g, clip)
        u, st = o.update(g, st, p)
        opt.apply_updates(p, u)
        out.append(([x.numpy().copy() for x in p],
                    {k: [t.clone() for t in v] if isinstance(v, list) else v
                     for k, v in st.items()}))
    return out


def _moments(st, key):
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in st[key]]


OPTIMIZERS = [
    ("adamw", dict(lr=0.1), None),
    ("adamw", dict(lr=3e-3, weight_decay=0.1), None),
    ("adamw", dict(lr="sched", weight_decay=0.01, b2=0.999), None),
    ("adamw", dict(lr=0.05, weight_decay=0.1, state_dtype="bf16"), None),
    ("adamw", dict(lr=0.05), 0.5),
    ("sgd", dict(lr="sched"), None),
    ("sgd", dict(lr=0.1, momentum=0.5), 0.2),
]


@pytest.mark.parametrize("kind,kw,clip", OPTIMIZERS)
def test_optimizer_five_steps(kind, kw, clip):
    params, grads = _tree(11)
    kw_ref, kw_port = dict(kw), dict(kw)
    if kw.get("lr") == "sched":
        kw_ref["lr"] = ref_sched.linear_warmup_cosine(0.1, 2, 5)
        kw_port["lr"] = sched.linear_warmup_cosine(0.1, 2, 5)
    bf16 = kw.get("state_dtype") == "bf16"
    if bf16:
        kw_ref["state_dtype"], kw_port["state_dtype"] = (jnp.bfloat16,
                                                         torch.bfloat16)
    ref = _run_ref(getattr(ref_opt, kind)(**kw_ref), params, grads, clip)
    got = _run_port(getattr(opt, kind)(**kw_port), params, grads, clip)
    tol = BF16 if bf16 else F32
    for (pr, sr), (pp, sp) in zip(ref, got):
        for a, b in zip(pr, pp):
            np.testing.assert_allclose(b, a, **tol)
        keys = ("m", "v") if kind == "adamw" else ("mu",)
        for key in keys:
            for a, b in zip(_moments(sr, key), sp[key]):
                assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
                np.testing.assert_allclose(b.to(torch.float32).numpy(), a,
                                           **tol)
        assert int(sr["step"]) == sp["step"]


def test_clip_by_global_norm_matches():
    rng = np.random.default_rng(2)
    g = [rng.standard_normal(s).astype(np.float32) * 4 for s in
         ((10,), (3, 3))]
    for max_norm in (1.0, 100.0):
        cr, nr = ref_opt.clip_by_global_norm([jnp.asarray(x) for x in g],
                                             max_norm)
        cp, npt = opt.clip_by_global_norm([torch.tensor(x) for x in g],
                                          max_norm)
        np.testing.assert_allclose(float(npt), float(nr), rtol=1e-6)
        for a, b in zip(cr, cp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
