"""The port's LM training path against the JAX package: ``train_loss``
(moe and dense), three steps of ``launch.train``'s AdamW step from the
reference's init, ``launch.train.main`` on the CPU and its checkpoint in
the reference's ``repro.checkpoint``.

Configs are the registry's granite-moe-1b-a400m and granite-8b reduced
to 2 layers, d_model 64, vocab 64 (the three steps and ``main`` also
xlstm-350m and recurrentgemma-2b); weights come from the reference's
``init_params`` (``load_jax_params``), batches from ``make_batch_fn``
(numpy, the reference's bit for bit); ``remat`` gives the same bits.
``train_loss`` and its metrics hold within rtol 1e-5, its gradients
within rtol 1e-5 and an atol of 1e-5 times the largest gradient (float32
sums of cancelling terms). Three
training steps: losses within rtol 1e-4; parameters within an atol of
0.05 times the summed learning rates of the steps, with at most 1e-4 of
the elements beyond 1e-6. AdamW's first steps divide each gradient by
its own magnitude, so an element whose gradient is near zero moves by up
to ±lr on float32 noise in either package (measured: at most 2.1% of the
summed rates, on 2.1e-5 of the elements). The sLSTM's input-gate bias
(xlstm-350m's ``slstm/bi``) is left out of that check: it shifts every
step's input-gate preactivation alike, the cell's c/n is invariant to a
common scale of the input gates, so its exact gradient is 0 and both
packages' are float32 noise (at most 7.9e-10 in the reference here),
which AdamW turns into steps of up to ±lr in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro import checkpoint as ref_ckpt
from repro import configs as RC
from repro.launch.train import make_batch_fn as ref_batches
from repro.models import transformer as RT
from repro.optim.optimizers import adamw as ref_adamw
from repro.optim.schedules import linear_warmup_cosine as ref_lwc
from repro_torch import checkpoint as ckpt
from repro_torch import configs as C
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T

ARCHS = ["granite-moe-1b-a400m", "granite-8b"]
# the recurrent families (ssm, hybrid) through the same trainer
RECURRENT = ["xlstm-350m", "recurrentgemma-2b"]
# leaves whose exact gradient is 0, so that AdamW moves them on float32
# noise alone (module docstring): left out of the parameter check
NOISE_ONLY = {("blocks", "slstm", "bi")}
LR, STEPS = 3e-3, 3
GRAD_ATOL = 1e-5


def _cfgs(arch):
    return (RC.reduced(RC.get_arch(arch), d_model=64, vocab=64),
            C.reduced(C.get_arch(arch), d_model=64, vocab=64))


def _init(cfg_r, cfg, seed=0):
    params = RT.init_params(cfg_r, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg).load_jax_params(
        jax.tree.map(np.asarray, params))
    return params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads(arch):
    cfg_r, cfg = _cfgs(arch)
    params, model = _init(cfg_r, cfg, seed=1)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 64, (2, 16)).astype(np.int32)
    lab = rng.integers(0, 64, (2, 16)).astype(np.int32)
    lab[0, :3] = -1                       # masked labels
    (lr, mr), gr = jax.jit(jax.value_and_grad(
        lambda p: RT.train_loss(p, cfg_r, {"tokens": jnp.asarray(tok),
                                           "labels": jnp.asarray(lab)}),
        has_aux=True))(params)
    loss, met = T.train_loss(model, {"tokens": torch.as_tensor(tok).long(),
                                     "labels": torch.as_tensor(lab).long()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss), float(lr), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(met[k]), float(mr[k]), rtol=1e-5)
    assert (float(met["aux"]) > 0) == (cfg.moe is not None)
    got, want = model.jax_params(grads), jax.tree.map(np.asarray, gr)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    atol = GRAD_ATOL * max(np.abs(w).max() for w in jax.tree.leaves(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)


def test_remat_recomputes_each_block_to_the_same_bits():
    """``train_loss(..., remat=True)`` (each block under
    ``torch.utils.checkpoint``) gives the plain run's loss and gradients
    bit for bit: the backward recomputes the same forward."""
    cfg_r, cfg = _cfgs("granite-moe-1b-a400m")
    _, model = _init(cfg_r, cfg, seed=2)
    batch = TR.make_batch_fn(cfg, 2, 16, seed=4)()
    out = []
    for remat in (False, True):
        loss, _ = T.train_loss(model, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_cross_entropy_z_loss_and_mask():
    from repro.models.transformer import cross_entropy as ref_ce
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, (3, 5)).astype(np.int32)
    for z in (0.0, 1e-3):
        want = float(ref_ce(jnp.asarray(logits), jnp.asarray(labels),
                            z_loss=z))
        got = float(T.cross_entropy(torch.tensor(logits),
                                    torch.tensor(labels), z_loss=z))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    none = -np.ones((2, 3), np.int32)
    assert float(T.cross_entropy(torch.tensor(logits[:2, :3]),
                                 torch.tensor(none))) == 0.0


@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_three_adamw_steps_from_the_reference_init(arch):
    cfg_r, cfg = _cfgs(arch)
    params, model = _init(cfg_r, cfg)
    opt = ref_adamw(ref_lwc(LR, 10, STEPS))
    state = opt.init(params)
    next_batch = ref_batches(cfg_r, 2, 16)

    @jax.jit
    def step(p, s, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: RT.train_loss(q, cfg_r, b), has_aux=True)(p)
        u, s = opt.update(g, s, p)
        return jax.tree.map(jnp.add, p, u), s, loss
    ref_losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, next_batch())
        ref_losses.append(float(loss))
    losses, seconds, model = TR.train(cfg, steps=STEPS, batch=2, seq=16,
                                      lr=LR, device="cpu", model=model,
                                      say=lambda *a: None)
    assert len(seconds) == STEPS
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    summed_lr = sum(float(ref_lwc(LR, 10, STEPS)(jnp.int32(t)))
                    for t in range(1, STEPS + 1))
    diffs = [np.abs(a - np.asarray(b)) for (path, a), b in zip(
        jax.tree_util.tree_flatten_with_path(model.jax_params())[0],
        jax.tree.leaves(params)) if _keys(path) not in NOISE_ONLY]
    assert max(float(d.max()) for d in diffs) <= 0.05 * summed_lr
    n = sum(d.size for d in diffs)
    assert sum(int((d > 1e-6).sum()) for d in diffs) <= 1e-4 * n


def _keys(path):
    return tuple(k.key for k in path)


def test_batches_are_the_references():
    cfg_r, cfg = _cfgs("granite-moe-1b-a400m")
    a, b = ref_batches(cfg_r, 3, 9), TR.make_batch_fn(cfg, 3, 9)
    for _ in range(3):
        x, y = a(), b()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(np.asarray(x[k]), y[k].numpy())


def test_main_on_the_cpu_and_its_checkpoint_in_the_reference(tmp_path,
                                                            capsys):
    _main_and_its_checkpoint("granite-moe-1b-a400m", tmp_path, capsys)


@pytest.mark.parametrize("arch", RECURRENT)
def test_main_trains_the_recurrent_families(arch, tmp_path, capsys):
    _main_and_its_checkpoint(arch, tmp_path, capsys, steps=12)


def _main_and_its_checkpoint(arch, tmp_path, capsys, steps=30):
    """``main`` at the reduced config: the loss falls over ``steps``, and
    the checkpoint restores in the reference, whose forward runs on it."""
    d = str(tmp_path / "ck")
    losses = TR.main(["--device", "cpu", "--arch", arch, "--reduced",
                      "--steps", str(steps), "--batch", "4", "--seq", "32",
                      "--lr", "3e-3", "--log-every", "10", "--ckpt-dir",
                      d])
    out = capsys.readouterr().out
    assert len(losses) == steps and losses[-1] < losses[0]
    assert f"arch={arch}-reduced" in out and "saved" in out
    cfg_r = RC.reduced(RC.get_arch(arch))
    like = jax.eval_shape(lambda k: RT.init_params(cfg_r, k),
                          jax.random.PRNGKey(0))
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), like)
    assert ref_ckpt.latest_step(d) == steps
    got = ref_ckpt.restore_checkpoint(d, steps, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    mine = ckpt.restore_checkpoint(d, steps, jax.tree.map(np.asarray, like))
    for a, b, w in zip(jax.tree.leaves(got), jax.tree.leaves(mine),
                       jax.tree.leaves(like)):
        assert a.shape == w.shape and np.isfinite(np.asarray(a)).all()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reference's forward runs on the trained weights
    logits, aux = RT.forward(got, cfg_r, jnp.zeros((1, 4), jnp.int32))
    assert np.isfinite(np.asarray(logits)).all()


def test_train_on_a_model_axis_and_mains_refusals(tmp_path):
    """``main`` refuses an unknown arch and, by default, a host without a
    card; on two gloo ranks (``tests/_torch_mesh_prog.py``) the audio and
    vlm families, their seed-0 weights ``Transformer.shard``-ed and
    trained by ``train`` under ``model_parallel``, give every rank the 20
    AdamW losses of ``main``'s one process within rtol 1e-5."""
    import _torch_mesh_prog as prog
    with pytest.raises(KeyError, match="unknown arch"):
        TR.main(["--device", "cpu", "--arch", "no-such-arch", "--reduced"])
    train = {"steps": 20, "batch": 4, "seq": 32, "lr": 3e-3}
    archs = ("hubert-xlarge", "llama32-vision")
    ranks = prog.spawn(2, "train_sharded", {"runs": [
        {"arch": arch, "train": train} for arch in archs]}, tmp_path)
    for i, arch in enumerate(archs):
        want = TR.main(["--device", "cpu", "--arch", arch, "--reduced"]
                       + [a for k, v in train.items()
                          for a in (f"--{k}", str(v))])
        for rank in ranks:
            np.testing.assert_allclose(rank[i], want, rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TR.main(["--arch", "granite-moe", "--reduced", "--steps", "1"])
