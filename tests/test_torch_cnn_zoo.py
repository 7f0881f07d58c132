"""The port's Tables I/II CNN zoo (``repro_torch.models.cnn``) against the
JAX reference's (``repro.models.cnn``), on the CPU.

Every one of the 20 client architectures is built by the port, loaded with
the reference's ``spec.init`` parameters through ``load_jax_params`` and
fed the same NHWC batch: the logits in train mode (BatchNorm on the
batch's statistics) and in eval mode (the stored ones), and the gradients
of one CE step, hold to rtol 1e-4 / atol 1e-5 (f32 convolutions and
matmuls summed in another order by two libraries; measured at most 0.17
of that tolerance, on the deepest CIFAR net). Also: ``init_conv``'s
shapes and statistics, the zoo's heterogeneity, BatchNorm never updating
its buffers, the load's refusals and the fp32 pin of the entry points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as ref_distill
from repro.models import cnn as ref_cnn
from repro_torch.common.pytree import init_conv
from repro_torch.core import distill
from repro_torch.fed import simulator
from repro_torch.launch import fed_train
from repro_torch.models import cnn

TOL = dict(rtol=1e-4, atol=1e-5)
SLOTS = [(ds, i) for ds in ("mnist", "cifar10") for i in range(10)]


def _port_grads_layout(spec, grads):
    """The reference's per-layer gradients in the port's parameter order
    and layout (conv OIHW; BN scale and bias only: its mean and var are
    buffers in the port, and their reference gradients are zero)."""
    out = []
    for layer, g in zip(spec.layers, grads):
        if layer[0] == "conv":
            out += [np.transpose(np.asarray(g["w"]), (3, 2, 0, 1)), g["b"]]
        elif layer[0] == "bn":
            assert not np.any(np.asarray(g["mean"]))
            assert not np.any(np.asarray(g["var"]))
            out += [g["scale"], g["bias"]]
        else:
            out += [g["w"], g["b"]]
    return [np.asarray(v) for v in out]


def _reference_and_port(ds, slot):
    spec, hw, ch = ref_cnn.get_client_model(slot, ds)
    params = spec.init(jax.random.PRNGKey(slot), hw, ch)
    pspec, phw, pch = cnn.get_client_model(slot, ds)
    assert (phw, pch) == (hw, ch) and pspec.layers == spec.layers
    model = pspec.build(hw, ch).load_jax_params(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(slot)
    x = np.tanh(rng.standard_normal((4, hw, hw, ch))).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    return spec, params, model, x, y


@pytest.mark.parametrize("ds,slot", SLOTS)
def test_client_cnn_forward_matches_reference(ds, slot):
    spec, params, model, x, _ = _reference_and_port(ds, slot)
    for train in (True, False):
        want = np.asarray(spec.apply(params, jnp.asarray(x), train))
        model.train(train)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == (4, 10)
        np.testing.assert_allclose(got, want, err_msg=f"train={train}", **TOL)


@pytest.mark.parametrize("ds,slot", SLOTS)
def test_client_cnn_ce_gradients_match_reference(ds, slot):
    spec, params, model, x, y = _reference_and_port(ds, slot)
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: ref_distill.ce_loss(spec.apply(p, jnp.asarray(x), True),
                                      jnp.asarray(y)))(params)
    model.train(True)
    loss = distill.ce_loss(model(torch.from_numpy(x)),
                           torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), **TOL)
    want = _port_grads_layout(spec, g_ref)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"parameter {i}",
                                   **TOL)


def test_init_conv_shapes_and_statistics():
    p = init_conv(16, 64, 3, generator=torch.Generator().manual_seed(0))
    assert p["w"].shape == (64, 16, 3, 3) and p["w"].dtype == torch.float32
    assert p["b"].shape == (64,) and not bool(p["b"].any())
    std = (2.0 / (16 * 3 * 3)) ** 0.5
    assert abs(float(p["w"].std()) / std - 1.0) < 0.03
    assert abs(float(p["w"].mean())) < 0.03 * std
    again = init_conv(16, 64, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(p["w"], again["w"])


def test_architectures_are_heterogeneous():
    """As the reference's zoo: parameter counts differ across the ten
    Table I slots, and the port's counts equal the reference's."""
    counts = []
    for ds in ("mnist", "cifar10"):
        for idx in range(10):
            spec, hw, ch = ref_cnn.get_client_model(idx, ds)
            ref = sum(int(np.prod(leaf.shape))
                      for p in spec.init(jax.random.PRNGKey(0), hw, ch)
                      for leaf in jax.tree.leaves(p))
            model = cnn.get_client_model(idx, ds)[0].build(hw, ch)
            port = sum(t.numel() for t in model.parameters()) + sum(
                t.numel() for t in model.buffers())
            assert port == ref, (ds, idx)
            counts.append(ref)
    assert len(set(counts[:10])) >= 6, counts


def test_batchnorm_uses_batch_statistics_and_never_updates():
    spec, _, model, x, _ = _reference_and_port("cifar10", 2)
    bn = [m for m in model.modules() if isinstance(m, cnn._BatchNorm)]
    assert bn and all(not b.mean.requires_grad for b in bn)
    model.train(True)
    with torch.no_grad():
        train = model(torch.from_numpy(x))
    for b in bn:
        assert not bool(b.mean.any()) and bool((b.var == 1).all())
    model.eval()
    with torch.no_grad():
        assert not torch.allclose(model(torch.from_numpy(x)), train)


def test_load_refuses_another_architecture():
    spec, hw, ch = ref_cnn.get_client_model(0, "mnist")
    params = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(0), hw, ch))
    other = cnn.get_client_model(7, "mnist")[0].build(hw, ch)
    with pytest.raises(ValueError, match="conv w"):
        other.load_jax_params(params)
    deeper = cnn.get_client_model(1, "mnist")[0].build(hw, ch)
    with pytest.raises(ValueError, match="layers given"):
        deeper.load_jax_params(params)


@pytest.mark.parametrize("entry", ["fed_train", "simulator.run"])
def test_image_entry_points_pin_fp32_convolutions(entry):
    """cuDNN's TF32 default is turned off by every entry of the image path
    (the CLI and ``simulator.run``, through ``build_experiment``)."""
    torch.backends.cudnn.allow_tf32 = True
    if entry == "fed_train":
        fed_train.main(["--dataset", "mnist_like", "--clients", "2",
                        "--rounds", "1", "--n-train", "200", "--n-test",
                        "50", "--device", "cpu"])
    else:
        cfg = simulator.FedConfig(num_clients=2, rounds=1)
        simulator.run(cfg, "mnist_like", n_train=200, n_test=50,
                      device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("name", ["mnist_like", "fashion_like", "cifar_like"])
def test_image_datasets_follow_the_reference_spec(name):
    """The image specs carry the reference's separation, spread, latent
    width and image shape; the port's draws (a torch generator) render as
    NHWC float32 pixels in [-1, 1] (tanh, saturating in f32), the same
    for the same seed, and
    ``dataset_from_arrays`` keeps such arrays as they are."""
    import dataclasses

    from repro.data.synthetic import SPECS as REF_SPECS
    from repro_torch.data import synthetic
    assert (dataclasses.asdict(synthetic.SPECS[name])
            == dataclasses.asdict(REF_SPECS[name]))
    synthetic.check_dataset(name)
    ds = synthetic.make_dataset(name, n_train=300, n_test=40, seed=2)
    spec = synthetic.SPECS[name]
    hw, ch = spec.image_hw, spec.channels
    assert ds.x.shape == (300, hw, hw, ch) and ds.x.dtype == np.float32
    assert ds.x_test.shape == (40, hw, hw, ch)
    assert float(np.abs(ds.x).max()) <= 1.0 and ds.y.dtype == np.int32
    again = synthetic.make_dataset(name, n_train=300, n_test=40, seed=2)
    np.testing.assert_array_equal(ds.x, again.x)
    wrapped = synthetic.dataset_from_arrays(ds.x.astype(np.float64), ds.y,
                                            ds.x_test, ds.y_test, 10)
    assert wrapped.x.shape == ds.x.shape and wrapped.x.dtype == np.float32
    with pytest.raises(KeyError, match="unknown dataset"):
        synthetic.check_dataset("imagenet_like")
