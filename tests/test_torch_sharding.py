"""The port's ``launch/mesh.param_spec`` against the reference's, and the
logical-rule tables of ``models/sharding.py``.

``param_spec`` is pure (a leaf's shape, its name and the mesh's ``shape``
and ``axis_names``), so both packages' functions run on one duck-typed
mesh: every leaf of every ``configs.ARCHS`` entry (the reference's
``init_params`` shapes, by ``jax.eval_shape``) at model in {1, 2, 4, 16}
and data in {1, 16}, with and without FSDP, and the reference's
Hypothesis property (``tests/test_sharding.py``).
"""
import jax
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS
from repro.launch import mesh as RM
from repro.models import sharding as RS
from repro.models import transformer as RT
from repro_torch.fed import mesh as FM
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as S


class FakeMesh:
    """Duck-typed mesh for spec derivation without devices."""
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _leaves(arch):
    shapes = jax.eval_shape(lambda k: RT.init_params(arch, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(shapes)[0]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_spec_equals_the_reference_on_every_arch(name):
    leaves = _leaves(ARCHS[name])
    for model in (1, 2, 4, 16):
        for data in (1, 16):
            mesh = FakeMesh(data=data, model=model)
            for path, leaf in leaves:
                keys = [getattr(p, "key", getattr(p, "idx", None))
                        for p in path]
                depth = M._stack_depth(keys)
                assert depth == RM._stack_depth(path), keys
                leaf_name = M._leaf_name(keys)
                for fsdp in (True, False):
                    got = M.param_spec(tuple(leaf.shape), mesh,
                                       n_stack_axes=depth, fsdp=fsdp,
                                       name=leaf_name)
                    want = RM.param_spec(tuple(leaf.shape), mesh,
                                         n_stack_axes=depth, fsdp=fsdp,
                                         name=leaf_name)
                    assert tuple(got) == tuple(want), (
                        keys, leaf.shape, model, data, fsdp)


@settings(max_examples=40, deadline=None)
@given(dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
       model=st.sampled_from([1, 4, 16]), data=st.sampled_from([1, 4, 16]))
def test_param_spec_always_divisible(dims, model, data):
    """Property: whatever the shape, assigned axes divide evenly, each is
    used at most once, and the reference assigns the same."""
    mesh = FakeMesh(data=data, model=model)
    spec = M.param_spec(tuple(dims), mesh)
    for d, axis in zip(dims, spec):
        if axis == "model":
            assert d % model == 0
        if axis == "data":
            assert d % data == 0
    axes = [a for a in spec if a]
    assert len(axes) == len(set(axes))
    assert tuple(spec) == tuple(RM.param_spec(tuple(dims), mesh))


def test_rule_tables_and_logical_spec_match_the_reference():
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES
    assert S.PROFILES == RS.PROFILES
    mesh = FakeMesh(clients=2, model=2)
    with S.logical_rules(S.DEFAULT_RULES, mesh):
        got = S.logical_spec("batch", "heads", None, "ff")
        assert S.get_mesh() is mesh
        x = object()
        assert S.constrain(x, "batch") is x      # no GSPMD: the identity
    with RS.logical_rules(RS.DEFAULT_RULES, mesh):
        want = RS.logical_spec("batch", "heads", None, "ff")
    assert tuple(got) == tuple(want) == (None, "model", None, "model")
    assert S.logical_spec("batch") is None and S.get_mesh() is None


def test_split_dims_of_the_token_backbone():
    """At the reference's token config on a model axis of 2 (4 heads, 1
    kv head): wq splits on heads, wk/wv on head_dim, the norms on d."""
    mesh = FM.ClientMesh((1, 2), ("clients", "model"))
    split = {n: FM.model_split(n, shape, mesh) for n, shape in
             {"wq": (64, 4, 16), "wk": (64, 1, 16), "wo": (4, 16, 64),
              "scale": (64,), "embed": (32, 64), "lm_head": (64, 32),
              "wg": (64, 192), "wd": (192, 64)}.items()}
    assert split == {"wq": 1, "wk": 2, "wo": 0, "scale": 0, "embed": 0,
                     "lm_head": 1, "wg": 1, "wd": 0}


def test_batch_spec_and_placements_match_the_reference():
    """``batch_spec`` as the reference's on each layout; ``param_shardings``
    and ``opt_state_shardings`` place each leaf by ``param_spec`` (the
    latter with 'data' on a remaining divisible dim, ZeRO-style)."""
    for axes in ({"data": 4, "model": 2}, {"pod": 2, "data": 4, "model": 2},
                 {"clients": 2, "model": 2}):
        mesh = FakeMesh(**axes)
        for shard in (True, False):
            assert tuple(M.batch_spec(mesh, shard_batch=shard)) == tuple(
                RM.batch_spec(mesh, shard_batch=shard))
    mesh = FakeMesh(data=4, model=2)
    leaves = {"embed": jax.ShapeDtypeStruct((32, 64), "float32"),
              "blocks": {"wq": jax.ShapeDtypeStruct((2, 64, 4, 16),
                                                    "float32")}}
    params = M.param_shardings(leaves, mesh)
    assert tuple(params["embed"].spec) == ("model", "data")
    assert tuple(params["blocks"]["wq"].spec) == (None, "data", "model", None)
    opt = M.opt_state_shardings(leaves, mesh)
    assert tuple(opt["blocks"]["wq"].spec) == (None, "data", "model", None)
    data = M.data_shardings({"x": jax.ShapeDtypeStruct((8, 16), "int32")},
                            mesh)
    assert tuple(data["x"].spec) == ("data", None)


def test_the_launcher_meshes_name_the_launcher():
    """A pod layout in a world of one rank raises, naming the launcher."""
    with pytest.raises(ValueError, match="torch.distributed.run"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="torch.distributed.run"):
        M.make_debug_mesh(2, 1)
    assert M.make_debug_mesh(1, 1).shape == {"data": 1, "model": 1}
