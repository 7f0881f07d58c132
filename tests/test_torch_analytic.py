"""``repro_torch.launch.analytic`` against the reference's
``repro.launch.analytic``: ``step_cost`` bit for bit on every ARCHS x
SHAPES cell, with no window and the long-context window, at both AdamW
widths; and the counterparts of the reference's analytic tests
(``tests/test_sharding.py``)."""
import ast
import itertools
import os

import pytest

from repro import configs as RC
from repro.launch import analytic as RA
from repro_torch import configs as C
from repro_torch.launch import analytic as A
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M

CELLS = list(itertools.product(sorted(C.ARCHS), sorted(C.SHAPES)))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_cost_is_the_references_bit_for_bit(arch, shape):
    """Every (window, optimizer bytes) pair: flops, hbm_bytes and each
    detail entry equal as floats (``==`` on the same value and type)."""
    for window, opt in itertools.product((None, D.LONG_WINDOW), (4.0, 8.0)):
        got = A.step_cost(C.get_arch(arch), C.SHAPES[shape], window=window,
                          opt_bytes_per_param=opt)
        want = RA.step_cost(RC.get_arch(arch), RC.SHAPES[shape],
                            window=window, opt_bytes_per_param=opt)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
        assert type(got.flops) is type(want.flops)
        assert got.detail == want.detail
        assert [type(v) for v in got.detail.values()] == \
            [type(v) for v in want.detail.values()]


def test_the_long_window_and_skips_are_the_references():
    """Read from the reference's source: importing it sets XLA_FLAGS for
    512 host devices, which would reach every later JAX test of this
    process."""
    path = os.path.join(os.path.dirname(RA.__file__), "dryrun.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id in ("LONG_WINDOW", "SKIPS")}
    assert consts == {"LONG_WINDOW": D.LONG_WINDOW, "SKIPS": D.SKIPS}


def test_analytic_cost_model_scales():
    qwen = C.get_arch("qwen2.5-3b")
    llama = C.get_arch("llama3-405b")
    tr = C.SHAPES["train_4k"]
    c_q = A.step_cost(qwen, tr)
    c_l = A.step_cost(llama, tr)
    # 405b must cost ~2 orders of magnitude more compute than 3b
    assert c_l.flops / c_q.flops > 50
    # train flops ≈ 6·N·T
    t = tr.global_batch * tr.seq_len
    assert c_q.flops == pytest.approx(6 * qwen.active_param_count() * t,
                                      rel=0.35)


def test_analytic_decode_memory_dominated_by_params_or_cache():
    cfg = C.get_arch("llama3-405b")
    c = A.step_cost(cfg, C.SHAPES["decode_32k"])
    assert c.detail["param_bytes"] + c.detail["cache_bytes"] == \
        pytest.approx(c.hbm_bytes - C.SHAPES["decode_32k"].global_batch
                      * cfg.vocab_size * 2)


def test_production_layouts_are_the_references():
    assert M.production_layout() == ((16, 16), ("data", "model"))
    assert M.production_layout(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="torch.distributed.run"):
        M.make_production_mesh()


def test_make_debug_mesh_single_device():
    mesh = M.make_debug_mesh(1, 1)
    assert mesh.shape == {"data": 1, "model": 1}
