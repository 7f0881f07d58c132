"""The cohort engine over a 1-D mesh of ranks (gloo, CPU) against the
unsharded engine and the live JAX reference.

Two worlds are spawned once each (``tests/_torch_mesh_prog.py``: a file
store in a temporary directory, one torch thread a rank), of 2 and 4
ranks. Each runs edgefd strong on ``mnist_feat`` over the 1-D client mesh,
built from the reference's arrays, C = 4 (sync) and C = 5 (overlap:
client-axis padding, dummy lanes): round logs bitwise the port's unsharded
cohort run, and within the harness's tolerances of the live reference
(``_torch_parity.check_logs``), trace and simulated times included; every
rank's logs equal, apart from ``wall_s``/``phase_s``. The world of 2 also
runs ``masked_mean_logits_psum`` against the reference's under
``jax.vmap(..., axis_name=...)``. The model axis's cases are in
``tests/test_torch_mesh_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_prog as prog
from _torch_parity import (FIXED_COSTS, Run, _Result, check_logs,
                           cohort_config, run_port, run_reference)
from repro.core.aggregation import \
    masked_mean_logits_psum as ref_masked_mean_logits_psum
from repro_torch.core.protocol import RoundLog

FEATURE_CASES = {"C4-sync": (4, "sync"), "C5-overlap": (5, "overlap")}
PSUM_RNG = np.random.default_rng(3)
PSUM_LOGITS = PSUM_RNG.normal(size=(2, 6, 5)).astype(np.float32)
PSUM_MASKS = PSUM_RNG.random((2, 6)) < 0.5


def _feature_kw(clients, mode, devices=0):
    return cohort_config("edgefd", "strong", num_clients=clients,
                         round_mode=mode, num_devices=devices)


def _arrays(ref):
    ds = ref.dataset
    return {"dataset": (ds.x, ds.y, ds.x_test, ds.y_test, ds.num_classes),
            "params": ref.params, "kmeans_inits": ref.kmeans_inits,
            "kulsif_aux": ref.kulsif_aux,
            "student_params": ref.student_params}


@pytest.fixture(scope="module")
def references():
    """The live reference runs of the feature cases, and the port's
    unsharded cohort runs built from their arrays."""
    out = {}
    for name, (c, mode) in FEATURE_CASES.items():
        kw = _feature_kw(c, mode)
        ref = run_reference(kw, sim_phase_costs=FIXED_COSTS)
        out[name] = (kw, ref, run_port(kw, ref, FIXED_COSTS))
    return out


@pytest.fixture(scope="module")
def worlds(references, tmp_path_factory):
    out = {}
    for world in (2, 4):
        items = [{"kw": _feature_kw(c, mode, devices=world),
                  "arrays": _arrays(references[name][1]),
                  "costs": FIXED_COSTS}
                 for name, (c, mode) in sorted(FEATURE_CASES.items())]
        tasks = [("run", {"items": items})]
        if world == 2:
            tasks.append(("psum", {"logits": PSUM_LOGITS,
                                   "masks": PSUM_MASKS}))
        out[world] = prog.spawn(world, "many", {"tasks": tasks},
                                tmp_path_factory.mktemp(f"world{world}"),
                                timeout=300)
    return out


def test_masked_mean_logits_psum_matches_the_reference(worlds):
    """Two ranks, one client each: the two all-reduces give the
    reference's masked mean under ``jax.vmap(axis_name=...)``."""
    want_t, want_v = jax.vmap(
        lambda lo, m: ref_masked_mean_logits_psum(lo, m, "data"),
        axis_name="data")(jnp.asarray(PSUM_LOGITS), jnp.asarray(PSUM_MASKS))
    for rank in worlds[2]:
        teacher, valid = rank[1]
        np.testing.assert_allclose(teacher, np.asarray(want_t[0]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(valid, np.asarray(want_v[0]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_feature_mesh_matches_unsharded_and_reference(worlds, references,
                                                      world, case):
    """1-D client mesh, edgefd strong on mnist_feat: bitwise the port's
    unsharded cohort run, final parameters too, and within the harness's
    tolerances of the live reference (trace and simulated times too)."""
    kw, ref, port = references[case]
    got = worlds[world][0][0][sorted(FEATURE_CASES).index(case)]
    assert got["mesh"] == {"clients": world}
    assert prog.strip(got["logs"]) == prog.strip(port.result.rounds)
    sharded = Run(_Result([RoundLog(**lg) for lg in got["logs"]]),
                  port.clients, port.server,
                  trace=[tuple(k) for k in got["trace"]])
    check_logs(kw, ref, sharded, sim_phase_costs=FIXED_COSTS)
    for c, params in enumerate(got["params"]):
        for p, q in zip(params, port.clients[c].params):
            np.testing.assert_array_equal(p, q.detach().numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_logs(worlds, world):
    """Every rank's round logs and trace equal, apart from the measured
    ``wall_s`` and ``phase_s``; every rank's clients end with the same
    parameters (the final sync gathers the state)."""
    ranks = [r[0] for r in worlds[world]]
    for item in range(len(ranks[0])):
        first = ranks[0][item]
        for r in ranks[1:]:
            assert prog.strip(r[item]["logs"]) == prog.strip(first["logs"])
            assert r[item]["trace"] == first["trace"]
            for a, b in zip(r[item]["params"], first["params"]):
                for p, q in zip(a, b):
                    np.testing.assert_array_equal(p, q)
