"""The cohort engine over the 2-D ``(clients, model)`` mesh and more of
the engine on a mesh of ranks (gloo, CPU), against the unsharded engine.

Two worlds are spawned once each (``tests/_torch_mesh_prog.py``), of 2
and 4 ranks. Each runs:

* the three model-axis collectives under ``vmap``, alone and inside the
  reduced granite backbone on the ``(1, world)`` mesh, against the same
  backbone on whole leaves;
* reduced-granite ``lm_tokens`` on the ``(1, 2)`` and ``(2, 2)`` meshes,
  sync and overlap, C = 4 and 5 (the reference's token config: 4 heads
  and 1 kv head, so ``wk``/``wv`` split on head_dim and are gathered,
  the norms on d): within atol 1e-5 of the unsharded run (the model axis
  sums partial products in another order); accuracy, ID fraction, bytes,
  participants and simulated times equal;
* in the world of 2: waves (C = 5 in waves of 2 on the 1-D mesh, bitwise
  the unwaved unsharded run; the MLP zoo on (1, 2) in waves of 3, its
  split leaves gathered whole for the forward), selective-fd (KuLSIF-DRE)
  and partial participation under overlap with measured phase costs,
  whose simulated timeline every rank takes from rank 0's clock;
* every rank's round logs equal, apart from ``wall_s``/``phase_s``;
* per-rank state bytes at model shards 1, 2 and 4 on one client row,
  counted from the tensors.

The unsharded runs are the port's own: the unsharded token cohort is held
to the live reference in ``tests/test_torch_token_cohort.py``.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_prog as prog
from _torch_resume_prog import FIXED_COSTS
from repro_torch.common.types import FedConfig
from repro_torch.core.protocol import as_engine, engine_from_config
from repro_torch.fed import simulator

torch.set_num_threads(min(2, torch.get_num_threads()))

TOL = dict(rtol=0.0, atol=1e-5)
# (world, model_shards, clients, round mode)
TOKEN_CASES = [(2, 2, 4, "sync"), (2, 2, 4, "overlap"),
               (4, 2, 4, "sync"), (4, 2, 5, "overlap")]
LM = dict(dataset="lm_tokens", n_train=200, n_test=100)


def _token_kw(clients, mode, devices=0, shards=0):
    return dict(num_clients=clients, rounds=2, proxy_batch=64,
                batch_size=16, lr=1e-2, seed=0, engine="cohort",
                round_mode=mode, num_devices=devices, model_shards=shards)


def _extra_kw(**kw):
    base = dict(num_clients=4, rounds=2, method="edgefd", scenario="strong",
                seed=0, engine="cohort", proxy_batch=120, batch_size=32,
                lr=1e-2, round_mode="sync")
    base.update(kw)
    return base


# the world of 2's further cases: (name, its config on the mesh, the
# unsharded config it is held to, fixed costs or measured, bitwise)
EXTRA_CASES = [
    ("waves-1d", _extra_kw(num_clients=5, wave_size=2, num_devices=2),
     _extra_kw(num_clients=5), FIXED_COSTS, True),
    ("waves-2d-mlp", _extra_kw(wave_size=3, num_devices=2, model_shards=2),
     _extra_kw(), FIXED_COSTS, False),
    ("selective-fd", _extra_kw(method="selective-fd", num_devices=2),
     _extra_kw(method="selective-fd"), FIXED_COSTS, True),
    ("measured-overlap", _extra_kw(round_mode="overlap",
                                   participation_fraction=0.75,
                                   staleness_decay=0.5, num_devices=2),
     _extra_kw(round_mode="overlap", participation_fraction=0.75,
               staleness_decay=0.5), None, True),
]


def _items(world):
    items = [{"kw": _token_kw(c, mode, world, ms), "costs": FIXED_COSTS,
              **LM} for w, ms, c, mode in TOKEN_CASES if w == world]
    if world == 2:
        items += [{"kw": kw, "costs": costs}
                  for _, kw, _, costs, _ in EXTRA_CASES]
    # state bytes on one client row: model shards = world
    items.append({"kw": _token_kw(4, "sync", world, world),
                  "bytes_only": True, **LM})
    return items


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {world: prog.spawn(
        world, "many", {"tasks": [("collectives", {"model_shards": world}),
                                  ("run", {"items": _items(world)})]},
        tmp_path_factory.mktemp(f"world{world}"), timeout=300)
        for world in (2, 4)}


def _runs(worlds, world):
    return [r[1] for r in worlds[world]]        # per rank: the run items


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_under_vmap_match_the_unsharded_layer(worlds, world):
    """On the (1, world) mesh: the backbone's outputs and every leaf's
    gradient (gathered whole) equal the unsharded backbone's within fp32
    rounding; each collective alone has the forward and the gradient its
    definition gives."""
    m = world
    for idx, rank in enumerate(worlds[world]):
        r = rank[0]
        np.testing.assert_allclose(r["out"], r["out_ref"], rtol=1e-5,
                                   atol=1e-5)
        assert r["loss"] == pytest.approx(r["loss_ref"], rel=1e-6)
        for name, g, gr in zip(r["names"], r["grads"], r["grads_ref"]):
            np.testing.assert_allclose(g, gr, rtol=1e-4,
                                       atol=1e-5 * np.abs(gr).max(),
                                       err_msg=name)
        x = r["x"]
        a, b, c = r["coll"]
        s = m * (m + 1) / 2                       # sum over ranks of idx + 1
        np.testing.assert_allclose(a, x * (idx + 1), rtol=1e-6)
        np.testing.assert_allclose(b, x * s, rtol=1e-6)
        np.testing.assert_allclose(
            c, np.concatenate([x * (j + 1) for j in range(m)], axis=2),
            rtol=1e-6)
        want = s + 2 * x * s * (idx + 1) + 2 * x * (idx + 1) ** 2
        np.testing.assert_allclose(r["coll_grad"], want, rtol=1e-5,
                                   atol=1e-5)
    if world == 2:
        # the reference's token config: wk/wv split on head_dim, the
        # norms on d
        names = dict(zip(worlds[2][0][0]["names"],
                         worlds[2][0][0]["splits"]))
        assert names["backbone.blocks.0.attn.wk"] == 2
        assert names["backbone.blocks.0.ln1.scale"] == 0


@pytest.mark.parametrize("case", TOKEN_CASES,
                         ids=[f"w{w}-m{m}-C{c}-{mode}"
                              for w, m, c, mode in TOKEN_CASES])
def test_token_mesh_matches_unsharded(worlds, case):
    """Reduced granite on the (clients, model) mesh: within atol 1e-5 of
    the unsharded cohort engine; accuracy, ID fraction, bytes,
    participants and simulated times equal."""
    world, shards, clients, mode = case
    idx = [t for t in TOKEN_CASES if t[0] == world].index(case)
    got = _runs(worlds, world)[0][idx]
    assert got["mesh"] == {"clients": world // shards, "model": shards}
    want = prog.port_logs(_token_kw(clients, mode), costs=FIXED_COSTS, **LM)
    assert len(got["logs"]) == len(want)
    for g, w in zip(got["logs"], want):
        for f in ("local_loss", "distill_loss"):
            np.testing.assert_allclose(g[f], getattr(w, f), **TOL)
        for f in ("accs", "id_fraction", "bytes_up", "bytes_down",
                  "participants", "sim_finish_s", "served_model_age_s"):
            assert g[f] == getattr(w, f), f


@pytest.mark.parametrize("case", EXTRA_CASES, ids=[c[0] for c in EXTRA_CASES])
def test_more_of_the_engine_on_the_mesh(worlds, case):
    """Waves, KuLSIF-DRE and measured-cost overlap on the world of 2:
    bitwise the unsharded run where the mesh is 1-D (the simulated
    timeline apart under measured costs), within atol 1e-5 on (1, 2)."""
    name, _, kw, costs, bitwise = case
    n_tok = len([t for t in TOKEN_CASES if t[0] == 2])
    got = _runs(worlds, 2)[0][n_tok + [c[0] for c in EXTRA_CASES]
                              .index(name)]
    want = prog.port_logs(kw, costs=costs)
    timing = () if costs else ("sim_finish_s", "served_model_age_s")
    if bitwise:
        assert [{k: v for k, v in lg.items() if k not in timing}
                for lg in prog.strip(got["logs"])] == [
            {k: v for k, v in lg.items() if k not in timing}
            for lg in prog.strip(want)]
        return
    for g, w in zip(got["logs"], want):
        for f in ("local_loss", "distill_loss"):
            np.testing.assert_allclose(g[f], getattr(w, f), **TOL)
        for f in ("accs", "id_fraction", "bytes_up", "participants"):
            assert g[f] == getattr(w, f), f


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_logs(worlds, world):
    """Every rank's round logs and trace equal, apart from the measured
    ``wall_s`` and ``phase_s`` (under measured costs the simulated
    timeline too: it is rank 0's)."""
    ranks = _runs(worlds, world)
    for item in range(len(ranks[0])):
        if "logs" not in ranks[0][item]:
            continue
        first = prog.strip(ranks[0][item]["logs"])
        for r in ranks[1:]:
            assert prog.strip(r[item]["logs"]) == first
            assert r[item]["trace"] == ranks[0][item]["trace"]


def test_state_bytes_shrink_per_shard_doubling(worlds):
    """One client row of 4 reduced-granite clients at model shards 1, 2
    and 4: each doubling sheds at least 1.3x of each rank's stacked
    parameters and momentum (``benchmarks/fd_transformer.py``'s gate)."""
    cfg = FedConfig(**_token_kw(4, "sync", devices=1))
    clients, *_ = simulator.build_experiment(
        cfg, "lm_tokens", n_train=LM["n_train"], n_test=LM["n_test"],
        device="cpu")
    one = prog.state_bytes(engine_from_config(clients, cfg))
    two, four = (max(r[-1]["state_bytes"] for r in _runs(worlds, w))
                 for w in (2, 4))
    assert _runs(worlds, 4)[0][-1]["mesh"] == {"clients": 1, "model": 4}
    assert one / two >= 1.3 and two / four >= 1.3, (one, two, four)


def test_model_shards_env_is_inert_without_mesh(monkeypatch):
    """$REPRO_MODEL_SHARDS never changes a meshless run."""
    kw = dict(_token_kw(3, "sync"), rounds=1)
    base = prog.port_logs(kw, costs=FIXED_COSTS, **LM)
    monkeypatch.setenv("REPRO_MODEL_SHARDS", "2")
    under_env = prog.port_logs(kw, costs=FIXED_COSTS, **LM)
    assert prog.strip(base) == prog.strip(under_env)


def test_engine_from_config_builds_the_2d_mesh(worlds):
    """``FedConfig.model_shards`` reaches the cohort engine's mesh; the
    loop engine rejects it legibly."""
    with pytest.raises(ValueError, match="cohort"):
        as_engine(simulator.build_experiment(
            FedConfig(num_clients=2, rounds=1), "mnist_feat", n_train=120,
            n_test=40, device="cpu")[0], "loop", model_shards=2)
    for rank in _runs(worlds, 4):
        assert rank[0]["mesh"] == {"clients": 2, "model": 2}
