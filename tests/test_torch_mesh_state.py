"""A mesh rank holds only its own lanes (ROADMAP C11), on two gloo ranks
of the CPU (``tests/_torch_mesh_prog.py``'s ``c11`` task).

Reduced-granite ``lm_tokens`` clients (4) on the 1-D ``(clients,)`` mesh
and on ``(1, 2)``, and ``mnist_feat`` MLP clients (5) in waves of 2 on the
1-D mesh. On every rank:

* no client's module holds parameter storage (every parameter ``meta``)
  and no client keeps a slice once the engine has stacked it;
* the rank owns the lanes of its client-axis block (rank 0 clients 0-1,
  rank 1 clients 2-3 on the 1-D mesh; every client on (1, 2); waves of 2
  over 5 clients give rank 0 clients 0, 2 and 4) and its stacked state
  is its lanes' share of the unsharded engine's bytes (half of every
  leaf on (1, 2));
* ``state_dict`` is whole on rank 0 alone, bit for bit the unsharded
  engine's after the same round on the 1-D mesh (within atol 1e-5 on
  (1, 2), whose model axis sums partial products in another order);
  rank 1 returns its own rows and slices, and each rank's state restores
  from what it returned, bit for bit.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_prog as prog
from _torch_resume_prog import FIXED_COSTS
from repro_torch.common.types import FedConfig
from repro_torch.core.methods import get_method
from repro_torch.core.protocol import engine_from_config, make_scheduler
from repro_torch.fed import simulator

torch.set_num_threads(min(2, torch.get_num_threads()))

LM = dict(dataset="lm_tokens", n_train=200, n_test=100)


def _kw(devices=0, shards=0, **kw):
    base = dict(num_clients=4, rounds=1, proxy_batch=64, batch_size=16,
                lr=1e-2, seed=0, engine="cohort", num_devices=devices,
                model_shards=shards)
    base.update(kw)
    return base


CASES = [  # (name, mesh kw, data, rounds, bitwise)
    ("1d-tokens", _kw(2), LM, 1, True),
    ("2d-tokens", _kw(2, 2), LM, 1, False),
    ("1d-waves-mlp", _kw(2, num_clients=5, wave_size=2, proxy_batch=120,
                         batch_size=32), dict(n_train=400, n_test=100), 1,
     True),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    items = [{"kw": kw, "rounds": rounds, "costs": FIXED_COSTS, **data}
             for _, kw, data, rounds, _ in CASES]
    return prog.spawn(2, "c11", {"items": items},
                      tmp_path_factory.mktemp("c11"), timeout=240)


def _unsharded(kw, data, rounds):
    kw = dict(kw, num_devices=0, model_shards=0)
    cfg = FedConfig(**kw)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, data.get("dataset", "mnist_feat"), n_train=data["n_train"],
        n_test=data["n_test"], device="cpu")
    engine = engine_from_config(clients, cfg)
    method = get_method(cfg.method)
    engine.learn_dres(cfg.seed)
    sched = make_scheduler(engine, server, method, cfg, x_test, y_test,
                           sim_phase_costs=FIXED_COSTS)
    logs = sched.run_rounds(0, rounds)
    return prog.strip(logs), engine.state_dict(), prog.state_bytes(engine)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_a_rank_holds_only_its_lanes(ranks, i):
    name, kw, data, rounds, bitwise = CASES[i]
    logs, whole, whole_bytes = _unsharded(kw, data, rounds)
    n = kw["num_clients"]
    for r, rec in enumerate(ranks):
        rec = rec[i]
        assert not any(any(s) for s in rec["member_storage"]), name
        assert not any(rec["left_shards"])
        assert rec["shards"] == [c in sum(rec["owned"], []) for c in range(n)]
        if kw["model_shards"] > 1:
            assert sorted(sum(rec["owned"], [])) == list(range(n))
        elif not kw.get("wave_size"):
            assert sum(rec["owned"], []) == [2 * r, 2 * r + 1]
        owned = len(sum(rec["owned"], []))
        if kw["model_shards"] > 1:
            assert rec["state_bytes"] * 2 == whole_bytes
        else:    # its lanes' share (waves of 2 over 5: rank 0 holds 3)
            assert rec["state_bytes"] * n == whole_bytes * owned
        assert rec["logs"] == ranks[0][i]["logs"]
        if bitwise:
            assert rec["logs"] == logs
        sd = rec["state_dict"]
        assert len(sd["clients"]) == n
        assert [e["cid"] for e in sd["clients"]] == list(range(n))
        if r == 0:
            assert "shard" not in sd
            for got, want in zip(sd["clients"], whole["clients"]):
                for part in ("params", "opt_state"):
                    assert got[part].keys() == want[part].keys()
                    for k in want[part]:
                        if bitwise:
                            np.testing.assert_array_equal(got[part][k],
                                                          want[part][k])
                        else:
                            np.testing.assert_allclose(
                                got[part][k], want[part][k], rtol=0,
                                atol=1e-5)
        else:
            assert "shard" in sd
            assert all(set(e) == {"cid", "rng"} for e in sd["clients"])
        # each rank's state restores from what its state_dict returned
        for a, b in zip(sum(rec["after_load"], []), sum(rec["before"], [])):
            np.testing.assert_array_equal(a, b)
        assert not any(any(s) for s in rec["member_storage_after"])
