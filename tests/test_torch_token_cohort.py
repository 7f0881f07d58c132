"""Token (transformer) clients on the port's cohort engine.

At ``tests/test_torch_lm_tokens.py``'s sizes: the reduced granite backbone,
3 clients, 2 rounds, proxy batch 64, batch 16, n_train 300, n_test 150,
on the CPU through the plain PyTorch versions. The cohort runs every
lane's transformer as one ``vmap`` over ``functional_call``; on the card
the flash-attention kernel's ``vmap`` rule folds the client axis into its
batch (checked here with the launch replaced by the plain version).

* against the live reference cohort engine, within the harness's
  tolerances (``tests/_torch_parity.py``);
* against the port's loop engine from the same arrays: losses within
  rtol 1e-5 (the reference's own ``tests/test_fd_transformer.py`` holds
  its engines to atol 1e-5), accuracies, ID fraction and bytes equal;
* bit for bit at four threads: the embedding's gradient under ``vmap``
  (a product with one-hot rows, ``models.transformer.Transformer.lookup``)
  and whole runs, waved and unwaved;
* the scheduler, the resumable state and FedDF's transformer student on
  token cohorts.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.func import vmap

from _torch_parity import (check_logs, cohort_config, run_port,
                           run_reference)
from _torch_resume_prog import build_sched, snapshots, strip
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.common.types import FedConfig
from repro_torch.core.fd_trainer import TransformerClientModel
from repro_torch.core.protocol import run_experiment
from repro_torch.fed import simulator
from repro_torch.fed.cohort import CohortEngine
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

N_TRAIN, N_TEST = 300, 150
SIZES = dict(num_clients=3, rounds=2, proxy_batch=64, batch_size=16, lr=1e-2)
ENGINE_RTOL = 1e-5
# host-clock fields: the simulated timeline is priced from the measured
# phase seconds
TIMING = ("wall_s", "phase_s", "sim_finish_s", "served_model_age_s")


@functools.cache
def _reference(scenario):
    """One live reference cohort run a scenario, shared by the tests."""
    kw = cohort_config("edgefd", scenario, **SIZES)
    return kw, run_reference(kw, "lm_tokens", N_TRAIN, N_TEST)


@functools.cache
def _port(scenario, engine):
    """The port's run of ``_reference(scenario)``'s experiment on
    ``engine``."""
    kw, ref = _reference(scenario)
    return run_port(dict(kw, engine=engine), ref)


def _logs(res):
    return [{k: v for k, v in dataclasses.asdict(lg).items()
             if k not in TIMING} for lg in res.rounds]


def _assert_engines_agree(a, b):
    """Two runs of one experiment on the two engines: losses within
    ENGINE_RTOL, everything else that is not host timing equal."""
    assert len(a.rounds) == len(b.rounds)
    for p, q in zip(a.rounds, b.rounds):
        for f in ("local_loss", "distill_loss", "server_distill_loss"):
            np.testing.assert_allclose(getattr(p, f), getattr(q, f),
                                       rtol=ENGINE_RTOL, err_msg=f)
        assert p.accs == q.accs
        assert p.server_student_acc == q.server_student_acc
        assert p.id_fraction == q.id_fraction
        assert (p.bytes_up, p.bytes_down) == (q.bytes_up, q.bytes_down)
        assert p.participants == q.participants
        assert p.mean_staleness == q.mean_staleness


def _cfg(**kw):
    base = dict(method="edgefd", scenario="strong", engine="cohort", seed=0,
                **SIZES)
    base.update(kw)
    return FedConfig(**base)


def _run(cfg):
    return simulator.run(cfg, "lm_tokens", n_train=N_TRAIN, n_test=N_TEST,
                         device="cpu")


@pytest.mark.parametrize("scenario", ["strong", "weak"])
def test_token_cohort_matches_live_reference_cohort(scenario):
    kw, ref = _reference(scenario)
    port = _port(scenario, "cohort")
    check_logs(kw, ref, port, N_TEST)
    assert all(isinstance(c.model, TransformerClientModel)
               for c in port.clients)
    assert all(0.0 < r.id_fraction < 1.0 for r in port.result.rounds)


@pytest.mark.parametrize("scenario", ["strong", "weak"])
def test_token_cohort_matches_the_port_loop_engine(scenario):
    _assert_engines_agree(_port(scenario, "cohort").result,
                          _port(scenario, "loop").result)


@pytest.fixture
def four_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


def test_token_cohort_gradients_and_runs_are_bitwise_at_four_threads(
        four_threads):
    """The embedding gradient under ``vmap`` was summed in a
    thread-dependent order (``embed[tokens]``'s backward): at four threads
    repeated passes parted by ~6e-5. Now every leaf's gradient repeats bit
    for bit, and so do whole runs, and waves of 2 equal unwaved."""
    clients, *_ = simulator.build_experiment(_cfg(), "lm_tokens",
                                             n_train=N_TRAIN, n_test=N_TEST,
                                             device="cpu")
    cohort = CohortEngine(clients).cohorts[0]
    x = cohort.x[:, :16]

    def grads():
        logits = cohort._forward(cohort.params, x, True)
        return torch.autograd.grad(logits.square().sum(), cohort.params)
    first = grads()
    for _ in range(3):
        for name, a, b in zip(cohort.names, first, grads()):
            assert torch.equal(a, b), name
    # one round runs every phase
    once = _logs(_run(_cfg(rounds=1)))
    assert _logs(_run(_cfg(rounds=1))) == once
    assert _logs(_run(_cfg(rounds=1, wave_size=2))) == once


def test_token_cohort_partial_participation_under_overlap_matches_loop():
    cfg = _cfg(rounds=3, participation_fraction=0.67, round_mode="overlap",
               staleness_decay=0.5, max_inflight=2)
    cohort, loop = _run(cfg), _run(dataclasses.replace(cfg, engine="loop"))
    _assert_engines_agree(cohort, loop)
    assert all(len(r.participants) == 2 for r in cohort.rounds)
    assert any(r.mean_staleness > 0 for r in cohort.rounds)


def test_token_cohort_resumes_bit_for_bit_and_across_engines(tmp_path):
    """A token cohort killed after round 0 (the snapshot at its eval
    boundary, written to disk) resumes bit for bit; the checkpoint drains
    on the loop engine too, and a loop checkpoint on the cohort engine,
    each within the engines' tolerance of the uninterrupted run."""
    runs = {}
    for engine in ("cohort", "loop"):
        config = FedConfig(num_clients=3, rounds=2, method="edgefd",
                           scenario="strong", proxy_batch=64, batch_size=16,
                           lr=1e-2, seed=0, engine=engine, round_mode="sync")
        logs, snaps = snapshots(config, crash_round=0, boundaries=("eval",),
                                dataset="lm_tokens")
        (_, tree), = snaps
        save_state(str(tmp_path / engine), 1, tree)
        runs[engine] = config, logs
    for src, dst in (("cohort", "cohort"), ("cohort", "loop"),
                     ("loop", "cohort")):
        sched = build_sched(runs[dst][0], "lm_tokens")
        sched.restore(restore_state(str(tmp_path / src), 1))
        sched.drain()
        want = runs[src][1]
        if src == dst:
            assert strip(sched.logs) == want
            continue
        for got, ref in zip(strip(sched.logs), want):
            np.testing.assert_allclose(
                [got["local_loss"], got["distill_loss"]],
                [ref["local_loss"], ref["distill_loss"]], rtol=ENGINE_RTOL)
            for f in ("accs", "id_fraction", "bytes_up", "participants"):
                assert got[f] == ref[f], f
        assert len(sched.logs) == len(want)


def test_token_cohort_members_hold_views_of_the_stacked_state():
    """One copy of the state: the members' parameters and momentum are
    views of their rows of the cohort's stacked tensors, which a training
    phase updates in place; ``state_dict`` reads the trained values."""
    clients, *_ = simulator.build_experiment(_cfg(), "lm_tokens",
                                             n_train=N_TRAIN, n_test=N_TEST,
                                             device="cpu")
    engine = CohortEngine(clients)
    cohort = engine.cohorts[0]
    ptrs = [p.data_ptr() for p in cohort.params]

    def views():
        for i, c in enumerate(clients):
            for p, m, sp, sm in zip(c.params, c.opt_state["mu"],
                                    cohort.params, cohort.opt_state["mu"]):
                assert p.data_ptr() == sp[i].data_ptr()
                assert m.data_ptr() == sm[i].data_ptr()
    views()
    engine.phase_local_train(1, 16)
    assert [p.data_ptr() for p in cohort.params] == ptrs
    views()
    engine.sync_to_clients()
    views()
    assert clients[1].opt_state["step"] > 0
    sd = engine.state_dict()
    np.testing.assert_array_equal(
        sd["clients"][1]["params"]["embed"],
        cohort.params[cohort.names.index("backbone.embed")][1].detach())
    engine.load_state_dict(sd)
    views()


def test_feddf_transformer_student_on_the_token_cohort():
    """FedDF (``server_distill``): the clients on the cohort engine, the
    server's transformer student distilling after them; one round held to
    the loop engine."""
    cfg = _cfg(method="server_distill", rounds=1)
    res = {}
    for engine in ("cohort", "loop"):
        clients, server, x_test, y_test = simulator.build_experiment(
            dataclasses.replace(cfg, engine=engine), "lm_tokens",
            n_train=N_TRAIN, n_test=N_TEST, device="cpu")
        assert isinstance(server.student.model, TransformerClientModel)
        res[engine] = run_experiment(clients, server, cfg.method,
                                     dataclasses.replace(cfg, engine=engine),
                                     x_test, y_test)
    log = res["cohort"].rounds[0]
    assert "server_distill" in log.phase_s
    assert np.isfinite(log.server_distill_loss) and log.server_distill_loss > 0
    _assert_engines_agree(res["cohort"], res["loop"])


class _PlainLaunches:
    """``flash_attention_cuda`` replaced by the plain version: the batch of
    every call, on the CPU."""

    def __init__(self):
        self.batches = []

    def __call__(self, q, k, v, causal):
        self.batches.append(q.shape[0])
        return fa_ref.attention_gqa(q, k, v, causal=causal)


def _attn(q, k, v):
    return fa_ops.FlashAttentionFunction.apply(q, k, v, True)


def _plain(q, k, v):
    return fa_ref.attention_gqa(q, k, v, causal=True)


@pytest.mark.parametrize("case", ["batched", "kv-unbatched", "chunked"])
def test_flash_attention_vmap_rule_folds_the_client_axis(case, monkeypatch):
    """Under ``vmap`` the autograd function calls the launch once on
    (C·B, N, S, h) (in chunks of ``MAX_GRID_YZ`` rows past it), in the
    model's strided layout; outputs and q/k/v gradients are bitwise those
    of the vmapped plain version. ``kv-unbatched``: k and v shared by
    every lane (``in_dims`` None), expanded."""
    launches = _PlainLaunches()
    monkeypatch.setattr(fa_ops, "flash_attention_cuda", launches)
    if case == "chunked":
        monkeypatch.setattr(fa_ops, "MAX_GRID_YZ", 5)
    g = torch.Generator().manual_seed(0)
    C, B, N, NKV, S, H = 3, 4, 8, 2, 5, 16

    def randn(*shape):
        return torch.randn(shape, generator=g)
    # the model's layout: (B, N, S, h) views of (B, S, N, h) tensors
    q = randn(C, B, S, N, H).transpose(2, 3).requires_grad_(True)
    k = randn(C, B, S, NKV, H).transpose(2, 3).requires_grad_(True)
    v = randn(C, B, S, NKV, H).transpose(2, 3).requires_grad_(True)
    dims = (0, 0, 0)
    if case == "kv-unbatched":
        k = k[0].detach().requires_grad_(True)
        v = v[0].detach().requires_grad_(True)
        dims = (0, None, None)
    out = vmap(_attn, in_dims=dims)(q, k, v)
    want = vmap(_plain, in_dims=dims)(q, k, v)
    if case == "kv-unbatched":
        assert torch.equal(out, want)
        # the shared operands' gradients sum the lanes': held to the plain
        # version on the expanded operands, whose backward sums as the
        # rule's expand does
        want = vmap(_plain)(q, k.expand(C, *k.shape), v.expand(C, *v.shape))
    assert launches.batches == ([5, 5, 2] if case == "chunked"
                                else [C * B])
    assert out.shape == (C, B, N, S, H)
    assert torch.equal(out, want)
    go = randn(*out.shape)
    for a, b in zip(torch.autograd.grad(out, (q, k, v), go),
                    torch.autograd.grad(want, (q, k, v), go)):
        assert torch.equal(a, b)
    assert len(launches.batches) == (3 if case == "chunked" else 1)


KNOBS = {
    "participation": ["--participation", "0.5", "--staleness-decay", "0.5"],
    "roundrobin-overlap": ["--participation", "0.5", "--policy",
                           "roundrobin", "--round-mode", "overlap"],
    "concurrent-cohorts": ["--concurrent-cohorts", "--round-mode",
                           "overlap"],
    "churn-dropout": ["--churn", "0.3", "--dropout", "0.3"],
    "admission-bursty": ["--max-pending-reports", "1", "--round-mode",
                         "overlap", "--participation", "0.5", "--policy",
                         "weighted", "--arrival-process", "bursty",
                         "--arrival-spread", "2"],
    "edges": ["--edge-aggregators", "2", "--participation", "0.75",
              "--staleness-decay", "0.5"],
    "trimmed-mean": ["--robust-aggregation", "trimmed_mean", "--fault-mode",
                     "colluding_flip", "--byzantine-frac", "0.5"],
    "median": ["--robust-aggregation", "median", "--fault-mode", "scaled",
               "--byzantine-frac", "0.25"],
    "krum-row": ["--robust-aggregation", "krum_row", "--fault-mode",
                 "random_logits", "--byzantine-frac", "0.25"],
    "quarantine": ["--scenario", "iid", "--quarantine-threshold", "1.5",
                   "--fault-mode", "scaled", "--byzantine-frac", "0.25",
                   "--trim-frac", "0.3", "--robust-aggregation",
                   "trimmed_mean"],
    "watchdog-nan": ["--watchdog", "--fault-mode", "nan",
                     "--byzantine-frac", "0.5"],
    "selective-fd": ["--method", "selective-fd"],
    "fkd": ["--method", "fkd"],
}


@pytest.mark.parametrize("name", list(KNOBS))
def test_scheduler_and_server_knobs_take_a_token_cohort(name):
    """Each scheduler and server knob runs ``fed_train`` on a token
    cohort to its end, with finite accuracies."""
    from repro_torch.launch import fed_train
    res = fed_train.main(
        ["--device", "cpu", "--dataset", "lm_tokens", "--engine", "cohort",
         "--clients", "4", "--rounds", "2", "--n-train", "300", "--n-test",
         "100", "--proxy-batch", "32"] + KNOBS[name])
    assert len(res.rounds) >= 1
    assert all(0.0 <= r.mean_acc <= 1.0 for r in res.rounds)
