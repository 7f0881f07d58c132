"""The full scheduler's kernel paths on a card.

Marked ``cuda``: without a CUDA device every test skips. They repeat
``chip_smoke.py``'s scheduler checks: the fused KL loss over clients
through a distill phase with a lane whose weights are all zero (a
sampled-out lane), the cohort report gating sampled-out lanes after one
batched launch, and small partial-participation overlap runs on the card
against the CPU. Run them on a machine with a card from the repository
root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda_scheduler.py
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.common.types import FedConfig
from repro_torch.fed import simulator
from repro_torch.fed.cohort import CohortEngine
from repro_torch.kernels.kmeans_dist import ops as kd_ops

pytestmark = pytest.mark.cuda

_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture
def smoke():
    """``chip_smoke.py``'s check functions, on a host with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kd_kl_loss_zero_lane_through_a_distill_phase(smoke):
    smoke.check_kl_loss_zero_lane_phase()


def test_cohort_report_gates_sampled_out_lanes_after_one_launch(smoke):
    cfg = FedConfig(num_clients=6, rounds=1, engine="cohort", seed=0)
    clients, server, *_ = simulator.build_experiment(
        cfg, n_train=1200, n_test=100, device="cuda")
    engine = CohortEngine(clients)
    engine.learn_dres(cfg.seed)
    idx = server.select_indices(64)
    px, owner = server.proxy.x[idx], server.proxy.owner[idx]
    part = np.array([True, False, True, True, False, True])
    full = engine.phase_report(px, owner)
    before = kd_ops.min_dist_and_mask_clients_cuda.launches
    logits, masks = engine.phase_report(px, owner, participants=part)
    assert kd_ops.min_dist_and_mask_clients_cuda.launches - before == 1
    keep = torch.as_tensor(part, device="cuda")
    assert torch.equal(logits[keep], full[0][keep])
    assert torch.equal(masks[keep], full[1][keep])
    assert not bool(masks[~keep].any()) and bool((logits[~keep] == 0).all())


def test_small_partial_participation_overlap_card_vs_cpu(smoke):
    smoke.check_small_scheduler_runs()
