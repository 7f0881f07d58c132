"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test skips. These repeat
``chip_smoke.py``'s kernel checks (same functions, same tolerances) and
add the routing of the autograd function and the wrappers' refusals.
Run them on a machine with a card from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the shared conftest imports JAX, which the port's
hosts need not have.)
"""
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.core.kmeans import kmeans_fit
from repro_torch.kernels import dispatch
from repro_torch.kernels.distill_kl import ops as kl_ops
from repro_torch.kernels.distill_kl import ref as kl_ref
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


@pytest.mark.parametrize("n,k", [(6000, 1), (6000, 3), (6000, 10),
                                 (6000, 64), (5999, 3)])
def test_lloyd_kernel_matches_plain_and_is_deterministic(smoke, n, k):
    smoke.check_lloyd(n, 50, k)


@pytest.mark.parametrize("n,k", [(64, 10), (512, 10), (4096, 1000)])
def test_kd_kl_kernels_match_plain(smoke, n, k):
    smoke.check_kl(n, k)


@pytest.mark.parametrize("teacher_grad", [False, True])
def test_kd_kl_autograd_runs_the_kernels(smoke, teacher_grad):
    s, t, g = smoke.kl_inputs(64, 10, seed=2)
    s_k = s.clone().requires_grad_(True)
    t_k = t.clone().requires_grad_(teacher_grad)
    before = [w.launches for w in smoke.launch_counts().values()]
    out = dispatch.kd_kl_per_sample(s_k, t_k, 3.0)
    out.backward(g)
    after = [w.launches for w in smoke.launch_counts().values()]
    # lloyd, fwd, ds, dt: dt only when the teacher needs a gradient
    assert [b - a for a, b in zip(before, after)] == [0, 1, 1,
                                                      int(teacher_grad)]
    s_r = s.clone().requires_grad_(True)
    t_r = t.clone().requires_grad_(teacher_grad)
    kl_ref.kd_kl_per_sample(s_r, t_r, 3.0).backward(g)
    torch.testing.assert_close(s_k.grad, s_r.grad, rtol=1e-5, atol=1e-6)
    if teacher_grad:
        torch.testing.assert_close(t_k.grad, t_r.grad, rtol=1e-5, atol=1e-6)


def test_kmeans_fit_on_the_card_matches_the_cpu(smoke):
    # three separated blobs: a well-posed fit, so float differences between
    # the devices cannot steer the two runs to different local optima
    # (chip_smoke.py phase 4 compares the routes on unclustered inputs)
    g = torch.Generator().manual_seed(4)
    centers = torch.randn((3, 50), generator=g) * 4
    x = centers[torch.arange(3000) % 3] + torch.randn((3000, 50), generator=g)
    init = x[:3] + 1.0
    before = kd_ops.lloyd_step_cuda.launches
    gpu = kmeans_fit(x.cuda(), 3, init=init.cuda())
    cpu = kmeans_fit(x, 3, init=init)
    assert kd_ops.lloyd_step_cuda.launches - before == gpu.n_iter + 1
    assert gpu.n_iter == cpu.n_iter
    assert torch.equal(gpu.assignments.cpu(), cpu.assignments)
    torch.testing.assert_close(gpu.centroids.cpu(), cpu.centroids,
                               rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(smoke):
    x, cents = smoke.lloyd_inputs(256, 8, 2, seed=0)
    with pytest.raises(TypeError, match="dtype"):
        kd_ops.lloyd_step_cuda(x.double(), cents.double())
    with pytest.raises(ValueError, match="contiguous"):
        kd_ops.lloyd_step_cuda(x.transpose(1, 2).contiguous()
                               .transpose(1, 2), cents)
    big = torch.zeros((1, 1024, 64), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        kd_ops.lloyd_step_cuda(torch.zeros((1, 10, 64), device="cuda"), big)
    s, t, _ = smoke.kl_inputs(8, 10, seed=0)
    with pytest.raises(ValueError, match="shape"):
        kl_ops.kd_kl_fwd_cuda(s, t[:4], 3.0)
