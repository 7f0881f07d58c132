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

from repro_torch.core import distill
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.kernels import dispatch
from repro_torch.kernels.distill_kl import ops as kl_ops
from repro_torch.kernels.distill_kl import ref as kl_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.kmeans_dist import ops as kd_ops
from repro_torch.kernels.kmeans_dist import ref as kd_ref
from repro_torch.kernels.kulsif_rbf import ops as rbf_ops

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
                                 (6000, 12), (6000, 64), (5999, 3)])
def test_lloyd_kernel_matches_plain_and_is_deterministic(smoke, n, k):
    smoke.check_lloyd(n, 50, k)


# several clients in one launch (the cohort engine's batched fit), and the
# widest centroid count at a ragged n, alone and batched; d = 16 is
# lm_tokens' flattened samples
@pytest.mark.parametrize("n,d,k,c", [(6000, 50, 3, 3), (1001, 50, 10, 5),
                                     (5999, 50, 64, 1), (5999, 50, 64, 2),
                                     (777, 16, 32, 2)])
def test_lloyd_kernel_batches_clients_in_one_launch(smoke, n, d, k, c):
    smoke.check_lloyd(n, d, k, c=c)


# flattened images (mnist_like 784, cifar_like 3072 wide): the wide route
@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("d", [784, 3072])
def test_lloyd_kernel_wide_route_matches_plain(smoke, d, k):
    smoke.check_lloyd(6000, d, k)


def test_lloyd_kernel_wide_route_batches_clients(smoke):
    smoke.check_lloyd(1001, 784, 10, c=3)


# the narrow route (split and lanes-over-centroids paths) and the wide one
@pytest.mark.parametrize("case", ["rows", "centroid"])
@pytest.mark.parametrize("n,d,k", [(6000, 50, 3), (777, 16, 32),
                                   (1000, 784, 3)])
def test_lloyd_kernel_nonfinite_matches_plain(smoke, n, d, k, case):
    smoke.check_nonfinite_lloyd(n, d, k, case)


@pytest.mark.parametrize("case", ["rows", "centroid"])
@pytest.mark.parametrize("t,d,k", [(512, 50, 3), (256, 16, 1), (300, 50, 64),
                                   (512, 784, 10)])
def test_min_dist_kernel_nonfinite_matches_plain(smoke, t, d, k, case):
    smoke.check_nonfinite_min_dist(t, d, k, case)


@pytest.mark.parametrize("case", ["rows", "centroid"])
@pytest.mark.parametrize("n,m,d", [(512, 6000, 50), (256, 256, 50)])
def test_rbf_kernel_nonfinite_matches_plain(smoke, n, m, d, case):
    smoke.check_nonfinite_rbf(n, m, d, case)


@pytest.mark.parametrize("n,k", [(64, 10), (512, 10), (4096, 1000)])
def test_kd_kl_kernels_match_plain(smoke, n, k):
    smoke.check_kl(n, k)


@pytest.mark.parametrize("teacher_grad", [False, True])
def test_kd_kl_autograd_runs_the_kernels(smoke, teacher_grad):
    s, t, g = smoke.kl_inputs(64, 10, seed=2)
    s_k = s.clone().requires_grad_(True)
    t_k = t.clone().requires_grad_(teacher_grad)
    before = {n: w.launches for n, w in smoke.launch_counts().items()}
    out = dispatch.kd_kl_per_sample(s_k, t_k, 3.0)
    out.backward(g)
    after = {n: w.launches for n, w in smoke.launch_counts().items()}
    # fwd and ds once, dt only when the teacher needs a gradient
    assert {n: after[n] - before[n] for n in after} == {
        "lloyd_step": 0, "min_dist_and_mask": 0,
        "min_dist_and_mask_clients": 0, "kd_kl_loss": 0,
        "kd_kl_loss_clients": 0, "rbf_matrix_clients": 0, "kd_kl_fwd": 1,
        "kd_kl_bwd_ds": 1, "kd_kl_bwd_dt": int(teacher_grad),
        "rbf_matrix": 0, "flash_attention": 0}
    s_r = s.clone().requires_grad_(True)
    t_r = t.clone().requires_grad_(teacher_grad)
    kl_ref.kd_kl_per_sample(s_r, t_r, 3.0).backward(g)
    torch.testing.assert_close(s_k.grad, s_r.grad, rtol=1e-5, atol=1e-6)
    if teacher_grad:
        torch.testing.assert_close(t_k.grad, t_r.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weights", ["masked", "none", "zero"])
@pytest.mark.parametrize("n,k", [(64, 10), (64, 32), (256, 32), (300, 10),
                                 (4096, 1000), (5, 1500)])
def test_kd_kl_loss_kernel_matches_plain_and_is_deterministic(smoke, n, k,
                                                              weights):
    smoke.check_kl_loss(n, k, weights)


@pytest.mark.parametrize("teacher_grad", [False, True])
def test_distill_loss_launches_the_fused_kernel_once(smoke, teacher_grad):
    """A weighted distill step's loss and backward: one fused launch, no
    per-sample kernel; the dt kernel once only when the teacher needs a
    gradient, which equals the plain route's."""
    s, t, _ = smoke.kl_inputs(64, 10, seed=3)
    w = smoke.kl_weights(64, "masked", seed=3)
    s_k = s.clone().requires_grad_(True)
    t_k = t.clone().requires_grad_(teacher_grad)
    before = {n: w_.launches for n, w_ in smoke.launch_counts().items()}
    loss = distill.kd_kl_loss(s_k, t_k, 3.0, w)
    mid = {n: w_.launches for n, w_ in smoke.launch_counts().items()}
    loss.backward()
    after = {n: w_.launches for n, w_ in smoke.launch_counts().items()}
    assert {n: mid[n] - before[n] for n in mid if mid[n] != before[n]} == {
        "kd_kl_loss": 1}
    assert {n: after[n] - mid[n] for n in after if after[n] != mid[n]} == (
        {"kd_kl_bwd_dt": 1} if teacher_grad else {})
    s_r = s.clone().requires_grad_(True)
    t_r = t.clone().requires_grad_(teacher_grad)
    loss_r = distill.kd_kl_loss(s_r, t_r, 3.0, w, backend="torch")
    loss_r.backward()
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s_k.grad, s_r.grad, rtol=1e-5, atol=1e-6)
    if teacher_grad:
        torch.testing.assert_close(t_k.grad, t_r.grad, rtol=1e-5, atol=1e-6)


def test_fused_loss_wrapper_refuses_what_the_kernel_does_not_take(smoke):
    s, t, _ = smoke.kl_inputs(8, 10, seed=0)
    w = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        kl_ops.kd_kl_loss_cuda(s, t.T.contiguous().T, w, 3.0)
    with pytest.raises(TypeError, match="dtype"):
        kl_ops.kd_kl_loss_cuda(s, t.double(), w, 3.0)
    with pytest.raises(TypeError, match="dtype"):
        kl_ops.kd_kl_loss_cuda(s, t, w.bool(), 3.0)
    with pytest.raises(ValueError, match="shape"):
        kl_ops.kd_kl_loss_cuda(s, t[:4], w, 3.0)
    with pytest.raises(ValueError, match="shape"):
        kl_ops.kd_kl_loss_cuda(s, t, w[:4], 3.0)
    with pytest.raises(ValueError, match="is on cpu"):
        kl_ops.kd_kl_loss_cuda(s, t.cpu(), w, 3.0)
    with pytest.raises(ValueError, match="differentiate the sample weight"):
        kl_ops.kd_kl_loss(s, t, 3.0, w.clone().requires_grad_(True))
    if torch.cuda.device_count() > 1:
        with torch.cuda.device(1):
            with pytest.raises(ValueError, match="current device"):
                kl_ops.kd_kl_loss_cuda(s, t, w, 3.0)


# reports (strong, weak, iid), a calibration, a ragged t, a wide k
@pytest.mark.parametrize("t,k", [(512, 1), (512, 3), (512, 10), (6000, 1),
                                 (5999, 3), (300, 64)])
def test_min_dist_kernel_matches_plain_and_is_deterministic(smoke, t, k):
    smoke.check_min_dist(t, 50, k)


# lm_tokens' report and calibration, flattened images (the wide route), an
# odd narrow width and a width just past the narrow route
@pytest.mark.parametrize("t,d,k", [(256, 16, 1), (600, 16, 1), (512, 784, 10),
                                   (512, 3072, 10), (300, 7, 3),
                                   (300, 100, 20)])
def test_min_dist_kernel_at_other_widths(smoke, t, d, k):
    smoke.check_min_dist(t, d, k)


# learn K11 and K12, report k_ta and k_tp, ragged both ways, a narrow d;
# the small shapes also at the widest single stage and a narrow odd width;
# private sets of odd size (rows starting inside a 32-byte sector); a
# width past one stage; a report on flattened mnist_like and cifar_like
# images (pixel-like rows)
@pytest.mark.parametrize("n,m,d", [(256, 256, 50), (256, 6000, 50),
                                   (512, 256, 50), (512, 6000, 50),
                                   (511, 5999, 50), (70, 33, 7),
                                   (256, 256, 64), (256, 256, 7),
                                   (512, 256, 64), (512, 256, 7),
                                   (256, 6001, 50), (512, 6001, 50),
                                   (300, 700, 130), (512, 6000, 784),
                                   (512, 5000, 3072)])
def test_rbf_kernel_matches_plain_and_is_deterministic(smoke, n, m, d):
    smoke.check_rbf(n, m, d)


# a training step and a report at granite-8b's widths, ragged S (two
# 64-row tiles and a partial one), the reduced backbone (GQA 4), GQA 1
# with h 64 and 32; then the short route (Sq <= 32) at qwen2.5-3b's GQA 8
# (two row tiles a group) and llama3-405b's GQA 16 (four), at Sq = 1 and
# Sq = 32 (two row and two key tiles), and at h 64 and 32 with GQA 4
@pytest.mark.parametrize("b,n,nkv,s,h", [(64, 32, 8, 16, 128),
                                         (256, 32, 8, 16, 128),
                                         (3, 32, 8, 300, 128),
                                         (16, 4, 1, 16, 16),
                                         (4, 8, 8, 40, 64),
                                         (2, 4, 4, 20, 32),
                                         (16, 16, 2, 16, 128),
                                         (4, 128, 8, 16, 128),
                                         (64, 32, 8, 1, 128),
                                         (16, 32, 8, 32, 128),
                                         (16, 32, 8, 16, 64),
                                         (16, 32, 8, 16, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain_and_is_deterministic(
        smoke, b, n, nkv, s, h, causal):
    smoke.check_flash(b, n, nkv, s, h, causal=causal)


@pytest.mark.parametrize("b,n,nkv,s,h", [(64, 32, 8, 16, 128),
                                         (16, 4, 1, 16, 16),
                                         (3, 32, 8, 300, 128),
                                         (16, 16, 2, 16, 128)])
def test_flash_attention_function_grads_match_plain_autograd(smoke, b, n,
                                                             nkv, s, h):
    smoke.check_flash_grads(b, n, nkv, s, h)


@pytest.mark.parametrize("c,b,n,nkv,s,h", [(10, 64, 32, 8, 16, 128),
                                           (4, 16, 4, 1, 16, 16)])
def test_flash_attention_under_vmap_launches_once_for_the_clients(
        smoke, c, b, n, nkv, s, h):
    """The token cohort's route: the ``vmap`` rule folds the client axis
    into the batch, one launch, each client's slice bitwise its own."""
    smoke.check_flash_clients(c, b, n, nkv, s, h)


@pytest.mark.parametrize("b,n,nkv,s,h", [(8, 16, 16, 16, 80),
                                         (8, 16, 16, 128, 80),
                                         (3, 16, 4, 33, 80)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_width_80_matches_plain(smoke, b, n, nkv, s,
                                                        h, causal):
    """hubert-xlarge's heads of 80: 20 16-byte chunks a row, on both
    routes lanes 0-3 of each eight holding a third chunk each (16-19)."""
    smoke.check_flash(b, n, nkv, s, h, causal=causal)


@pytest.mark.parametrize("b,n,nkv,s,h,sk", [(8, 16, 16, 16, 80, None),
                                            (3, 16, 16, 5, 80, 37),
                                            (2, 4, 4, 32, 80, 3)])
def test_flash_attention_writes_every_chunk_at_head_width_80(smoke, b, n,
                                                             nkv, s, h, sk):
    """The short route's output over memory that held NaN: with the old
    ``RC = C / 8`` lanes (two chunks each, chunks 0-15 only) columns 64-79
    of every row would keep the NaN."""
    smoke.check_flash(b, n, nkv, s, h, causal=False, sk=sk, poison=True)


@pytest.mark.parametrize("b,n,nkv,s,h,sk", [(8, 64, 8, 128, 128, 1601),
                                            (4, 64, 8, 16, 128, 1601),
                                            (2, 16, 16, 40, 80, 77),
                                            (2, 8, 2, 1, 64, 1601)])
def test_flash_attention_cross_attention_over_ragged_keys(smoke, b, n, nkv,
                                                          s, h, sk):
    """Full attention with Sk != Sq and a ragged last key tile: the vlm's
    cross-attention, 64 query heads over 8 kv heads and 1601 vision keys,
    on the long route (training, Sq 128) and the short one (a prefill of
    16); and the gradients through the autograd function there."""
    smoke.check_flash(b, n, nkv, s, h, causal=False, sk=sk)
    if s > 1:
        smoke.check_flash_grads(min(b, 2), n, nkv, s, h, causal=False,
                                sk=sk)


@pytest.mark.parametrize("name", ["flash_attention_h80_local",
                                  "flash_attention_vlm_self_local",
                                  "flash_attention_cross_local",
                                  "flash_attention_cross_prefill_local"])
def test_flash_attention_at_the_model_axis_local_heads(smoke, name):
    """B6 at a rank's heads on the (1, 2) mesh: hubert's 8 of 16 heads of
    80, full; the vlm's 32 of 64 query heads over 4 of 8 kv heads, causal
    self-attention and full cross-attention over 1601 vision keys (the
    training step's and the prefill's), against the plain version; and
    the gradients through the autograd function at the cross shape."""
    b, n, nkv, s, h, sk, causal = smoke.LOCAL_ATTN[name]
    smoke.check_flash(b, n, nkv, s, h, causal=causal, sk=sk)
    if name == "flash_attention_cross_local":
        smoke.check_flash_grads(2, n, nkv, s, h, causal=False, sk=sk)


@pytest.mark.parametrize("b,n,nkv,s,h,sk,causal,grads", [
    (2, 32, 2, 33, 80, None, True, True),
    (2, 32, 2, 33, 80, None, False, True),
    (2, 16, 1, 33, 128, None, True, False),
    (2, 16, 1, 33, 128, None, False, False),
    (2, 16, 2, 33, 80, 1601, False, False),
    (2, 8, 8, 300, 64, None, True, False),
    (2, 8, 8, 300, 64, None, False, False),
    (8, 12, 4, 256, 64, None, True, True),
    (2, 12, 4, 300, 80, None, False, False),
    (16, 16, 16, 128, 80, None, False, False),
    (16, 16, 16, 128, 80, None, True, False)])
def test_flash_attention_long_route_over_a_gqa_group(smoke, b, n, nkv, s, h,
                                                     sk, causal, grads):
    """B6's long route (Sq > 32), whose work item is a 64-row tile of
    (query head of the group, position) pairs: Sq 33 at GQA 16 and h 80
    and 128, over 1601 keys at GQA 8, GQA 1 at a ragged 300, and GQA 3,
    whose tiles straddle positions, at train_100m's shape (one key group a
    block at h 64) and a ragged 300 (two), and hubert's heads at batch 16
    (one key group a block at h 80), on a poisoned output (a column left
    unwritten fails); the gradients at GQA 16 and 3."""
    smoke.check_flash(b, n, nkv, s, h, causal=causal, sk=sk, poison=True)
    if grads:
        smoke.check_flash_grads(b, n, nkv, s, h, causal=causal)


def test_flash_attention_folded_batch_past_grid_z_launches_in_chunks(smoke):
    smoke.check_flash_chunked(*smoke.CHUNKED_ATTN)


def test_flash_attention_refuses_misaligned_operands_the_op_copies(smoke):
    """The kernel's 16-byte copies need aligned pointers and strides in
    multiples of 4: the wrapper refuses anything else, and the public op
    copies such an operand first, giving the aligned operand's bits."""
    q, k, v = smoke.attn_inputs(2, 8, 2, 16, 32, seed=0)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    padded = torch.zeros((2, 8, 16, 34), device="cuda")
    padded[..., :32] = q
    want = fa_ops.flash_attention_cuda(q, k, v, True)
    for bad in (shifted, padded[..., :32]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa_ops.flash_attention_cuda(bad, k, v, True)
        assert torch.equal(fa_ops.flash_attention(bad, k, v, causal=True),
                           want)


def test_model_attention_on_the_card_runs_the_kernel(smoke):
    """The transformer's forward launches the kernel once per layer, and
    the client's ``kernel_backend="torch"`` keeps attention plain."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.fd_trainer import TransformerClientModel
    cfg = reduced(get_arch("granite-8b"), layers=2, d_model=64, vocab=32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 32, (8, 16), device="cuda", generator=gen)
    kern = TransformerClientModel(cfg, generator=gen, device="cuda")
    plain = TransformerClientModel(cfg, device="cuda", kernel_backend="torch")
    plain.load_state_dict(kern.state_dict())
    before = fa_ops.flash_attention_cuda.launches
    out_k = kern(tokens)
    assert fa_ops.flash_attention_cuda.launches - before == 2
    out_p = plain(tokens)
    assert fa_ops.flash_attention_cuda.launches - before == 2
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-5)


def test_kmeans_dre_filter_on_the_card_reads_its_threshold_there(smoke):
    """The calibrated threshold stays a device tensor and the filter's
    estimation step takes it without a host read; fit, calibration and
    filter agree with the CPU's plain route."""
    from repro_torch.core.dre import KMeansDRE
    # separated blobs, as in the k-means test below: a well-posed fit, so
    # the two devices' float sums cannot steer it to different optima
    g = torch.Generator().manual_seed(7)
    centers = torch.randn((3, 50), generator=g) * 4
    x_cpu = (centers[torch.arange(3000) % 3]
             + torch.randn((3000, 50), generator=g))
    init = x_cpu[:3] + 1.0
    x = x_cpu.cuda()
    before = kd_ops.min_dist_and_mask_cuda.launches
    gpu = KMeansDRE(num_centroids=3).learn(x, init=init.cuda())
    cpu = KMeansDRE(num_centroids=3).learn(x_cpu, init=init)
    assert kd_ops.min_dist_and_mask_cuda.launches - before == 1
    assert gpu.threshold.device.type == "cuda"
    torch.testing.assert_close(gpu.threshold.cpu(), cpu.threshold,
                               rtol=1e-5, atol=1e-5)
    probe = x[::7] + 0.5
    d_gpu, id_gpu = gpu.distances_and_id(probe)
    d_cpu, id_cpu = kd_ref.min_dist_and_mask(probe.cpu(), gpu.centroids.cpu(),
                                             gpu.threshold.cpu())
    assert kd_ops.min_dist_and_mask_cuda.launches - before == 2
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-5, atol=1e-4)
    near = (d_cpu - gpu.threshold.cpu()).abs() <= 1e-4
    assert torch.equal(id_gpu.cpu()[~near], id_cpu[~near])


def test_kmeans_dre_on_flattened_images_matches_the_cpu(smoke):
    """KMeans-DRE with 10 centroids on 784-wide rows (a flattened
    mnist_like client): the fit goes through the Lloyd kernel's wide route
    and the calibration through the estimation kernel's; centroids and
    threshold agree with the CPU's plain route."""
    from repro_torch.core.dre import KMeansDRE
    g = torch.Generator().manual_seed(9)
    centers = torch.randn((10, 784), generator=g) * 2
    x_cpu = (centers[torch.arange(2000) % 10]
             + torch.randn((2000, 784), generator=g))
    init = x_cpu[:10] + 0.5
    before = (kd_ops.lloyd_step_cuda.launches,
              kd_ops.min_dist_and_mask_cuda.launches)
    gpu = KMeansDRE(num_centroids=10).learn(x_cpu.cuda(), init=init.cuda())
    cpu = KMeansDRE(num_centroids=10).learn(x_cpu, init=init)
    assert kd_ops.lloyd_step_cuda.launches > before[0]
    assert kd_ops.min_dist_and_mask_cuda.launches == before[1] + 1
    torch.testing.assert_close(gpu.centroids.cpu(), cpu.centroids,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gpu.threshold.cpu(), cpu.threshold,
                               rtol=1e-5, atol=1e-5)


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
    with pytest.raises(ValueError, match="at most 64 centroids"):
        kd_ops.lloyd_step_cuda(torch.zeros((1, 10, 64), device="cuda"), big)
    with pytest.raises(ValueError, match="width at most 4096"):
        kd_ops.lloyd_step_cuda(torch.zeros((1, 10, 4097), device="cuda"),
                               torch.zeros((1, 3, 4097), device="cuda"))
    s, t, _ = smoke.kl_inputs(8, 10, seed=0)
    with pytest.raises(ValueError, match="shape"):
        kl_ops.kd_kl_fwd_cuda(s, t[:4], 3.0)
    xd = x[0]
    with pytest.raises(ValueError, match="threshold"):
        kd_ops.min_dist_and_mask_cuda(xd, cents[0], torch.ones(1))  # on CPU
    with pytest.raises(ValueError, match="shared memory"):
        kd_ops.min_dist_and_mask_cuda(torch.zeros((10, 64), device="cuda"),
                                      big[0], torch.ones(1, device="cuda"))
    with pytest.raises(TypeError, match="dtype"):
        rbf_ops.rbf_matrix_cuda(xd.double(), xd.double(), 4.0)
    with pytest.raises(ValueError, match="shape"):
        rbf_ops.rbf_matrix_cuda(xd, torch.zeros((3, 5), device="cuda"), 4.0)
    q, k, v = smoke.attn_inputs(2, 4, 2, 16, 16, seed=0)
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.flash_attention_cuda(q.double(), k.double(), v.double(), True)
    with pytest.raises(ValueError, match="divide"):
        fa_ops.flash_attention_cuda(q, k[:, :1].repeat(1, 3, 1, 1),
                                    v[:, :1].repeat(1, 3, 1, 1), True)
    with pytest.raises(ValueError, match="head width"):
        fa_ops.flash_attention_cuda(q[..., :8].contiguous(),
                                    k[..., :8].contiguous(),
                                    v[..., :8].contiguous(), True)
    with pytest.raises(ValueError, match="last axis"):
        fa_ops.flash_attention_cuda(q.transpose(2, 3), k, v, True)


# ---- the cohort engine's routes: one launch for C clients, each client's
# slice bit for bit its own launch's
@pytest.mark.parametrize("n,d,k,c", [(6000, 50, 1, 10), (6000, 50, 3, 10),
                                     (600, 50, 10, 34), (6000, 784, 1, 10),
                                     (1001, 3072, 3, 10)])
def test_lloyd_kernel_clients_equal_their_own_launches(smoke, n, d, k, c):
    smoke.check_lloyd_clients(n, d, k, c=c)


@pytest.mark.parametrize("c,t,d,k,shared", [
    (10, 512, 50, 1, True), (10, 512, 50, 3, True), (10, 6000, 50, 1, False),
    (34, 600, 50, 10, False), (1, 512, 784, 1, True),
    (1, 5000, 3072, 1, False), (3, 5999, 50, 3, False),
    (3, 777, 16, 1, False)])
def test_min_dist_kernel_over_clients(smoke, c, t, d, k, shared):
    smoke.check_min_dist_clients(c, t, d, k, shared)


@pytest.mark.parametrize("poison", ["rows", "centroid"])
def test_min_dist_kernel_over_clients_nonfinite(smoke, poison):
    smoke.check_min_dist_clients(10, 512, 50, 3, True, poison=poison)
    smoke.check_min_dist_clients(2, 300, 784, 3, False, poison=poison)


@pytest.mark.parametrize("n,c,m,d,sentinel", [
    (512, 10, 6000, 50, 0), (512, 10, 6001, 50, 7), (512, 100, 600, 50, 0),
    (512, 1, 5001, 3072, 3)])
def test_rbf_kernel_over_clients(smoke, n, c, m, d, sentinel):
    smoke.check_rbf_clients(n, c, m, d, sentinel)


@pytest.mark.parametrize("c,n,k", [(10, 64, 10), (34, 64, 10), (1, 64, 10),
                                   (3, 300, 10)])
def test_kd_kl_loss_kernel_over_clients(smoke, c, n, k):
    smoke.check_kl_loss_clients(c, n, k)


@pytest.mark.parametrize("weights", ["masked", "none", "zero"])
@pytest.mark.parametrize("n,k", [(16, 1024), (16, 1025), (16, 8193),
                                 (16, 65536), (16, 65537), (3, 500000)])
def test_fused_loss_wide_route_at_its_boundaries(smoke, n, k, weights):
    """The fused loss on both sides of the register route's last width
    (1024 / 1025), at the wide route's first two-block row, at the
    portable clusters' last size and the first non-portable one (8 / 9
    blocks a row), and on a row too wide for shared memory (re-read at
    each pass): kernel against plain, two launches bitwise, a launch
    without ds."""
    smoke.check_kl_loss(n, k, weights)


@pytest.mark.parametrize("c,n,k", [(3, 16, 1025), (2, 16, 65537),
                                   (3, 5, 8193)])
def test_fused_loss_wide_route_over_clients(smoke, c, n, k):
    """The wide route with the client on grid y: each client bitwise its
    own launch, against the plain version, an all-zero lane 0."""
    smoke.check_kl_loss_clients(c, n, k)


def test_kmeans_fit_batched_equals_each_clients_fit(smoke):
    smoke.check_kmeans_batched()


# ------------------------------------------------ the trainer path (A11)

def test_flash_kernel_at_the_trainers_long_route(smoke):
    """B6 at granite-moe's training step: (8, 16, 128, 64), 8 kv heads,
    its long route (S > 32), forward and the recompute backward."""
    smoke.check_flash(*smoke.TRAIN_ATTN)
    smoke.check_flash_grads(*smoke.TRAIN_ATTN)


def test_fused_loss_at_a_vocab_of_49155(smoke):
    """The fused KL loss at the FD trainer's (16, 49155) rows: rows past
    the register route's 1024, read from memory at every pass."""
    smoke.check_kl_loss(*smoke.FD_KL, "masked")
    smoke.check_kl_loss(*smoke.FD_KL, "none")


def _reduced_moe(no_drop=False):
    import dataclasses

    from repro_torch import configs
    from repro_torch.common.types import MoEConfig
    cfg = configs.reduced(configs.get_arch("granite-moe"), d_model=64,
                          vocab=64)
    if no_drop:
        e = cfg.moe.num_experts
        cfg = dataclasses.replace(cfg, moe=MoEConfig(e, cfg.moe.top_k,
                                                     float(e)))
    return cfg


def test_train_steps_on_the_card_match_the_cpu(smoke):
    """``launch.train``'s AdamW steps on reduced granite-moe: the card
    (B6 launched) and the CPU from the same weights, losses within rtol
    1e-3."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train
    from repro_torch.models.transformer import Transformer
    cfg = _reduced_moe()
    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    card = Transformer(cfg, generator=torch.Generator().manual_seed(0)
                       ).to("cuda")
    before = ops.flash_attention_cuda.launches
    got, _, _ = train.train(cfg, steps=4, batch=4, seq=48, lr=3e-3,
                            device="cuda", model=card, say=lambda m: None)
    assert ops.flash_attention_cuda.launches > before
    want, _, _ = train.train(cfg, steps=4, batch=4, seq=48, lr=3e-3,
                             device="cpu", model=cpu, say=lambda m: None)
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                               rtol=1e-3, atol=0)


def test_decode_on_the_card_matches_the_prefill_and_the_cpu(smoke):
    """``prefill_then_decode`` on the card: the replay's logits equal the
    prefill's within the reference's 2e-2 and the generated tokens are
    the CPU's."""
    from repro_torch.launch import decode_demo
    from repro_torch.models.transformer import Transformer
    cfg = _reduced_moe(no_drop=True)
    prompt = torch.randint(0, 64, (3, 10), generator=torch.Generator()
                           .manual_seed(1))
    out = []
    for dev in ("cuda", "cpu"):
        model = Transformer(cfg, generator=torch.Generator().manual_seed(2)
                            ).to(dev)
        toks, prefill, replay = decode_demo.prefill_then_decode(
            model, prompt.to(dev), 24, 6, return_logits=True)
        torch.testing.assert_close(replay, prefill, rtol=2e-2, atol=2e-2)
        out.append(toks.cpu())
    assert torch.equal(out[0], out[1])


def test_fd_round_on_the_card_matches_the_cpu(smoke):
    """``fd_round_local`` on two reduced granite-moe clients, the card's
    (B6 and the fused loss launched) against the CPU's: losses within
    rtol 1e-4."""
    from repro_torch.core import fd_trainer as FD
    from repro_torch.kernels.distill_kl import ops as kl_ops
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.optimizers import sgd
    cfg = _reduced_moe()
    res = []
    for dev in ("cuda", "cpu"):
        opt = sgd(1e-2)
        states, batches, cents = [], [], []
        for c in range(2):
            m = Transformer(cfg, generator=torch.Generator().manual_seed(c)
                            ).to(dev)
            states.append((m, opt.init(list(m.parameters()))))
            toks = torch.randint(32 * c, 32 * (c + 1), (2, 16),
                                 generator=torch.Generator().manual_seed(c))
            batches.append({"tokens": toks.to(dev), "labels": toks.to(dev)})
            cents.append(FD.proxy_features(m, toks.to(dev)).mean(0,
                                                                  True))
        proxy = torch.cat([b["tokens"][:1] for b in batches])
        before = kl_ops.kd_kl_loss_cuda.launches
        _, metrics, frac = FD.fd_round_local(
            opt, states, batches, proxy, torch.arange(2, device=dev), cents,
            [1.0, 1.0])
        if dev == "cuda":
            assert kl_ops.kd_kl_loss_cuda.launches == before + 2
        res.append(([float(m["loss"]) for m in metrics], frac))
    torch.testing.assert_close(torch.tensor(res[0][0]),
                               torch.tensor(res[1][0]), rtol=1e-4, atol=0)
    assert res[0][1] == res[1][1]


# ------------------------------ the recurrent families (A11.1) on the card

@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_fused_loss_at_the_recurrent_vocabularies(smoke, arch):
    """The fused KL loss at the recurrent archs' FD trainer rows: (16,
    50304) and (16, 256000), past the register route's 1024 columns."""
    smoke.check_kl_loss(*smoke.RECURRENT_KL[arch], "masked")


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_recurrent_forward_and_decode_on_the_card_match_the_cpu(smoke,
                                                                arch):
    """Reduced xlstm-350m and recurrentgemma-2b (window cut to 16, so that
    S = 40 runs past it) on the card against the CPU's plain path from
    the same weights: logits, the loss and its gradients (both sLSTM
    routes) within rtol 1e-4, atol 1e-4 (float32 sums in another order),
    decode step by step likewise over 24 steps against a cache of 16
    (hybrid's ring wraps); no kernel launched."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.reduced(
        configs.get_arch(arch), layers=6 if arch.startswith("recurrent")
        else 4, d_model=64, vocab=64), local_window=16)
    models = {dev: T.Transformer(cfg, generator=torch.Generator(
        ).manual_seed(0)).to(dev) for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, 64, (2, 40), generator=gen)
    lab = torch.randint(0, 64, (2, 40), generator=gen)
    before = ops.flash_attention_cuda.launches
    close = dict(rtol=1e-4, atol=1e-4)
    for custom_vjp in (True, False):
        ssm.set_slstm_custom_vjp(custom_vjp)
        try:
            out = {}
            for dev, m in models.items():
                loss, _ = T.train_loss(m, {"tokens": tok.to(dev),
                                           "labels": lab.to(dev)})
                grads = torch.autograd.grad(loss, list(m.parameters()))
                out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads])
        finally:
            ssm.set_slstm_custom_vjp(True)
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], **close)
        for a, b in zip(out["cuda"][1], out["cpu"][1]):
            torch.testing.assert_close(a, b, **close)
    caches = {dev: T.init_cache(cfg, 2, 16, torch.float32, device=dev)
              for dev in models}
    with torch.no_grad():
        torch.testing.assert_close(models["cuda"](tok.cuda()).cpu(),
                                   models["cpu"](tok), **close)
        for t in range(24):
            lg = {}
            for dev, m in models.items():
                lg[dev], caches[dev] = T.decode_step(
                    m, tok[:, t:t + 1].to(dev), caches[dev], t)
            torch.testing.assert_close(lg["cuda"].cpu(), lg["cpu"], **close)
    assert ops.flash_attention_cuda.launches == before
