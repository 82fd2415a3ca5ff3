"""The port's fused bottleneck backward-input (``transferattack_torch/ops/fused_bwd.py``).

On the CPU its plain versions are held against the JAX package's functions,
run as the JAX package's own tests run them (the Pallas kernels in interpret
mode, and the jnp compositions), in fp32 at the tolerances of
``tests/test_fused_bwd.py``; the chain is also held against autograd of the
port's ``Bottleneck`` after ``fold_bn``.  The tests marked ``cuda`` hold the
CUDA kernels against the plain versions on a card, in bf16, within one bf16
rounding of the largest output (``1e-2 · max|ref|``).  JAX is imported
inside the tests that use it, so the ``cuda`` tests also run where JAX is
absent: ``python -m pytest --noconftest tests/test_torch_port_fused_bwd.py -m cuda``.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transferattack_torch.models import init_weights
from transferattack_torch.models.resnet import Bottleneck, fold_bn
from transferattack_torch.ops import fused_bwd as fb


def _1x1_inputs(m, cout, cin, skip, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(m, cout).astype(np.float32)
    mask = (rng.rand(m, cout) > 0.5).astype(np.float32)
    wt = (rng.randn(cout, cin) * 0.05).astype(np.float32)
    s = rng.randn(m, cin).astype(np.float32) if skip else None
    return g, mask, wt, s


def _chain_inputs(b, h, w, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(b, h, w, 256).astype(np.float32)
    masks = {k: (rng.rand(b, h, w, c) > 0.5).astype(np.float32)
             for k, c in (("out", 256), ("c2", 64), ("c1", 64))}
    weights = {k: (rng.randn(*s) * 0.05).astype(np.float32) for k, s in
               (("w1", (1, 1, 256, 64)), ("w2", (3, 3, 64, 64)), ("w3", (1, 1, 64, 256)))}
    return g, masks, weights


def _torch(tree, device="cpu", dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch(v, device, dtype) for v in tree]
    return None if tree is None else torch.from_numpy(tree).to(device, dtype)


def _jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree)


# ---------------------------------------------------------------------------
# the plain versions against JAX, fp32 on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,cout,cin,skip", [(2048, 256, 64, False), (1024, 64, 256, True),
                                             (1000, 256, 64, True)],
                         ids=["256to64", "64to256_skip", "ragged_m1000_skip"])
def test_plain_1x1_matches_jax(m, cout, cin, skip):
    from transferattack_tpu.ops import fused_bwd as jfb

    args = _1x1_inputs(m, cout, cin, skip)
    out = fb.fused_bwd_1x1_plain(*_torch(args)).numpy()
    jargs = [_jax(a) for a in args]
    for ref in (jfb.fused_bwd_1x1(*jargs[:3], skip=jargs[3], interpret=True),
                jfb.jnp_bwd_1x1(*jargs[:3], skip=jargs[3])):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,cout,cin,skip", [(1000, 256, 64, False), (200, 64, 256, True)],
                         ids=["256to64", "64to256_skip"])
def test_plain_1x1_return_gm_matches_jax(m, cout, cin, skip):
    """``return_gm`` hands back JAX's ``g * mask`` beside an ``out`` that
    still matches JAX's kernel in interpret mode."""
    import jax.numpy as jnp
    from transferattack_tpu.ops import fused_bwd as jfb

    args = _1x1_inputs(m, cout, cin, skip, seed=10)
    out, gm = fb.fused_bwd_1x1_plain(*_torch(args), return_gm=True)
    jargs = [_jax(a) for a in args]
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jnp.multiply(jargs[0], jargs[1])))
    ref = jfb.fused_bwd_1x1(*jargs[:3], skip=jargs[3], interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plan_1x1_fits_every_channel_count():
    """Every Cout and Cin that are multiples of 16 up to 2048, with and
    without a skip, fit a block's shared memory with at least two stages;
    BN is 64 exactly when Cin ≤ 64; the chain's two launches get the plans
    ``csrc/fused_bwd.cu`` pins."""
    for cout in range(16, 2049, 16):
        for cin in range(16, 2049, 16):
            for skip in (False, True):
                plan = fb.plan_1x1(401_408, cout, cin, skip)
                assert plan.stages >= 2 and plan.smem <= fb.SMEM_PER_BLOCK
                assert plan.smem == plan.stages * plan.stage_bytes
                assert (plan.bn == 64) == (cin <= 64)
    assert fb.plan_1x1(401_408, 256, 64, False) == (64, 46_080, 4, 184_320, 3136)
    assert fb.plan_1x1(401_408, 64, 256, True) == (128, 87_040, 2, 174_080, 6272)
    assert fb.plan_1x1(128 * 133 + 5, 64, 80, True).tiles == 134 * 1
    with pytest.raises(ValueError, match="multiples of 16"):
        fb.plan_1x1(8, 24, 64, False)


@pytest.mark.parametrize("shape,cin", [
    ((2, 16, 16, 64), 64),
    ((3, 13, 17, 64), 64),   # the kernel's 256-pixel blocks cross images
    ((2, 4, 40, 16), 16),    # a block spans several images; 16 channels
    ((5, 4, 5, 48), 16),     # a partial 64-channel chunk and a partial N block
    ((1, 3, 300, 16), 32),   # W wider than a block
], ids=["16x16", "13x17", "4x40_c16", "4x5_c48to16", "3x300"])
def test_plain_3x3_matches_jax(shape, cin):
    """Pins the oracle the CUDA kernel is held to, at the shapes that reach
    its edge cases."""
    from transferattack_tpu.ops import fused_bwd as jfb

    rng = np.random.RandomState(1)
    g = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(*shape) > 0.5).astype(np.float32)
    wfwd = (rng.randn(3, 3, cin, shape[3]) * 0.05).astype(np.float32)
    w_col = fb.flip_3x3_for_bwd(torch.from_numpy(wfwd))
    np.testing.assert_array_equal(w_col.numpy(),
                                  np.asarray(jfb.flip_3x3_for_bwd(_jax(wfwd))))
    out = fb.fused_bwd_3x3_plain(torch.from_numpy(g), torch.from_numpy(mask), w_col).numpy()
    for ref in (jfb.fused_bwd_3x3(_jax(g), _jax(mask), _jax(w_col.numpy()), interpret=True),
                jfb.jnp_bwd_3x3(_jax(g), _jax(mask), _jax(wfwd))):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_smem_3x3_fits_the_halo_up_to_w_613():
    assert fb.smem_3x3(56) == (256 + 2 * 56 + 3) * 144 + 2 * 64 * 144 == 71_856
    assert fb.smem_3x3(1) == 256 * 68 * 4  # the epilogue tile is the larger
    assert fb.smem_3x3(613) == 232_272 <= fb.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="W <= 613"):
        fb.smem_3x3(614)


def test_plain_3x3_is_true_conv_backward():
    """The plain 3×3 equals autograd of the SAME conv, through the mask."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 8, 8, 4).astype(np.float32)).permute(0, 3, 1, 2)
    wfwd = torch.from_numpy((rng.randn(3, 3, 4, 4) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 8, 8, 4).astype(np.float32))
    mask = torch.from_numpy((rng.rand(1, 8, 8, 4) > 0.5).astype(np.float32))
    x.requires_grad_(True)
    y = F.conv2d(x, wfwd.permute(3, 2, 0, 1), padding=1)
    ref = torch.autograd.grad(y, x, grad_outputs=(g * mask).permute(0, 3, 1, 2))[0]
    out = fb.fused_bwd_3x3_plain(g, mask, fb.flip_3x3_for_bwd(wfwd))
    np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_plain_chain_matches_jax():
    from transferattack_tpu.ops import fused_bwd as jfb

    g, masks, weights = _chain_inputs(2, 8, 8, seed=3)
    out = fb.bottleneck_bwd_input_plain(_torch(g), _torch(masks), _torch(weights)).numpy()
    for ref in (jfb.bottleneck_bwd_input_pallas(_jax(g), _jax(masks), _jax(weights),
                                                interpret=True),
                jfb.bottleneck_bwd_input_jnp(_jax(g), _jax(masks), _jax(weights))):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the witness: the chain is a true input gradient of a BN-folded block
# ---------------------------------------------------------------------------


def bottleneck_off_identity(seed=0):
    """A port ``Bottleneck(256, 64)`` (ResNet-50 ``layer1.1``) with seeded
    weights and BatchNorm off the identity (statistics and affine)."""
    blk = Bottleneck(256, 64)
    init_weights(blk, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for norm in (blk.bn1, blk.bn2, blk.bn3):
            c = norm.num_features
            for t, v in ((norm.weight, rng.normal(1.0, 0.1, c)),
                         (norm.bias, rng.normal(0.0, 0.05, c)),
                         (norm.running_mean, rng.normal(0.0, 0.05, c)),
                         (norm.running_var, rng.uniform(0.5, 1.5, c))):
                t.copy_(torch.from_numpy(v))
    return blk.eval().requires_grad_(False)


def block_masks_and_grad(blk, x, g):
    """The block's three ReLU masks (NHWC) from its forward, and autograd's
    input gradient (NHWC) for the output gradient ``g`` (NHWC)."""
    with torch.no_grad():
        a1 = blk.bn1(blk.conv1(x))
        a2 = blk.bn2(blk.conv2(F.relu(a1)))
        a3 = blk.bn3(blk.conv3(F.relu(a2))) + x
    masks = {k: (a > 0).to(x.dtype).permute(0, 2, 3, 1).contiguous()
             for k, a in (("out", a3), ("c2", a2), ("c1", a1))}
    xg = x.detach().requires_grad_(True)
    grad = torch.autograd.grad(blk(xg), xg, grad_outputs=g.permute(0, 3, 1, 2))[0]
    return masks, grad.permute(0, 2, 3, 1).contiguous()


def block_weights(blk):
    return {k: conv.weight.permute(2, 3, 1, 0) for k, conv in  # OIHW -> HWIO
            (("w1", blk.conv1), ("w2", blk.conv2), ("w3", blk.conv3))}


def test_plain_chain_is_the_gradient_of_a_folded_bottleneck():
    """With masks from the folded block's forward and its folded weights, the
    chain is the input gradient of the folded block and of the block as it
    was before folding."""
    blk = bottleneck_off_identity()
    folded = fold_bn(copy.deepcopy(blk))
    rng = np.random.RandomState(4)
    x = torch.relu(torch.from_numpy(rng.randn(2, 256, 8, 8).astype(np.float32)))
    g = torch.from_numpy(rng.randn(2, 8, 8, 256).astype(np.float32))
    masks, ref_folded = block_masks_and_grad(folded, x, g)
    ref = block_masks_and_grad(blk, x, g)[1]
    out = fb.bottleneck_bwd_input_plain(g, masks, block_weights(folded)).numpy()
    np.testing.assert_allclose(out, ref_folded.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    before = (fb.fused_bwd_1x1.launches, fb.fused_bwd_3x3.launches)
    a = _torch(_1x1_inputs(40, 32, 16, True, seed=5))
    assert torch.equal(fb.fused_bwd_1x1(*a), fb.fused_bwd_1x1_plain(*a))
    g, masks, weights = (_torch(t) for t in _chain_inputs(1, 5, 7, seed=6))
    w_col = fb.flip_3x3_for_bwd(weights["w2"])
    assert torch.equal(fb.fused_bwd_3x3(g[..., :64], masks["c2"], w_col),
                       fb.fused_bwd_3x3_plain(g[..., :64], masks["c2"], w_col))
    assert torch.equal(fb.bottleneck_bwd_input(g, masks, weights),
                       fb.bottleneck_bwd_input_plain(g, masks, weights))
    assert (fb.fused_bwd_1x1.launches, fb.fused_bwd_3x3.launches) == before


def test_1x1_wrapper_return_gm_on_cpu_runs_plain_without_launching():
    before = fb.fused_bwd_1x1.launches
    for skip in (False, True):
        a = _torch(_1x1_inputs(40, 32, 16, skip, seed=11))
        out, gm = fb.fused_bwd_1x1(*a, return_gm=True)
        ref_out, ref_gm = fb.fused_bwd_1x1_plain(*a, return_gm=True)
        assert torch.equal(out, ref_out) and torch.equal(gm, ref_gm)
        assert torch.equal(gm, a[0] * a[1])
        assert torch.equal(out, fb.fused_bwd_1x1(*a))
    assert fb.fused_bwd_1x1.launches == before


def test_wrappers_refuse_tensors_off_the_cpu_that_are_not_cuda():
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="one CUDA device"):
        fb.fused_bwd_1x1(torch.zeros(8, 32, **meta), torch.zeros(8, 32),
                         torch.zeros(32, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        fb.fused_bwd_3x3(torch.zeros(1, 4, 4, 16, **meta), torch.zeros(1, 4, 4, 16),
                         torch.zeros(144, 16))
    g, masks, weights = _chain_inputs(1, 2, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        fb.bottleneck_bwd_input(_torch(g, "meta"), _torch(masks), _torch(weights))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

BF16_TOL = 1e-2  # max|out - ref| / max|ref|: one bf16 rounding


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(out, ref):
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,cout,cin,skip", [
    (8192, 256, 64, False), (8192, 64, 256, True), (1031, 256, 64, False),
    (1031, 64, 256, True), (1, 16, 16, True), (98, 2048, 512, False), (98, 512, 2048, True),
    # a tile count that is not a multiple of the grid (134 and 268 tiles)
    (128 * 133 + 5, 256, 64, False), (128 * 133 + 5, 64, 256, True),
    # a partial k-step (Cout 48) and a partial BN = 128 tile (Cin 80)
    (1000, 48, 64, True), (1000, 64, 80, True), (1000, 48, 80, False),
])
def test_1x1_kernel_matches_plain(cuda, m, cout, cin, skip):
    """Within one bf16 rounding of the plain version, with and without the
    second output, which is bit for bit ``g * mask``."""
    args = _torch(_1x1_inputs(m, cout, cin, skip, seed=7), cuda, torch.bfloat16)
    before = fb.fused_bwd_1x1.launches
    out = fb.fused_bwd_1x1(*args)
    out_gm, gm = fb.fused_bwd_1x1(*args, return_gm=True)
    torch.cuda.synchronize()
    assert fb.fused_bwd_1x1.launches == before + 2
    assert out.shape == (m, cin) and out.dtype == torch.bfloat16
    assert _rel_err(out, fb.fused_bwd_1x1_plain(*args)) <= BF16_TOL
    assert torch.equal(out_gm, out)
    assert torch.equal(gm, args[0] * args[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin", [
    ((4, 56, 56, 64), 64), ((3, 13, 17, 64), 64), ((1, 1, 1, 16), 32), ((2, 7, 7, 512), 512),
    # ResNet-50's stride-1 3x3s at batch 128, stages 1 to 4
    ((128, 56, 56, 64), 64), ((128, 28, 28, 128), 128), ((128, 14, 14, 256), 256),
    ((128, 7, 7, 512), 512),
    # a block spans several images, with a partial chunk and a partial N block;
    # W wider than a block; the widest W whose halo fits
    ((5, 4, 5, 48), 16), ((1, 3, 300, 64), 64), ((1, 2, 613, 16), 16),
])
def test_3x3_kernel_matches_plain(cuda, shape, cin):
    rng = np.random.RandomState(8)
    g = torch.from_numpy(rng.randn(*shape)).to(cuda, torch.bfloat16)
    mask = torch.from_numpy(rng.rand(*shape) > 0.5).to(cuda, torch.bfloat16)
    w_col = fb.flip_3x3_for_bwd(
        torch.from_numpy(rng.randn(3, 3, cin, shape[3]) * 0.05).to(cuda, torch.bfloat16))
    before = fb.fused_bwd_3x3.launches
    out = fb.fused_bwd_3x3(g, mask, w_col)
    torch.cuda.synchronize()
    assert fb.fused_bwd_3x3.launches == before + 1
    assert out.shape == shape[:3] + (cin,)
    assert _rel_err(out, fb.fused_bwd_3x3_plain(g, mask, w_col)) <= BF16_TOL


@pytest.mark.cuda
def test_chain_on_a_folded_bottleneck(cuda):
    blk = fold_bn(bottleneck_off_identity()).to(cuda, torch.bfloat16,
                                                memory_format=torch.channels_last)
    rng = np.random.RandomState(9)
    x = torch.relu(torch.from_numpy(rng.randn(4, 256, 14, 14))).to(cuda, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.from_numpy(rng.randn(4, 14, 14, 256)).to(cuda, torch.bfloat16)
    masks, ref = block_masks_and_grad(blk, x, g)
    weights = block_weights(blk)
    before = (fb.fused_bwd_1x1.launches, fb.fused_bwd_3x3.launches)
    out = fb.bottleneck_bwd_input(g, masks, weights)
    torch.cuda.synchronize()
    assert (fb.fused_bwd_1x1.launches - before[0], fb.fused_bwd_3x3.launches - before[1]) \
        == (2, 1)
    assert _rel_err(out, ref) <= 2 * BF16_TOL
    assert _rel_err(out, fb.bottleneck_bwd_input_plain(g, masks, weights)) <= 2 * BF16_TOL


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    g = torch.zeros(32, 64, device=cuda, dtype=torch.bfloat16)
    wt = torch.zeros(64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        fb.fused_bwd_1x1(g.float(), g.float(), wt.float())
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_bwd_1x1(g.t().contiguous().t(), g, wt)
    with pytest.raises(ValueError, match="multiples of 16"):
        fb.fused_bwd_1x1(g[:, :24].contiguous(), g[:, :24].contiguous(), wt[:24])
    with pytest.raises(ValueError, match="shapes"):
        fb.fused_bwd_1x1(g, g[:16], wt)
    with pytest.raises(ValueError, match="one CUDA device"):
        fb.fused_bwd_1x1(g, g.cpu(), wt)
    with pytest.raises(ValueError, match="16-byte"):
        buf = torch.zeros(32 * 64 + 1, device=cuda, dtype=torch.bfloat16)
        fb.fused_bwd_1x1(buf[1:].view(32, 64), g, wt)
    with pytest.raises(ValueError, match="shapes"):
        fb.fused_bwd_3x3(g.view(2, 4, 4, 64), g.view(2, 4, 4, 64), wt)


@pytest.mark.cuda
def test_3x3_kernel_refuses_an_image_too_wide_for_its_halo(cuda):
    g = torch.zeros(1, 1, 614, 16, device=cuda, dtype=torch.bfloat16)
    w_col = torch.zeros(9 * 16, 16, device=cuda, dtype=torch.bfloat16)
    before = fb.fused_bwd_3x3.launches
    with pytest.raises(ValueError, match="W <= 613"):
        fb.fused_bwd_3x3(g, g, w_col)
    assert fb.fused_bwd_3x3.launches == before
