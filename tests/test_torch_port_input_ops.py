"""The port's image ops and input-transformation apply steps against the JAX
package, function by function.

Where JAX draws from a key inline, the helpers here (``j*_draws``) repeat
its ``jax.random`` calls on that key and hand the values to the port's apply
step; given the same draws, each apply step agrees with JAX's to
``1e-5·max|ref|`` in fp32, and ``scale_and_translate`` with
``jax.image.scale_and_translate(method="linear")`` to 1e-6.  The warps are
held against JAX's exact ``grid_sample``, ``affine_warp``, ``translate`` and
``rotate``, never against its gather-free TPU stand-ins; how far those
stand-ins sit from exact bilinear is measured here too.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transferattack_tpu.gradient import mumodig as jmumodig
from transferattack_tpu.input_transformation import bsr as jbsr
from transferattack_tpu.input_transformation import decowa as jdecowa
from transferattack_tpu.input_transformation import dim as jdim
from transferattack_tpu.input_transformation import l2t as jl2t
from transferattack_tpu.input_transformation import mfi as jmfi
from transferattack_tpu.input_transformation import sia as jsia
from transferattack_tpu.input_transformation import su as jsu
from transferattack_tpu.ops import blocks as jblocks
from transferattack_tpu.ops import image as jimage
from transferattack_tpu.ops import kernels as jkernels
from transferattack_torch.gradient import mumodig as tmumodig
from transferattack_torch.input_transformation import bsr as tbsr
from transferattack_torch.input_transformation import decowa as tdecowa
from transferattack_torch.input_transformation import dim as tdim
from transferattack_torch.input_transformation import l2t as tl2t
from transferattack_torch.input_transformation import mfi as tmfi
from transferattack_torch.input_transformation import sia as tsia
from transferattack_torch.input_transformation import su as tsu
from transferattack_torch.ops import blocks as tblocks
from transferattack_torch.ops import image as timage
from transferattack_torch.ops import kernels as tkernels

EPS = 16 / 255
TOL = 1e-5  # of max|ref|, an apply step given the same draws


def T(a):
    """A JAX or numpy array as a torch tensor."""
    return torch.from_numpy(np.array(a))


def close(t, j, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * max(np.abs(j).max(), 1e-30), f"max|t - j| = {err:.3e}"


def images(seed=0, shape=(4, 32, 32, 3), smooth=False):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    if smooth:  # a smooth image: a 9×9 box blur of the noise, then stretched to [0, 1]
        k = np.ones(9) / 9
        for ax in (1, 2):
            x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, x)
        x = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# JAX's inline draws, repeated on a key (shared with the attack-level tests)
# ---------------------------------------------------------------------------

@jax.jit
def _jdim(key, lo, hi, large, prob):
    """The bounds traced, so that one program serves every rate (a bound
    traced or static draws the same value)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    rnd = jax.random.randint(k1, (), lo, hi).astype(jnp.float32)
    top = jax.random.uniform(k2, (), jnp.float32) * (large - rnd)
    left = jax.random.uniform(k3, (), jnp.float32) * (large - rnd)
    return rnd, top, left, jax.random.uniform(k4, (), jnp.float32) < prob


def jdim_draws(key, size, rate, prob):
    """``random_resize_pad``'s draws (``dim.py:26-31``)."""
    large = float(int(size * rate))
    rnd, top, left, apply = _jdim(key, min(size, int(large)), max(size, int(large)),
                                  np.float32(large), np.float32(prob))
    return {"rnd": T(rnd), "top": T(top), "left": T(left), "apply": T(apply),
            "large": large}


@functools.partial(jax.jit, static_argnums=(1,))
def _jcrop(key, scale):
    k1, k2, k3 = jax.random.split(key, 3)
    area = jax.random.uniform(k1, (), minval=scale[0], maxval=scale[0] + scale[1] + 1e-6)
    side = jnp.sqrt(area)
    return side, jax.random.uniform(k2, ()) * (1 - side), jax.random.uniform(k3, ()) * (1 - side)


def jcrop_draws(key, scale):
    """``random_resized_crop``'s draws (``su.py:22-27``)."""
    side, ty, tx = _jcrop(key, tuple(scale))
    return {"side": T(side), "ty": T(ty), "tx": T(tx)}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jsia(key, shape, num_block, eps_noise):
    B, H, W, C = shape
    kh, kw, kop, kv, kh2, ks, kn = jax.random.split(key, 7)
    cells = (num_block, num_block)
    return {"h_edges": jblocks.random_cuts(kh, H, num_block),
            "w_edges": jblocks.random_cuts(kw, W, num_block),
            "ops": jax.random.randint(kop, cells, 0, jsia.NUM_OPS),
            "shift_v": jax.random.uniform(kv, cells),
            "shift_h": jax.random.uniform(kh2, cells),
            "scale": jax.random.uniform(ks, cells, jnp.float32),
            "noise": jax.random.uniform(kn, shape, jnp.float32, minval=-eps_noise,
                                        maxval=eps_noise)}


def jsia_draws(key, shape, num_block, eps_noise=16 / 255):
    """``sia_blocktransform``'s draws (``sia.py:40-52``)."""
    return {k: T(v) for k, v in _jsia(key, tuple(shape), num_block, eps_noise).items()}


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jl2t(key, op, shape):
    B, H, W, C = shape
    if op == 0:
        return {"angle": jax.random.uniform(key, (B,), minval=-0.2, maxval=0.2)}
    if op == 1:
        return {"power": jax.random.randint(key, (), 0, 5)}
    if op == 2:
        return {"dim": _jdim(key, H, int(H * 1.1), np.float32(int(H * 1.1)), np.float32(1.0))}
    if op == 3:
        k1, k2 = jax.random.split(key)
        return {"edges": jblocks.bsr_lengths(k1, H, 3), "perm": jax.random.permutation(k2, 3)}
    if op == 4:
        return {"perm": jax.random.permutation(key, B)}
    if op == 5:
        return {"keep": jax.random.bernoulli(key, 0.9, shape)}
    if op == 6:
        k1, _ = jax.random.split(key)
        return {"cell": jax.random.bernoulli(k1, 0.75, (4, 4))}
    if op == 7:
        k1, k2 = jax.random.split(key)
        return {"gauss": jax.random.normal(k1, shape, jnp.float32),
                "mask": jax.random.uniform(k2, shape, jnp.float32, minval=0.5, maxval=1.5)}
    if op == 8:
        k1, k2, k3 = jax.random.split(key, 3)
        side = jax.random.uniform(k1, (), minval=0.8, maxval=1.0)
        return {"side": side, "ty": jax.random.uniform(k2, ()) * (1 - side) * H,
                "tx": jax.random.uniform(k3, ()) * (1 - side) * W}
    k1, k2 = jax.random.split(key)
    return {"tx": jax.random.uniform(k1, (B,), minval=-0.1, maxval=0.1),
            "ty": jax.random.uniform(k2, (B,), minval=-0.1, maxval=0.1)}


def jl2t_draws(key, op, shape, pin_rotation=True):
    """L2T's op ``op`` draws (``l2t.py:28-96``); the rotation's angle pinned
    at zero unless asked."""
    d = _jl2t(key, int(op), tuple(shape))
    if op == 2:
        rnd, top, left, apply = d["dim"]
        return {"dim": {"rnd": T(rnd), "top": T(top), "left": T(left), "apply": T(apply),
                        "large": float(int(shape[1] * 1.1))}}
    d = {k: T(v) for k, v in d.items()}
    if op == 0 and pin_rotation:
        d["angle"] = d["angle"] * 0.0
    return d


@functools.partial(jax.jit, static_argnums=(1,))
def _jmumodig(key, shape):
    B, H, W, C = shape
    _, k_op, k_param = jax.random.split(key, 3)
    k1, k2, k3 = jax.random.split(k_param, 3)
    inter = jax.random.randint(k1, (), min(W, 245), max(W, 245)).astype(jnp.float32)
    return {"branch": jax.random.randint(k_op, (), 0, 2),
            "op": jax.random.randint(k_param, (), 0, 5),
            "shift_h": jax.random.randint(k_param, (), 0, H),
            "shift_w": jax.random.randint(k_param, (), 0, W),
            "angle": jax.random.uniform(k_param, (B,), minval=-45.0, maxval=45.0),
            "inter": inter,
            "top": jax.random.uniform(k2, (), jnp.float32) * (245.0 - inter),
            "left": jax.random.uniform(k3, (), jnp.float32) * (245.0 - inter)}


def jmumodig_transform_draws(key, shape, pin_rotation=True):
    """``MUMODIG._rand_transform``'s draws (``mumodig.py:60-107``)."""
    a = _jmumodig(key, tuple(shape))
    if int(a["branch"]) == 0:
        op = int(a["op"])
        d = {"branch": 0, "op": op}
        if op in (0, 1):
            d["shift"] = int(a["shift_h"] if op == 0 else a["shift_w"])
        elif op == 4:
            d["angle"] = T(a["angle"] * 0.0 if pin_rotation else a["angle"])
        return d
    return {"branch": 1, "inter": T(a["inter"]), "top": T(a["top"]), "left": T(a["left"])}


# ---------------------------------------------------------------------------
# ops/image.py, ops/kernels.py, ops/blocks.py
# ---------------------------------------------------------------------------

AFFINE_WARP = jax.jit(jimage.affine_warp)
ROTATE = jax.jit(jimage.rotate)
GRID_SAMPLE = jax.jit(jimage.grid_sample)

# downscales (DIM, MUMODIG, L2T's DIM op), SU's upscale, L2T's crop, fractional shifts
SCALES = [(0.3, 0.0), (0.55, 3.7), (0.9, -0.25), (0.99, 0.5), (1 / math.sqrt(0.1), -12.3),
          (1.2, -2.1), (1.0, 0.4)]


@pytest.mark.parametrize("scale,shift", SCALES)
def test_scale_and_translate_matches_jax(scale, shift):
    x = images(1, (2, 32, 24, 3))
    s, t = (scale, scale * 1.05), (shift, 0.5 * shift + 0.25)
    # eager: JAX's own arithmetic, unfused
    ref = jax.image.scale_and_translate(jnp.asarray(x), x.shape, (1, 2), jnp.asarray(s),
                                        jnp.asarray(t), method="linear")
    out = timage.scale_and_translate(T(x), (32, 24), s, t)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-6


def test_scale_and_translate_antialiases_a_downscale():
    """Shrinking widens the triangle by 1/scale: an image of alternating
    columns shrunk by 0.3 comes out flat, as JAX's does; a plain bilinear
    resample would keep its stripes."""
    x = np.tile((np.arange(32) % 2).astype(np.float32)[None, None, :, None], (1, 8, 1, 1))
    out = timage.scale_and_translate(T(x), (8, 32), (1.0, 0.3), (0.0, 0.0)).numpy()
    inside = out[0, 0, 1:8, 0]
    assert np.ptp(inside) < 0.1


def test_warps_match_jax_exact_warps():
    x = images(2, (3, 20, 28, 3))
    rng = np.random.RandomState(3)
    theta = (np.array([[1, 0, 0], [0, 1, 0]], np.float32)
             + rng.randn(3, 2, 3).astype(np.float32) * 0.3)
    grid = rng.uniform(-1.3, 1.3, (3, 9, 11, 2)).astype(np.float32)
    jx = jnp.asarray(x)
    close(timage.affine_grid(T(theta), 20, 28),
          jax.jit(jimage.affine_grid, static_argnums=(1, 2))(jnp.asarray(theta), 20, 28))
    close(timage.grid_sample(T(x), T(grid)), jax.jit(jimage.grid_sample)(jx, jnp.asarray(grid)))
    close(timage.affine_warp(T(x), T(theta)), AFFINE_WARP(jx, jnp.asarray(theta)))
    tx, ty = rng.uniform(-0.3, 0.3, (2, 3)).astype(np.float32)
    close(timage.translate(T(x), T(tx), T(ty)), jax.jit(jimage.translate)(jx, tx, ty))
    close(timage.translate(T(x), 0.3, -0.15),
          jax.jit(jimage.translate_scalar, static_argnums=3)(jx, 0.3, -0.15, 6))
    ang = rng.uniform(-0.8, 0.8, 3).astype(np.float32)
    close(timage.rotate(T(x), T(ang)), ROTATE(jx, ang))
    close(timage.rotate(T(x), 0.2), ROTATE(jx, np.float32(0.2)))
    close(timage.scale_around_center(T(x), 1.3), jax.jit(jimage.scale_around_center)(jx, 1.3))


def test_warp_gradients_match_jax():
    """The port's warps differentiate as JAX's exact ones do."""
    x = images(4, (2, 16, 16, 3))
    theta = np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, -0.05]]] * 2, np.float32)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a: (jimage.affine_warp(a, jnp.asarray(theta)) * w).sum()))(
        jnp.asarray(x))
    tx = T(x).requires_grad_(True)
    (timage.affine_warp(tx, T(theta)) * T(w)).sum().backward()
    close(tx.grad, jg)


@pytest.mark.parametrize("angle", [90, -90, 180])
def test_quarter_turns_match_jax_rotate_mm(angle):
    x = images(6, (2, 16, 16, 3))
    np.testing.assert_array_equal(
        timage.rotate_quarter_then(T(x), angle).numpy(),
        np.asarray(jax.jit(jimage.rotate_mm, static_argnums=1)(jnp.asarray(x), angle)))
    close(timage.rotate_quarter_then(T(x), angle),
          ROTATE(jnp.asarray(x), np.float32(math.radians(angle))))


@pytest.mark.parametrize("angle", [5, -15, 45])
def test_static_rotations_are_exact_bilinear(angle):
    """OPS's residual angles go through ``rotate``: the same map JAX's
    ``rotate_mm`` approximates."""
    x = images(6, (2, 16, 16, 3))
    close(timage.rotate_quarter_then(T(x), angle),
          ROTATE(jnp.asarray(x), np.float32(math.radians(angle))))


def test_smoothing_kernels_and_conv_match_jax():
    x = images(7, (2, 24, 20, 3))
    for kind in ("gaussian", "uniform", "linear"):
        for size in (5, 15):
            k = tkernels.make_kernel(kind, size)
            np.testing.assert_array_equal(k, jkernels.make_kernel(kind, size))
            close(tkernels.smooth_conv(T(x), k), jax.jit(jkernels.smooth_conv)(jnp.asarray(x), k))


def test_block_index_maps_match_jax():
    @functools.partial(jax.jit, static_argnums=1)
    def maps(key, n):
        out = []
        for edges in (jblocks.random_cuts(key, 37, n), jblocks.bsr_lengths(key, 37, n)):
            perm = jax.random.permutation(jax.random.fold_in(key, 1), n)
            out.append((edges, perm, jblocks.block_id(edges, 37), jblocks.block_bounds(edges),
                        jblocks.permute_strips(edges, perm, 37)))
        return out

    for seed, n in ((0, 3), (1, 4)):
        for edges, perm, ids, bounds, strips in maps(jax.random.PRNGKey(seed), n):
            np.testing.assert_array_equal(tblocks.block_id(T(edges), 37).numpy(), np.asarray(ids))
            for t, j in zip(tblocks.block_bounds(T(edges)), bounds):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            np.testing.assert_array_equal(tblocks.permute_strips(T(edges), T(perm), 37).numpy(),
                                          np.asarray(strips))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):  # the port's own draws: distinct sorted cuts, lengths summing to size
        cuts = tblocks.random_cuts(gen, 9, 4)
        assert cuts[-1] == 9 and (cuts.diff() > 0).all() and cuts[0] >= 1
        ends = tblocks.bsr_lengths(gen, 9, 3)
        assert ends[-1] == 9 and (ends.diff() >= 0).all()


# ---------------------------------------------------------------------------
# the transforms' apply steps, given JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,prob,seed", [(1.66, 1.0, 1), (2.9, 0.5, 2), (1.1, 0.5, 3)])
def test_random_resize_pad_matches_jax(rate, prob, seed):
    x = images(8)
    key = jax.random.PRNGKey(seed)
    d = jdim_draws(key, 32, rate, prob)
    ref = jax.jit(jdim.random_resize_pad, static_argnums=(2, 3))(jnp.asarray(x), key, rate, prob)
    close(tdim.resize_pad(T(x), **d), ref)


def test_random_resized_crop_matches_jax():
    x = images(9)
    for seed, scale in ((0, (0.1, 0.0)), (1, (0.1, 0.3))):
        key = jax.random.PRNGKey(seed)
        close(tsu.resized_crop(T(x), **jcrop_draws(key, scale)),
              jax.jit(jsu.random_resized_crop, static_argnums=2)(jnp.asarray(x), key, scale))


def test_sia_apply_matches_jax():
    x = images(10)
    ref = jax.jit(jsia.sia_blocktransform, static_argnums=2)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        close(tsia.sia_apply(T(x), **jsia_draws(key, x.shape, 3)), ref(jnp.asarray(x), key, 3))


def bsr_params(rng, size, num_block, flip, angles=None):
    """A BSR copy's parameters, numpy (the keys of JAX's ``params=``)."""
    def lengths():
        r = rng.uniform(0, 2, num_block)
        ends = np.round(np.cumsum(r) / r.sum() * size).astype(np.int32)
        ends[-1] = size
        return ends

    return {"flip": np.bool_(flip), "h_edges": lengths(),
            "angles": (np.zeros(num_block, np.float32) if angles is None
                       else np.asarray(angles, np.float32)),
            "w_edges": np.stack([lengths() for _ in range(num_block)]),
            "col_perms": np.stack([rng.permutation(num_block) for _ in range(num_block)]),
            "row_perm": rng.permutation(num_block)}


JBSR_COPY = jax.jit(lambda x, params: jbsr.bsr_one_copy(x, None, 3, params=params))


@pytest.mark.parametrize("flip", [False, True])
def test_bsr_one_copy_with_params_matches_jax(flip):
    """The shuffles given JAX's ``params=``, at angle zero, where JAX's
    three-shear rotation is exact."""
    x = images(11)
    rng = np.random.RandomState(int(flip))
    for _ in range(3):
        p = bsr_params(rng, 32, 3, flip)
        close(tbsr.bsr_one_copy(T(x), None, 3, params={k: T(v) for k, v in p.items()}),
              JBSR_COPY(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))


def test_bsr_strip_rotation_is_exact_bilinear():
    """Each strip rotates about its own center as an image of its own: JAX's
    exact ``grid_sample`` of the strip alone (zero outside it) at the
    pixel-space rotation, read back into the strip's rows."""
    x = images(12, (2, 30, 26, 3))
    edges, angles = np.array([9, 17, 30]), np.array([0.3, -0.4, 0.2], np.float32)
    out = tbsr.rotate_row_strips(T(x), T(edges), T(angles)).numpy()
    H, W = 30, 26
    r, c = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    for s, (a, e) in enumerate(zip([0, 9, 17], edges)):
        strip = np.zeros_like(x)
        strip[:, a:e] = x[:, a:e]
        cy, cx = a + (e - a - 1) / 2, (W - 1) / 2
        cos, sin = np.cos(angles[s]), np.sin(angles[s])
        sc = cx + (c - cx) * cos + (r - cy) * sin
        sr = cy - (c - cx) * sin + (r - cy) * cos
        grid = np.stack([(2 * sc + 1) / W - 1, (2 * sr + 1) / H - 1], -1)[None].repeat(2, 0)
        ref = np.asarray(GRID_SAMPLE(jnp.asarray(strip), jnp.asarray(grid, jnp.float32)))
        close(out[:, a:e], ref[:, a:e])
    # and it is the map of JAX's three shears: on a smooth image the two
    # resamplers differ only by interpolation
    xs = images(12, (2, 30, 26, 3), smooth=True)
    shear = np.asarray(jax.jit(jbsr._rotate_row_strips)(jnp.asarray(xs), jnp.asarray(edges),
                                                        jnp.asarray(angles)))
    exact = tbsr.rotate_row_strips(T(xs), T(edges), T(angles)).numpy()
    assert np.abs(shear - exact).mean() < 0.02


def test_mfi_mix_matches_jax():
    x = images(13)
    rng = np.random.RandomState(14)
    perm, alpha = rng.permutation(4), np.float32(0.37)
    noise = rng.randn(*x.shape).astype(np.float32)
    for kind in ("smfi", "hmfi"):
        j = jmfi.MFI.__new__(jmfi.MFI)
        t = tmfi.MFI.__new__(tmfi.MFI)
        for atk in (j, t):
            atk.mask_radius, atk.gaussian_sigma, atk.mfi_type = 8, 32.0, kind
        close(t.mix_one(T(x), T(perm), T(alpha), T(noise)),
              jax.jit(j._mix_one)(jnp.asarray(x), jnp.asarray(perm), alpha, jnp.asarray(noise)))


# the op index traced: one program for all ten ops
JL2T_OP = jax.jit(jl2t._apply_op)


@pytest.mark.parametrize("op", range(10))
def test_l2t_ops_match_jax(op):
    """Each of L2T's ten ops given JAX's draws.  The rotation is held against
    JAX's exact ``rotate`` at the drawn angles (JAX's op rotates by three
    shears); the translation against ``translate`` (JAX's
    ``translate_sep`` is the same warp)."""
    x = images(15)
    key = jax.random.PRNGKey(op)
    d = jl2t_draws(key, op, x.shape, pin_rotation=False)
    out = tl2t.apply_l2t_op(T(x), op, d, EPS)
    if op == 0:
        ref = ROTATE(jnp.asarray(x), jnp.asarray(d["angle"].numpy()))
    else:
        ref = JL2T_OP(jnp.asarray(x), op, key, EPS)
    close(out, ref)


def test_tps_grid_matches_jax_and_its_solve():
    atk = jdecowa.DeCowA.__new__(jdecowa.DeCowA)
    atk.mesh_width = atk.mesh_height = 3
    np.testing.assert_allclose(tdecowa.tps_operator(20, 24),
                               np.asarray(atk._tps_operator(20, 24)), rtol=0, atol=1e-6)
    nm = np.random.RandomState(16).uniform(-1, 1, (1, 1, 2)).astype(np.float32)
    t = tdecowa.DeCowA.__new__(tdecowa.DeCowA)
    t.mesh_width = t.mesh_height = 3
    t._tps = {}
    grid = t.tps_grid(T(nm), 20, 24)

    @jax.jit
    def jgrid(nm):  # JAX's own solve of the same TPS (jnp.linalg.solve, decowa.py:29-53)
        src = jdecowa.base_control_points(3, 3)
        return jdecowa.tps_grid(src, src.at[4].add(nm[0, 0]), 20, 24)

    close(grid, jgrid(jnp.asarray(nm)), tol=1e-4)
    x = images(17, (2, 20, 24, 3))
    close(t.warp(T(x), T(nm)), GRID_SAMPLE(jnp.asarray(x), jnp.broadcast_to(
        jnp.asarray(grid.numpy())[None], (2, 20, 24, 2))))


def test_mumodig_branches_and_quantization_match_jax(monkeypatch):
    """Each of MUMODIG's branches given JAX's draws; the rotation against
    JAX's exact ``rotate`` at the drawn angles (JAX's own three shears, not
    compared, are replaced by the identity, which spares their compile)."""
    import transferattack_tpu.ops as jops

    monkeypatch.setattr(jops, "rotate_shear", lambda x, a, max_angle=0.25: x)
    x = images(18)
    atk = jmumodig.MUMODIG.__new__(jmumodig.MUMODIG)
    transform = jax.jit(atk._rand_transform)
    seen = set()
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        d = jmumodig_transform_draws(key, x.shape, pin_rotation=False)
        branch = (d["branch"], d.get("op"))
        if branch in seen:
            continue
        seen.add(branch)
        out = tmumodig.rand_transform(T(x), d)
        if branch == (0, 4):
            ref = ROTATE(jnp.asarray(x), jnp.asarray(d["angle"].numpy()) * np.float32(np.pi / 180))
        else:
            ref = transform(jnp.asarray(x), key)
        close(out, ref)
        if len(seen) == 6:
            break
    assert len(seen) == 6
    quantize = jax.jit(jmumodig.lb_quantize, static_argnums=2)
    for region_num in (2, 4):
        key = jax.random.PRNGKey(region_num)
        u = jax.random.uniform(key, (4 * 3, region_num - 1), jnp.float32)
        close(tmumodig.lb_quantize(T(x), T(u), region_num),
              quantize(jnp.asarray(x), key, region_num))


@pytest.mark.parametrize("model", ["toy_cnn", "narrow_bottleneck"])
def test_surrogate_feature_matches_jax(model):
    """``Surrogate.feature`` at a reference-named tap: the logits and the
    feature agree with JAX's ``Surrogate.feature``, and so does the gradient
    of a cosine between two views' features."""
    from test_torch_port_models import narrow_bottleneck_pair, registry_pair

    js, ts, _ = narrow_bottleneck_pair(3) if model != "toy_cnn" else registry_pair(model, 3)
    layer = "layer3" if model != "toy_cnn" else "layer2"
    x = images(19, (4, 32, 32, 3))

    def jcos(a):
        f = js.feature(js.variables, a, layer)[1].reshape(4, -1)
        return (f[:2] * f[2:]).sum() / (jnp.linalg.norm(f[:2]) * jnp.linalg.norm(f[2:]))

    @jax.jit
    def jref(a):
        return js.feature(js.variables, a, layer), jax.grad(jcos)(a)

    (jl, jf), g = jref(jnp.asarray(x))
    tx = T(x).requires_grad_(True)
    tl, tf = ts.feature(tx, layer)
    close(tl, jl, 1e-4)
    close(tf, jf, 1e-4)
    f = tf.reshape(4, -1)
    ((f[:2] * f[2:]).sum() / (f[:2].norm() * f[2:].norm())).backward()
    g = np.asarray(g)
    cos = (tx.grad.numpy() * g).sum() / (np.linalg.norm(tx.grad.numpy()) * np.linalg.norm(g))
    assert cos > 0.999
    with pytest.raises(KeyError):
        ts.feature(T(x), "layer9")


def test_tpu_stand_ins_distance_from_exact_bilinear(monkeypatch, capsys):
    """How far JAX's gather-free stand-ins sit from exact bilinear at their
    callers' angle ranges, on a smooth 32² image: max and mean abs pixel
    distance, printed and recorded in ROADMAP queue 3.  The port does not
    share them: this measures JAX's deliberate departure and asserts only
    that it is there (the stand-in is not the exact warp)."""
    x = jnp.asarray(images(20, (2, 32, 32, 3), smooth=True))
    pairs = {}
    for name, angle in (("l2t rotate_shear ±0.2 rad", 0.2),
                        ("mumodig rotate_shear ±45°", math.pi / 4)):
        a = jnp.asarray([angle, -angle], jnp.float32)
        pairs[name] = (jax.jit(jimage.rotate_shear, static_argnums=2)(x, a, angle), ROTATE(x, a))
    pairs["ops rotate_mm 45°"] = (jax.jit(jimage.rotate_mm, static_argnums=1)(x, 45),
                                  ROTATE(x, np.float32(math.pi / 4)))
    edges = np.array([10, 21, 32])
    ang = np.array([0.42, -0.42, 0.3], np.float32)  # BSR's ±24°
    pairs["bsr three-shear strips ±24°"] = (
        jax.jit(jbsr._rotate_row_strips)(x, jnp.asarray(edges), jnp.asarray(ang)),
        tbsr.rotate_row_strips(T(np.asarray(x)), T(edges), T(ang)).numpy())
    # DeCowA's separable field against its own bilinear path, noise_scale 2,
    # the interior point moved near the edge of its ±1 draw
    atk = jdecowa.DeCowA.__new__(jdecowa.DeCowA)
    atk.mesh_width = atk.mesh_height = 3
    atk.noise_scale = 2.0
    atk._tps_operator(32, 32)  # its cache filled outside a trace
    nm = jnp.asarray([[[0.9, -0.8]]], jnp.float32)
    sep = jax.jit(atk._warp)(x, nm)
    monkeypatch.setenv("TA_TPU_DECOWA_WARP", "bilinear")
    pairs["decowa warp_field_sep"] = (sep, jax.jit(atk._warp)(x, nm))
    for name, (stand_in, exact) in pairs.items():
        d = np.abs(np.asarray(stand_in) - np.asarray(exact))
        with capsys.disabled():
            print(f"\n{name}: max {d.max():.4f}, mean {d.mean():.5f}", end="")
        assert d.max() > 0, name
