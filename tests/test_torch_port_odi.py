"""The port's ODI and its mesh rasterizer against the JAX package.

On each of ODI's three meshes (pack, pillow, book) at 32²: the loaded face
arrays are JAX's bit for bit; ``look_at`` and ``tilt_matrix`` match JAX's;
the rasterizer's hit mask matches JAX's on at least 99.9% of pixels and its
face ids where both hit (the depth is an fp32 expression of edge functions,
so a pixel on an edge may take the other face), its barycentrics within
1e-4 where the face ids agree; ``shade`` given JAX's geometry gives JAX's
colours within ``1e-5·max`` on a smooth texture and JAX's texture gradient
(the gather's backward) within ``5e-4·max``; a whole render on the book,
given JAX's draws, matches JAX's within 1e-4 on at least 99.9% of pixels.
The ODI key runs in both packages on ``toy_cnn``, its renders fed the
values that JAX's ``jax.random`` calls give on the step's key, at the bar
of the other attack-level tests.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_port_gradient_deterministic import run_pair
from test_torch_port_input_ops import T
from test_torch_port_models import registry_pair
from transferattack_tpu.input_transformation import ssm_tricks as jssm_tricks
from transferattack_tpu.ops import render3d as jr
from transferattack_torch.ops import render3d as tr

MESHES = ("pack", "pillow", "book")
H = W = 32
EPOCH, BATCH = 3, 2
KEYS = jax.random.split(jax.random.PRNGKey(41), EPOCH)  # one JAX key a step


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jrender_draws(key, B, H, W):
    """JAX's draws of one render of B images on ``key``
    (``ssm_tricks.py:104-118``, ``render3d.py:211-238``)."""
    kobj, krender = jax.random.split(key)
    obj = jax.random.randint(kobj, (), 0, len(MESHES))

    def one(k):
        ks = jax.random.split(k, 8)
        return {"solid": jax.random.uniform(ks[0], (1, 1, 3)).reshape(3),
                "elev": jax.random.randint(ks[1], (), -35, 36),
                "azim": jax.random.randint(ks[2], (), -35, 36),
                "dist": jax.random.uniform(ks[3], ()),
                "angle": jax.random.randint(ks[4], (), -35, 36),
                "light": jax.random.uniform(ks[5], (3,)),
                "ambient": jax.random.uniform(ks[6], ()),
                "diffuse": jax.random.uniform(ks[7], ()),
                "background": jax.random.uniform(jax.random.fold_in(k, 99), (H, W, 3))}

    return obj, jax.vmap(one)(jax.random.split(krender, B))


def jrender_draws(key, B, H, W):
    """The values of :func:`_jrender_draws` as the port's
    ``render_draws`` returns them."""
    obj, d = _jrender_draws(key, B, H, W)
    return {"obj": int(obj), **{k: T(v) for k, v in d.items()}}


def cameras(mesh, seed, B=2):
    """(the port's R, T, JAX's R, T) of B random cameras about ``mesh``."""
    base_dist, base_elev, base_azim, trans = jr.ODI_MODEL_SETTINGS[mesh][4:]
    rng = np.random.RandomState(seed)
    elev = (base_elev + rng.randint(-35, 36, B)).astype(np.float32)
    azim = (base_azim + rng.randint(-35, 36, B)).astype(np.float32)
    dist = (base_dist * (0.8 + 0.4 * rng.rand(B))).astype(np.float32)
    angle = rng.randint(-35, 36, B).astype(np.float32)
    R, Tt = tr.look_at(T(dist), T(elev), T(azim), trans)
    R = R @ tr.tilt_matrix(T(angle)).transpose(1, 2)
    jl = jax.jit(jax.vmap(lambda d, e, a, t: (
        jr.look_at(d, e, a, trans)[0] @ jr.tilt_matrix(t).T, jr.look_at(d, e, a, trans)[1])))
    jR, jT = jl(dist, elev, azim, angle)
    return R, Tt, jR, jT


def smooth_texture(B, th, tw, seed=7):
    """B smooth (th, tw, 3) canvases in [0, 1], a few cycles across: a
    pixel's UV times the canvas side amplifies a last-bit difference in it
    to 1e-4 texel, which white noise would turn into that much colour."""
    rng = np.random.RandomState(seed)
    v, u = np.meshgrid(np.arange(th) / th, np.arange(tw) / tw, indexing="ij")
    f = rng.uniform(2, 6, (B, 3, 2))
    p = rng.uniform(0, 2 * np.pi, (B, 3))
    tex = 0.5 + 0.5 * np.sin(2 * np.pi * (f[..., 0, None, None] * u + f[..., 1, None, None] * v)
                             + p[..., None, None])
    return tex.transpose(0, 2, 3, 1).astype(np.float32)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_loads_as_jax_does(mesh):
    port, ref = tr.load_mesh(mesh), jr.load_mesh(mesh)
    assert port.tri_pos.shape[0] % 256 == 0
    for t, j in zip(port, ref):
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_camera_matches_jax():
    R, Tt, jR, jT = cameras("book", 0, B=8)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(jT), atol=1e-6)


@functools.partial(jax.jit, static_argnums=(0,))
def _jgeometry_and_shade(name, R, Tt, texture, light, ambient, diffuse, ct):
    mesh = jr.load_mesh(name)
    hit, fid, bary = jr.rasterize(mesh, R, Tt, H, W)

    def colour(tex):
        return jr.shade(mesh, hit, fid, bary, tex, light, ambient, diffuse, H, W)

    out, vjp = jax.vjp(colour, texture)
    return hit, fid, bary, out, vjp(ct)[0]


@pytest.mark.parametrize("mesh", MESHES)
def test_rasterize_and_shade_match_jax(mesh):
    """Two random cameras a mesh at 32²: geometry, colours and the texture
    gradient against JAX's (module docstring)."""
    R, Tt, jR, jT = cameras(mesh, MESHES.index(mesh) + 1)
    th, tw = tr.ODI_TEXTURE_SIZES[mesh]
    rng = np.random.RandomState(7)
    tex = smooth_texture(2, th, tw)
    light = (rng.rand(2, 3) * 4 - 2 + [0, 0, 4]).astype(np.float32)
    amb, dif = (0.6 + 0.3 * rng.rand(2)).astype(np.float32), (0.5 * rng.rand(2)).astype(np.float32)
    ct = rng.randn(2, H, W, 3).astype(np.float32)
    hit, fid, bary = tr.rasterize(tr.load_mesh(mesh), R, Tt, H, W)
    m = tr.load_mesh(mesh)
    for b in range(2):
        jhit, jfid, jbary, jcol, jgrad = (np.asarray(v) for v in _jgeometry_and_shade(
            mesh, jR[b], jT[b], tex[b], light[b], amb[b], dif[b], ct[b]))
        assert jhit.mean() > 0.05, "the object is in view"
        assert (hit[b].numpy() == jhit).mean() >= 0.999
        both = hit[b].numpy() & jhit
        same = fid[b].numpy() == jfid
        assert same[both].mean() >= 0.999
        agree = both & same
        # an edge function over a face's area: a last-bit difference in the
        # pixel grid or an FMA is amplified by the small areas of far faces
        np.testing.assert_allclose(bary[b].numpy()[agree], jbary[agree], atol=1e-4)
        # shade alone, on JAX's geometry
        texture = T(tex[b:b + 1]).requires_grad_(True)
        col = tr.shade(m, T(jhit)[None], T(jfid).long()[None], T(jbary)[None], texture,
                       T(light[b:b + 1]), T(amb[b:b + 1]), T(dif[b:b + 1]), H, W)
        (g,) = torch.autograd.grad((col * T(ct[b:b + 1])).sum(), texture)
        assert np.abs(col[0].detach().numpy() - jcol).max() <= 1e-5 * np.abs(jcol).max()
        # the gather's weights are the fractional parts of UV × (side − 1):
        # a last-bit difference in UV moves them by up to 1e-4
        assert np.abs(g[0].numpy() - jgrad).max() <= 5e-4 * np.abs(jgrad).max()


def test_render_odi_matches_jax():
    """A whole render of two smooth 32² images on the book given JAX's
    draws: pixels within 1e-4 of JAX's (the barycentrics' bar) on at least
    99.9% of them.  The book's canvas is oblong and offset in its texture;
    every mesh's geometry and shading are held above, and the ODI key
    renders all three."""
    mesh = "book"
    from test_torch_port_input_ops import images

    key = jax.random.PRNGKey(22)
    img = images(2, (2, H, W, 3), smooth=True)
    got = tr.render_odi(T(img), tr.load_mesh(mesh), tr.ODI_MODEL_SETTINGS[mesh],
                        tr.ODI_TEXTURE_SIZES[mesh], jrender_draws(key, 2, H, W), H, W).numpy()
    jmesh = jr.load_mesh(mesh)
    ref = np.asarray(jax.jit(jax.vmap(lambda im, k: jr.render_odi(
        im, jmesh, jr.ODI_MODEL_SETTINGS[mesh], jr.ODI_TEXTURE_SIZES[mesh], k, H, W)))(
        img, jax.random.split(jax.random.split(key)[1], 2)))
    close = (np.abs(got - ref) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, f"{mesh}: {close.mean():.5f} of pixels agree"


def test_odi_agrees_with_jax():
    """ODI on ``toy_cnn`` at 32², batch 2, 3 iterations: JAX's gradient on
    the bank's key for the step; the port's renders given JAX's draws on
    that key (the object among the three drawn as JAX draws it)."""
    toy = registry_pair("toy_cnn", seed=5)
    rng = np.random.RandomState(6)
    x = rng.rand(BATCH, H, W, 3).astype(np.float32)
    y = rng.randint(0, 10, BATCH)
    y = np.stack([y, (y + 3) % 10], 1)
    base = jssm_tricks.ODI.get_grad
    objs = {jrender_draws(jax.random.fold_in(k, 0), BATCH, H, W)["obj"] for k in KEYS}
    assert len(objs) > 1, "the bank's keys draw more than one object"
    run_pair("odi", toy, x, y,
             {"get_grad": lambda self, v, x_, y_, s, k: base(self, v, x_, y_, s, KEYS[s.step])},
             {"render_draws": lambda self, g, B, step, H_, W_: jrender_draws(
                 jax.random.fold_in(KEYS[step], 0), B, H_, W_)})
